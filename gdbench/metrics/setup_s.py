"""Seconds from the process's start to the first timed frame: imports,
the kernels built or loaded, the scene loaded and put on the device, the
tracer made and one frame of the cell's size rendered."""


def read(rec):
    return rec.setup_s
