"""Kernels launched on the device per frame of the traced window (the
profiler's device kernels; copies and fills not counted)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr["launches"]:
        return None
    return tr["launches"] / tr["frames"]
