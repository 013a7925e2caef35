"""Device milliseconds a frame that rank 0 spends in collective calls:
the program's `collective` spans (the halo adds at the seams, the
gather of the buffers to rank 0, the ray count's reduce), each from its entry CUDA event to its exit event, so waiting on a slower
rank counts, summed over the traced window's frames, per frame."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    ms = tr and program_trace.device_ms(tr, "collective")
    return None if ms is None else ms / tr["frames"]
