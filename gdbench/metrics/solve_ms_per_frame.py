"""Device milliseconds of the program's L1 solve inside its frames: from
the `solve` span's entry CUDA event to its exit event (idle inside the
solve included), summed over the traced window's frames, per frame."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    ms = tr and program_trace.device_ms(tr, "solve")
    return None if ms is None else ms / tr["frames"]
