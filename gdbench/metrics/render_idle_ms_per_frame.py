"""Device milliseconds a frame in which the device idled inside the
program's frames: the top-level `render` spans' device time (from each
span's entry CUDA event to its exit event) over the traced window, less
the device's busy time of the window (the union of its device ops), per
frame.  The harness's own few small ops between frames count as busy
time, so this reads low by their time."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    if not tr or rec.trace["busy_s"] <= 0:
        return None
    ms = [s["device_ms"] for s in program_trace.frame_spans(tr)]
    if not ms or None in ms:
        return None
    return (sum(ms) - rec.trace["busy_s"] * 1e3) / tr["frames"]
