"""Collective calls rank 0 makes a frame: the program's `collectives`
counter (one count a halo exchange, reduce or gather) over the traced
window's frames, per frame."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    if not tr or "collectives" not in tr["counters"]:
        return None
    return tr["counters"]["collectives"] / tr["frames"]
