"""Synchronizing host calls a frame inside the program's frames: the
program's host_syncs counter (torch's sync debug mode, on while a span
is open) over the spans of the traced window's frames, per frame."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    if not tr:
        return None
    return tr["counters"].get("host_syncs", 0) / tr["frames"]
