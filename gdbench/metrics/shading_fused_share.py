"""Per cent of the shading wavefront's lanes that the fused bounce
shaded (the program's shade_lanes_fused counter, one count a bounce of
its lanes) of all lanes shaded, fused or by the eager bounce
(shade_lanes_eager), over the traced window's frames.  None where the
program counts neither."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    if not tr:
        return None
    fused = tr["counters"].get("shade_lanes_fused", 0)
    lanes = fused + tr["counters"].get("shade_lanes_eager", 0)
    if not lanes:
        return None
    return 100.0 * fused / lanes
