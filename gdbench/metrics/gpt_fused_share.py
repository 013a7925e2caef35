"""Per cent of G-PT's bounces, counted in lanes, that the fused kernels
shaded (the program's gpt_lanes_fused counter, one count a bounce of its
N lanes) of all G-PT bounce lanes, fused or by the eager bounce
(gpt_lanes_eager), over the traced window's frames.  None where the
program counts neither."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    if not tr:
        return None
    fused = tr["counters"].get("gpt_lanes_fused", 0)
    lanes = fused + tr["counters"].get("gpt_lanes_eager", 0)
    if not lanes:
        return None
    return 100.0 * fused / lanes
