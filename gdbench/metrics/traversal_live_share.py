"""Per cent of the lanes sent to the traversal kernels that were live
rays, over the traced window: the program's live-ray tally (lanes with
maxt > 0, as mrays_per_s reads it) over the lanes its `traverse` spans
counted."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    lanes = tr and tr["counters"].get("lanes")
    if not lanes or not rec.trace.get("rays"):
        return None
    return 100.0 * rec.trace["rays"] / lanes
