"""Rays a second of the traced window, in millions: the program's own
device counter (lanes with maxt > 0 of every traversal call) over the
window's seconds."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.get("rays"):
        return None
    return tr["rays"] / tr["window_s"] / 1e6
