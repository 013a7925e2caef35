"""Per cent of the traced window in which no operation ran on the
device: 1 - (the union of the device ops' intervals / the window)."""


def read(rec):
    tr = rec.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
