"""Device milliseconds per frame outside the traversal kernels and the
L1 solve: the device's busy time per frame of the traced window, less
the traversal kernels' time (names in kernels.json) and less
poisson_ms_per_frame where the cell solves."""


def read(rec):
    tr = rec.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    per = (tr["busy_s"] * 1e3 - tr["traversal_ms"]) / tr["frames"]
    return per - rec.spans.get("poisson_ms", 0.0)
