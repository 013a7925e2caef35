"""Device milliseconds of the program's L1 solve (models/poisson.py
solve_l1) on a frame's buffers: the union of its device ops' intervals
when it runs again, profiled, after the traced window on that window's
last frame's buffers."""


def read(rec):
    return rec.spans.get("poisson_ms")
