"""Traversal kernel device milliseconds per million live rays over one
traced frame (the kept frame rendered again, every call's live rays)."""


def read(rec):
    rf = (rec.trace or {}).get("roofline")
    if not rf or rf["rays"] <= 0:
        return None
    return rf["kernel_ms"] / (rf["rays"] / 1e6)
