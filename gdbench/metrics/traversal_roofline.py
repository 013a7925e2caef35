"""Per cent of the roofline of the traversal kernels over one traced
frame (the kept frame rendered again): the frozen bound (roofline.py)
summed over its traversal calls, over those calls' kernel device time."""


def read(rec):
    rf = (rec.trace or {}).get("roofline")
    if not rf or rf["kernel_ms"] <= 0:
        return None
    return 100.0 * rf["bound_ms"] / rf["kernel_ms"]
