"""RGB spectrum helpers (counterpart of gradientdomain_mitsuba_tpu/
core/spectrum.py; Mitsuba's src/libcore/spectrum.cpp, 3 samples)."""
from __future__ import annotations

# ITU-R BT.709 luminance weights — same as Mitsuba's Spectrum::getLuminance.
LUMINANCE_WEIGHTS = (0.212671, 0.715160, 0.072169)


def luminance(s):
    """Weighted channel sum, written out so no weight tensor has to be
    copied to the device on every call."""
    w0, w1, w2 = LUMINANCE_WEIGHTS
    return s[..., 0] * w0 + s[..., 1] * w1 + s[..., 2] * w2
