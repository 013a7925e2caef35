"""Path-tracing helpers shared by the integrators.

Counterpart of the parts of gradientdomain_mitsuba_tpu/models/path.py
that G-PT uses: the power-heuristic MIS weight and the bounce cap for
maxDepth = -1.  The PathTracer integrator itself is not ported yet
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import torch

# bounce cap used for maxDepth = -1 (unlimited; Russian roulette ends
# paths long before it)
MAX_BOUNCES_UNLIMITED = 40


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (path.cpp miWeight)."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0,
                       a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-30), 0.0)
