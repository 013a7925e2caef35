"""Render loops around the integrators (counterpart of
gradientdomain_mitsuba_tpu/parallel): checkpointed accumulation.  The
multi-device pieces (tiles, distributed Poisson, multi-host) are not
ported yet (ROADMAP Queue 1 item 23)."""
