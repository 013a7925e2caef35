"""Multi-channel rendering (src/integrators/misc/multichannel.cpp).

Counterpart of gradientdomain_mitsuba_tpu/models/multichannel.py: every
child integrator renders as its own full wavefront pass over the SAME
counter-RNG sample stream (pixel jitters line up across children, like
the reference's shared sample vector), and the result is a dict of
channel name -> image on the device (the reference's CLI writes one EXR
per channel).  Children are built through the factory, with the
reference's channel names and per-child maxDepth / rrDepth.
"""
from __future__ import annotations

import copy

from .factory import make_integrator


class MultiChannelIntegrator:
    def __init__(self, scene, settings):
        self.settings = settings
        children = settings.integrator_children or [("path", {})]
        self.children = []
        names = set()
        for i, (t, props) in enumerate(children):
            if t in ("multichannel", "adaptive"):
                raise ValueError(
                    f"multichannel: nested '{t}' is not supported")
            st = copy.deepcopy(settings)
            st.integrator = t
            st.integrator_props = dict(props)
            st.integrator_children = []
            st.max_depth = int(props.get("maxDepth", settings.max_depth))
            st.rr_depth = int(props.get("rrDepth", settings.rr_depth))
            name = t if t != "field" else \
                f"field_{props.get('field', 'distance')}"
            while name in names:
                name = f"{name}_{i}"
            names.add(name)
            self.children.append((name, make_integrator(scene, st)))

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        return {name: tracer.render(scene, seed=seed, spp=spp)
                for name, tracer in self.children}


def render(scene, settings, seed=0, spp=None):
    return MultiChannelIntegrator(scene, settings).render(
        scene, seed=seed, spp=spp)
