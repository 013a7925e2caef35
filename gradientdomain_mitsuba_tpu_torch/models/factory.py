"""Integrator factory: XML `type` string -> tracer instance.

Counterpart of gradientdomain_mitsuba_tpu/models/factory.py (the analog
of PluginManager::createObject for the integrator family,
src/libcore/plugin.cpp).  It constructs the integrator types the port
renders (PORTED); every other type of KNOWN raises NotImplementedError
naming its ROADMAP Queue 1 item, so none of them falls through to the
path tracer.  A type outside KNOWN falls through to the path tracer, as
in the reference, unless the scene carries subsurface attachments (the
reference's dipole route, item 17c).  `gpt` / `gbdpt` return buffers
that the reconstruction layer (models/poisson.reconstruct) turns into
the final image.
"""
from __future__ import annotations

KNOWN = ("path", "direct", "ao", "bdpt", "field", "volpath",
         "volpath_simple", "pssmlt", "mlt", "erpt", "irrcache",
         "sppm", "ppm",
         "photonmapper", "adaptive", "multichannel", "vpl", "gpt",
         "gbdpt")

PORTED = ("path", "gpt", "bdpt", "gbdpt", "direct", "ao", "field",
          "multichannel", "adaptive")

# the ROADMAP Queue 1 item of every type of KNOWN the port does not render
UNPORTED = {
    "volpath": "17b", "volpath_simple": "17b",
    "irrcache": "18a", "vpl": "18a",
    "sppm": "18b", "ppm": "18b", "photonmapper": "18b",
    "pssmlt": "19", "mlt": "19", "erpt": "19",
}


def make_integrator(scene, settings):
    t = settings.integrator
    if t in UNPORTED:
        raise NotImplementedError(
            f"integrator {t!r}: ROADMAP Queue 1 item {UNPORTED[t]}")
    if t == "gpt":
        from .gpt import GPTracer
        return GPTracer(scene, settings)
    if t == "gbdpt":
        from .gbdpt import GBDPTracer
        return GBDPTracer(scene, settings)
    if t == "bdpt":
        from .bdpt import BDPTracer
        return BDPTracer(scene, settings)
    if t == "adaptive":
        from .adaptive import AdaptiveTracer
        return AdaptiveTracer(scene, settings)
    if t == "multichannel":
        from .multichannel import MultiChannelIntegrator
        return MultiChannelIntegrator(scene, settings)
    if t == "direct":
        from .direct import DirectIntegrator
        return DirectIntegrator(scene, settings)
    if t == "ao":
        from .direct import AOIntegrator
        return AOIntegrator(scene, settings)
    if t == "field":
        from .direct import FieldIntegrator
        return FieldIntegrator(scene, settings)
    if getattr(settings, "has_sss", False):
        raise NotImplementedError(
            "subsurface (dipole) path tracer: ROADMAP Queue 1 item 17c")
    from .path import PathTracer
    return PathTracer(scene, settings)
