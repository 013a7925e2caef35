"""Integrator factory: XML `type` string -> tracer instance.

Counterpart of gradientdomain_mitsuba_tpu/models/factory.py (the analog
of PluginManager::createObject for the integrator family,
src/libcore/plugin.cpp).  It constructs every integrator type of
KNOWN.  A type outside KNOWN falls through to the path tracer, as in the
reference, unless the scene carries subsurface attachments: those go
to the dipole path tracer (models/sss.DipoleTracer), as in the
reference, which routes only the path family there (the bidirectional
integrators ignore subsurface).
`gpt` / `gbdpt` return buffers that the reconstruction layer
(models/poisson.reconstruct) turns into the final image.
"""
from __future__ import annotations

from ..utils import stats

KNOWN = ("path", "direct", "ao", "bdpt", "field", "volpath",
         "volpath_simple", "pssmlt", "mlt", "erpt", "irrcache",
         "sppm", "ppm",
         "photonmapper", "adaptive", "multichannel", "vpl", "gpt",
         "gbdpt")

PORTED = ("path", "gpt", "bdpt", "gbdpt", "direct", "ao", "field",
          "multichannel", "adaptive", "volpath", "volpath_simple",
          "irrcache", "vpl", "sppm", "ppm", "photonmapper", "pssmlt",
          "mlt", "erpt")

# the ROADMAP Queue 1 item of every type of KNOWN the port does not render
UNPORTED = {}


def make_integrator(scene, settings):
    """The tracer of settings.integrator for `scene`."""
    with stats.span("make_integrator"):
        return _make(scene, settings)


def _make(scene, settings):
    t = settings.integrator
    if t in UNPORTED:
        raise NotImplementedError(
            f"integrator {t!r}: ROADMAP Queue 1 item {UNPORTED[t]}")
    if t == "pssmlt":
        from .pssmlt import PSSMLTracer
        return PSSMLTracer(scene, settings)
    if t == "mlt":
        from .mlt import MLTracer
        return MLTracer(scene, settings)
    if t == "erpt":
        from .erpt import ERPTracer
        return ERPTracer(scene, settings)
    if t == "gpt":
        from .gpt import GPTracer
        return GPTracer(scene, settings)
    if t == "gbdpt":
        from .gbdpt import GBDPTracer
        return GBDPTracer(scene, settings)
    if t == "bdpt":
        from .bdpt import BDPTracer
        return BDPTracer(scene, settings)
    if t in ("volpath", "volpath_simple"):
        from .volpath import VolPathTracer
        return VolPathTracer(scene, settings)
    if t == "irrcache":
        from .irrcache import IrrCacheTracer
        return IrrCacheTracer(scene, settings)
    if t in ("sppm", "ppm", "photonmapper"):
        from .sppm import SPPMTracer
        return SPPMTracer(scene, settings)
    if t == "vpl":
        from .vpl import VPLTracer
        return VPLTracer(scene, settings)
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
        from .sss import DipoleTracer
        return DipoleTracer(scene, settings)
    from .path import PathTracer
    return PathTracer(scene, settings)
