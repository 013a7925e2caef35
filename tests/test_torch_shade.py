"""The fused shading wavefront (ops/shade.py) on the CPU, where it runs
its plain version, against the eager bounce (models/path.py _bounce).

1. On the diffuse cbox and a four-tree grove (tools/gen_forest.py, the
   pair traversal's plain version), every bounce's outputs (the next
   rays, the shadow rays, throughput, eta, alive, the last pdf and delta
   flag, and the radiance once the pending NEE has its answer) and the
   whole frame equal the eager tracer's bit for bit, in the same
   traversal calls.
2. The fused path engages only where PathTracer._fused_scene admits the
   scene: each disqualifying feature keeps the eager bounce.
3. The shade_lanes_fused / shade_lanes_eager counters add up to the
   lanes shaded.
"""
import copy
import importlib.util
import os
import re

import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.models.pssmlt import _PSSPathTracer
from gradientdomain_mitsuba_tpu_torch.models.sss import DipoleTracer
from gradientdomain_mitsuba_tpu_torch.ops import shade as shade_ops
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import materials as mats
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.utils import stats
from torch_parity import load_tool
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
_spec = importlib.util.spec_from_file_location(
    "gen_forest", os.path.join(ROOT, "tools", "gen_forest.py"))
gen_forest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen_forest)


def _load(path, **v):
    var = {"width": "16", "height": "12", "spp": "2", "maxDepth": "5"}
    var.update({k: str(x) for k, x in v.items()})
    scene_np, st = port_scene.load_scene(path, var)
    return bridge.to_torch(scene_np, "cpu"), st


@pytest.fixture(scope="module")
def cbox():
    return _load(CBOX)


@pytest.fixture(scope="module")
def grove(tmp_path_factory):
    """A 2x2-tree forest (25,476 triangles, the pair traversal) with the
    camera moved in to frame it."""
    path = tmp_path_factory.mktemp("grove") / "forest.xml"
    path.write_text(re.sub(
        r'<lookat origin="[^"]*" target="[^"]*"',
        '<lookat origin="250, 300, -500" target="250, 120, 250"',
        gen_forest.generate(grid=2)))
    return _load(str(path), width=12, height=10)


def _recorded(tracer):
    """Wrap the tracer's traversal calls and its bounces: every call's
    arguments and answer, every bounce's outputs, in order."""
    log = dict(calls=[], bounces=[])
    closest, occluded = tracer.closest, tracer.occluded

    def c(o, d, mint, maxt, geom):
        hit = closest(o, d, mint, maxt, geom)
        log["calls"].append(("closest", o.clone(), d.clone(), mint.clone(),
                             maxt.clone(), hit.t.clone(), hit.prim.clone()))
        return hit

    def a(o, d, mint, maxt, geom):
        occ = occluded(o, d, mint, maxt, geom)
        log["calls"].append(("occluded", o.clone(), d.clone(), mint.clone(),
                             maxt.clone(), occ.clone()))
        return occ

    tracer.closest, tracer.occluded = c, a
    if tracer.shade is None:
        bounce = tracer._bounce

        def b(*args, **kw):
            s = bounce(*args, **kw)
            log["bounces"].append({k: v for k, v in s.items()
                                   if k != "its"})
            return s
        tracer._bounce = b
    else:
        shade = tracer.shade

        def f(*args, **kw):
            st = shade(*args, **kw)
            log["bounces"].append(st._asdict())
            return st
        tracer.shade = f
    return log


def _trace(scene, st, fused, direct=True, sample_idx=None, seed=5):
    tracer = PathTracer(scene, st)
    assert tracer.shade is not None
    if not fused:
        tracer.shade = None
    log = _recorded(tracer)
    N = st.width * st.height
    pix = torch.arange(N, dtype=torch.int64)
    sidx = torch.arange(N, dtype=torch.int64) % 3 if sample_idx is None \
        else sample_idx
    if direct:
        _, L = tracer.trace_pass(scene, seed, sidx, pixel_id=pix)
    else:
        L = _trace_gather(tracer, scene, seed, sidx, pix)
    return L, log


def _trace_gather(tracer, scene, seed, sidx, pix):
    """trace_rays in final-gather mode (irrcache's call) on the camera's
    rays."""
    from gradientdomain_mitsuba_tpu_torch.ops import sensor as sensor_ops
    st = tracer.settings
    px = torch.stack([(pix % st.width).float(), (pix // st.width).float()],
                     -1) + 0.5
    o, d = sensor_ops.sample_ray(tracer.sensor, st.width, st.height, px,
                                 torch.full_like(px, 0.5))
    return tracer.trace_rays(scene, seed, sidx, pix, o, d,
                             direct_at_first=False)


def _assert_same(eager, fused, L_eager, L_fused):
    assert len(eager["calls"]) == len(fused["calls"])
    for ce, cf in zip(eager["calls"], fused["calls"]):
        assert ce[0] == cf[0]
        for x, y in zip(ce[1:], cf[1:]):
            assert torch.equal(x, y), ce[0]
    occl = [c[-1] for c in fused["calls"] if c[0] == "occluded"]
    assert len(eager["bounces"]) == len(fused["bounces"]) - 1 == len(occl)
    for b, (se, sf) in enumerate(zip(eager["bounces"], fused["bounces"])):
        for k in ("o", "d", "tp", "eta", "alive", "last_pdf", "last_delta"):
            assert torch.equal(se[k], sf[k]), (b, k)
        # the eager bounce has added the NEE the fused one holds pending
        L = sf["L"] + torch.where((~occl[b])[..., None], sf["pending"], 0.0)
        assert torch.equal(se["L"], L), b
        assert torch.equal(se["alive"], sf["maxt"] > 0), b
    assert torch.equal(L_eager, L_fused)
    assert (L_fused > 0).any()


@pytest.mark.parametrize("case", ["cbox", "cbox_unlimited", "cbox_gather",
                                  "grove"])
def test_fused_bounces_equal_eager(cbox, grove, case):
    """Every bounce's outputs and the radiance, bit for bit: cbox at
    maxDepth 5 and at -1 (40 bounces, Russian roulette from depth 5,
    here from 2), final-gather mode with an integer sample index, and the
    grove through the pair traversal."""
    scene, st = grove if case == "grove" else cbox
    st = copy.deepcopy(st)
    if case == "cbox_unlimited":
        st.max_depth, st.rr_depth = -1, 2
    direct = case != "cbox_gather"
    sidx = 4 if case == "cbox_gather" else None
    L_e, eager = _trace(scene, st, False, direct, sidx)
    L_f, fused = _trace(scene, st, True, direct, sidx)
    _assert_same(eager, fused, L_e, L_f)


def test_fused_frame_equals_eager(grove):
    """A whole render (two passes through render_accumulate, the ray
    count) of the grove, fused and eager."""
    scene, st = grove
    out = []
    for fused in (True, False):
        tracer = PathTracer(scene, st)
        if not fused:
            tracer.shade = None
        tracer.count_rays = True
        out.append((tracer.render(scene, seed=9, spp=2, chunk=1),
                    tracer.last_ray_count))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] > 0


def _without(scene, st, feature):
    """The cbox scene and settings with one feature the fused bounce does
    not shade."""
    st = copy.deepcopy(st)
    g, em, ma = scene.geom, scene.emitters, scene.materials
    if feature == "textures":
        st.has_textures = 1
    elif feature == "plastic":
        kind = ma.kind.clone()
        kind[0] = mats.PLASTIC
        packed = ma.packed.clone()
        packed[0, 0] = mats.PLASTIC
        scene = scene._replace(materials=ma._replace(kind=kind,
                                                     packed=packed))
    elif feature == "mask":       # the OPACITY pseudo-kind
        packed = ma.packed.clone()
        packed[0, 22] = 0.5
        scene = scene._replace(materials=ma._replace(packed=packed))
    elif feature == "bump_columns":
        packed = torch.cat([ma.packed, torch.zeros(ma.packed.shape[0], 4)],
                           1)
        scene = scene._replace(materials=ma._replace(packed=packed))
    elif feature == "bary_payload":
        ts = torch.cat([g.tri_shade, torch.zeros(g.tri_shade.shape[0], 12)],
                       1)
        scene = scene._replace(geom=g._replace(tri_shade=ts))
    elif feature == "spheres":
        scene = scene._replace(geom=g._replace(
            sph_center=torch.zeros(1, 3), sph_radius=torch.ones(1),
            sph_bsdf=torch.zeros(1, dtype=torch.int32),
            sph_shape=torch.zeros(1, dtype=torch.int32)))
    elif feature == "delta_light":
        st.n_delta = 1
    elif feature == "environment":
        st.has_env, st.env_kind = True, 1
    elif feature == "no_area_light":
        scene = scene._replace(emitters=em._replace(
            tri_count=torch.zeros_like(em.tri_count)))
    elif feature == "sampler":
        st.sampler, st.spp = "ldsampler", 4
    return scene, st


@pytest.mark.parametrize("feature", [
    "textures", "plastic", "mask", "bump_columns", "bary_payload", "spheres",
    "delta_light", "environment", "no_area_light", "sampler", "pssmlt",
    "sss_cache"])
def test_eligibility_keeps_eager(cbox, tmp_path, feature):
    """The untouched cbox is shaded fused; each feature the kernel does
    not shade keeps the eager bounce (sss_cache, a call's argument, at
    the call: DipoleTracer's camera pass on the subsurface floor
    scene)."""
    scene, st = cbox
    assert PathTracer(scene, st).shade is not None
    if feature == "pssmlt":
        assert _PSSPathTracer(scene, st).shade is None
        return
    if feature == "sss_cache":
        path = load_tool("sss_scene").write_scene(str(tmp_path), "floor")
        ts, sst = _load(path, width=8, height=8, spp=1, maxDepth=3)
        tracer = DipoleTracer(ts, sst)
        assert tracer.shade is not None     # its scene alone would fuse
        stats.tracing(True)
        try:
            stats.collect()
            tracer.render(ts, seed=3, spp=1)
            counters = stats.collect()["counters"]
        finally:
            stats.tracing(False)
        # the camera pass, which adds the dipole term, shades eagerly;
        # the cache's gather (trace_rays without the cache) fuses
        assert counters["shade_lanes_eager"] == 8 * 8 * tracer.n_bounces
        assert counters["shade_lanes_fused"] > 0
        return
    assert PathTracer(*_without(scene, st, feature)).shade is None


@pytest.mark.parametrize("fused", [True, False])
def test_shade_counters_add_up(cbox, fused):
    """Each bounce counts the lanes it shaded on its path: lanes x
    bounces x passes in all, none on the other path; the CPU runs no
    kernel launch."""
    scene, st = cbox
    tracer = PathTracer(scene, st)
    if not fused:
        tracer.shade = None
    stats.tracing(True)
    try:
        stats.collect()
        tracer.render(scene, seed=2, spp=2, chunk=1)
        t = stats.collect()
    finally:
        stats.tracing(False)
    lanes = st.width * st.height * 2 * tracer.n_bounces
    on, off = (("shade_lanes_fused", "shade_lanes_eager") if fused else
               ("shade_lanes_eager", "shade_lanes_fused"))
    assert t["counters"][on] == lanes
    assert off not in t["counters"]
    per_bounce = [s["counts"].get(on) for s in t["spans"]
                  if s["name"] == "bounce"]
    assert per_bounce == [st.width * st.height] * (2 * tracer.n_bounces)
    if fused:
        assert tracer.shade.launches == 0


def test_plain_state_shapes(cbox):
    """The plain bounce's state out: each field's shape and dtype, the
    first launch's direct flag, the last launch's radiance only."""
    scene, st = cbox
    tracer = PathTracer(scene, st)
    N = 8
    o = torch.tensor([[278.0, 273.0, -800.0]]).expand(N, 3)
    g = torch.Generator().manual_seed(0)
    d = torch.nn.functional.normalize(torch.randn(
        N, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    zeros = torch.zeros(N)
    hit = tracer.closest(o, d, zeros, torch.full((N,), 3e38), scene.geom)
    rng = (1, torch.arange(N), 0)
    s0 = tracer.shade(scene, hit, 0, rng, ray=(o, d), direct=False)
    assert not s0.last_delta.any() and s0.alive.dtype == torch.bool
    for k in ("o", "d", "shadow_o", "shadow_d", "L", "tp", "pending"):
        assert getattr(s0, k).shape == (N, 3), k
    for k in ("maxt", "shadow_maxt", "eta", "last_pdf", "alive"):
        assert getattr(s0, k).shape == (N,), k
    occ = tracer.occluded(s0.shadow_o, s0.shadow_d, zeros, s0.shadow_maxt,
                          scene.geom)
    hit = tracer.closest(s0.o, s0.d, zeros, s0.maxt, scene.geom)
    fin = tracer.shade(scene, hit, 1, rng, st=s0, occl=occ, final=True)
    assert fin.L.shape == (N, 3) and fin.tp is s0.tp
    assert shade_ops.SHADE_COLUMNS == scene.geom.tri_shade.shape[1]


def test_pinhole_pass_skips_the_aperture_draw(cbox):
    """trace_pass draws the aperture sample only for a sensor that reads
    it (a lens, the fluencemeter): cbox's pinhole draws the pixel jitter
    and the bounces' dims, no aperture."""
    from gradientdomain_mitsuba_tpu_torch.core.rng import DimAllocator as DA
    from gradientdomain_mitsuba_tpu_torch.ops import sensor as sensor_ops
    scene, st = cbox
    tracer = PathTracer(scene, st)
    desc = tracer.sensor
    assert not sensor_ops.reads_aperture(desc)
    assert sensor_ops.reads_aperture(desc._replace(lens=True))
    assert sensor_ops.reads_aperture(desc._replace(
        kind=sensor_ops.FLUENCEMETER))
    dims = []
    u2 = tracer._u2

    def recorded(seed, pixel_id, sample_idx, dim):
        dims.append(dim)
        return u2(seed, pixel_id, sample_idx, dim)
    tracer._u2 = recorded
    tracer.trace_pass(scene, 3, 0)
    assert dims == [DA.PIXEL_JITTER]
