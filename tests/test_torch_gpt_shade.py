"""G-PT's fused shading wavefront (ops/gpt_shade.py) on the CPU, where it
runs its plain version, against the eager bounce (models/gpt.py
GPTracer._bounce and _shift_offsets).

1. On the diffuse cbox and a four-tree grove (tools/gen_forest.py, the
   pair traversal's plain version), the lane state after each bounce
   (throughput, alive, primal, the four gradients, the offsets'
   throughput, pdf ratio, connection state, liveness and incoming
   direction; the suffix's primal from bounce 2 on), very_direct and the
   returned buffers equal the eager chain's bit for bit, in the same
   traversal calls on the same rays, at maxDepth 2, 3 and 5, unlimited,
   and on a tiles-style subset of pixel rows; the offsets pass through
   every connection state (NOT CONNECTED, RECENT, DONE, killed).
2. A 64 x 48, 4 spp grove frame through render_final, fused and eager.
3. The fused route engages only where GPTracer._fused_scene admits the
   tracer: a specular, a textured and an environment-lit scene, the
   other features ops/shade.fused_scene refuses, and G-BDPT's aux_only
   tracer keep the eager bounce.
4. The gpt_lanes_fused / gpt_lanes_eager counters add up to the lanes
   shaded a bounce.
"""
import copy
import importlib.util
import os
import re

import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.ops import gpt_shade as gs
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import materials as mats
from gradientdomain_mitsuba_tpu_torch.scene import scene as port_scene
from gradientdomain_mitsuba_tpu_torch.utils import stats
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "data", "scenes")
CBOX = os.path.join(SCENES, "cbox/cbox.xml")
_spec = importlib.util.spec_from_file_location(
    "gen_forest", os.path.join(ROOT, "tools", "gen_forest.py"))
gen_forest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen_forest)

# the eager state after a bounce, by the fused state's field
_STATE = dict(tp="tp", alive="alive", primal="primal", grad="grad",
              o_tp="o_tp", o_r="o_r", o_conn="o_conn", o_alive="o_alive",
              o_wi="o_wi")


def _load(path, **v):
    var = {"width": "16", "height": "12", "spp": "2", "maxDepth": "5",
           "integrator": "gpt"}
    var.update({k: str(x) for k, x in v.items()})
    scene_np, st = port_scene.load_scene(path, var)
    return bridge.to_torch(scene_np, "cpu"), st


@pytest.fixture(scope="module")
def cbox():
    return _load(CBOX)


@pytest.fixture(scope="module")
def grove_xml(tmp_path_factory):
    """A 2x2-tree forest (25,476 triangles, the pair traversal) with the
    camera moved in to frame it."""
    path = tmp_path_factory.mktemp("grove") / "forest.xml"
    path.write_text(re.sub(
        r'<lookat origin="[^"]*" target="[^"]*"',
        '<lookat origin="250, 300, -500" target="250, 120, 250"',
        gen_forest.generate(grid=2)))
    return str(path)


@pytest.fixture(scope="module")
def grove(grove_xml):
    return _load(grove_xml, width=24, height=18)


def _recorded(tracer):
    """Wrap the tracer's traversal calls and its bounces (eager) or
    stages (fused): every call's arguments and answer, the state after
    every bounce, in order."""
    log = dict(calls=[], states=[])
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
            log["states"].append(dict(s, rest=s["primal"],
                                      offsets=kw.get("with_offsets", True)))
            return s
        tracer._bounce = b
    else:
        shade = tracer.shade
        for name in ("shift", "bounce"):
            def stage(*args, _f=getattr(shade, name), **kw):
                st = _f(*args, **kw)
                log["states"].append(st._asdict())
                return st
            setattr(shade, name, stage)
    return log


def _trace(scene, st, fused, pix=None, sidx=None, seed=5):
    tracer = GPTracer(scene, st)
    assert tracer.shade is not None
    if not fused:
        tracer.shade = None
    log = _recorded(tracer)
    N = st.width * st.height
    if pix is None:
        pix = torch.arange(N, dtype=torch.int64)
        sidx = torch.arange(N, dtype=torch.int64) % 3
    out = tracer.trace_pass(scene, seed, sidx, pixel_id=pix)
    return out, log, tracer


def _assert_same(eager, fused, out_e, out_f, n_bounces):
    assert len(eager["calls"]) == len(fused["calls"])
    for ce, cf in zip(eager["calls"], fused["calls"]):
        assert ce[0] == cf[0]
        for x, y in zip(ce[1:], cf[1:]):
            assert torch.equal(x, y), ce[0]
    assert len(eager["states"]) == len(fused["states"]) == n_bounces
    for b, (se, sf) in enumerate(zip(eager["states"], fused["states"])):
        keys = _STATE if se["offsets"] else dict(tp="tp", alive="alive",
                                                 rest="rest")
        for kf, ke in keys.items():
            assert torch.equal(se[ke], sf[kf]), (b, kf)
    for x, y in zip(out_e, out_f):
        assert torch.equal(x, y)
    assert (out_f[1] > 0).any() and (out_f[3] != 0).any()


@pytest.mark.parametrize("case", ["cbox", "cbox_unlimited", "grove",
                                  "grove_depth2", "grove_depth3",
                                  "grove_rows"])
def test_fused_bounces_equal_eager(cbox, grove, case):
    """Each bounce's lane state, the traversal calls and the returned
    buffers, bit for bit: cbox at maxDepth 5 and at -1 (40 bounces,
    Russian roulette from depth 2), the grove through the pair traversal
    at maxDepth 5, 2 and 3, and every other film row of the grove with
    one Python int sample index (the tiles route's call)."""
    scene, st = grove if case.startswith("grove") else cbox
    st = copy.deepcopy(st)
    if case == "cbox_unlimited":
        st.max_depth, st.rr_depth = -1, 2
    if case.startswith("grove_depth"):
        st.max_depth = int(case[-1])
    pix = sidx = None
    if case == "grove_rows":
        N = st.width * st.height
        pix = torch.arange(N, dtype=torch.int64)
        pix, sidx = pix[(pix // st.width) % 2 == 0], 3
    out_e, eager, tracer = _trace(scene, st, False, pix, sidx)
    out_f, fused, _ = _trace(scene, st, True, pix, sidx)
    _assert_same(eager, fused, out_e, out_f, tracer.n_bounces)


def test_connection_states_are_all_reached(grove):
    """The fused lanes pass through every connection state: after bounce
    0 offsets are RECENT (reconnected) or dead (killed shifts keep NOT
    CONNECTED), after bounce 1 the live ones are DONE."""
    scene, st = grove
    _, fused, _ = _trace(scene, st, True)
    s0, s1 = fused["states"][:2]
    assert (s0["o_conn"][s0["o_alive"]] == gs.CONN_RECENT).all()
    assert (s0["o_conn"] == gs.CONN_RECENT).any()
    killed = ~s0["o_alive"] & (s0["o_conn"] == gs.CONN_NONE)
    assert killed.any()
    assert (s1["o_conn"][s1["o_alive"]] == gs.CONN_DONE).all()
    assert s1["o_alive"].any()


def test_fused_frame_equals_eager(grove_xml):
    """render_final of the grove at 64 x 48, 4 spp (two passes of two
    samples), fused and eager: buffers, final image and ray count."""
    scene, st = _load(grove_xml, width=64, height=48, spp=4)
    out = []
    for fused in (True, False):
        tracer = GPTracer(scene, st)
        if not fused:
            tracer.shade = None
        tracer.count_rays = True
        mp = pytest.MonkeyPatch()
        mp.setenv("GDMT_LANES", str(2 * 64 * 48))
        try:
            final, bufs = tracer.render_final(scene, 9, 4)
        finally:
            mp.undo()
        out.append((final, bufs))
    (fa, ba), (fb, bb) = out
    for k in ("primal", "very_direct", "dx", "dy", "rays"):
        assert torch.equal(ba[k], bb[k]), k
    assert torch.equal(fa, fb)
    assert int(ba["rays"]) > 0


def _without(scene, st, feature):
    """The cbox scene and settings with one feature the fused bounce does
    not shade."""
    st = copy.deepcopy(st)
    g, em, ma = scene.geom, scene.emitters, scene.materials
    if feature == "textures":
        st.has_textures = 1
    elif feature == "conductor":
        kind = ma.kind.clone()
        kind[0] = mats.CONDUCTOR
        packed = ma.packed.clone()
        packed[0, 0] = mats.CONDUCTOR
        scene = scene._replace(materials=ma._replace(kind=kind,
                                                     packed=packed))
    elif feature == "spheres":
        scene = scene._replace(geom=g._replace(
            sph_center=torch.zeros(1, 3), sph_radius=torch.ones(1),
            sph_bsdf=torch.zeros(1, dtype=torch.int32),
            sph_shape=torch.zeros(1, dtype=torch.int32)))
    elif feature == "delta_light":
        st.n_delta = 1
    elif feature == "environment":
        st.env_kind = 1
    elif feature == "sampler":
        st.sampler, st.spp = "ldsampler", 4
    elif feature == "no_bounce":
        st.max_depth = 1
    return scene, st


@pytest.mark.parametrize("feature", [
    "conductor", "textures", "environment", "spheres", "delta_light",
    "sampler", "no_bounce"])
def test_eligibility_keeps_eager(cbox, feature):
    """The untouched cbox is shaded fused; each feature the kernels do
    not shade keeps the eager bounce."""
    scene, st = cbox
    assert GPTracer(scene, st).shade is not None
    tracer = GPTracer(*_without(scene, st, feature))
    assert tracer.shade is None
    if feature == "conductor":
        assert tracer.any_specular


@pytest.mark.parametrize("name,scene_kw", [
    ("cbox-mats", {}), ("caustics", {}), ("envmap", {})])
def test_specular_textured_env_scenes_stay_eager(name, scene_kw):
    """The repo's specular (cbox-mats, caustics), textured and
    environment-lit (envmap) scenes keep the eager bounce, and a pass
    through it counts its lanes as eager."""
    scene, st = _load(os.path.join(SCENES, name, f"{name}.xml"), width=8,
                      height=6, spp=1, maxDepth=3, **scene_kw)
    tracer = GPTracer(scene, st)
    assert tracer.shade is None
    assert tracer.any_specular or tracer.has_env or tracer.has_textures
    stats.tracing(True)
    try:
        stats.collect()
        tracer.trace_pass(scene, 1, 0)
        counters = stats.collect()["counters"]
    finally:
        stats.tracing(False)
    assert counters["gpt_lanes_eager"] == 8 * 6 * tracer.n_bounces
    assert "gpt_lanes_fused" not in counters


def test_gbdpt_aux_tracer_stays_eager(cbox):
    """G-BDPT's embedded aux_only tracer (the environment / delta-light
    family) never takes the fused route: built on cbox, which the fused
    route shades, and inside G-BDPT on cbox lit by an environment too."""
    scene, st = cbox
    assert GPTracer(scene, st, aux_only=True).shade is None
    st = copy.deepcopy(st)
    st.env_kind, st.has_env = 1, True
    tracer = GBDPTracer(scene, st)
    assert tracer._aux_tracer.aux_only
    assert tracer._aux_tracer.shade is None


@pytest.mark.parametrize("fused", [True, False])
def test_gpt_lane_counters_add_up(cbox, fused):
    """Each bounce counts its N lanes on its route: lanes x bounces x
    passes in all, none on the other route; the CPU runs no kernel
    launch."""
    scene, st = cbox
    tracer = GPTracer(scene, st)
    if not fused:
        tracer.shade = None
    stats.tracing(True)
    try:
        stats.collect()
        tracer.render(scene, seed=2, spp=2)
        t = stats.collect()
    finally:
        stats.tracing(False)
    spb = tracer.samples_per_batch(2)      # samples a pass
    lanes = st.width * st.height * 2 * tracer.n_bounces
    on, off = (("gpt_lanes_fused", "gpt_lanes_eager") if fused else
               ("gpt_lanes_eager", "gpt_lanes_fused"))
    assert t["counters"][on] == lanes
    assert off not in t["counters"]
    per_bounce = [s["counts"].get(on) for s in t["spans"]
                  if s["name"] == "bounce"]
    assert per_bounce == [spb * st.width * st.height] * (
        2 // spb * tracer.n_bounces)
    if fused:
        assert tracer.shade.launches == 0


def test_plain_state_shapes(cbox):
    """The plain stages' state: each field's shape and dtype, and the
    shadow buffer's width (5N at bounce 0, N after)."""
    scene, st = cbox
    tracer = GPTracer(scene, st)
    N = st.width * st.height
    out, log, _ = _trace(scene, st, True)
    s = log["states"][0]
    for k in ("primal", "very", "tp", "rest"):
        assert s[k].shape == (N, 3), k
    for k in ("grad", "o_tp", "o_wi"):
        assert s[k].shape == (4, N, 3), k
    assert s["o_conn"].dtype == torch.int32 and s["alive"].dtype == torch.bool
    assert s["shadow_o"].shape == (N, 3) and s["ray_o"].shape == (N, 3)
    calls = [c for c in log["calls"] if c[0] == "occluded"]
    assert [c[1].shape[0] for c in calls[:3]] == [5 * N, 4 * N, N]
    assert tracer.shade.n_bounces == tracer.n_bounces
