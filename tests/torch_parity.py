"""Helpers shared by the port's slice parity tests (test_torch_volpath.py,
test_torch_sppm.py, test_torch_irrcache.py, test_torch_specular.py, ...):
one scene rendered through both packages' factories with the reference's
intersectors pinned to the linear-MT matmul sweeps (the function the
port's plain sweeps compute, as in test_torch_gpt.py), the image check,
the lane-share check of an op, XLA's flush of subnormals, the L1
final's check by objective and mean, and the bidirectional renders of
one scene in both packages (test_torch_gbdpt_glossy.py,
test_torch_gbdpt_door.py)."""
import copy

import jax
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.models import factory as ref_factory
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.scene import bridge


@pytest.fixture(scope="module")
def flush_subnormals():
    """XLA's CPU arithmetic flushes subnormal floats to zero; torch's does
    not.  A steep lobe underflows (roughdielectric alpha 0.05 at a grazing
    half vector: f ~ 1e-39), so a shift would be valid in the port and
    dead in the reference.  A module that uses this fixture runs the port
    in the reference's mode (ROADMAP Queue 3)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one CPU thread: in a process that also runs XLA, a
    multi-threaded CPU torch.exp has returned a thread's chunk at ~1.5e-4
    relative error (tests/test_torch_medium.py), which lane-level
    tolerances of 1e-4 cannot absorb."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def op_close(got, ref, name, frac=0.999, rtol_all=1e-4, atol=1e-6):
    """rtol 1e-5 / atol on >= frac of lanes (a lane: all of its
    components) and rtol_all / 10 atol on all, NaN equal to NaN."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    lanes = np.isclose(got, ref, rtol=1e-5, atol=atol, equal_nan=True)
    lanes = lanes.reshape(lanes.shape[0], -1).all(-1)
    assert lanes.mean() >= frac, (name, lanes.mean())
    np.testing.assert_allclose(got, ref, rtol=rtol_all, atol=10 * atol,
                               equal_nan=True, err_msg=name)


def pinned_matmul(settings, n_tris, n_clusters=0):
    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    return ref_common.add_sphere_intersections(closest, occl)


def pinned_full_matmul(scene, ray_chunk=512):
    """choose_intersector for a clustered scene (whose geom.linC is a
    stub): the linear-MT matmul sweeps over a table built here from the
    scene's non-degenerate triangle slots (the window padding left
    out), prims mapped back to the slot ids (k*W + lane) the port's pair
    traversal returns; rays swept ray_chunk at a time (lax.map), so one
    [rays x triangles] product stays small."""
    import jax.numpy as jnp
    g = scene.geom
    v0, e1, e2 = (np.asarray(x) for x in (g.tris.v0, g.tris.e1, g.tris.e2))
    slots = np.nonzero(np.linalg.norm(np.cross(e1, e2), axis=-1) > 0)[0]
    linC = jnp.asarray(ref_isec.build_linear_mt(v0[slots], e1[slots],
                                                e2[slots]))
    slots = jnp.asarray(slots, jnp.int32)

    def chunked(fn, o, d, mint, maxt):
        N = o.shape[0]
        pad = (-N) % ray_chunk

        def split(x, fill):
            x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1),
                        constant_values=fill)
            return x.reshape((-1, ray_chunk) + x.shape[1:])
        out = jax.lax.map(lambda a: fn(*a, linC),
                          (split(o, 0.0), split(d, 0.0), split(mint, 0.0),
                           split(maxt, -1.0)))
        return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:])[:N],
                            out)

    def choose(settings, n_tris, n_clusters=0):
        def closest(o, d, mint, maxt, geom):
            hit = chunked(ref_isec.intersect_matmul, o, d, mint, maxt)
            return hit._replace(prim=jnp.where(
                hit.valid, slots[jnp.maximum(hit.prim, 0)], -1))

        def occl(o, d, mint, maxt, geom):
            return chunked(ref_isec.occluded_matmul, o, d, mint, maxt)
        return ref_common.add_sphere_intersections(closest, occl)
    return choose


def load(path, integrator, size=16, spp=2, depth=5, props=None):
    scene, st = ref_scene.load_scene(path, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth)})
    st.integrator = integrator
    st.integrator_props.update(props or {})
    return scene, st


def counting_choose(choose, tally):
    """choose_intersector whose intersectors append each call's live
    lanes (maxt > 0, what the tracers' own counters count) to the list
    `tally`, from inside the reference's jitted code (a host callback;
    read it after jax.effects_barrier())."""
    import jax.numpy as jnp

    def counted(fn):
        def f(o, d, mint, maxt, geom):
            jax.debug.callback(lambda n: tally.append(int(n)),
                               jnp.sum(maxt > 0))
            return fn(o, d, mint, maxt, geom)
        return f

    def wrapped(settings, n_tris, n_clusters=0):
        closest, occl = choose(settings, n_tris, n_clusters)
        return counted(closest), counted(occl)
    return wrapped


def count_port_rays(tracer, tally):
    """The port's counterpart of counting_choose: every tracer that
    traces for `tracer` (itself, an irradiance cache's direct-light path
    tracer, a chain tracer's inner tracer) appends each intersector
    call's live lanes to `tally`."""
    def counted(fn):
        def f(o, d, mint, maxt, geom):
            tally.append(int((maxt > 0).sum()))
            return fn(o, d, mint, maxt, geom)
        return f
    for t in (tracer, getattr(tracer, "_direct", None),
              getattr(tracer, "inner", None)):
        if t is not None and hasattr(t, "closest"):
            t.closest, t.occluded = counted(t.closest), counted(t.occluded)


def make_both(scene, st, choose=pinned_matmul):
    """(reference tracer, its device scene, port tracer, its scene), each
    built through its package's factory on its own copy of the
    settings; the reference's intersectors pinned (to `choose`) while
    it is built."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", choose)
    try:
        rt = ref_factory.make_integrator(scene, copy.deepcopy(st))
    finally:
        mp.undo()
    ts = bridge.to_torch(scene, "cpu")
    return (rt, jax.device_put(scene),
            factory.make_integrator(ts, copy.deepcopy(st)), ts)


def render_both(scene, st, seeds, spp, count_rays=False):
    """Renders of each seed of `seeds` in both packages (one tracer each,
    so re-renders reuse it): ([reference images], [port images],
    reference tracer, port tracer)."""
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = count_rays
    ref = [np.asarray(rt.render(rs, seed=s, spp=spp)) for s in seeds]
    got = [pt.render(ts, seed=s, spp=spp).numpy() for s in seeds]
    return ref, got, rt, pt


def assert_image_close(got, ref, size=16):
    """rtol 1e-3 / atol 1e-4 on >= 99% of pixels, finite, equal shape."""
    assert got.shape == ref.shape == (size, size, 3)
    assert np.isfinite(got).all()
    frac = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert frac >= 0.99, frac
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean()) + 1e-6


def render_chains(rt, rs, pt, ts, seed, spp):
    """Render a Markov-chain tracer (pssmlt, erpt, mlt) in both packages
    and record every mutation's acceptance decisions.

    The reference runs its own _run / _run_round code with the outer jit
    undone: _eval is jitted alone and the fori_loops over mutations run as
    Python loops, so each step's chain states can be read (a proposal
    always differs from the current state, so a chain accepted where its
    state changed).  This compiles one _eval instead of the whole chain
    program.  Returns (reference image, port image, reference decisions
    [steps, C], port decisions [steps, C])."""
    import functools

    ref_takes, port_takes = [], []
    orig_loop = jax.lax.fori_loop

    def loop(lo, hi, body, init):
        if any(isinstance(x, jax.core.Tracer)
               for x in jax.tree_util.tree_leaves(init)):
            return orig_loop(lo, hi, body, init)
        c = init
        for i in range(lo, hi):
            n = body(i, c)
            if isinstance(c, tuple):
                ref_takes.append(
                    (np.asarray(n[0]) != np.asarray(c[0])).any(1))
            c = n
        return c

    cls = type(rt)
    rt._eval = jax.jit(functools.partial(cls._eval, rt))
    for name in ("_run", "_run_round"):
        f = getattr(cls, name, None)
        if f is not None:
            setattr(rt, name, functools.partial(f.__wrapped__, rt))
    port_step = pt._mstep

    def mstep(scene, seed, it, state, b, fb):
        new, fb = port_step(scene, seed, it, state, b, fb)
        port_takes.append((new[0] != state[0]).any(1).numpy())
        return new, fb

    pt._mstep = mstep
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "fori_loop", loop)
    try:
        ref = np.asarray(rt.render(rs, seed=seed, spp=spp))
    finally:
        mp.undo()
    got = pt.render(ts, seed=seed, spp=spp).numpy()
    return ref, got, np.stack(ref_takes), np.stack(port_takes)


def frac_close(got, ref):
    """Share of pixels within rtol 1e-3 / atol 1e-4 (all channels)."""
    return np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()


def rel_mean_diff(got, ref):
    return abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-12)


def assert_l1_final_close(got, ref_bufs, alpha=0.2):
    """An L1 final against the reference's by mean (5e-3 relative) and by
    the L1 objective it minimizes on the reference's buffers (1%): the
    reference's own IRLS moves by more than a pixel tolerance under
    one-ulp input changes (test_torch_poisson.py)."""
    assert np.isfinite(got).all()
    ref = ref_bufs["L1"]
    assert rel_mean_diff(got, ref) < 5e-3
    p, gx, gy, vd = (ref_bufs[k] for k in ("primal", "dx", "dy",
                                           "very_direct"))

    def energy(x):
        gxm, gym = gx.copy(), gy.copy()
        gxm[:, -1] = 0.0
        gym[-1] = 0.0
        dx = np.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1), (0, 0)))
        dy = np.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0)))
        return (np.abs(dx - gxm).sum() + np.abs(dy - gym).sum() +
                alpha * np.abs(x - p).sum())

    e_ref, e_got = energy(ref - vd), energy(got - vd)
    assert abs(e_got - e_ref) <= 0.01 * e_ref, (e_got, e_ref)


GBDPT_BUFS = ("primal", "very_direct", "dx", "dy")


def bidir_renders(path, size, spp, depth, seed):
    """BDPT and G-BDPT (+ L1, models/poisson.reconstruct) of one scene
    through both factories, rays counted, and the port's BDPT image:
    {"bdpt": {"ref", "port", "ref_rays", "port_rays"}, "gbdpt": {"ref":
    buffers + "L1" + "rays", "port": the same}}."""
    from gradientdomain_mitsuba_tpu.models import poisson as ref_poisson
    from gradientdomain_mitsuba_tpu_torch.models import poisson
    out = {}
    scene, st = load(path, "bdpt", size=size, spp=spp, depth=depth)
    ref, got, rt, pt = render_both(scene, st, [seed], spp, count_rays=True)
    out["bdpt"] = dict(ref=ref[0], port=got[0], ref_rays=rt.last_ray_count,
                       port_rays=pt.last_ray_count)
    scene, st = load(path, "gbdpt", size=size, spp=spp, depth=depth)
    rt, rs, pt, ts = make_both(scene, st)
    rt.count_rays = pt.count_rays = True
    rb = rt.render(rs, seed=seed, spp=spp)
    pb = pt.render(ts, seed=seed, spp=spp)
    out["gbdpt"] = {
        "ref": {k: np.asarray(rb[k]) for k in GBDPT_BUFS},
        "port": {k: pb[k].numpy() for k in GBDPT_BUFS}}
    out["gbdpt"]["ref"]["L1"] = np.asarray(
        ref_poisson.reconstruct(rb, mode="L1"))
    out["gbdpt"]["port"]["L1"] = poisson.reconstruct(pb, mode="L1").numpy()
    out["gbdpt"]["ref"]["rays"] = rt.last_ray_count
    out["gbdpt"]["port"]["rays"] = pt.last_ray_count
    return out


def check_bdpt(renders, size, lit):
    """The port's BDPT image against the reference's: finite, lit on more
    than `lit` of the pixels (a rule over pixels needs lit ones), within
    rtol 1e-3 on >= 99% of pixels, means within 1e-3 relative, equal
    rays."""
    b = renders["bdpt"]
    ref, got = b["ref"], b["port"]
    assert got.shape == ref.shape == (size, size, 3)
    assert np.isfinite(got).all()
    assert (ref.max(-1) > 1e-4).mean() > lit
    assert frac_close(got, ref) >= 0.99
    assert rel_mean_diff(got, ref) < 1e-3
    assert int(b["port_rays"]) == int(b["ref_rays"]) > 0


def check_gbdpt_buffer(renders, name, size):
    got = renders["gbdpt"]["port"][name]
    ref = renders["gbdpt"]["ref"][name]
    assert got.shape == ref.shape == (size, size, 3)
    assert np.isfinite(got).all()
    assert frac_close(got, ref) >= 0.99
    assert (rel_mean_diff(got, ref) < 1e-3 or
            abs(got.mean() - ref.mean()) < 1e-6)


def check_gbdpt_primal_is_bdpt(renders):
    """primal (with the light image) + very_direct == the BDPT image at
    the same seed (tests/test_bdpt.py's identity, on the port), at
    test_torch_gbdpt.py's tolerance."""
    g = renders["gbdpt"]["port"]
    np.testing.assert_allclose(g["primal"] + g["very_direct"],
                               renders["bdpt"]["port"], rtol=2e-4,
                               atol=2e-5)


def load_tool(name):
    """A module of tools/ (not a package), loaded by path."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHAINS = ("pssmlt", "erpt", "mlt")
# the lifted cloth board's quads in two subsets that together hold every
# texture bit (tools/cloth_board.py): woven cloth (bit 16, through the
# hits' barycentric payload), the mask's textured opacity (bit 2),
# vertexcolors and wireframe (bit 1, the payload again); the bump and
# normal maps and the blendbsdf's textured weight (bits 4 and 8).  Both
# keep the board's EWA-filtered floor.
BOARD_CLOTH = ("denim8", "mask", "vertexcolors", "wireframe")
BOARD_WRAPPED = ("bumpmap", "normalmap", "blend")
BOARD_BITS = {BOARD_CLOTH: 1 | 2 | 16, BOARD_WRAPPED: 1 | 4 | 8}


def board_renders(directory, family, labels, props=None, seed=3, spp=2,
                  depth=3, width=16, height=12):
    """`family` on the lifted cloth board holding the quads `labels`
    (written into `directory`), through both factories with the rays
    counted in both (counting_choose, count_port_rays); a chain family
    through render_chains.  Returns dict(ref, got: images; ref_rays,
    port_rays; bits: the scene's has_textures; ref_takes, port_takes:
    the chains' acceptance decisions or None)."""
    path = load_tool("cloth_board").write_board(str(directory), labels,
                                                lift=True)
    scene, st = ref_scene.load_scene(path, {
        "width": str(width), "height": str(height), "spp": str(spp),
        "maxDepth": str(depth)})
    st.integrator = family
    st.integrator_props.update(props or {})
    ref_tally, port_tally = [], []
    rt, rs, pt, ts = make_both(scene, st,
                               counting_choose(pinned_matmul, ref_tally))
    count_port_rays(pt, port_tally)
    takes = (None, None)
    if family in CHAINS:
        ref, got, *takes = render_chains(rt, rs, pt, ts, seed, spp)
    else:
        ref = np.asarray(rt.render(rs, seed=seed, spp=spp))
        got = pt.render(ts, seed=seed, spp=spp).numpy()
    jax.effects_barrier()
    return dict(ref=ref, got=got, ref_rays=sum(ref_tally),
                port_rays=sum(port_tally), bits=int(st.has_textures),
                ref_takes=takes[0], port_takes=takes[1])


def check_board_image(r, width=16, height=12):
    """A board render against the reference's: finite, lit, within rtol
    1e-3 / atol 1e-4 on >= 99% of pixels, means within 1e-4 relative."""
    got, ref = r["got"], r["ref"]
    assert got.shape == ref.shape == (height, width, 3)
    assert np.isfinite(got).all()
    assert (ref.max(-1) > 1e-4).mean() > 0.25
    assert frac_close(got, ref) >= 0.99
    assert rel_mean_diff(got, ref) <= 1e-4
