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


def load(path, integrator, size=16, spp=2, depth=5, props=None):
    scene, st = ref_scene.load_scene(path, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth)})
    st.integrator = integrator
    st.integrator_props.update(props or {})
    return scene, st


def make_both(scene, st):
    """(reference tracer, its device scene, port tracer, its scene), each
    built through its package's factory on its own copy of the
    settings; the reference's intersectors pinned while it is built."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_common, "choose_intersector", pinned_matmul)
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
