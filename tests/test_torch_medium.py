"""The port's participating-media ops (ops/medium.py) and the null BSDF
kind against the reference on the CPU, on seeded numpy inputs: gather,
transmittance, homogeneous free flight, the phase functions (isotropic,
Henyey-Greenstein, Rayleigh, SGGX microflake), the trilinear density and
orientation lookups, delta and ratio tracking (8 steps), and the null
kind's eval / pdf / sample.  Values at rtol 1e-5 / atol 1e-6; masks and
the sampled channel exactly.

The module runs torch's CPU ops on one thread: with torch 2.13's CPU
build (MKL), the first multi-threaded torch.exp of a process that also
runs XLA sometimes returns one intra-op thread's chunk at ~1.5e-4
relative error, later calls are exact; one thread never showed it."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.ops import medium as ref_med
from gradientdomain_mitsuba_tpu.scene import media as media_mod
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.ops import bsdf
from gradientdomain_mitsuba_tpu_torch.ops import medium as med
from gradientdomain_mitsuba_tpu_torch.scene import bridge

RTOL, ATOL = 1e-5, 1e-6
N = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=RTOL, atol=ATOL)


def _t(x):
    return torch.tensor(np.asarray(x))


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _w2g(lo, hi):
    """world -> [0,1]^3 volume space of the box [lo, hi]."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    m = np.eye(4)
    m[:3, :3] = np.diag(1.0 / (hi - lo))
    m[:3, 3] = -lo / (hi - lo)
    return m.astype(np.float32)


def _table():
    """Three medium rows: homogeneous isotropic; a density grid over
    [-1,1]^3 with an orientation grid (HG); a 2^3 density grid over a
    shifted box with a constant microflake axis."""
    rs = np.random.RandomState(5)
    g1 = rs.rand(4, 3, 5).astype(np.float32) * 2.0        # [nz, ny, nx]
    g2 = rs.rand(2, 2, 2).astype(np.float32)
    grid = np.concatenate([np.ones(1, np.float32), g1.ravel(), g2.ravel()])
    o1 = rs.normal(size=(2, 2, 3, 3)).astype(np.float32)   # [nz,ny,nx,3]
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    sigma_s = np.float32([[0.5, 0.7, 0.9], [1.1, 0.6, 0.3], [0.4, 0.4, 0.8]])
    sigma_a = np.float32([[0.1, 0.2, 0.3], [0.2, 0.1, 0.5], [0.3, 0.2, 0.1]])
    ax = _unit(rs, 3)
    return media_mod.MediumTable(
        sigma_s=sigma_s, sigma_a=sigma_a, sigma_t=sigma_s + sigma_a,
        phase_kind=np.int32([media_mod.PHASE_ISOTROPIC, media_mod.PHASE_HG,
                             media_mod.PHASE_MICROFLAKE]),
        g=np.float32([0.0, 0.6, 0.0]),
        flake=np.concatenate([ax, np.float32([[1.0], [0.5], [0.2]])], -1),
        het=np.int32([0, 1, 1]), grid_data=grid,
        grid_offset=np.int32([0, 1, 1 + g1.size]),
        grid_res=np.int32([[1, 1, 1], [5, 3, 4], [2, 2, 2]]),
        world_to_grid=np.stack([np.eye(4, dtype=np.float32),
                                _w2g((-1, -1, -1), (1, 1, 1)),
                                _w2g((0.2, -0.5, 0.1), (1.4, 0.5, 0.9))]),
        max_density=np.float32([1.0, g1.max(), g2.max()]),
        orient_data=o1.ravel(), orient_offset=np.int32([-1, 0, -1]),
        orient_res=np.int32([[1, 1, 1], [3, 2, 2], [1, 1, 1]]),
        orient_w2g=np.stack([np.eye(4, dtype=np.float32),
                             _w2g((-1, -1, -1), (1, 1, 1)),
                             np.eye(4, dtype=np.float32)]),
        orient_l2w=np.stack([np.eye(3, dtype=np.float32), rot,
                             np.eye(3, dtype=np.float32)]))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    tab = _table()
    return jax.device_put(tab), bridge.to_torch(tab, "cpu")


def _points_and_ids(n=N, seed=1):
    """Lane medium ids (vacuum -1 included) and points inside the grid
    boxes, exactly on their faces, and outside."""
    rs = np.random.RandomState(seed)
    mid = rs.randint(-1, 3, size=n).astype(np.int32)
    p = rs.uniform(-1.3, 1.6, size=(n, 3)).astype(np.float32)
    face = rs.rand(n) < 0.25
    axis = rs.randint(0, 3, size=n)
    side = np.where(rs.rand(n) < 0.5, -1.0, 1.0).astype(np.float32)
    p[face, axis[face]] = side[face]       # faces of [-1,1]^3
    return mid, p


def test_gather_and_transmittance(tables):
    tab, ttab = tables
    mid, _ = _points_and_ids()
    ref = ref_med.gather(tab, jnp.array(mid))
    got = med.gather(ttab, _t(mid))
    for r, g in zip(ref, got):
        if r.dtype == jnp.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            _close(g.numpy(), r)
    dist = np.random.RandomState(2).exponential(1.5, N).astype(np.float32)
    dist[::97] = 3e38
    _close(med.transmittance(got[1], _t(dist)).numpy(),
           ref_med.transmittance(ref[1], jnp.array(dist)))


def _implied_channel(t, sigma_t, u_dist):
    """The channel whose sigma_t turns the exponential draw into t."""
    e = -np.log1p(-np.clip(u_dist, 0.0, 1.0 - 1e-7)).astype(np.float64)
    return np.argmin(np.abs(t[:, None] * sigma_t - e[:, None]), -1)


def test_sample_distance(tables):
    tab, ttab = tables
    rs = np.random.RandomState(3)
    mid, _ = _points_and_ids(seed=3)
    uc, ud = rs.rand(2, N).astype(np.float32)
    tmax = rs.exponential(1.0, N).astype(np.float32)
    ss_r, st_r, _, _, _ = ref_med.gather(tab, jnp.array(mid))
    ss_p, st_p, _, _, _ = med.gather(ttab, _t(mid))
    ref = ref_med.sample_distance(ss_r, st_r, jnp.array(uc),
                                  jnp.array(ud), jnp.array(tmax))
    got = med.sample_distance(ss_p, st_p, _t(uc), _t(ud), _t(tmax))
    np.testing.assert_array_equal(got.scattered.numpy(),
                                  np.asarray(ref.scattered))
    assert 0.1 < float(got.scattered.float().mean()) < 0.9
    _close(got.t.numpy(), ref.t)
    _close(got.weight.numpy(), ref.weight)
    live = mid >= 0
    st = st_p.numpy()[live]
    np.testing.assert_array_equal(
        _implied_channel(got.t.numpy()[live], st, ud[live]),
        _implied_channel(np.asarray(ref.t)[live], st, ud[live]))


PHASES = [("isotropic", media_mod.PHASE_ISOTROPIC, 0.0),
          ("hg-0.4", media_mod.PHASE_HG, -0.4),
          ("hg0", media_mod.PHASE_HG, 0.0),
          ("hg0.6", media_mod.PHASE_HG, 0.6),
          ("rayleigh", media_mod.PHASE_RAYLEIGH, 0.0),
          ("microflake", media_mod.PHASE_MICROFLAKE, 0.0)]


@pytest.mark.parametrize("name,kind,g", PHASES, ids=[p[0] for p in PHASES])
def test_phase_sample_and_eval(name, kind, g):
    rs = np.random.RandomState(4)
    wi = _unit(rs, N)
    wo = _unit(rs, N)
    u2 = rs.rand(N, 2).astype(np.float32)
    flake = np.concatenate([_unit(rs, N), rs.uniform(
        0.05, 1.5, (N, 1)).astype(np.float32)], -1)
    kinds = np.full(N, kind, np.int32)
    gs = np.full(N, g, np.float32)
    r_args = [jnp.array(a) for a in (kinds, gs, wi)]
    p_args = [_t(a) for a in (kinds, gs, wi)]
    _close(med.phase_eval(*p_args, _t(wo), _t(flake)).numpy(),
           ref_med.phase_eval(*r_args, jnp.array(wo), jnp.array(flake)))
    wo_r, pdf_r = ref_med.phase_sample(*r_args, jnp.array(u2),
                                       jnp.array(flake))
    wo_p, pdf_p = med.phase_sample(*p_args, _t(u2), _t(flake))
    _close(wo_p.numpy(), wo_r)
    _close(pdf_p.numpy(), pdf_r)


def test_density_and_flake_lookup(tables):
    tab, ttab = tables
    mid, p = _points_and_ids(seed=6)
    ref = ref_med.density_at(tab, jnp.array(mid), jnp.array(p))
    got = med.density_at(ttab, _t(mid), _t(p))
    _close(got.numpy(), ref)
    # every case is exercised: grid interiors, faces, outside, vacuum
    d = got.numpy()
    assert ((mid > 0) & (d == 0.0)).any() and ((mid > 0) & (d > 0)).any()
    assert (d[mid <= 0] == 1.0).all()
    _close(med.flake_at(ttab, _t(mid), _t(p)).numpy(),
           ref_med.flake_at(tab, jnp.array(mid), jnp.array(p)))


def _uniforms(n_steps, seed):
    return np.random.RandomState(seed).rand(n_steps, N, 2).astype(
        np.float32)


def test_tracking(tables):
    """Delta tracking and ratio tracking, 8 steps, on the same uniforms."""
    tab, ttab = tables
    rs = np.random.RandomState(7)
    mid, _ = _points_and_ids(seed=7)
    o = rs.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    d = _unit(rs, N)
    tmax = rs.uniform(0.1, 3.0, N).astype(np.float32)
    U = _uniforms(8, 8)
    Uj = jnp.array(U)
    r_args = (tab, jnp.array(mid), jnp.array(o), jnp.array(d),
              jnp.array(tmax), lambda k: Uj[k], 8)
    p_args = (ttab, _t(mid), _t(o), _t(d), _t(tmax), lambda k: _t(U[k]), 8)
    ref = ref_med.sample_distance_tracking(*r_args)
    got = med.sample_distance_tracking(*p_args)
    np.testing.assert_array_equal(got.scattered.numpy(),
                                  np.asarray(ref.scattered))
    assert 0.05 < float(got.scattered.float().mean()) < 0.95
    _close(got.t.numpy(), ref.t)
    _close(got.weight.numpy(), ref.weight)
    _close(med.transmittance_tracking(*p_args).numpy(),
           ref_med.transmittance_tracking(*r_args))


def test_null_kind(tmp_path):
    """eval and pdf mask the null kind out; sample passes straight
    through (wo = -wi, weight 1, pdf 1, delta) on both sides of the
    surface; diffuse lanes of the same batch are unchanged."""
    xml = tmp_path / "s.xml"
    xml.write_text("""<scene version="0.5.0">
  <sensor type="perspective"><film type="hdrfilm">
    <integer name="width" value="4"/><integer name="height" value="4"/>
  </film></sensor>
  <shape type="cube"><bsdf type="null"/></shape>
  <shape type="rectangle"><bsdf type="diffuse"/>
    <emitter type="area"><rgb name="radiance" value="1 1 1"/></emitter>
  </shape>
</scene>""")
    scene, _ = ref_scene.load_scene(str(xml))
    ts = bridge.to_torch(scene, "cpu")
    rs = np.random.RandomState(9)
    mid = rs.randint(0, int(scene.materials.kind.shape[0]), N).astype(
        np.int32)
    wi, wo = _unit(rs, N), _unit(rs, N)
    u2 = rs.rand(N, 2).astype(np.float32)
    uc = rs.rand(N).astype(np.float32)
    kinds = bsdf.scene_kinds(ts)
    assert kinds == ref_bsdf.scene_kinds(scene) == frozenset(
        {bsdf.DIFFUSE, bsdf.NULL_BSDF})
    rp = ref_bsdf.gather_params(scene.materials, jnp.array(mid))
    pp = bsdf.gather_params(ts.materials, _t(mid))
    null = pp.kind.numpy() == bsdf.NULL_BSDF
    assert null.any() and (~null).any()
    f = bsdf.eval(pp, _t(wi), _t(wo), kinds)
    _close(f.numpy(), ref_bsdf.eval(rp, jnp.array(wi), jnp.array(wo),
                                    kinds))
    assert (f.numpy()[null] == 0).all()
    pdf = bsdf.pdf(pp, _t(wi), _t(wo), kinds)
    _close(pdf.numpy(), ref_bsdf.pdf(rp, jnp.array(wi), jnp.array(wo),
                                     kinds))
    assert (pdf.numpy()[null] == 0).all()
    ref = ref_bsdf.sample(rp, jnp.array(wi), jnp.array(u2),
                          jnp.array(uc), kinds)
    got = bsdf.sample(pp, _t(wi), _t(u2), _t(uc), kinds)
    for name in ("wo", "weight", "pdf", "eta"):
        _close(getattr(got, name).numpy(), getattr(ref, name))
    for name in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got.wo.numpy()[null], -wi[null])
    assert got.is_delta.numpy()[null].all()
    assert not got.is_delta.numpy()[~null].any()
