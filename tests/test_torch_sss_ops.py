"""Dipole subsurface scattering's pieces in the port (ROADMAP step G2c)
against the reference on the CPU: ops/sss.py (fdr, the dipole
coefficients, Rd, the surface points, eval_mo), the factory's routes on
a subsurface scene, and the emitter and SSS CDF searches
(emitter._searchsorted_segment), which read only inside their row's
segment.  The scenes are tests/test_sss.py's, written by
tools/sss_scene.py (a tessellated marble sphere; a second sphere of
another preset in the "two" variant).  The DipoleTracer's cache and
render: tests/test_torch_sss.py.

Tolerances: fdr / coefficients / Rd at rtol 1e-6; the surface points'
rows bit for bit, p / n / aw at rtol 1e-6; eval_mo at rtol 1e-5 on 300
cache points (not a multiple of its 256-point chunk)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import sss as ref_sss
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.models.bdpt import BDPTracer
from gradientdomain_mitsuba_tpu_torch.models.sss import DipoleTracer
from gradientdomain_mitsuba_tpu_torch.ops import emitter as em_ops
from gradientdomain_mitsuba_tpu_torch.ops import sss
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from torch_parity import load_tool
from torch_parity import one_thread  # noqa: F401

# torch on one thread: the suite runs six workers, and a multi-threaded
# CPU torch among them spends the renders' time contending for cores
pytestmark = pytest.mark.usefixtures("one_thread")

sss_scene = load_tool("sss_scene")
# (sigma_s, sigma_a, g, eta): marble at scale 10, test_sss.py's eval_mo
# table, a forward-scattering row with eta < 1
TABLES = (((21.9, 26.2, 30.0), (0.021, 0.041, 0.071), 0.0, 1.5),
          ((1.0, 2.0, 0.5), (0.05, 0.02, 0.1), 0.0, 1.3),
          ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48), 0.4, 0.8))


def _table(rows):
    """An SSSTable of the given rows (one triangle each: only the
    coefficient fields matter here)."""
    R = len(rows)
    return ref_scene.SSSTable(
        sigma_s=np.asarray([r[0] for r in rows], np.float32),
        sigma_a=np.asarray([r[1] for r in rows], np.float32),
        g=np.asarray([r[2] for r in rows], np.float32),
        eta=np.asarray([r[3] for r in rows], np.float32),
        shape=np.arange(R, dtype=np.int32),
        shape_sss=np.arange(R, dtype=np.int32),
        tri_offset=np.arange(R, dtype=np.int32),
        tri_count=np.ones(R, np.int32), tri_cdf=np.ones(R, np.float32),
        tri_index=np.arange(R, dtype=np.int32),
        total_area=np.ones(R, np.float32))


def test_fdr_matches_reference():
    eta = np.asarray([0.5, 0.8, 0.99, 1.0, 1.01, 1.3, 1.5, 2.4])
    np.testing.assert_array_equal(sss.fdr(eta), ref_sss.fdr(eta))


@pytest.mark.parametrize("row", range(len(TABLES)))
def test_dipole_coeffs_match_reference(row):
    table = _table([TABLES[row]])
    got = sss.dipole_coeffs(bridge.to_torch(table, "cpu"))
    ref = ref_sss.dipole_coeffs(table)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    assert sss.rd_total(table, 0) == pytest.approx(
        ref_sss.rd_total(table, 0), rel=1e-12)


def test_rd_matches_reference():
    co_np = ref_sss.dipole_coeffs(_table(TABLES))
    co = sss.dipole_coeffs(bridge.to_torch(_table(TABLES), "cpu"))
    rs = np.random.RandomState(5)
    r2 = (10.0 ** rs.uniform(-6, 1, size=(4096, len(TABLES), 1))).astype(
        np.float32)
    got = sss.rd(torch.from_numpy(r2), co.sigma_tr, co.zr, co.zv,
                 co.alpha_p).numpy()
    ref = np.asarray(ref_sss.rd(jnp.asarray(r2), co_np.sigma_tr, co_np.zr,
                                co_np.zv, co_np.alpha_p))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_rd_total_reflectance():
    """2 pi ∫ r Rd(r) dr == the closed-form total diffuse reflectance
    (test_sss.py's oracle, on the port's Rd)."""
    table = _table(TABLES[:1])
    co = sss.dipole_coeffs(bridge.to_torch(table, "cpu"))
    r = np.logspace(-4, 2, 4096)
    vals = sss.rd(torch.tensor((r * r)[:, None], dtype=torch.float32),
                  co.sigma_tr[0], co.zr[0], co.zv[0], co.alpha_p[0]).numpy()
    total = np.trapezoid(2 * np.pi * r[:, None] * vals, r, axis=0)
    np.testing.assert_allclose(total, sss.rd_total(table, 0), rtol=2e-2)


def _eval_mo_inputs(rows):
    """test_eval_mo_matches_bruteforce's inputs (P = 300, N = 64, 3
    masked queries), with the cache's and the queries' rows drawn from
    `rows` table rows."""
    rs = np.random.RandomState(3)
    P, N = 300, 64
    cache = dict(p=rs.randn(P, 3).astype(np.float32),
                 n=np.zeros((P, 3), np.float32),
                 E=rs.rand(P, 3).astype(np.float32),
                 aw=(rs.rand(P) + 0.1).astype(np.float32),
                 row=rs.randint(0, rows, P).astype(np.int32))
    q = rs.randn(N, 3).astype(np.float32)
    q_row = rs.randint(0, rows, N).astype(np.int32)
    q_row[-3:] = -1
    return cache, q, q_row


@pytest.mark.parametrize("rows", [1, 2])
def test_eval_mo_matches_reference(rows):
    table = _table([TABLES[1], TABLES[2]][:rows])
    cache, q, q_row = _eval_mo_inputs(rows)
    ref = np.asarray(ref_sss.eval_mo(
        {k: jnp.asarray(v) for k, v in cache.items()},
        ref_sss.dipole_coeffs(table), jnp.asarray(q), jnp.asarray(q_row)))
    got = sss.eval_mo({k: torch.from_numpy(v) for k, v in cache.items()},
                      sss.dipole_coeffs(bridge.to_torch(table, "cpu")),
                      torch.from_numpy(q), torch.from_numpy(q_row)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert (got[-3:] == 0).all() and (got[:-3] > 0).all()


def test_eval_mo_matches_bruteforce():
    """eval_mo's chunked sum against a brute-force loop (test_sss.py's
    oracle, on the port; chunk 64: 300 points are not whole chunks)."""
    table = _table(TABLES[1:2])
    co = sss.dipole_coeffs(bridge.to_torch(table, "cpu"))
    cache, q, q_row = _eval_mo_inputs(1)
    mo = sss.eval_mo({k: torch.from_numpy(v) for k, v in cache.items()},
                     co, torch.from_numpy(q), torch.from_numpy(q_row),
                     chunk=64).numpy()
    st, zr, zv, ap = (x[0].numpy().astype(np.float64)
                      for x in (co.sigma_tr, co.zr, co.zv, co.alpha_p))
    want = np.zeros((q.shape[0], 3))
    for i in range(q.shape[0] - 3):
        r2 = np.sum((q[i] - cache["p"]) ** 2, -1)[:, None]
        dr = np.sqrt(r2 + zr * zr)
        dv = np.sqrt(r2 + zv * zv)
        rd = ap / (4 * np.pi) * (
            zr * (st * dr + 1) * np.exp(-st * dr) / dr ** 3 +
            zv * (st * dv + 1) * np.exp(-st * dv) / dv ** 3)
        want[i] = np.sum(rd * cache["E"] * cache["aw"][:, None], 0)
    np.testing.assert_allclose(mo, want, rtol=2e-3, atol=1e-5)


def _load(path):
    return ref_scene.load_scene(path, {"width": "8", "height": "8",
                                       "spp": "1"})


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The one- and two-sphere scenes, each loaded once: {variant:
    (numpy scene, settings)}."""
    d = str(tmp_path_factory.mktemp("sss"))
    return {v: _load(sss_scene.write_scene(d, v)) for v in ("one", "two")}


@pytest.mark.parametrize("variant", ["one", "two"])
def test_surface_points_match_reference(scenes, variant):
    """The round-robin rows bit for bit, p / n / aw at rtol 1e-6, on one
    sphere and on two of different presets (rows 0 and 1 alternate)."""
    scene, st = scenes[variant]
    R = int(scene.sss.shape.shape[0])
    assert R == {"one": 1, "two": 2}[variant] and st.has_sss
    ref = jax.jit(lambda: ref_sss.sample_surface_points(scene, 513, 9))()
    got = sss.sample_surface_points(bridge.to_torch(scene, "cpu"), 513, 9)
    np.testing.assert_array_equal(got["row"].numpy(), np.asarray(ref["row"]))
    assert np.bincount(got["row"].numpy()).tolist() == (
        [513] if R == 1 else [257, 256])
    for k in ("p", "n", "aw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_unknown_and_bidirectional_types_on_subsurface(scenes):
    """An unknown type on a subsurface scene falls through to the dipole
    tracer; the bidirectional families ignore subsurface (the
    reference's routes)."""
    scene, st = scenes["two"]
    ts = bridge.to_torch(scene, "cpu")
    for integ, cls in (("no-such-integrator", DipoleTracer),
                       ("bdpt", BDPTracer)):
        st2 = copy.deepcopy(st)
        st2.integrator = integ
        assert type(factory.make_integrator(ts, st2)) is cls


class _Reads:
    """A CDF that records every index a search reads."""

    def __init__(self, cdf):
        self.cdf, self.shape, self.seen = cdf, cdf.shape, []

    def __getitem__(self, i):
        self.seen.append(i.clone())
        return self.cdf[i]


def _search_reads(cdf, lo, hi, u):
    rec = _Reads(cdf)
    k = em_ops._searchsorted_segment(rec, lo, hi, u)
    return k, torch.stack(rec.seen)


@pytest.mark.parametrize("name", ["envmap", "lights", "sss"])
def test_segment_search_reads_inside_rows(name, scenes, tmp_path):
    """The searches of the emitter NEE (lo, lo + count - 1) and of the
    SSS points (lo, lo + count) read the CDF only inside their own
    row's segment, for u at 0, 1 and in between: no area row has count
    0, and no read reaches past the array's end (on the card such a
    read would be a device-side index assert).  envmap.xml has no area
    row: BDPT's light walk still searches its table's one row, of count
    0, and reads only index -1 (the last element, as in the reference's
    gather), a lane its n_area == 0 mask kills."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    u = torch.cat([torch.tensor([0.0, 1.0, 1.0 - 2 ** -24]),
                   torch.rand(61, generator=torch.Generator().manual_seed(0))])
    if name == "sss":
        t = bridge.to_torch(scenes["two"][0], "cpu").sss
        lo_r, cnt, cdf, hi_off = t.tri_offset, t.tri_count, t.tri_cdf, 0
    else:
        path = (os.path.join(root, "data/scenes/envmap/envmap.xml")
                if name == "envmap" else
                load_tool("lights_board").write_board(str(tmp_path)))
        em = bridge.to_torch(_load(path)[0], "cpu").emitters
        n_area = int((em.tri_count > 0).sum())
        if name == "envmap":
            assert n_area == 0 and em.tri_count.tolist() == [0]
            lo = em.tri_offset[0].long().expand(u.shape[0])
            k, seen = _search_reads(em.tri_cdf, lo, lo - 1, u)
            assert (seen == -1).all() and (k == 0).all()
            return
        assert n_area > 0 and (em.tri_count[:n_area] > 0).all()
        lo_r, cnt, cdf, hi_off = (em.tri_offset[:n_area],
                                  em.tri_count[:n_area], em.tri_cdf, -1)
    for r in range(lo_r.shape[0]):
        lo = lo_r[r].long().expand(u.shape[0])
        hi = lo + cnt[r] + hi_off
        k, seen = _search_reads(cdf, lo, hi, u)
        first, last = int(lo_r[r]), int(lo_r[r] + cnt[r] - 1)
        assert int(seen.min()) >= first and int(seen.max()) <= last
        assert last < cdf.shape[0]
        assert int(k.min()) >= first and int(k.max()) <= last + 1
