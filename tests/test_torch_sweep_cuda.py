"""CUDA sweep kernels (csrc/sweep.cu) against their plain PyTorch
versions, on the card.  Imports no jax, so the card's machine (which has
none) runs it without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_sweep_cuda.py -m cuda -q

Without a card every case skips."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.ops import sweep

_spec = importlib.util.spec_from_file_location(
    "sweep_soups", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "sweep_soups.py"))
sweep_soups = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep_soups)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _soup(kind, T, n, seed, dev):
    """sweep_soups.random_soup on the card: (o, d, mint, maxt, linC),
    every 5th lane dead."""
    return [torch.from_numpy(a).to(dev)
            for a in sweep_soups.random_soup(T, n, seed, kind)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [3, 36, 130, 2048])
def test_cuda_kernels_match_plain(cuda_device, T):
    args = _soup("random", T, 10_007, T, cuda_device)
    k = sweep.make_sweep_intersector(T)
    got = k(*args)
    ref = isec.intersect_matmul(*args)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert torch.equal(got.valid, ref.valid)
    assert not got.valid[::5].any()
    assert bool((got.prim[~got.valid] == -1).all())
    mk = ref.valid & (got.prim == ref.prim)
    assert mk.sum() >= 0.998 * ref.valid.sum()
    torch.testing.assert_close(got.t[mk], ref.t[mk], rtol=1e-5, atol=0)
    o = sweep.make_sweep_occluder(T)
    occ = o(*args)
    assert o.launches == 1
    assert (occ == isec.occluded_matmul(*args)).float().mean() >= 0.999


@pytest.mark.cuda
def test_cuda_kernels_sweep_every_cluster(cuda_device):
    """Cluster-major layout: 3 windows of 128 columns with 100 real
    triangles each; the kernels must test the triangles past column 256."""
    args = _soup("windowed", 300, 10_007, 5, cuda_device)
    assert args[4].shape == (10, 4 * 384)
    got = sweep.make_sweep_intersector(300)(*args)
    ref = isec.intersect_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.valid, ref.valid)
    assert bool((got.prim >= 256).any())
    assert (got.prim == ref.prim).float().mean() >= 0.998
    occ = sweep.make_sweep_occluder(300)(*args)
    assert (occ == isec.occluded_matmul(*args)).float().mean() >= 0.999


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    o, d, mint, maxt, linC = _soup("random", 8, 64, 0, cuda_device)
    k = sweep.make_sweep_intersector(8)
    with pytest.raises(TypeError):
        k(o.double(), d, mint, maxt, linC)
    with pytest.raises(ValueError):
        k(o[:, :2], d, mint, maxt, linC)
    with pytest.raises(ValueError):
        k(o.t().contiguous().t(), d, mint, maxt, linC)
    with pytest.raises(ValueError):
        k(o, d, mint.cpu(), maxt, linC)
    assert k.launches == 0


def _check_against_plain(args, n_tris):
    """Both kernels against their plain versions on one batch, at the
    smoke run's tolerances; returns the kernels' (Hit, occluded)."""
    k = sweep.make_sweep_intersector(n_tris)
    got = k(*args)
    ref = isec.intersect_matmul(*args)
    ko = sweep.make_sweep_occluder(n_tris)
    occ = ko(*args)
    ref_occ = isec.occluded_matmul(*args)
    torch.cuda.synchronize()
    assert k.launches == 1 and ko.launches == 1
    assert torch.equal(got.valid, ref.valid)
    assert not got.valid[args[3] <= args[2]].any()
    assert not occ[args[3] <= args[2]].any()
    assert bool((got.prim[~got.valid] == -1).all())
    assert bool((got.t[~got.valid] == np.float32(3.0e38)).all())
    mk = ref.valid & (got.prim == ref.prim)
    assert mk.sum() >= 0.998 * ref.valid.sum()
    torch.testing.assert_close(got.t[mk], ref.t[mk], rtol=1e-5, atol=0)
    assert (occ == ref_occ).float().mean() >= 0.999
    return got, occ


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T", [("windowed", 300), ("zero_area", 96),
                                    ("ties", 64)])
def test_cuda_kernels_match_plain_on_soups(cuda_device, kind, T):
    """The windowed layout (triangles past column 256), zero-area
    triangles (left out of the packed table) and duplicated triangles
    (equal t: the lowest column must win)."""
    args = _soup(kind, T, 20_011, 11, cuda_device)
    got, _ = _check_against_plain(args, T)
    n_rec = sweep.make_sweep_intersector(T).packed(args[4]).shape[0]
    if kind == "windowed":
        assert n_rec == T and bool((got.prim >= 256).any())
    elif kind == "zero_area":
        assert n_rec == T - len(range(0, T, 3))
        assert not bool((got.prim[got.valid] % 3 == 0).any())
    else:
        assert n_rec == T and bool(got.valid.any())
        assert bool((got.prim[got.valid] < (T + 1) // 2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 255, 257])
def test_cuda_kernels_any_batch_size(cuda_device, n):
    args = _soup("random", 36, max(n, 1), 3, cuda_device)
    args = [a[:n] for a in args[:4]] + [args[4]]
    k = sweep.make_sweep_intersector(36)
    ko = sweep.make_sweep_occluder(36)
    got, occ = k(*args), ko(*args)
    ref = isec.intersect_matmul(*args)
    torch.cuda.synchronize()
    assert got.t.shape == (n,) and occ.shape == (n,)
    assert torch.equal(got.prim, ref.prim)
    assert torch.equal(occ, isec.occluded_matmul(*args))
    assert k.launches == 1 and ko.launches == 1


@pytest.mark.cuda
def test_cuda_kernels_dead_lanes_stay_unhit(cuda_device):
    """Every lane dead (maxt <= mint, as finished wavefront lanes carry)."""
    o, d, mint, maxt, linC = _soup("random", 130, 4_099, 4, cuda_device)
    for dead_maxt in (torch.full_like(maxt, -1.0), mint.clone()):
        got = sweep.make_sweep_intersector(130)(o, d, mint, dead_maxt, linC)
        occ = sweep.make_sweep_occluder(130)(o, d, mint, dead_maxt, linC)
        torch.cuda.synchronize()
        assert not got.valid.any() and not occ.any()
        assert bool((got.t == np.float32(3.0e38)).all())
        assert bool((got.prim == -1).all())


@pytest.mark.cuda
def test_cuda_kernels_negative_mint(cuda_device):
    """Hits behind the origin down to mint < 0 (t may be negative)."""
    o, d, mint, maxt, linC = _soup("random", 130, 20_011, 6, cuda_device)
    mint = torch.full_like(mint, -5.0)
    got, _ = _check_against_plain((o, d, mint, maxt, linC), 130)
    assert bool((got.t[got.valid] < 0).any())


@pytest.mark.cuda
def test_cuda_largest_table_staged_whole(cuda_device):
    """T = 2048: 160 KB of records in one block's shared memory (the
    launch opts in above 48 KB); one more record raises."""
    args = _soup("random", 2048, 20_011, 8, cuda_device)
    assert sweep.pack_linear_mt(args[4]).shape == (2048, 20)
    _check_against_plain(args, 2048)
    big = _soup("random", sweep.MAX_RECORDS + 1, 64, 8, cuda_device)
    k = sweep.make_sweep_intersector(sweep.MAX_RECORDS + 1)
    with pytest.raises(ValueError):
        k(*big)
    assert k.launches == 0


@pytest.mark.cuda
def test_pack_on_card_equals_pack_on_cpu(cuda_device):
    linC = _soup("windowed", 300, 1, 2, cuda_device)[4]
    assert torch.equal(sweep.pack_linear_mt(linC).cpu(),
                       sweep.pack_linear_mt(linC.cpu()))


# ---------------------------------------------------------------------------
# Where the any-hit kernel and its plain version may differ: VPL's
# 16,777,216-lane shadow call on cbox (256^2, vplChunk 256, the first call
# of a render at seed 0) differed on these 7 lanes.  Each crosses the
# plane of cbox's light quad (triangles 24 and 25, y = 548) at a grazing
# |cos| of 0.0026-0.0042, within 1e-4 (barycentric) of the quad's front
# or back edge, where the rounding error of the linear-MT numerators is
# ~1e-3: whether the shadow ray passes just outside the light is decided
# by rounding, and the kernel's fmaf chains and the plain version's matrix
# product round differently (float64 sides with the plain version on 5
# lanes, with the kernel on 2).
VPL_LANES = dict(
    o=[[344.65997314453125, 548.703857421875, 21.67230224609375],
       [84.92654418945312, 548.703857421875, 40.66827392578125],
       [352.5263671875, 548.703857421875, 63.3895263671875],
       [406.30621337890625, 548.703857421875, 437.02490234375],
       [190.93328857421875, 548.703857421875, 509.970458984375],
       [410.71551513671875, 548.703857421875, 549.7427978515625],
       [368.7298278808594, 548.703857421875, 549.6339111328125]],
    d=[[-0.2744949758052826, -0.003296375274658203, 0.9615828394889832],
       [0.7157716155052185, -0.002637815661728382, 0.6983295679092407],
       [-0.19028529524803162, -0.00422363355755806, 0.9817196726799011],
       [-0.7785026431083679, -0.004206399898976088, -0.6276272535324097],
       [0.18206265568733215, -0.0038885888643562794, -0.9832791686058044],
       [-0.3331499397754669, -0.0030479421839118004, -0.9428688883781433],
       [-0.20189432799816132, -0.0031672504264861345, -0.9794021844863892]],
    maxt=[288.3877868652344, 356.48126220703125, 226.30230712890625,
          225.6459503173828, 244.66494750976562, 301.7812805175781,
          290.0166931152344])
F32_EPS = 2.0 ** -24


def _cbox_linC():
    from gradientdomain_mitsuba_tpu_torch.scene import scene as sc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s, _ = sc.load_scene(os.path.join(root, "data/scenes/cbox/cbox.xml"),
                         {"width": "16", "height": "16"})
    return s.geom.linC, s.geom.tris


def rounding_decided(o, d, mint, maxt, linC, slack=16.0):
    """[N] bool: some triangle's any-hit test on the ray is decided by
    float32 rounding.  In float64, a triangle whose crossing lies inside
    the ray's extent and within `slack` times the float32 error bound of
    its linear-MT numerators (eps x the sum of the terms' magnitudes,
    over |det|) of an edge, or whose t lies that close to mint or maxt."""
    o, d = (np.asarray(x, np.float64) for x in (o, d))
    C = np.asarray(linC, np.float64)
    T = C.shape[1] // 4
    f = np.concatenate([np.cross(o, d), d, o, np.ones_like(o[:, :1])], 1)
    # magnitudes of the terms (a cross product's two products each)
    fa = np.abs(np.concatenate([np.cross(o, d), d, o,
                                np.ones_like(o[:, :1])], 1))
    fa[:, :3] = (np.abs(o[:, [1, 2, 0]] * d[:, [2, 0, 1]]) +
                 np.abs(o[:, [2, 0, 1]] * d[:, [1, 2, 0]]))
    F = f @ C
    A = fa @ np.abs(C)
    det, un, vn, tn = (F[:, k * T:(k + 1) * T] for k in range(4))
    ad = np.abs(det)
    live = (np.abs(C[3:6, :T]).sum(0) > 0)[None] & (ad > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        u, v, t = (x * np.sign(det) / ad for x in (un, vn, tn))
        rel = slack * F32_EPS / ad
        eu = rel * (A[:, T:2 * T] + np.abs(u) * A[:, :T])
        ev = rel * (A[:, 2 * T:3 * T] + np.abs(v) * A[:, :T])
        et = rel * (A[:, 3 * T:] + np.abs(t) * A[:, :T])
        mint, maxt = (np.asarray(x, np.float64)[:, None] for x in (mint, maxt))
        inside = ((u > -eu) & (v > -ev) & (1 - u - v > -(eu + ev)) &
                  (t > mint - et) & (t < maxt + et))
        edge = ((np.abs(u) < eu) | (np.abs(v) < ev) |
                (np.abs(1 - u - v) < eu + ev) | (np.abs(t - maxt) < et) |
                (np.abs(t - mint) < et))
    return (live & inside & edge).any(1)


def test_vpl_mismatch_lanes_are_rounding_decided():
    """The 7 lanes of VPL's shadow call where the any-hit kernel and the
    plain version differed cross cbox's light quad at a grazing angle
    within the float32 rounding bound of its edge (see VPL_LANES)."""
    linC, tris = _cbox_linC()
    o = np.float32(VPL_LANES["o"])
    d = np.float32(VPL_LANES["d"])
    maxt = np.float32(VPL_LANES["maxt"])
    assert rounding_decided(o, d, np.zeros(7), maxt, linC).all()
    # the triangles in question: the light quad, a grazing angle
    n = np.cross(tris.e1[24], tris.e2[24])
    cos = d.astype(np.float64) @ (n / np.linalg.norm(n))
    assert (np.abs(cos) < 0.005).all() and (np.abs(cos) > 0.002).all()
    # away from the edge the same rays are not rounding-decided
    assert not rounding_decided(o, d, np.zeros(7), maxt * 0.5, linC).any()


def _grazing_light_rays(tris, n, seed, offset):
    """Rays from just above the plane of cbox's light quad toward points
    on its four outer edges and its diagonal, moved `offset` (a
    fraction of the quad's side, signed at random) across the edge,
    grazing the plane at |cos| 0.002-0.006."""
    rs = np.random.RandomState(seed)
    # the quad's corners: v0, v0 + e1 (triangle 24), v0 + e2 (both), and
    # triangle 25's v0 + e2 of its own table
    p = np.array([tris.v0[24], tris.v0[24] + tris.e1[24],
                  tris.v0[24] + tris.e2[24], tris.v0[25] + tris.e2[25]],
                 np.float64)
    edges = [(p[0], p[1]), (p[1], p[2]), (p[2], p[3]), (p[3], p[0]),
             (p[0], p[2])]
    k = rs.randint(0, len(edges), n)
    s = rs.uniform(0.05, 0.95, n)
    e0 = np.array([edges[i][0] for i in k])
    e1 = np.array([edges[i][1] for i in k])
    along = e1 - e0
    perp = np.cross(along, [0.0, 1.0, 0.0])
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    target = (e0 + s[:, None] * along +
              perp * (offset * 130.0 * rs.choice([-1.0, 1.0], n))[:, None])
    slope = rs.uniform(0.002, 0.006, n)
    az = rs.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(az), -slope, np.sin(az)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rs.uniform(50, 400, n)
    o = target - d * dist[:, None]
    maxt = dist + rs.uniform(1, 100, n)
    return (np.float32(o), np.float32(d), np.zeros(n, np.float32),
            np.float32(maxt))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0.0, 1e-4, 5e-2])
def test_occluded_differs_only_where_rounding_decides(cuda_device, offset):
    """Grazing rays at cbox's light quad, aimed at its edges (offset 0),
    1e-4 of its side across them, or 5e-2 across (clear of rounding):
    the any-hit kernel and its plain version agree on every lane that
    rounding does not decide, and the kernel repeats its own bits.  With
    the 7 recorded VPL lanes in the batch."""
    linC, tris = _cbox_linC()
    o, d, mint, maxt = _grazing_light_rays(tris, 65_536, 7, offset)
    o = np.concatenate([np.float32(VPL_LANES["o"]), o])
    d = np.concatenate([np.float32(VPL_LANES["d"]), d])
    mint = np.concatenate([np.zeros(7, np.float32), mint])
    maxt = np.concatenate([np.float32(VPL_LANES["maxt"]), maxt])
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (o, d, mint, maxt, linC)]
    k = sweep.make_sweep_occluder(linC.shape[1] // 4)
    occ = k(*args)
    assert torch.equal(occ, k(*args))
    ref = isec.occluded_matmul(*args)
    _check_differ_where_decided((occ != ref).cpu().numpy(),
                                (o, d, mint, maxt), linC, offset, 7)


def _check_differ_where_decided(differ, rays, linC, offset, n_vpl):
    """Every lane that differs is decided by rounding; the grazing batch
    after the first n_vpl lanes aims where it should (on the edges
    rounding decides most lanes, 5e-2 across them almost none)."""
    decided = rounding_decided(*rays, linC)
    assert not (differ & ~decided).any(), np.nonzero(differ & ~decided)
    share = decided[n_vpl:].mean()
    assert share > 0.9 if offset == 0 else share < 0.01 if offset >= 5e-2 \
        else True


@pytest.mark.parametrize("offset", [0.0, 1e-4, 5e-2])
def test_any_hit_orders_differ_only_where_rounding_decides(offset):
    """The mechanism on the CPU: the plain version and the same any-hit
    test with its ten products summed in the opposite order (another
    float32 rounding, as the kernel's fmaf chains are) disagree on the
    grazing rays at cbox's light quad, and only on lanes that rounding
    decides."""
    linC, tris = _cbox_linC()
    o, d, mint, maxt = _grazing_light_rays(tris, 65_536, 7, offset)
    args = [torch.from_numpy(x) for x in (o, d, mint, maxt, linC)]
    ref = isec.occluded_matmul(*args)
    f = isec._features(args[0], args[1])
    C = args[4]
    F = torch.zeros(f.shape[0], C.shape[1])
    for k in reversed(range(10)):
        F = F + f[:, k:k + 1] * C[k][None]
    T = C.shape[1] // 4
    sgn = torch.sign(F[:, :T])
    ad, su, sv, st = (F[:, k * T:(k + 1) * T] * sgn for k in range(4))
    alt = ((su >= 0) & (sv >= 0) & (su + sv <= ad) & (ad > 0) &
           (st > args[2][:, None] * ad) &
           (st < args[3][:, None] * ad)).any(1)
    differ = (alt != ref).numpy()
    assert differ.any() == (offset < 5e-2)
    _check_differ_where_decided(differ, (o, d, mint, maxt), linC, offset,
                                0)
