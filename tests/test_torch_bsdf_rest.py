"""The BSDF kinds of ROADMAP step G1 in the port against the reference.

Per kind (thindielectric, roughdiffuse, difftrans, phong, ward, hk, a
mask with a constant opacity, blendbsdf, coating, roughcoating), a table
of its rows (one-sided and two-sided) beside the rows it wraps and a
diffuse row, built with BOTH packages' MaterialBuilder (the packed
tables are held equal) and gathered through each package's
common.material_params (has_textures bit 2 where there are wrapper
rows):

- eval, pdf and sample on seeded wi / wo over the whole sphere against
  the reference's: eval and pdf at rtol 1e-5 on >= 99.9% of lanes and
  1e-4 on all (test_torch_envmap.py's rule for steep lobes: Phong and
  Ward take pow / exp of large arguments, a coating refracts twice),
  sampled directions by the same rule at atol 1e-5 (the warps' atol; a
  coating refracts its child's sample out of the layer, which scales
  the child's last bits by 1 / cos_out: one lane of the roughcoating
  table, a Beckmann normal 2.9e-6 apart near the pole, exits the layer
  2.5e-5 apart), the sample's pdf and weight where the directions
  agree at rtol 1e-4 on >= 99.9% of lanes and 2e-4 on all (a lobe at
  its own sample sits near its peak: test_torch_envmap.py's and
  test_torch_specular.py's bounds for steep lobes), validity and the
  delta class exactly;
- a chi^2 of the port's sample against its own pdf over the sphere, as
  tests/test_bsdf.py holds the reference's (the smooth lobes; delta
  lobes are left out of both), and for the delta kinds the share of each
  discrete event against its pdf;
- weight == eval / pdf on the smooth samples;
- a path render of the materials board (tools/materials_board.py: one
  sphere per kind) in both packages at 16^2, 2 spp, maxDepth 6, with the
  reference's intersectors pinned to the linear-MT matmul sweeps, at
  rtol 1e-3 / atol 1e-4 on >= 99% of pixels with means within 1e-3
  relative and equal rays.

torch runs on one thread with subnormals flushed, as XLA's CPU
arithmetic does (tests/torch_parity.py)."""
import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.scene import materials as RM
from gradientdomain_mitsuba_tpu_torch.ops import bsdf, common
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene import materials as PM
from torch_parity import flush_subnormals, one_thread  # noqa: F401
from torch_parity import load, op_close, render_both

pytestmark = pytest.mark.usefixtures("flush_subnormals", "one_thread")

AU_ETA, AU_K = (0.143, 0.374, 1.442), (3.983, 2.385, 1.603)
CU_ETA, CU_K = (0.2, 0.92, 1.1), (3.91, 2.45, 2.14)


def _coat(mb, M, rid, layer_alpha=0.0, dist=0, flags=0,
          sigma=(0.1, 0.2, 0.3), spec=(1.0, 1.0, 1.0)):
    """A COATING row over row `rid`, as MaterialBuilder._build makes it
    from a coating / roughcoating node (intIOR 1.5, extIOR 1.000277,
    thickness 1)."""
    rough = min(mb._row_roughness(rid), 1e30)
    if layer_alpha > 0.0:
        rough = min(rough, layer_alpha)
    return mb.add_row(kind=M.COATING, flags=flags, alpha=rough,
                      alpha_v=layer_alpha, dist=dist,
                      eta=(1.5 / 1.000277,) * 3, specular=spec,
                      transmittance=sigma,
                      reflectance=mb.rows[rid]["reflectance"],
                      child0=rid, child1=rid)


def _rows_blend(mb, M):
    c0 = mb.add_row(kind=M.DIFFUSE, reflectance=(0.6, 0.6, 0.6))
    c1 = mb.add_row(kind=M.ROUGH_CONDUCTOR, alpha=0.3, eta=CU_ETA, k=CU_K)
    mb.add_blend(c0, c1, 0.4)
    c2 = mb.add_row(kind=M.PLASTIC, reflectance=(0.1, 0.27, 0.36),
                    eta=(1.49,) * 3, fdr_int=0.58)
    c3 = mb.add_row(kind=M.CONDUCTOR, eta=AU_ETA, k=AU_K)
    mb.add_blend(c2, c3, 0.7)


def _rows_coating(mb, M):
    d = mb.add_row(kind=M.DIFFUSE, reflectance=(0.5, 0.3, 0.2))
    _coat(mb, M, d)
    rc = mb.add_row(kind=M.ROUGH_CONDUCTOR, alpha=0.25, eta=CU_ETA, k=CU_K,
                    dist=M.DIST_GGX)
    _coat(mb, M, rc, flags=M.FLAG_TWOSIDED, sigma=(0.0, 0.0, 0.0),
          spec=(0.9, 0.9, 0.9))


def _rows_roughcoating(mb, M):
    d = mb.add_row(kind=M.DIFFUSE, reflectance=(0.5, 0.3, 0.2))
    _coat(mb, M, d, layer_alpha=0.2)
    rp = mb.add_row(kind=M.ROUGH_PLASTIC, reflectance=(0.1, 0.6, 0.2),
                    alpha=0.3, eta=(1.49,) * 3, fdr_int=0.58)
    _coat(mb, M, rp, layer_alpha=0.1, dist=M.DIST_GGX,
          flags=M.FLAG_TWOSIDED)


def _rows(*specs):
    """A builder adding plain rows: (kind name, keyword arguments)."""
    def build(mb, M):
        for kind, kw in specs:
            kw = dict(kw)
            if kw.pop("twosided", False):
                kw["flags"] = M.FLAG_TWOSIDED
            mb.add_row(kind=getattr(M, kind), **kw)
    return build


KINDS = {
    "thindielectric": _rows(
        ("THIN_DIELECTRIC", dict(eta=(1.5,) * 3)),
        ("THIN_DIELECTRIC", dict(eta=(1.33,) * 3, specular=(0.95, 0.9, 0.85),
                                 transmittance=(0.9, 0.8, 0.7),
                                 twosided=True))),
    "roughdiffuse": _rows(
        ("ROUGH_DIFFUSE", dict(alpha=0.3, reflectance=(0.6, 0.5, 0.4))),
        ("ROUGH_DIFFUSE", dict(alpha=0.8, reflectance=(0.2, 0.7, 0.3),
                               twosided=True))),
    "difftrans": _rows(
        ("DIFFTRANS", dict(reflectance=(0.6, 0.4, 0.2))),
        ("DIFFTRANS", dict(reflectance=(0.3, 0.5, 0.7), twosided=True))),
    "phong": _rows(
        ("PHONG", dict(alpha=20.0, reflectance=(0.4,) * 3,
                       specular=(0.3,) * 3)),
        ("PHONG", dict(alpha=120.0, reflectance=(0.1, 0.2, 0.3),
                       specular=(0.6, 0.5, 0.4), twosided=True))),
    "ward": _rows(
        ("WARD", dict(alpha=0.2, reflectance=(0.4,) * 3,
                      specular=(0.3,) * 3)),
        ("WARD", dict(alpha=0.1, alpha_v=0.3, reflectance=(0.3,) * 3,
                      specular=(0.4,) * 3, twosided=True))),
    "hk": _rows(
        ("HK", dict(reflectance=(1.0, 0.8, 0.6),
                    transmittance=(0.05, 0.1, 0.2), alpha=1.0, alpha_v=0.0)),
        ("HK", dict(reflectance=(2.0, 1.5, 1.0),
                    transmittance=(0.2, 0.1, 0.05), alpha=0.3, alpha_v=0.6))),
    "mask": _rows(
        ("DIFFUSE", dict(reflectance=(0.6, 0.5, 0.4), opacity=0.4)),
        ("ROUGH_CONDUCTOR", dict(alpha=0.2, eta=AU_ETA, k=AU_K,
                                 opacity=0.7)),
        ("DIELECTRIC", dict(eta=(1.5,) * 3, opacity=0.5)),
        ("PLASTIC", dict(reflectance=(0.7, 0.2, 0.1), eta=(1.6,) * 3,
                         fdr_int=0.6, opacity=0.6, twosided=True))),
    "blend": _rows_blend,
    "coating": _rows_coating,
    "roughcoating": _rows_roughcoating,
}
WRAPPERS = ("blend", "coating", "roughcoating")


def _tables(name):
    """(reference Materials, port Materials on the CPU, has_textures):
    the same rows through each package's builder."""
    out = []
    for M in (RM, PM):
        mb = M.MaterialBuilder()
        KINDS[name](mb, M)
        mb.add_row(kind=M.DIFFUSE, reflectance=(0.6, 0.5, 0.4))
        out.append(mb.finalize())
    np.testing.assert_array_equal(out[1].packed, out[0].packed)
    return (jax.device_put(out[0]), bridge.to_torch(out[1], "cpu"),
            4 if name in WRAPPERS else 0)


def _params(name, mid):
    """Both packages' params of rows `mid` through material_params, and
    both scene_kinds."""
    rmat, tmat, bits = _tables(name)
    rs, ts = SimpleNamespace(materials=rmat), SimpleNamespace(materials=tmat)
    n = mid.shape[0]
    rp = ref_common.material_params(rs, bits, jnp.asarray(mid),
                                    jnp.zeros((n, 2)))
    tp = common.material_params(ts, bits, torch.from_numpy(mid),
                                torch.zeros(n, 2))
    kinds = bsdf.scene_kinds(ts)
    assert kinds == ref_bsdf.scene_kinds(rs)
    return rp, tp, kinds, rmat, tmat


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return np.float32(v / np.linalg.norm(v, axis=-1, keepdims=True))


@pytest.mark.parametrize("name", sorted(KINDS))
def test_kind_matches_reference(name):
    """eval, pdf, sample, roughness and any_specular over the kind's
    table on seeded directions over the whole sphere."""
    rs = np.random.RandomState(sorted(KINDS).index(name))
    n = 6000
    n_rows = _tables(name)[1].kind.shape[0]
    mid = rs.randint(0, n_rows, n).astype(np.int32)
    rp, tp, kinds, rmat, tmat = _params(name, mid)
    wi, wo = _unit(rs, n), _unit(rs, n)
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    jw = [jnp.asarray(a) for a in (wi, wo, u2, uc)]
    tw = [torch.from_numpy(a) for a in (wi, wo, u2, uc)]
    f_ref = np.asarray(ref_bsdf.eval(rp, jw[0], jw[1], kinds))
    op_close(bsdf.eval(tp, tw[0], tw[1], kinds).numpy(), f_ref, "eval")
    op_close(bsdf.pdf(tp, tw[0], tw[1], kinds).numpy(),
             np.asarray(ref_bsdf.pdf(rp, jw[0], jw[1], kinds)), "pdf")
    if name != "thindielectric":   # delta only: eval is 0
        assert (f_ref.max(-1) > 0).mean() > 0.1
    rsam = ref_bsdf.sample(rp, jw[0], jw[2], jw[3], kinds)
    tsam = bsdf.sample(tp, tw[0], tw[2], tw[3], kinds)
    for f in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(tsam, f).numpy(),
                                      np.asarray(getattr(rsam, f)), f)
    assert tsam.valid.float().mean() > 0.3
    np.testing.assert_allclose(tsam.eta.numpy(), np.asarray(rsam.eta),
                               rtol=1e-6)
    op_close(tsam.wo.numpy(), np.asarray(rsam.wo), "wo", atol=1e-5)
    # the lobes' values at their own samples, near the peaks where a steep
    # lobe scales the last bits by 1 / alpha^2, on the lanes whose
    # directions agree at atol 1e-5 (>= 99.9%, above): rtol 1e-4 on >=
    # 99.9% of them, as test_torch_envmap.py holds the microfacet kinds'
    # samples, and 2e-4 on all, test_torch_specular.py's bound for steep
    # lobes (one lane of the roughcoating table: GGX alpha 0.1 at 1.1e-4)
    same = np.isclose(tsam.wo.numpy(), np.asarray(rsam.wo), rtol=1e-5,
                      atol=1e-5).all(-1)
    for f in ("pdf", "weight"):
        got = getattr(tsam, f).numpy()[same]
        ref = np.asarray(getattr(rsam, f))[same]
        close = np.isclose(got, ref, rtol=1e-4, atol=1e-5)
        assert close.reshape(close.shape[0], -1).all(-1).mean() >= 0.999, f
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(
        bsdf.roughness(tmat, torch.from_numpy(mid)).numpy(),
        np.asarray(ref_bsdf.roughness(rmat, jnp.asarray(mid))), rtol=1e-6)
    for thr in (1e-3, 0.5):
        assert (bsdf.any_specular(tmat, thr) ==
                ref_bsdf.any_specular(rmat, thr))


CT_BINS, PHI_BINS, NSUB = 12, 24, 24
# (kind, row of its table, wi): the smooth lobes of every new kind, the
# wrappers over smooth and delta children, from either side where the
# kind handles signed cosines
CHI2 = [("roughdiffuse", 0, (0.4, -0.2, 0.89)),
        ("roughdiffuse", 1, (0.3, 0.5, -0.81)),
        ("difftrans", 0, (0.4, -0.2, 0.89)),
        ("difftrans", 1, (0.3, 0.5, -0.81)),
        ("phong", 0, (0.4, -0.2, 0.89)),
        ("phong", 1, (0.3, 0.5, 0.81)),
        ("ward", 0, (0.4, -0.2, 0.89)),
        ("ward", 1, (0.3, 0.5, 0.81)),
        ("hk", 0, (0.4, -0.2, 0.89)),
        ("hk", 1, (0.3, 0.5, -0.81)),
        ("mask", 0, (0.4, -0.2, 0.89)),
        ("mask", 1, (0.3, 0.5, 0.81)),
        ("blend", 2, (0.3, -0.2, 0.93)),
        ("blend", 5, (0.3, 0.5, 0.81)),
        ("coating", 1, (0.4, -0.2, 0.89)),
        ("coating", 3, (0.3, 0.5, -0.81)),
        ("roughcoating", 1, (0.4, -0.2, 0.89)),
        ("roughcoating", 3, (0.3, 0.5, 0.81))]


def _sphere_dirs():
    cts = -1 + 2 * (np.arange(CT_BINS * NSUB) + 0.5) / (CT_BINS * NSUB)
    phs = 2 * np.pi * (np.arange(PHI_BINS * NSUB) + 0.5) / (PHI_BINS * NSUB)
    CT, PH = np.meshgrid(cts, phs, indexing="ij")
    ST = np.sqrt(np.maximum(0, 1 - CT ** 2))
    return np.float32(np.stack([ST * np.cos(PH), ST * np.sin(PH), CT],
                               -1).reshape(-1, 3))


@pytest.mark.parametrize("name,row,wi", CHI2)
def test_chi2_sample_vs_pdf(name, row, wi):
    """The port's sample() against its own pdf(): a histogram of the
    smooth samples' wo over the sphere against the pdf integrated over
    each bin; then weight == eval / pdf on those samples."""
    n = 1 << 16
    wi = np.float32(wi) / np.linalg.norm(wi)
    _, tp, kinds, _, _ = _params(name, np.full(n, row, np.int32))
    rs = np.random.RandomState(17 + row)
    u2 = torch.from_numpy(np.float32(rs.uniform(size=(n, 2))))
    uc = torch.from_numpy(np.float32(rs.uniform(size=n)))
    wi_t = torch.from_numpy(wi).expand(n, 3)
    bs = bsdf.sample(tp, wi_t, u2, uc, kinds)
    keep = (bs.valid & ~bs.is_delta).numpy()
    wo = bs.wo.numpy()[keep]
    phi = np.arctan2(wo[:, 1], wo[:, 0]) % (2 * np.pi)
    counts, _, _ = np.histogram2d(
        np.clip(wo[:, 2], -1, 1), phi, bins=[CT_BINS, PHI_BINS],
        range=[[-1, 1], [0, 2 * np.pi]])
    dirs = _sphere_dirs()
    K = dirs.shape[0]
    _, pk, _, _, _ = _params(name, np.full(K, row, np.int32))
    vals = bsdf.pdf(pk, torch.from_numpy(wi).expand(K, 3),
                    torch.from_numpy(dirs), kinds).numpy()
    dA = (2.0 / (CT_BINS * NSUB)) * (2 * np.pi / (PHI_BINS * NSUB))
    probs = vals.reshape(CT_BINS, NSUB, PHI_BINS, NSUB).sum((1, 3)) * dA
    total = probs.sum()
    expected = probs * keep.sum() / max(total, 1e-9)
    mask = expected > 8
    chi2 = ((counts[mask] - expected[mask]) ** 2 / expected[mask]).sum()
    dof = mask.sum() - 1
    # the pdf integrates to the share of smooth samples
    assert abs(total - keep.mean()) < 0.03, (total, keep.mean())
    assert chi2 < dof + 5.5 * np.sqrt(2.0 * max(dof, 1)), (chi2, dof)
    # weight == eval / pdf on the smooth samples
    sel = torch.from_numpy(keep) & (bs.pdf > 1e-5)
    f = bsdf.eval(tp, wi_t, bs.wo, kinds)[sel]
    expect = (f / bs.pdf[sel][:, None]).numpy()
    np.testing.assert_allclose(bs.weight[sel].numpy(), expect, rtol=2e-3,
                               atol=2e-5)


@pytest.mark.parametrize("name,row,wi", [
    ("thindielectric", 0, (0.4, -0.2, 0.89)),
    ("thindielectric", 1, (0.6, 0.3, -0.74)),
    ("hk", 0, (0.4, -0.2, 0.89)),
    ("mask", 0, (0.3, 0.5, 0.81)),
    ("coating", 1, (0.3, 0.5, 0.81))])
def test_delta_events_follow_their_pdf(name, row, wi):
    """The delta kinds: each discrete event (thin glass's reflection and
    pass-through, hk's unscattered transmission, a mask's pass-through,
    a smooth coating's layer reflection) is drawn at the rate its pdf
    states, within 5 standard deviations, and goes where it should."""
    n = 1 << 16
    wi = np.float32(wi) / np.linalg.norm(wi)
    _, tp, kinds, _, _ = _params(name, np.full(n, row, np.int32))
    rs = np.random.RandomState(29 + row)
    u2 = torch.from_numpy(np.float32(rs.uniform(size=(n, 2))))
    uc = torch.from_numpy(np.float32(rs.uniform(size=n)))
    wi_t = torch.from_numpy(wi).expand(n, 3)
    bs = bsdf.sample(tp, wi_t, u2, uc, kinds)
    delta = (bs.valid & bs.is_delta).numpy()
    wo = bs.wo.numpy()
    mirror = np.float32([-wi[0], -wi[1], wi[2]])
    through = np.isclose(wo, -wi, atol=1e-6).all(-1)
    reflect = np.isclose(wo, mirror, atol=1e-6).all(-1)
    assert (through | reflect)[delta].all()
    assert delta.any()
    # each event's pdf is constant over the lanes: its probability
    for event in (through, reflect):
        on = delta & event
        if not on.any():
            continue
        p_ev = bs.pdf.numpy()[on]
        np.testing.assert_allclose(p_ev, p_ev[0], rtol=1e-6)
        sd = np.sqrt(n * p_ev[0] * (1 - p_ev[0]))
        assert abs(on.sum() - n * p_ev[0]) < 5 * sd + 1, (on.sum(),
                                                          n * p_ev[0])
    if name == "thindielectric":
        assert through[delta].any() and reflect[delta].any()


def test_thin_dielectric_reflectance():
    """thindielectric.cpp's two-interface reflectance R' = R + (1-R)^2 R /
    (1 - R^2) as sample's reflection pdf, transmittance and specular as
    its weights, and 0 in eval and pdf; the ray that passes goes on
    unbent (wo = -wi)."""
    n = 512
    rs = np.random.RandomState(3)
    _, tp, kinds, _, _ = _params("thindielectric", np.full(n, 1, np.int32))
    wi = _unit(rs, n)
    wi_t = torch.from_numpy(wi)
    F, _ = bsdf.fresnel_dielectric(wi_t[:, 2].abs(), torch.full((n,), 1.33))
    R = (F + (1 - F) ** 2 * F / (1 - F ** 2)).numpy()
    for uc, refl in ((0.0, True), (0.999999, False)):
        bs = bsdf.sample(tp, wi_t, torch.zeros(n, 2), torch.full((n,), uc),
                         kinds)
        assert bs.is_delta.all() and bs.valid.all()
        if refl:
            np.testing.assert_allclose(bs.pdf.numpy(), R, rtol=1e-6)
            np.testing.assert_allclose(bs.weight.numpy(),
                                       np.tile([0.95, 0.9, 0.85], (n, 1)),
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(bs.pdf.numpy(), 1 - R, rtol=1e-5)
            np.testing.assert_array_equal(bs.wo.numpy(), -wi)
            np.testing.assert_allclose(bs.weight.numpy(),
                                       np.tile([0.9, 0.8, 0.7], (n, 1)),
                                       rtol=1e-6)
    wo_t = torch.from_numpy(_unit(rs, n))
    assert not bsdf.eval(tp, wi_t, wo_t, kinds).any()
    assert not bsdf.pdf(tp, wi_t, wo_t, kinds).any()


def test_two_sided_flip_skips_the_sign_handling_kinds():
    """thindielectric, difftrans and hk take signed cosines themselves:
    a two-sided row of theirs lit from below is not flipped (reference
    bsdf._flip_frame); a two-sided diffuse row is."""
    M = PM
    kinds = torch.tensor([M.THIN_DIELECTRIC, M.DIFFTRANS, M.HK, M.DIFFUSE,
                          M.DIELECTRIC, M.ROUGH_DIELECTRIC, M.NULL_BSDF])
    n = kinds.shape[0]
    p = SimpleNamespace(kind=kinds, twosided=torch.ones(n, dtype=torch.bool))
    sign = bsdf._flip_sign(p, torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3))
    assert sign.tolist() == [1.0] * 3 + [-1.0] + [1.0] * 3


def test_irawan_still_raises():
    """Woven cloth, the one kind that raised here (ROADMAP Queue 1 item
    12), is ported (its parity: tests/test_torch_irawan.py): every kind
    of the reference is in PORTED_KINDS, and only a static set that
    names no kind or an unknown one raises."""
    assert {k for k in range(PM.IRAWAN + 1)} <= bsdf.PORTED_KINDS
    n = 4
    z = torch.zeros(n)
    v3 = torch.full((n, 3), 0.5)
    p = bsdf.MatParams(
        kind=torch.full((n,), PM.IRAWAN, dtype=torch.int32),
        twosided=torch.zeros(n, dtype=torch.bool), reflectance=v3,
        specular=v3, transmittance=v3, alpha=z + 10, eta=v3 + 1,
        k=v3 * 0, dist=torch.zeros(n, dtype=torch.int32), fdr_int=z,
        spec_weight=z, alpha_v=z + 10, opacity=z + 1)
    wi = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    f = bsdf.eval(p, wi, wi, frozenset({PM.DIFFUSE, PM.IRAWAN}))
    torch.testing.assert_close(f, v3 / np.pi)   # no cloth: the kd term
    for kinds in (None, frozenset({PM.DIFFUSE, 99})):
        with pytest.raises(ValueError, match="static set"):
            bsdf.eval(p, wi, wi, kinds)


def test_materials_board_path_matches_reference(tmp_path):
    """The board through both packages' path tracers."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "materials_board", os.path.join(root, "tools/materials_board.py"))
    board = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(board)
    scene, st = load(board.write_board(str(tmp_path)), "path", size=16,
                     spp=2, depth=6)
    assert st.has_textures == 4   # the wrappers' bit, no textures
    ref, got, rt, pt = render_both(scene, st, [1], 2, count_rays=True)
    assert pt.kinds == {PM.ROUGH_DIFFUSE, PM.DIFFTRANS, PM.PHONG, PM.WARD,
                        PM.HK, PM.DIFFUSE, PM.ROUGH_CONDUCTOR, PM.BLEND,
                        PM.COATING, bsdf.OPACITY, bsdf.ROUGH_COAT}
    ref, got = ref[0], got[0]
    # the board fills the middle of the frame (measured 39% lit)
    assert np.isfinite(got).all() and (ref.max(-1) > 1e-4).mean() > 0.3
    assert np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    assert int(pt.last_ray_count) == int(rt.last_ray_count) > 0
