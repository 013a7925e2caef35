"""The port's caustics slice against the reference on the CPU: analytic
spheres (the dense quadric solve, the merge with the triangle sweep by
closest t, the sphere branch of fill_intersection), the dielectric and
conductor BSDFs (Fresnel terms, delta-only eval / pdf, sample), and
PathTracer (maxDepth 8, the scene's) and SPPM (maxDepth 5, the zoo's) on
data/scenes/caustics/caustics.xml (a glass and an Ag sphere over a
diffuse floor, ldsampler, gaussian filter) through both factories at
16^2.

Tolerances: sphere ids, hit validity, material / shape ids and every
boolean exactly; sphere t at rtol 1e-6 (XLA's CPU sqrt is not correctly
rounded: it differs from torch's in the last bit on some inputs);
hit-fill positions, normals and uv at rtol 1e-5 / atol 1e-4; Fresnel
terms and the delta lobes' samples at rtol 1e-6 / atol 1e-6 (random
conductor parameters at atol 1e-5); images at
rtol 1e-3 / atol 1e-4 on >= 99% of pixels with equal ray counts."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradientdomain_mitsuba_tpu.ops import bsdf as ref_bsdf
from gradientdomain_mitsuba_tpu.ops import common as ref_common
from gradientdomain_mitsuba_tpu.ops import intersect as ref_isec
from gradientdomain_mitsuba_tpu.scene import scene as ref_scene
from gradientdomain_mitsuba_tpu_torch.models import factory
from gradientdomain_mitsuba_tpu_torch.models.erpt import ERPTracer
from gradientdomain_mitsuba_tpu_torch.models.gbdpt import GBDPTracer
from gradientdomain_mitsuba_tpu_torch.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu_torch.models.mlt import MLTracer
from gradientdomain_mitsuba_tpu_torch.models.path import PathTracer
from gradientdomain_mitsuba_tpu_torch.models.pssmlt import PSSMLTracer
from gradientdomain_mitsuba_tpu_torch.models.sppm import SPPMTracer
from gradientdomain_mitsuba_tpu_torch.ops import bsdf, common, sensor
from gradientdomain_mitsuba_tpu_torch.ops import intersect as isec
from gradientdomain_mitsuba_tpu_torch.scene import bridge
from gradientdomain_mitsuba_tpu_torch.scene.materials import (CONDUCTOR,
                                                              DIELECTRIC,
                                                              DIFFUSE)
from torch_parity import assert_image_close, load, render_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUS = os.path.join(ROOT, "data/scenes/caustics/caustics.xml")
W = H = 16
KINDS = frozenset({DIFFUSE, CONDUCTOR, DIELECTRIC})
DELTA_TOL = dict(rtol=1e-6, atol=1e-6)
FILL_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def scenes():
    """(reference scene as jax arrays, port scene as CPU tensors) from ONE
    numpy load of caustics.xml."""
    s, _ = ref_scene.load_scene(CAUS, {"width": str(W), "height": str(H)})
    return jax.device_put(s), bridge.to_torch(s, "cpu")


def _sphere_rays(n=6000, seed=0):
    """Rays from above the floor aimed near the two spheres (and a few
    past them), unit directions; 10% dead lanes (maxt -1) and a spread of
    finite maxt."""
    rs = np.random.RandomState(seed)
    cen = np.float32([[278, 130, 300], [470, 90, 420]])
    o = np.float32(rs.uniform([0, 20, -300], [600, 500, 700], (n, 3)))
    tgt = cen[rs.randint(0, 2, n)] + np.float32(rs.normal(0, 70, (n, 3)))
    d = tgt - o
    d = np.float32(d / np.linalg.norm(d, axis=1, keepdims=True))
    maxt = np.where(rs.uniform(size=n) < 0.1, -1.0,
                    np.where(rs.uniform(size=n) < 0.3,
                             rs.uniform(0, 900, n), 3e38))
    return o, d, np.zeros(n, np.float32), np.float32(maxt)


def test_intersect_spheres_matches_reference(scenes):
    rs_scene, ts_scene = scenes
    o, d, mint, maxt = _sphere_rays()
    cen = np.concatenate([np.asarray(rs_scene.geom.sph_center),
                          np.float32([[300, 100, 320]])])    # overlapping
    rad = np.concatenate([np.asarray(rs_scene.geom.sph_radius),
                          np.float32([50])])
    rt, rsid = ref_isec.intersect_spheres(*map(jnp.asarray,
                                               (o, d, mint, maxt, cen, rad)))
    pt, psid = isec.intersect_spheres(*map(torch.from_numpy,
                                           (o, d, mint, maxt, cen, rad)))
    np.testing.assert_array_equal(psid.numpy(), np.asarray(rsid))
    assert psid.dtype == torch.int32
    hit = np.asarray(rsid) >= 0
    assert 0.3 < hit.mean() < 0.9
    assert not hit[maxt < 0].any()
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), rtol=1e-6)
    occ_r = ref_isec.occluded_spheres(*map(jnp.asarray,
                                           (o, d, mint, maxt, cen, rad)))
    occ_p = isec.occluded_spheres(*map(torch.from_numpy,
                                       (o, d, mint, maxt, cen, rad)))
    np.testing.assert_array_equal(occ_p.numpy(), np.asarray(occ_r))


def _both_hits(scenes, o, d, mint, maxt):
    """The reference's sphere merge over its matmul sweep, and the port's
    choose_intersector (plain sweep on the CPU + spheres)."""
    rs_scene, ts_scene = scenes
    n_tris = int(ts_scene.geom.indices.shape[0])

    def closest(o, d, mint, maxt, geom):
        return ref_isec.intersect_matmul(o, d, mint, maxt, geom.linC)

    def occl(o, d, mint, maxt, geom):
        return ref_isec.occluded_matmul(o, d, mint, maxt, geom.linC)
    r_closest, r_occl = ref_common.add_sphere_intersections(closest, occl)
    p_closest, p_occl = common.choose_intersector(None, n_tris)
    rargs = tuple(map(jnp.asarray, (o, d, mint, maxt)))
    pargs = tuple(map(torch.from_numpy, (o, d, mint, maxt)))
    return (r_closest(*rargs, rs_scene.geom), p_closest(*pargs, ts_scene.geom),
            r_occl(*rargs, rs_scene.geom), p_occl(*pargs, ts_scene.geom))


def test_sphere_merge_matches_reference(scenes):
    """Sphere hits replace farther triangle hits, the prim id carries
    SPHERE_PRIM_BASE + sphere, u = v = 0; the any-hit query ORs the
    sphere test in."""
    o, d, mint, maxt = _sphere_rays(seed=1)
    rh, ph, ro, po = _both_hits(scenes, o, d, mint, maxt)
    assert common.SPHERE_PRIM_BASE == ref_common.SPHERE_PRIM_BASE
    np.testing.assert_array_equal(ph.prim.numpy(), np.asarray(rh.prim))
    np.testing.assert_array_equal(ph.valid.numpy(), np.asarray(rh.valid))
    np.testing.assert_allclose(ph.t.numpy(), np.asarray(rh.t), rtol=1e-6)
    sph = ph.prim.numpy() >= common.SPHERE_PRIM_BASE
    tri = ph.valid.numpy() & ~sph
    assert sph.sum() > 1000 and tri.sum() > 500
    assert (ph.u.numpy()[sph] == 0).all() and (ph.v.numpy()[sph] == 0).all()
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro))


def test_fill_intersection_on_sphere_lanes(scenes):
    """The sphere branch: the exact quadric normal, lat-long uv, the
    sphere's bsdf and shape ids, no emitter; camera rays and rays at the
    spheres, triangle lanes alongside."""
    rs_scene, ts_scene = scenes
    rs = np.random.RandomState(2)
    pos = np.float32(rs.uniform(0, 1, (3000, 2)) * [W, H])
    u_ap = np.float32(rs.uniform(size=(3000, 2)))
    co, cd = sensor.sample_ray(sensor.describe(ts_scene.camera), W, H,
                               torch.from_numpy(pos),
                               torch.from_numpy(u_ap))
    o, d, mint, maxt = _sphere_rays(3000, seed=3)
    o = np.concatenate([co.numpy(), o])
    d = np.concatenate([cd.numpy(), d])
    mint = np.zeros(len(o), np.float32)
    maxt = np.concatenate([np.full(3000, 3e38, np.float32), maxt])
    rh, ph, _, _ = _both_hits(scenes, o, d, mint, maxt)
    ri = ref_common.fill_intersection(rs_scene, jnp.asarray(o),
                                      jnp.asarray(d), rh)
    pi = common.fill_intersection(ts_scene, torch.from_numpy(o),
                                  torch.from_numpy(d), ph)
    sph = ph.prim.numpy() >= common.SPHERE_PRIM_BASE
    assert sph[:3000].sum() > 100 and sph[3000:].sum() > 1000
    for f in ("valid", "prim_id", "shape_id", "bsdf_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(pi, f).numpy(),
                                      np.asarray(getattr(ri, f)), err_msg=f)
    assert set(pi.bsdf_id.numpy()[sph]) == {2, 3}
    assert (pi.emitter_id.numpy()[sph] == -1).all()
    for f in ("p", "ng", "ns", "uv"):
        np.testing.assert_allclose(getattr(pi, f).numpy(),
                                   np.asarray(getattr(ri, f)),
                                   err_msg=f, **FILL_TOL)
    n = pi.ns.numpy()[sph]
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


def test_fresnel_matches_reference():
    rs = np.random.RandomState(4)
    n = 20000
    ci = np.float32(rs.uniform(-1, 1, n))
    ci[:8] = [1, -1, 0, 1e-7, -1e-7, 0.5, -0.5, 1e-30]
    eta = np.float32(rs.uniform(0.4, 2.6, n))
    for r, p in zip(ref_bsdf.fresnel_dielectric(jnp.asarray(ci),
                                                jnp.asarray(eta)),
                    bsdf.fresnel_dielectric(torch.from_numpy(ci),
                                            torch.from_numpy(eta))):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **DELTA_TOL)
    # the scene's Ag row at DELTA_TOL; random eta and k at atol 1e-5:
    # near F = 0 the difference t1 - t2 cancels and magnifies the two
    # packages' last-bit sqrt difference
    s, _ = ref_scene.load_scene(CAUS, {"width": "8", "height": "8"})
    ag = np.asarray(s.materials.packed)[3]
    for e3, k3, tol in (
            (np.broadcast_to(ag[12:15], (n, 3)),
             np.broadcast_to(ag[15:18], (n, 3)), DELTA_TOL),
            (np.float32(rs.uniform(0.05, 3, (n, 3))),
             np.float32(rs.uniform(0, 6, (n, 3))),
             dict(rtol=1e-6, atol=1e-5))):
        e3, k3 = np.ascontiguousarray(e3), np.ascontiguousarray(k3)
        r = ref_bsdf.fresnel_conductor(jnp.asarray(ci), jnp.asarray(e3),
                                       jnp.asarray(k3))
        p = bsdf.fresnel_conductor(torch.from_numpy(ci),
                                   torch.from_numpy(e3), torch.from_numpy(k3))
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("twosided", [False, True])
def test_delta_bsdfs_match_reference(scenes, twosided):
    """caustics' materials (diffuse floor and wall, glass, Ag) on random
    directions in both hemispheres: eval and pdf bit for bit (0 on the
    delta rows), and on the conductor and dielectric rows the sampled
    direction, weight, pdf, eta, delta flag and validity.  twosided=True
    flags every row two-sided: the conductor flips its frame when lit
    from the back, the dielectric never does."""
    rs_scene, ts_scene = scenes
    rs = np.random.RandomState(5)
    n = 20000
    mid = rs.randint(0, 5, n).astype(np.int32)
    wi, wo = (np.float32(rs.normal(size=(n, 3))) for _ in range(2))
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u2 = np.float32(rs.uniform(size=(n, 2)))
    uc = np.float32(rs.uniform(size=n))
    rp = ref_bsdf.gather_params(rs_scene.materials, jnp.asarray(mid))
    pp = bsdf.gather_params(ts_scene.materials, torch.from_numpy(mid))
    if twosided:
        rp = rp._replace(twosided=jnp.ones(n, bool))
        pp = pp._replace(twosided=torch.ones(n, dtype=torch.bool))
    T = torch.from_numpy
    for name in ("eval", "pdf"):
        r = getattr(ref_bsdf, name)(rp, jnp.asarray(wi), jnp.asarray(wo),
                                    KINDS)
        p = getattr(bsdf, name)(pp, T(wi), T(wo), KINDS)
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
    rsam = ref_bsdf.sample(rp, jnp.asarray(wi), jnp.asarray(u2),
                           jnp.asarray(uc), KINDS)
    psam = bsdf.sample(pp, T(wi), T(u2), T(uc), KINDS)
    delta = np.isin(mid, (2, 3))
    assert np.asarray(rsam.is_delta)[delta].all()
    for f in ("is_delta", "valid", "eta"):
        np.testing.assert_array_equal(getattr(psam, f).numpy(),
                                      np.asarray(getattr(rsam, f)), err_msg=f)
    for f in ("wo", "weight", "pdf"):
        np.testing.assert_allclose(getattr(psam, f).numpy()[delta],
                                   np.asarray(getattr(rsam, f))[delta],
                                   err_msg=f, **DELTA_TOL)
    # both dielectric lobes and the conductor's back side are exercised
    refr = (mid == 2) & (psam.eta.numpy() != 1.0)
    assert refr.sum() > 1000 and ((mid == 2) & ~refr).sum() > 100
    back = (mid == 3) & (wi[:, 2] < 0)
    assert psam.valid.numpy()[back].all() == twosided


def test_path_matches_reference_on_caustics():
    """PathTracer at the scene's maxDepth 8 through delta vertices: the
    NEE shadow ray is traced at every vertex, delta ones too, so the ray
    counts are equal; RR uses throughput * eta^2."""
    scene, st = load(CAUS, "path", size=W, spp=2, depth=8)
    assert st.sampler == "ldsampler" and st.rfilter == "gaussian"
    (ref,), (got,), rt, pt = render_both(scene, st, [0], 2, count_rays=True)
    assert type(pt) is PathTracer
    assert pt.last_ray_count == int(rt.last_ray_count)
    assert_image_close(got, ref)
    assert ref.mean() > 1e-3


SHIFTED = (('<translate x="278" y="0" z="300"/>',
            '<translate x="278" y="3.71" z="300"/>'),
           ('<translate x="278" y="350" z="800"/>',
            '<translate x="278" y="350" z="801.37"/>'))
SPPM_PROPS = {"photonCount": 8192, "initialRadius": 7.3}


@pytest.fixture(scope="module")
def shifted_caustics(tmp_path_factory):
    """caustics.xml with the floor at y = 3.71 and the wall at
    z = 801.37, off every multiple of both passes' gather radii (7.3 and
    its shrunk successor)."""
    txt = open(CAUS).read()
    for a, b in SHIFTED:
        assert a in txt
        txt = txt.replace(a, b)
    path = tmp_path_factory.mktemp("caustics") / "caustics-shifted.xml"
    path.write_text(txt)
    return str(path)


def test_sppm_matches_reference_off_cell_boundaries(shifted_caustics):
    """Same seed, on a copy of the scene whose surfaces sit off the hash
    grid's cell boundaries: a deposit within an ulp of a boundary (the
    original floor lies on y = 0) changes cell when its hit point moves by
    one rounding, and the two packages' sqrt, sin and cos differ in the
    last bit.  Photons refracted by the glass sphere and reflected by the
    Ag sphere deposit on the floor in both packages alike."""
    scene, st = load(shifted_caustics, "sppm", size=W, spp=2, depth=5,
                     props=SPPM_PROPS)
    (ref,), (got,), rt, pt = render_both(scene, st, [3], 2)
    assert type(pt) is SPPMTracer
    assert_image_close(got, ref)
    assert ref.mean() > 1e-3

    # caustic photons: deposits at a bounce whose previous vertex was a
    # delta sphere vertex; the same lanes in both packages
    ts = bridge.to_torch(scene, "cpu")
    pos, _, _, ok = pt._emit_photons(ts, 3, 0)
    rpos, _, _, rok = jax.jit(lambda sc: rt._emit_photons(sc, 3, 0))(
        jax.device_put(scene))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    # the glass sphere focuses: a last-bit difference of a refracted
    # direction lands up to a few hundredths apart on the floor (every
    # deposit within rtol 1e-3 / atol 1e-2, >= 99% at FILL_TOL)
    got, ref = pos.numpy()[ok.numpy()], np.asarray(rpos)[ok.numpy()]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2)
    assert np.isclose(got, ref, **FILL_TOL).all(-1).mean() >= 0.99
    ok = ok.numpy().reshape(-1, pt.n_photons)
    assert (~ok[0] & ok[1]).sum() > 50


def test_sppm_mean_on_caustics():
    """On caustics.xml itself (floor on a cell boundary) the two renders
    are held by mean, within 1%."""
    scene, st = load(CAUS, "sppm", size=W, spp=2, depth=5, props=SPPM_PROPS)
    (ref,), (got,), _, _ = render_both(scene, st, [3], 2)
    assert np.isfinite(got).all() and ref.mean() > 1e-3
    assert abs(got.mean() - ref.mean()) <= 1e-2 * ref.mean()


@pytest.mark.parametrize("integrator,cls", [
    ("pssmlt", PSSMLTracer), ("mlt", MLTracer), ("erpt", ERPTracer)])
def test_factory_builds_chain_families_on_caustics(integrator, cls):
    scene, st = load(CAUS, integrator, size=W, spp=2, depth=8)
    assert type(factory.make_integrator(bridge.to_torch(scene, "cpu"),
                                        st)) is cls


@pytest.mark.parametrize("integrator,cls", [("gpt", GPTracer),
                                             ("gbdpt", GBDPTracer)])
def test_factory_builds_gradient_tracers_on_caustics(integrator, cls):
    """The glass and Ag spheres classify specular: both gradient tracers
    take the half-vector shift (their parity with the reference:
    test_torch_specular.py, test_torch_gbdpt_specular.py)."""
    scene, st = load(CAUS, integrator, size=W, spp=2, depth=8)
    tracer = factory.make_integrator(bridge.to_torch(scene, "cpu"), st)
    assert type(tracer) is cls and tracer.any_specular
