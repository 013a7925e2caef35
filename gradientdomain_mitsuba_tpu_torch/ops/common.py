"""Scene-level intersection wrappers: traversal + hit-record fill.

Counterpart of gradientdomain_mitsuba_tpu/ops/common.py (Scene::
rayIntersect + Shape::fillIntersectionRecord, src/librender/scene.cpp,
shape.cpp, trimesh.cpp): traversal returns (t, u, v, prim); this module
gathers vertex attributes and material/emitter ids into the flat
Intersection record every integrator uses.

Ported: the small-scene (<= 2048 triangles) traversal through the sweep
kernels, the large-scene traversal through the pair kernels (or, under
GDMT_KERNEL=v4, the v4 block kernels) or, for a large scene without
clusters, the reference's plain cluster traversal, analytic spheres merged by
closest t (their exact normals and lat-long uv in the hit fill), the
hit fill with the barycentric payload (vertex colors, wireframe edge
distance, the yarn azimuth of woven cloth) and the bump / normal map
perturbation, the material gather under every has_textures bit
(reflectance textures, textured mask opacity, the blend / coating
wrappers' child rows, textured blend weights, woven cloth's yarn
segment), and the primary hits' uv footprint and its ellipse for the
anisotropic filter.  The reference's one-hot matmul gather
(fast_row_gather) is a TPU workaround; here it is plain indexing.
"""
from __future__ import annotations

import math
import os

import torch

from ..core import math as m
from ..core.spectrum import luminance
from ..core.records import Intersection, tree_map
from . import intersect as isec
from . import sweep, trace
from ..utils import stats

BRUTE_FORCE_MAX_TRIS = 2048


# prim-id namespace for analytic spheres (above any padded triangle count)
SPHERE_PRIM_BASE = 1 << 28


def add_sphere_intersections(closest_tri, occl_tri):
    """Merge analytic-sphere hits (intersect.intersect_spheres) into the
    triangle traversal by closest t: the sphere test runs with the
    triangle hit's t as its maxt, so a sphere hit is the nearer one.
    Scenes without analytic spheres pass straight through."""

    def closest(o, d, mint, maxt, geom):
        hit = closest_tri(o, d, mint, maxt, geom)
        if geom.sph_center.shape[0] == 0:
            return hit
        tri_t = torch.where(hit.valid, hit.t, maxt)
        ts, sid = isec.intersect_spheres(o, d, mint, tri_t,
                                         geom.sph_center, geom.sph_radius)
        sph = sid >= 0
        return isec.Hit(
            t=torch.where(sph, ts, hit.t),
            u=torch.where(sph, 0.0, hit.u),
            v=torch.where(sph, 0.0, hit.v),
            prim=torch.where(sph, SPHERE_PRIM_BASE + sid, hit.prim),
            valid=hit.valid | sph)

    def occluded(o, d, mint, maxt, geom):
        occ = occl_tri(o, d, mint, maxt, geom)
        if geom.sph_center.shape[0] == 0:
            return occ
        return occ | isec.occluded_spheres(o, d, mint, maxt,
                                           geom.sph_center, geom.sph_radius)

    closest.kernel = getattr(closest_tri, "kernel", None)
    occluded.kernel = getattr(occl_tri, "kernel", None)
    return closest, occluded


def choose_intersector(settings, n_tris: int, n_clusters: int = 0):
    """Returns (closest, occluded) with signature (o, d, mint, maxt, geom).

    Scenes of at most BRUTE_FORCE_MAX_TRIS triangles sweep the whole soup
    (ops/sweep.py: the CUDA kernels on a CUDA tensor, the plain linear-MT
    version on a CPU tensor).  Larger scenes walk the clustered soup with
    the pair kernels (ops/trace.py, the reference's default v7 kernel):
    the CUDA kernels on a CUDA tensor, their plain version on a CPU
    tensor.  GDMT_KERNEL, read here at each call as the reference reads
    it, selects the traversal: "pairs" (the default) the pair kernels,
    any other value the v4 block kernels (make_mt_intersector /
    make_mt_occluder, same tables, same results).  Each returned function
    carries the kernel wrapper it calls as `.kernel` (its `.launches`
    counts launches).

    A larger scene without clusters walks the reference's plain
    two-level traversal (intersect.make_cluster_intersector /
    make_cluster_occluder, on tris and clusters) on every device, as the
    reference's fallthrough does; it has no kernel (`.kernel` is None).

    Deviation: on the CPU the reference walks large scenes with clusters
    by that traversal too; the port runs the pair kernels' plain version
    there, as it runs the sweep kernels' plain version for small scenes,
    so the CPU path checks the arithmetic the card runs."""
    if n_tris <= BRUTE_FORCE_MAX_TRIS:
        closest_k = sweep.make_sweep_intersector(n_tris)
        occl_k = sweep.make_sweep_occluder(n_tris)

        def closest(o, d, mint, maxt, geom):
            return closest_k(o, d, mint, maxt, geom.linC)

        def occl(o, d, mint, maxt, geom):
            return occl_k(o, d, mint, maxt, geom.linC)
    elif n_clusters > 0:
        if os.environ.get("GDMT_KERNEL", "pairs") == "pairs":
            make_closest = trace.make_pair_intersector
            make_occl = trace.make_pair_occluder
        else:
            make_closest = trace.make_mt_intersector
            make_occl = trace.make_mt_occluder
        closest_k = make_closest(settings.cluster_window, n_clusters)
        occl_k = make_occl(settings.cluster_window, n_clusters)

        def closest(o, d, mint, maxt, geom):
            return closest_k(o, d, mint, maxt, geom.mt_slabs, geom.cbounds)

        def occl(o, d, mint, maxt, geom):
            return occl_k(o, d, mint, maxt, geom.mt_slabs, geom.cbounds)
    else:
        closest_k = occl_k = None
        closest_c = isec.make_cluster_intersector(settings.cluster_window)
        occl_c = isec.make_cluster_occluder(settings.cluster_window)

        def closest(o, d, mint, maxt, geom):
            return closest_c(o, d, mint, maxt, geom.tris, geom.clusters)

        def occl(o, d, mint, maxt, geom):
            return occl_c(o, d, mint, maxt, geom.tris, geom.clusters)
    closest.kernel = closest_k
    occl.kernel = occl_k
    return add_sphere_intersections(closest, occl)


def instrument_intersectors(tracer, closest, occluded):
    """Wrap the intersectors with a device-side ray counter: while
    `tracer.ray_tally` is a tensor, every traversal call adds the number
    of lanes with positive extent (maxt > 0; dead wavefront lanes carry
    maxt = -1).  The count stays on the device until the caller reads
    it once at the end.  Each call is also a `traverse` span of the
    program's trace (utils/stats.py) that counts the lanes it was sent,
    live or dead (a host integer)."""

    def closest_w(o, d, mint, maxt, geom):
        with stats.span("traverse", kind="closest"):
            stats.count("lanes", o.shape[0])
            if tracer.ray_tally is not None:
                tracer.ray_tally += (maxt > 0).sum()
            return closest(o, d, mint, maxt, geom)

    def occluded_w(o, d, mint, maxt, geom):
        with stats.span("traverse", kind="occluded"):
            stats.count("lanes", o.shape[0])
            if tracer.ray_tally is not None:
                tracer.ray_tally += (maxt > 0).sum()
            return occluded(o, d, mint, maxt, geom)

    return closest_w, occluded_w


def fast_row_gather(table, idx):
    """table[idx] for a [T, C] table and integer idx [...].  The
    reference routes small tables through a one-hot matmul on the TPU,
    where row gathers are latency-bound; on the GPU a gather is the
    fast path, so this is plain indexing."""
    return table[idx.long()]


def fill_intersection(scene, o, d, hit) -> Intersection:
    """Shading data for Hit records via ONE packed-row gather of the
    BVH-ordered tri_shade table (see scene.Geometry).  Two branches are
    chosen by the tables' static widths, as in the reference: the bump /
    normal map perturbation when the material table has its 32 columns,
    the barycentric payload (Intersection.bary [N, 6]) when tri_shade
    has its 41; otherwise bary is None."""
    g = scene.geom
    prim = torch.clamp(hit.prim, 0, g.tri_shade.shape[0] - 1)
    row = g.tri_shade[prim.long()]     # [N, 29] or [N, 41]

    u = hit.u[..., None]
    v = hit.v[..., None]
    w = 1.0 - u - v
    # missed lanes carry t = F32_MAX; an inf position would turn later
    # masked arithmetic into 0*NaN — keep them finite instead
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    p = o + t_safe[..., None] * d
    ng = row[..., 0:3]
    ns = row[..., 3:6] * w + row[..., 6:9] * u + row[..., 9:12] * v
    ns = m.normalize(ns)
    ns_ok = m.squared_length(ns) > 0.5
    use_face_n = row[..., 21] > 0.5
    ns = torch.where((use_face_n | ~ns_ok)[..., None], ng, ns)
    uv = row[..., 12:14] * w + row[..., 14:16] * u + row[..., 16:18] * v

    bsdf_id = row[..., 18].to(torch.int32)
    emitter_id = row[..., 19].to(torch.int32)
    shape_id = row[..., 20].to(torch.int32)

    has_sph = g.sph_center.shape[0] > 0
    if has_sph:
        # analytic-sphere lanes: exact quadric normals + lat-long uv
        # (z-up, matching meshes.make_sphere / sphere.cpp)
        is_sph = hit.prim >= SPHERE_PRIM_BASE
        sid = torch.clamp(hit.prim - SPHERE_PRIM_BASE, 0,
                          g.sph_center.shape[0] - 1).long()
        cen = g.sph_center[sid]
        rad = g.sph_radius[sid]
        n_s = m.normalize((p - cen) / torch.clamp_min(rad, 1e-12)[..., None])
        theta = torch.arccos(torch.clamp(n_s[..., 2], -1.0, 1.0))
        phi = torch.atan2(n_s[..., 1], n_s[..., 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        uv_s = torch.stack([phi / (2 * math.pi), 1.0 - theta / math.pi], -1)
        s3 = is_sph[..., None]
        # sphere lanes must not inherit the clamped triangle row's
        # tangents (columns 23 and up: the perturbation and the payload
        # read them)
        keep = (torch.arange(row.shape[-1], device=row.device) < 23).to(
            row.dtype)
        row = torch.where(s3, row * keep, row)
        ng = torch.where(s3, n_s, ng)
        ns = torch.where(s3, n_s, ns)
        uv = torch.where(s3, uv_s, uv)
        bsdf_id = torch.where(is_sph, g.sph_bsdf[sid], bsdf_id)
        emitter_id = torch.where(is_sph, -1, emitter_id)
        shape_id = torch.where(is_sph, g.sph_shape[sid], shape_id)

    if scene.materials.packed.shape[1] >= 32:
        # bumpmap / normalmap (src/bsdfs/{bumpmap,normalmap}.cpp)
        ns = _perturb_normal(scene, row, bsdf_id, uv, ns)

    bary = None
    if g.tri_shade.shape[-1] >= 41:
        # the barycentric payload (scene.py widens tri_shade when a
        # vertexcolors / wireframe texture or a woven-cloth BSDF is
        # bound): columns 29:38 the vertex colors, 38:41 the triangle's
        # heights 2A / |opposite edge|, so bary_i * h_i is the world
        # distance to edge i and their min the wireframe edge distance
        hu, hv = hit.u, hit.v
        wb = 1.0 - hu - hv
        vc = (row[..., 29:32] * wb[..., None] + row[..., 32:35] *
              hu[..., None] + row[..., 35:38] * hv[..., None])
        edist = torch.minimum(
            torch.minimum(wb * row[..., 38], hu * row[..., 39]),
            hv * row[..., 40])
        # the azimuth of dp/du in the canonical shading frame built from
        # ns (the yarn orientation of woven cloth, ops/irawan.py)
        ss_f, ts_f = m.build_frame(ns)
        dpdu = row[..., 23:26]
        fc = torch.sum(dpdu * ss_f, -1)
        fs = torch.sum(dpdu * ts_f, -1)
        flen = torch.sqrt(fc * fc + fs * fs)
        ok_f = flen > 1e-12
        fl_safe = torch.where(ok_f, flen, 1.0)
        fc = torch.where(ok_f, fc / fl_safe, 1.0)
        fs = torch.where(ok_f, fs / fl_safe, 0.0)
        if has_sph:
            # sphere lanes: white, no edge, the frame's own s
            vc = torch.where(is_sph[..., None], 1.0, vc)
            edist = torch.where(is_sph, 3.4e38, edist)
            fc = torch.where(is_sph, 1.0, fc)
            fs = torch.where(is_sph, 0.0, fs)
        bary = torch.cat([vc, torch.stack([edist, fc, fs], -1)], -1)
    return Intersection(
        valid=hit.valid,
        t=hit.t,
        p=p,
        ng=ng,
        ns=ns,
        uv=uv,
        prim_id=torch.where(hit.valid, hit.prim, -1),
        shape_id=torch.where(hit.valid, shape_id, -1),
        bsdf_id=torch.where(hit.valid, bsdf_id, -1),
        emitter_id=torch.where(hit.valid, emitter_id, -1),
        bary=bary,
    )


def _perturb_normal(scene, row, bsdf_id, uv, ns):
    """The shading normal of bumpmap / normalmap lanes (packed column 28:
    mode 1 bump, 2 normal; 29 the texture id; 30 the bump scale).

    row: the tri_shade gather (columns 23:26 dp/du, 26:29 dp/dv).  A
    normal map rotates the tangent-space normal 2 rgb - 1 into the
    UV-aligned TBN frame; a bump map displaces the tangents by the
    finite-differenced height (luminance, step 5e-4 in uv) and crosses
    them (bumpmap.cpp's getFrame).  Lanes without both tangents (analytic
    spheres, degenerate uv) keep ns."""
    from .texture import eval_texture
    mrow = scene.materials.packed[torch.clamp_min(bsdf_id, 0).long()]
    mode = mrow[..., 28].to(torch.int32)
    ptex = torch.clamp_min(mrow[..., 29].to(torch.int32), 0)
    scale = mrow[..., 30]

    dpdu = row[..., 23:26]
    dpdv = row[..., 26:29]
    ok_tb = ((m.squared_length(dpdu) > 1e-20) &
             (m.squared_length(dpdv) > 1e-20))

    # normalmap: ns' = TBN (2 rgb - 1)
    tex0 = eval_texture(scene.textures, ptex, uv)
    tval = 2.0 * tex0 - 1.0
    su_raw = dpdu - ns * m.dot(ns, dpdu, keepdims=True)
    su = m.normalize(torch.where(ok_tb[..., None], su_raw, ns))
    sv = m.cross(ns, su)
    n_nm = m.normalize(su * tval[..., 0:1] + sv * tval[..., 1:2] +
                       ns * torch.clamp_min(tval[..., 2:3], 1e-3))

    # bumpmap: displaced tangents, finite-differenced height gradient
    e = 5e-4
    h0 = luminance(tex0)
    zero = torch.zeros_like(h0)
    eu = torch.stack([torch.full_like(h0, e), zero], -1)
    ev = torch.stack([zero, torch.full_like(h0, e)], -1)
    hu = luminance(eval_texture(scene.textures, ptex, uv + eu))
    hv = luminance(eval_texture(scene.textures, ptex, uv + ev))
    e32 = torch.tensor(e, dtype=torch.float32, device=uv.device)
    dhdu = (hu - h0) / e32 * scale
    dhdv = (hv - h0) / e32 * scale
    n_bm = m.normalize(m.cross(dpdu + ns * dhdu[..., None],
                               dpdv + ns * dhdv[..., None]))
    n_bm = n_bm * torch.sign(m.dot(n_bm, ns, keepdims=True))

    use_nm = ((mode == 2) & ok_tb)[..., None]
    use_bm = ((mode == 1) & ok_tb)[..., None]
    return torch.where(use_nm, n_nm, torch.where(use_bm, n_bm, ns))


def _twice(x):
    """x (a tensor, an (area, ellipse) footprint or None) repeated along
    its first axis."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(torch.cat([a, a]) for a in x)
    return torch.cat([x, x])


def material_params(scene, has_textures, bsdf_id, uv, uv_footprint=None,
                    bary=None):
    """BSDF parameters of a batch of hits under the static has_textures
    mask (scene.compile_scene), as the reference resolves them: bit 0
    reflectance textures (uv_footprint: the primary hits' footprint for
    the mip level, or (area, ellipse) for the anisotropic filter; None =
    finest), bit 1 the mask's textured opacity, bit 2 (BLEND / COATING
    rows present) the wrapper rows' children one level deep (the params
    are child0's, the lane's own row where it is not a wrapper, with
    MatParams.blend the second child's, blend weight 0 off BLEND lanes,
    and the coat* fields the COATING row's layer), bit 3 the BLEND rows'
    textured weight, bit 4 woven cloth's yarn segment (MatParams.cloth,
    from bary's azimuth; without bary cloth stays None and eval falls
    back to its diffuse term, as in the reference).  bary: the hits'
    barycentric payload (Intersection.bary) for vertexcolors,
    wireframe and cloth.

    The wrapper's own fields are raw row columns, so its two children
    resolve as ONE batch of 2N lanes, and the textures of a batch (albedo
    without a footprint, opacity, blend weight) as one lookup
    (texture.resolve): each lane computes what it computes alone, with
    a fraction of the host's calls."""
    from . import bsdf as bsdf_ops
    from . import texture
    from ..scene.materials import BLEND, COATING
    bits = int(has_textures)
    mid = torch.clamp_min(bsdf_id, 0)
    ids, uv_c, bary_c, fp_c = mid, uv, bary, uv_footprint
    wrap = None
    if bits & 4:
        wrap = bsdf_ops.gather_params(scene.materials, mid)
        is_b = wrap.kind == BLEND
        is_c = wrap.kind == COATING
        ids = torch.cat([torch.where(is_b | is_c, wrap.child0, mid),
                         torch.where(is_b, wrap.child1, mid)])
        uv_c, bary_c, fp_c = _twice(uv), _twice(bary), _twice(uv_footprint)

    lookups = []
    if bits & 1:
        lookups.append(("albedo", ids, uv_c, bary_c))
    if bits & 2:
        lookups.append(("opacity", ids, uv_c, bary_c))
    if wrap is not None and bits & 8:
        lookups.append(("blend_weight", mid, uv, bary))
    vals = {}
    if bits & 1 and fp_c is not None:
        vals["albedo"] = texture.resolve(scene, lookups[:1], fp_c)[0]
        lookups = lookups[1:]
    vals.update(zip([what for what, *_ in lookups],
                    texture.resolve(scene, lookups)))
    p = bsdf_ops.gather_params(scene.materials, ids,
                               albedo_override=vals.get("albedo"),
                               opacity_override=vals.get("opacity"))
    if bits & 16 and bary is not None:
        from .irawan import resolve_features
        p = p._replace(cloth=resolve_features(scene, ids, uv_c, bary_c))
    if wrap is None:
        return p
    pa, pb = (tree_map(lambda a, h=h: a.chunk(2)[h], p) for h in (0, 1))
    w = torch.where(is_b, wrap.blend_w, 0.0)
    if "blend_weight" in vals:
        w = torch.where(is_b, vals["blend_weight"], w)
    return pa._replace(
        blend=pb, blend_w=w,
        coat=is_c, coat_eta=torch.clamp_min(wrap.eta[..., 0], 1.0 + 1e-4),
        coat_sigma=wrap.transmittance, coat_spec=wrap.specular,
        coat_alpha=torch.where(is_c, wrap.alpha_v, 0.0),
        coat_dist=wrap.dist)


def primary_uv_footprint(scene, W, H, d, its):
    """UV-space area of one pixel's footprint at a camera-ray hit — the
    mipmap level source (the reference's stand-in for camera-ray
    differentials; secondary bounces sample the finest level in both).
    Pixel solid angle ~ (A_img / (W H)) cos^3(theta_cam); projected
    surface area = t^2 omega / |cos(ng, d)|; converted to UV with the
    hit triangle's uv-per-world-area density (tri_shade column 22).
    Analytic-sphere lanes have no density row: 0, the finest level."""
    cos_hit = torch.clamp_min(torch.abs(m.dot(its.ng, d)), 1e-4)
    area = (torch.where(its.valid, its.t, 0.0) ** 2 *
            _pixel_solid_angle(scene, W, H, d) / cos_hit)
    tri_shade = scene.geom.tri_shade
    prim = torch.clamp(its.prim_id, 0, tri_shade.shape[0] - 1)
    uvd = tri_shade[prim.long(), 22]
    uvd = torch.where(its.prim_id >= SPHERE_PRIM_BASE, 0.0, uvd)
    return area * uvd


def _pixel_solid_angle(scene, W, H, d):
    """Solid angle of one pixel around camera direction d:
    (A_img / (W H)) cos^3(theta_cam)."""
    from .sensor import image_area
    cam = scene.camera
    fwd = cam.to_world[:3, 2]
    cos_cam = torch.clamp_min(m.dot(d, fwd.expand(d.shape)), 1e-6)
    return (image_area(cam) / (W * H)) * cos_cam ** 3


def primary_uv_jacobian(scene, W, H, d, its):
    """The footprint ellipse's axes in uv at primary hits [..., 2, 2]
    (columns the axes), the anisotropic filter's input (ops/texture.py).

    The pixel's solid-angle disk projects onto the hit's tangent plane:
    the major axis along the in-plane projection of the view ray
    (elongated by 1 / |cos|), the minor axis across it; both go to uv
    through the dual basis of the triangle's dp/du, dp/dv.  As in the
    reference, perspective divergence within a pixel is ignored (a
    deviation from mipmap.h's ray-differential EWA)."""
    cos_hit = torch.clamp_min(torch.abs(m.dot(its.ng, d)), 1e-2)
    area_w = (torch.where(its.valid, its.t, 0.0) ** 2 *
              _pixel_solid_angle(scene, W, H, d) / cos_hit)
    r = torch.sqrt(area_w * cos_hit / math.pi)

    ng = its.ng
    dir_t = d - ng * m.dot(ng, d, keepdims=True)
    lt = torch.sqrt(m.squared_length(dir_t))
    # normal incidence: any tangent direction works
    dir_maj = torch.where((lt > 1e-6)[..., None],
                          dir_t / torch.clamp_min(lt, 1e-6)[..., None],
                          m.build_frame(ng)[0])
    a1 = dir_maj * (r / cos_hit)[..., None]
    a2 = m.cross(ng, dir_maj) * r[..., None]

    tri_shade = scene.geom.tri_shade
    row = tri_shade[torch.clamp(its.prim_id, 0,
                                tri_shade.shape[0] - 1).long()]
    dpdu = row[..., 23:26]
    dpdv = row[..., 26:29]
    E = m.dot(dpdu, dpdu)
    F = m.dot(dpdu, dpdv)
    G2 = m.dot(dpdv, dpdv)
    det = E * G2 - F * F
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)

    def to_uv(a):
        bu = m.dot(dpdu, a)
        bv = m.dot(dpdv, a)
        return ((G2 * bu - F * bv) * inv_det,
                (E * bv - F * bu) * inv_det)

    du1, dv1 = to_uv(a1)
    du2, dv2 = to_uv(a2)
    return torch.stack([torch.stack([du1, du2], -1),
                        torch.stack([dv1, dv2], -1)], -2)


def offset_ray_origin(p, ng, d, eps):
    """Spawn-point offset along the geometric normal, signed toward the ray
    direction (replaces Mitsuba's Epsilon-scaled mint handling)."""
    sign = torch.sign(m.dot(ng, d, keepdims=True))
    return p + ng * sign * eps
