"""Shared pieces of the reference renderer: the scene on the device, the
camera, hit records, area-light sampling and the diffuse BSDF.

Semantics are Mitsuba's (perspective.cpp, diffuse.cpp, area.cpp and the
path tracer's NEE): camera rays through the film position (pixel +
jitter) of the sample-to-camera matrix; the shading normal interpolates
the vertex normals with the hit's barycentrics; NEE picks one area
emitter uniformly, a triangle of it by area and a point uniformly on the
triangle (b0 = 1 - sqrt(1 - u0), b1 = sqrt(1 - u0) u1); ray origins are
offset by the scene's epsilon along the geometric normal, toward the
ray.  Everything runs in the dtype the scene is put on the device in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .accel import Accel


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.clamp_min(torch.sqrt(torch.clamp_min(dot(v, v), 0.0)),
                               1e-20)[..., None]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def mis(a, b):
    """Power heuristic (beta = 2)."""
    a2 = a * a
    return torch.where(a > 0, a2 / torch.clamp_min(a2 + b * b, 1e-30), 0.0)


def frame(n):
    """Orthonormal (s, t) around the unit normal n (Duff et al. 2017)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], -1)
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return s, t


def to_local(v, s, t, n):
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], -1)


def to_world(v, s, t, n):
    return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n


def offset(p, ng, d, eps):
    return p + ng * torch.sign(dot(ng, d))[..., None] * eps


def _point(m, p):
    """4x4 matrix m applied to points p [..., 3] (homogeneous divide)."""
    r = [p[..., 0] * m[i, 0] + p[..., 1] * m[i, 1] + p[..., 2] * m[i, 2] +
         m[i, 3] for i in range(4)]
    return torch.stack(r[:3], -1) / r[3][..., None]


def diffuse_eval(refl, wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    f = refl * (1.0 / math.pi) * torch.clamp_min(wo[..., 2], 0.0)[..., None]
    return torch.where(ok[..., None], f, 0.0)


def diffuse_pdf(wi, wo):
    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(ok, torch.clamp_min(wo[..., 2], 0.0) / math.pi, 0.0)


def cosine_hemisphere(u):
    """Concentric disk lifted to the hemisphere (Shirley-Chiu)."""
    r1 = 2.0 * u[..., 0] - 1.0
    r2 = 2.0 * u[..., 1] - 1.0
    use1 = r1.abs() > r2.abs()
    r = torch.where(use1, r1, r2)
    phi = torch.where(
        use1, (math.pi / 4.0) * (r2 / torch.where(r1 == 0.0, 1.0, r1)),
        (math.pi / 2.0) - (math.pi / 4.0) * (
            r1 / torch.where(r2 == 0.0, 1.0, r2)))
    phi = torch.where((r1 == 0.0) & (r2 == 0.0), 0.0, phi)
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    return torch.stack([x, y, torch.sqrt(torch.clamp_min(
        1.0 - x * x - y * y, 0.0))], -1)


def diffuse_sample(refl, wi, u):
    """(wo, weight, pdf, valid) of the cosine-weighted diffuse lobe."""
    wo = cosine_hemisphere(u)
    pdf = torch.clamp_min(wo[..., 2], 0.0) / math.pi
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    weight = torch.where(valid[..., None], refl, 0.0)
    return wo, weight, torch.where(valid, pdf, 0.0), valid


@dataclass
class Hit:
    valid: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    ng: torch.Tensor
    ns: torch.Tensor
    refl: torch.Tensor
    emitter: torch.Tensor


class DeviceScene:
    """The reference scene's tables on a device, in one dtype."""

    def __init__(self, rs, device, dtype=torch.float32):
        self.rs, self.device, self.dtype = rs, device, dtype

        def f(a):
            return torch.as_tensor(a).to(device=device, dtype=dtype)
        self.accel = Accel(rs.p0, rs.p1, rs.p2, device, dtype)
        e1 = torch.as_tensor(rs.p1 - rs.p0)
        e2 = torch.as_tensor(rs.p2 - rs.p0)
        ng = torch.linalg.cross(e1, e2, dim=-1)
        self.ng = f(ng / torch.clamp_min(ng.norm(dim=-1, keepdim=True),
                                         1e-20))
        self.n0, self.n1, self.n2 = f(rs.n0), f(rs.n1), f(rs.n2)
        self.refl = f(rs.reflectance)
        self.emitter = torch.as_tensor(rs.emitter).to(device)
        self.radiance = f(rs.radiance)
        self.em_area = f(rs.em_area)
        self.n_area = len(rs.em_tris)
        self.em_tris = [torch.as_tensor(t).to(device) for t in rs.em_tris]
        self.em_cdf = [torch.as_tensor(c).to(device) for c in rs.em_cdf]
        self.p0 = f(rs.p0)
        self.e1, self.e2 = f(e1), f(e2)
        self.eps = rs.ray_eps
        self.to_world = f(rs.to_world)
        self.sample_to_camera = f(rs.sample_to_camera)

    # -- camera ------------------------------------------------------------
    def camera_ray(self, pos_film):
        rs = self.rs
        s = torch.stack([pos_film[..., 0] / rs.width,
                         pos_film[..., 1] / rs.height,
                         torch.zeros_like(pos_film[..., 0])], -1)
        d_cam = normalize(_point(self.sample_to_camera, s))
        m = self.to_world
        o = torch.broadcast_to(m[:3, 3], d_cam.shape)
        d = torch.stack([dot(d_cam, m[i, :3]) for i in range(3)], -1)
        return o.contiguous(), normalize(d)

    # -- hits ----------------------------------------------------------------
    def trace(self, o, d, maxt):
        """Closest hits of rays with mint 0 (maxt <= 0: not traced)."""
        valid, t, prim, u, v = self.accel.closest(
            o, d, torch.zeros_like(maxt), maxt)
        return self.fill(o, d, valid, t, prim, u, v)

    def fill(self, o, d, valid, t, prim, u, v):
        pc = torch.clamp_min(prim, 0)
        u, v = u[..., None], v[..., None]
        w = 1.0 - u - v
        ts = torch.where(valid, t, 1.0)
        p = o + ts[..., None] * d
        ng = self.ng[pc]
        ns = normalize(self.n0[pc] * w + self.n1[pc] * u + self.n2[pc] * v)
        ns = torch.where((dot(ns, ns) > 0.5)[..., None], ns, ng)
        return Hit(valid=valid, t=t, p=p, ng=ng, ns=ns, refl=self.refl[pc],
                   emitter=torch.where(valid, self.emitter[pc], -1))

    def occluded(self, o, d, maxt):
        return self.accel.occluded(o, d, torch.zeros_like(maxt), maxt)

    # -- emitters --------------------------------------------------------
    def sample_light(self, p_ref, u_sel, u_pos):
        """NEE toward one area emitter: dict of d, dist, pdf (solid
        angle), pdf_area, radiance, n, p, valid."""
        n_total = self.n_area
        idx = torch.clamp_max((u_sel.float() * n_total).to(torch.int64),
                              n_total - 1)
        u_resc = torch.clamp(u_sel * n_total - idx.to(u_sel.dtype), 0.0, 1.0)
        flat = torch.zeros_like(idx)
        for e in range(n_total):
            cdf = self.em_cdf[e]
            j = torch.clamp_max(torch.searchsorted(
                cdf, u_resc.float().contiguous()), cdf.shape[0] - 1)
            flat = torch.where(idx == e, self.em_tris[e][j], flat)
        a = torch.sqrt(torch.clamp_min(1.0 - u_pos[..., 0], 0.0))
        b0, b1 = 1.0 - a, a * u_pos[..., 1]
        pos = (self.p0[flat] + b0[..., None] * self.e1[flat] +
               b1[..., None] * self.e2[flat])
        n = self.ng[flat]
        to_l = pos - p_ref
        dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        dist = torch.sqrt(dist2)
        d = to_l / dist[..., None]
        cos_l = -dot(d, n)
        pick = 1.0 / n_total
        pdf_area = pick / torch.clamp_min(self.em_area[idx], 1e-12)
        return dict(d=d, dist=dist, n=n, p=pos, radiance=self.radiance[idx],
                    pdf=pdf_area * dist2 / torch.clamp_min(cos_l, 1e-9),
                    pdf_area=pdf_area, valid=cos_l > 1e-6)

    def light_pdf(self, emitter, p_ref, p_hit, ng_hit):
        """Solid-angle pdf of NEE sampling p_hit from p_ref."""
        to_l = p_hit - p_ref
        dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        d = to_l / torch.sqrt(dist2)[..., None]
        cos_l = -dot(d, ng_hit)
        area = self.em_area[torch.clamp_min(emitter, 0)]
        pdf = dist2 / (torch.clamp_min(cos_l, 1e-9) *
                       torch.clamp_min(area, 1e-12)) / self.n_area
        return torch.where((emitter >= 0) & (cos_l > 1e-6), pdf, 0.0)

    def emission(self, hit, d):
        """(is_emitter, radiance) seen along d at hit (front side)."""
        is_em = hit.valid & (hit.emitter >= 0) & (dot(hit.ns, -d) > 0)
        return is_em, self.radiance[torch.clamp_min(hit.emitter, 0)]
