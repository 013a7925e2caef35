"""Plain scene reader for the benchmark's reference renderer.

Reads the subset of Mitsuba 0.5 XML that the benchmark's scenes use and
builds a flat triangle soup in numpy, with no code of the program:
<default> and $variables; an integrator (type, maxDepth, rrDepth); a
perspective sensor (fov along x, a lookat / translate / rotate / scale
toWorld); an independent sampler; a box rfilter; diffuse BSDFs with an
rgb reflectance; area emitters; and the shapes rectangle, sphere
(tessellated: nTheta x nPhi latitude-longitude), open cylinder,
shapegroup and instance.  Anything else raises ValueError.

Shapes follow Mitsuba's definitions: the rectangle spans [-1, 1]^2 in
z = 0 with normal +z, the sphere's lattice runs theta over [0, pi] and
phi over [0, 2 pi] with exact vertex normals, the cylinder is open (no
caps) with 64 segments.  A shape without a BSDF is diffuse 0.5 (the
Mitsuba default).  Transforms compose in document order, each one
applied after the ones before it; normals transform by the inverse
transpose.  A sphere under a similarity transform is an analytic quadric
in Mitsuba; the reference renders only tessellated ones and refuses it.
"""
from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

_VAR = re.compile(r"\$(\w+)")


@dataclass
class Shape:
    type: str
    props: dict = field(default_factory=dict)
    bsdf: object = None          # reflectance [3] f32, or None
    radiance: object = None      # area emitter radiance [3] f32, or None
    children: list = field(default_factory=list)


@dataclass
class RefScene:
    p0: np.ndarray               # [T, 3] f32 world vertices
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray               # [T, 3] f32 vertex normals
    n1: np.ndarray
    n2: np.ndarray
    reflectance: np.ndarray      # [T, 3] f32
    emitter: np.ndarray          # [T] i32 area emitter index or -1
    radiance: np.ndarray         # [E, 3] f32
    em_tris: list                # per emitter: its triangle ids [n] i64
    em_cdf: list                 # per emitter: area CDF [n] f32
    em_area: np.ndarray          # [E] f32 total area
    to_world: np.ndarray         # [4, 4] f32 camera to world
    sample_to_camera: np.ndarray  # [4, 4] f32
    width: int
    height: int
    spp: int
    integrator: str
    max_depth: int
    rr_depth: int
    ray_eps: float


def _floats(s):
    return np.array([float(x) for x in re.split(r"[,\s]+", s.strip()) if x],
                    np.float64)


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _scale(v):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def _rotate(axis, deg):
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    k = 1 - c
    m[:3, :3] = [[c + x * x * k, x * y * k - z * s, x * z * k + y * s],
                 [y * x * k + z * s, c + y * y * k, y * z * k - x * s],
                 [z * x * k - y * s, z * y * k + x * s, c + z * z * k]]
    return m


def _look_at(origin, target, up):
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = (left, np.cross(d, left), d,
                                              origin)
    return m


def _perspective(fov_deg, near, far):
    cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    recip = 1.0 / (far - near)
    return np.array([[cot, 0, 0, 0], [0, cot, 0, 0],
                     [0, 0, far * recip, -near * far * recip],
                     [0, 0, 1, 0]], np.float64)


def _transform(elem, var):
    m = np.eye(4)
    for ch in elem:
        def g(k, d=None, ch=ch):
            return var(ch.get(k)) if ch.get(k) is not None else d
        if ch.tag == "translate":
            op = _translate([float(g(k, "0")) for k in "xyz"])
        elif ch.tag == "scale":
            if g("value") is not None:
                s = _floats(g("value"))
                op = _scale([s[0]] * 3 if s.size == 1 else list(s))
            else:
                op = _scale([float(g(k, "1")) for k in "xyz"])
        elif ch.tag == "rotate":
            op = _rotate([float(g(k, "0")) for k in "xyz"],
                         float(g("angle", "0")))
        elif ch.tag in ("lookat", "lookAt"):
            op = _look_at(_floats(g("origin")), _floats(g("target")),
                          _floats(g("up", "0 1 0")))
        else:
            raise ValueError(f"transform <{ch.tag}> is not in the reference")
        m = op @ m
    return m


def _rectangle():
    p = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    return p, np.array([[0, 1, 2], [2, 3, 0]], np.int32), n


def _sphere(center, radius, n_theta, n_phi):
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH),
                  np.cos(TH)], -1).reshape(-1, 3).astype(np.float32)
    p = np.asarray(center, np.float32) + radius * n
    tris = []
    W = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            if i > 0:
                tris.append((a, c, b))
            if i < n_theta - 1:
                tris.append((b, c, d))
    return p, np.asarray(tris, np.int32), n


def _cylinder(p0, p1, radius, n_seg=64):
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    axis = axis / max(float(np.linalg.norm(axis)), 1e-12)
    h = (np.array([1.0, 0, 0], np.float32) if abs(axis[0]) < 0.9
         else np.array([0, 1.0, 0], np.float32))
    s = np.cross(axis, h)
    s /= np.linalg.norm(s)
    t = np.cross(axis, s)
    ang = np.linspace(0, 2 * np.pi, n_seg + 1)
    ring = (np.cos(ang)[:, None] * s[None] +
            np.sin(ang)[:, None] * t[None]).astype(np.float32)
    pos = np.concatenate([p0[None] + radius * ring,
                          p1[None] + radius * ring]).astype(np.float32)
    W = n_seg + 1
    tris = []
    for j in range(n_seg):
        a, b, c, d = j, j + 1, W + j, W + j + 1
        tris += [(a, c, b), (b, c, d)]
    return pos, np.asarray(tris, np.int32), np.concatenate([ring, ring])


def _is_similarity(m):
    r = m[:3, :3]
    s = abs(np.linalg.det(r)) ** (1.0 / 3.0)
    q = r / max(s, 1e-12)
    return s >= 1e-12 and np.max(np.abs(q @ q.T - np.eye(3))) <= 1e-4


class _Reader:
    def __init__(self, variables):
        self.vars = dict(variables)
        self.ids = {}

    def sub(self, text):
        def repl(mm):
            if mm.group(1) not in self.vars:
                raise ValueError(f"undefined scene parameter ${mm.group(1)}")
            return self.vars[mm.group(1)]
        return _VAR.sub(repl, text)

    def props(self, elem):
        out = {}
        for ch in elem:
            name, val = ch.get("name"), ch.get("value")
            val = self.sub(val) if val is not None else None
            if ch.tag in ("integer",):
                out[name] = int(val)
            elif ch.tag == "float":
                out[name] = float(val)
            elif ch.tag == "boolean":
                out[name] = val.strip().lower() == "true"
            elif ch.tag == "string":
                out[name] = val
            elif ch.tag == "rgb":
                a = _floats(val)
                out[name] = (np.full(3, a[0]) if a.size == 1 else a).astype(
                    np.float32)
            elif ch.tag == "point":
                out[name] = (_floats(val) if val is not None else np.array(
                    [float(self.sub(ch.get(k, "0"))) for k in "xyz"]
                )).astype(np.float32)
            elif ch.tag == "transform":
                out[name or "toWorld"] = _transform(ch, self.sub)
        return out

    def bsdf(self, elem):
        if elem.get("type") != "diffuse":
            raise ValueError(f"bsdf {elem.get('type')} is not in the "
                             "reference")
        refl = self.props(elem).get("reflectance",
                                    np.full(3, 0.5, np.float32))
        if elem.get("id"):
            self.ids[elem.get("id")] = refl
        return refl

    def shape(self, elem):
        s = Shape(type=self.sub(elem.get("type")), props=self.props(elem))
        for ch in elem:
            if ch.tag == "bsdf":
                s.bsdf = self.bsdf(ch)
            elif ch.tag == "ref":
                target = self.ids[ch.get("id")]
                if isinstance(target, Shape):
                    s.children.append(target)
                else:
                    s.bsdf = target
            elif ch.tag == "emitter":
                if ch.get("type") != "area":
                    raise ValueError("only area emitters are in the reference")
                s.radiance = self.props(ch).get("radiance",
                                                np.ones(3, np.float32))
            elif ch.tag == "shape":
                s.children.append(self.shape(ch))
        if elem.get("id"):
            self.ids[elem.get("id")] = s
        return s


def _mesh(shape):
    pr = shape.props
    if shape.type == "rectangle":
        return _rectangle()
    if shape.type == "sphere":
        return _sphere(pr.get("center", np.zeros(3, np.float32)),
                       float(pr.get("radius", 1.0)), int(pr.get("nTheta", 64)),
                       int(pr.get("nPhi", 128)))
    if shape.type == "cylinder":
        return _cylinder(pr.get("p0", np.zeros(3, np.float32)),
                         pr.get("p1", np.array([0, 0, 1], np.float32)),
                         float(pr.get("radius", 1.0)))
    raise ValueError(f"shape {shape.type} is not in the reference")


def load(path, variables=None) -> RefScene:
    """Parse the scene file into a RefScene (numpy, float32)."""
    rd = _Reader(variables or {})
    root = ET.parse(path).getroot()
    integ = sensor = None
    shapes = []
    for ch in root:
        if ch.tag == "default":
            rd.vars.setdefault(ch.get("name"), rd.sub(ch.get("value")))
        elif ch.tag == "integrator":
            integ = ch
        elif ch.tag == "sensor":
            sensor = ch
        elif ch.tag == "bsdf":
            rd.bsdf(ch)
        elif ch.tag == "shape":
            s = rd.shape(ch)
            if s.type != "shapegroup":
                shapes.append(s)
        else:
            raise ValueError(f"<{ch.tag}> is not in the reference")

    # flatten instances into (mesh shape, toWorld)
    flat = []
    for s in shapes:
        tw = np.asarray(s.props.get("toWorld", np.eye(4)), np.float64)
        if s.type == "instance":
            for grp in s.children:
                for sub in grp.children:
                    sw = np.asarray(sub.props.get("toWorld", np.eye(4)))
                    flat.append((sub, tw @ sw))
        else:
            flat.append((s, tw))

    cols = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2", "refl",
                            "em")}
    radiance, memo = [], {}
    for s, tw in flat:
        if s.type == "sphere" and s.radiance is None and _is_similarity(tw):
            raise ValueError("an analytic sphere is not in the reference")
        key = id(s)
        if key not in memo:
            memo[key] = _mesh(s)
        p, idx, n = memo[key]
        pos = (np.asarray(p, np.float64) @ tw[:3, :3].T + tw[:3, 3])
        w = np.asarray(p, np.float64) @ tw[3, :3] + tw[3, 3]
        pos = (pos / w[:, None]).astype(np.float32)
        inv = np.linalg.inv(tw)
        nrm = n.astype(np.float64) @ inv[:3, :3]
        nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                                1e-20)).astype(np.float32)
        if np.linalg.det(tw[:3, :3]) < 0:
            idx = idx[:, ::-1]
        for c, j in (("p0", 0), ("p1", 1), ("p2", 2)):
            cols[c].append(pos[idx[:, j]])
        for c, j in (("n0", 0), ("n1", 1), ("n2", 2)):
            cols[c].append(nrm[idx[:, j]])
        refl = s.bsdf if s.bsdf is not None else np.full(3, 0.5, np.float32)
        cols["refl"].append(np.tile(refl[None], (len(idx), 1)))
        e = -1
        if s.radiance is not None:
            e = len(radiance)
            radiance.append(s.radiance)
        cols["em"].append(np.full(len(idx), e, np.int32))
    a = {k: np.concatenate(v) for k, v in cols.items()}

    em_tris, em_cdf, em_area = [], [], []
    areas = 0.5 * np.linalg.norm(np.cross(a["p1"] - a["p0"],
                                          a["p2"] - a["p0"]), axis=-1)
    for e in range(len(radiance)):
        ids = np.nonzero(a["em"] == e)[0]
        total = float(areas[ids].sum())
        em_tris.append(ids)
        em_cdf.append((np.cumsum(areas[ids]) / max(total, 1e-30)).astype(
            np.float32))
        em_area.append(total)

    sp = rd.props(sensor)
    if sensor.get("type") != "perspective":
        raise ValueError("only the perspective sensor is in the reference")
    film = next(c for c in sensor if c.tag == "film")
    fp = rd.props(film)
    width, height = int(fp.get("width", 768)), int(fp.get("height", 576))
    for c in film:
        if c.tag == "rfilter" and c.get("type") != "box":
            raise ValueError("only the box rfilter is in the reference")
    sampler = next((c for c in sensor if c.tag == "sampler"), None)
    spp = 16
    if sampler is not None:
        if sampler.get("type") != "independent":
            raise ValueError("only the independent sampler is in the "
                             "reference")
        spp = int(rd.props(sampler).get("sampleCount", 16))
    if sp.get("fovAxis", "x") != "x":
        raise ValueError("only fovAxis x is in the reference")
    aspect = width / height
    near, far = float(sp.get("nearClip", 1e-2)), float(sp.get("farClip", 1e4))
    cam_to_sample = (_scale([-0.5, -0.5 * aspect, 1.0]) @
                     _translate([-1.0, -1.0 / aspect, 0.0]) @
                     _perspective(float(sp.get("fov", 45.0)), near, far))

    ip = rd.props(integ)
    lo = np.minimum(np.minimum(a["p0"], a["p1"]), a["p2"]).min(0)
    hi = np.maximum(np.maximum(a["p0"], a["p1"]), a["p2"]).max(0)
    extent = float(np.linalg.norm(hi - lo))
    return RefScene(
        p0=a["p0"], p1=a["p1"], p2=a["p2"], n0=a["n0"], n1=a["n1"],
        n2=a["n2"], reflectance=a["refl"], emitter=a["em"],
        radiance=np.asarray(radiance, np.float32).reshape(-1, 3),
        em_tris=em_tris, em_cdf=em_cdf,
        em_area=np.asarray(em_area, np.float32),
        to_world=np.asarray(sp.get("toWorld", np.eye(4))).astype(np.float32),
        sample_to_camera=np.linalg.inv(cam_to_sample).astype(np.float32),
        width=width, height=height, spp=spp,
        integrator=rd.sub(integ.get("type")),
        max_depth=int(ip.get("maxDepth", -1)),
        rr_depth=int(ip.get("rrDepth", 5)),
        ray_eps=float(np.float32(max(extent, 1e-3) * 1e-4)))

