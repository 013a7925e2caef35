"""Mesh ingestion: OBJ / PLY / Mitsuba .serialized loaders + built-in shapes.

TPU-native replacement for Mitsuba's shape plugins (src/shapes/{obj,ply,
serialized,rectangle,sphere,cube,disk}.cpp) and TriMesh
(src/librender/trimesh.cpp).  Everything tessellates to indexed triangles in
numpy; spheres are tessellated (the analytic-sphere fast path is a later
optimization — tessellation only changes geometry detail, not estimator
semantics, at sufficient resolution).
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Mesh:
    positions: np.ndarray            # [V, 3] f32
    indices: np.ndarray              # [T, 3] i32
    normals: Optional[np.ndarray]    # [V, 3] f32 or None (-> face normals)
    uvs: Optional[np.ndarray]        # [V, 2] f32 or None
    colors: Optional[np.ndarray] = None  # [V, 3] f32 linear vertex colors

    @property
    def num_tris(self):
        return len(self.indices)


def compute_vertex_normals(positions, indices):
    """Area-weighted smooth vertex normals (TriMesh::computeNormals)."""
    p = positions
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(p[i1] - p[i0], p[i2] - p[i0])  # area-weighted
    vn = np.zeros_like(p)
    np.add.at(vn, i0, fn)
    np.add.at(vn, i1, fn)
    np.add.at(vn, i2, fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-20)).astype(np.float32)


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def load_obj(path: str, face_normals: bool = False) -> Mesh:
    vs, vns, vts = [], [], []
    # corners keyed by (v, vt, vn) -> output index
    corner_map = {}
    out_pos, out_nrm, out_uv, tris = [], [], [], []
    has_n = has_t = False

    def corner(tok):
        nonlocal has_n, has_t
        parts = tok.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ti - 1 if ti > 0 else (len(vts) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(vns) + ni if ni else -1)
        key = (vi, ti, ni)
        if key in corner_map:
            return corner_map[key]
        idx = len(out_pos)
        corner_map[key] = idx
        out_pos.append(vs[vi])
        if ni >= 0:
            has_n = True
            out_nrm.append(vns[ni])
        else:
            out_nrm.append((0.0, 0.0, 0.0))
        if ti >= 0:
            has_t = True
            out_uv.append(vts[ti])
        else:
            out_uv.append((0.0, 0.0))
        return idx

    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                t = line.split()
                vs.append((float(t[1]), float(t[2]), float(t[3])))
            elif line.startswith("vn "):
                t = line.split()
                vns.append((float(t[1]), float(t[2]), float(t[3])))
            elif line.startswith("vt "):
                t = line.split()
                vts.append((float(t[1]), float(t[2])))
            elif line.startswith("f "):
                toks = line.split()[1:]
                idx = [corner(tok) for tok in toks]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))

    positions = np.asarray(out_pos, np.float32)
    indices = np.asarray(tris, np.int32).reshape(-1, 3)
    normals = np.asarray(out_nrm, np.float32) if (has_n and not face_normals) else None
    if normals is None and not face_normals:
        normals = compute_vertex_normals(positions, indices)
    uvs = np.asarray(out_uv, np.float32) if has_t else None
    return Mesh(positions, indices, normals, uvs)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str, face_normals: bool = False) -> Mesh:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, idx_dtype)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line == "end_header":
                break
            t = line.split()
            if not t or t[0] == "comment":
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                elements.append((t[1], int(t[2]), []))
            elif t[0] == "property":
                if t[1] == "list":
                    elements[-1][2].append(
                        (t[4], _PLY_DTYPES[t[3]], True, _PLY_DTYPES[t[2]]))
                else:
                    elements[-1][2].append((t[2], _PLY_DTYPES[t[1]], False, None))
        data = {}
        if fmt == "ascii":
            for name, count, props in elements:
                rows = {p[0]: [] for p in props}
                for _ in range(count):
                    toks = f.readline().split()
                    k = 0
                    for pname, dt, is_list, ldt in props:
                        if is_list:
                            n = int(toks[k]); k += 1
                            rows[pname].append([float(x) for x in toks[k:k + n]])
                            k += n
                        else:
                            rows[pname].append(float(toks[k])); k += 1
                data[name] = rows
        else:
            endian = "<" if "little" in fmt else ">"
            for name, count, props in elements:
                if not any(p[2] for p in props):
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dt)
                    data[name] = {p[0]: arr[p[0]] for p in props}
                else:
                    rows = {p[0]: [] for p in props}
                    for _ in range(count):
                        for pname, dt, is_list, ldt in props:
                            if is_list:
                                n = np.frombuffer(
                                    f.read(np.dtype(ldt).itemsize),
                                    endian + ldt)[0]
                                vals = np.frombuffer(
                                    f.read(np.dtype(dt).itemsize * n),
                                    endian + dt)
                                rows[pname].append(vals)
                            else:
                                rows[pname].append(np.frombuffer(
                                    f.read(np.dtype(dt).itemsize),
                                    endian + dt)[0])
                    data[name] = rows

    v = data["vertex"]
    positions = np.stack([np.asarray(v[k], np.float32) for k in "xyz"], -1)
    normals = None
    if "nx" in v:
        normals = np.stack([np.asarray(v[k], np.float32)
                            for k in ("nx", "ny", "nz")], -1)
    uvs = None
    for ku, kv in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ku in v:
            uvs = np.stack([np.asarray(v[ku], np.float32),
                            np.asarray(v[kv], np.float32)], -1)
            break
    colors = None
    if "red" in v:
        colors = np.stack([np.asarray(v[k], np.float32)
                           for k in ("red", "green", "blue")], -1)
        # u8/u16-typed color properties arrive in [0, 255]/[0, 65535]
        ctype = {p[0]: p[1] for p in
                 next(e[2] for e in elements if e[0] == "vertex")}["red"]
        if ctype == "u1":
            colors = colors / 255.0
        elif ctype == "u2":
            colors = colors / 65535.0
    face_key = "vertex_indices" if "vertex_indices" in data.get("face", {}) \
        else "vertex_index"
    tris = []
    for poly in data["face"][face_key]:
        poly = np.asarray(poly, np.int64)
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
    indices = np.asarray(tris, np.int32).reshape(-1, 3)
    if normals is None and not face_normals:
        normals = compute_vertex_normals(positions, indices)
    if face_normals:
        normals = None
    return Mesh(positions, indices, normals, uvs, colors)


# ---------------------------------------------------------------------------
# Mitsuba .serialized (reference: src/shapes/serialized.cpp, fileformat v4)
# ---------------------------------------------------------------------------

MTS_FILEFORMAT_HEADER = 0x041C
_F_HAS_NORMALS = 0x0001
_F_HAS_TEXCOORDS = 0x0002
_F_HAS_COLORS = 0x0008
_F_FACE_NORMALS = 0x0010
_F_SINGLE = 0x1000
_F_DOUBLE = 0x2000


def load_serialized(path: str, shape_index: int = 0,
                    face_normals: bool = False) -> Mesh:
    with open(path, "rb") as f:
        raw = f.read()
    count = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    table_at = len(raw) - 4 - 8 * count
    offsets = struct.unpack_from("<%dQ" % count, raw, table_at)
    if shape_index >= count:
        raise IndexError(f"{path}: shape index {shape_index} >= {count}")
    start = offsets[shape_index]
    header, version = struct.unpack_from("<HH", raw, start)
    if header != MTS_FILEFORMAT_HEADER:
        raise ValueError(f"{path}: bad .serialized header 0x{header:04x}")
    end = offsets[shape_index + 1] if shape_index + 1 < count else table_at
    payload = zlib.decompress(raw[start + 4:end])

    pos = 0
    flags, = struct.unpack_from("<I", payload, pos); pos += 4
    if version >= 4:  # null-terminated mesh name
        z = payload.index(b"\0", pos)
        pos = z + 1
    vcount, tcount = struct.unpack_from("<QQ", payload, pos); pos += 16
    ftype = np.float64 if flags & _F_DOUBLE else np.float32
    fsize = 8 if flags & _F_DOUBLE else 4

    def take(n, dt, width):
        nonlocal pos
        a = np.frombuffer(payload, dt, n * width, pos).reshape(n, width)
        pos += n * width * np.dtype(dt).itemsize
        return a

    positions = take(vcount, ftype, 3).astype(np.float32)
    normals = None
    if flags & _F_HAS_NORMALS:
        normals = take(vcount, ftype, 3).astype(np.float32)
    uvs = None
    if flags & _F_HAS_TEXCOORDS:
        uvs = take(vcount, ftype, 2).astype(np.float32)
    colors = None
    if flags & _F_HAS_COLORS:
        colors = take(vcount, ftype, 3).astype(np.float32)
    indices = take(tcount, np.uint32, 3).astype(np.int32)
    if (flags & _F_FACE_NORMALS) or face_normals:
        normals = None
    elif normals is None:
        normals = compute_vertex_normals(positions, indices)
    return Mesh(positions, indices, normals, uvs, colors)


def save_serialized(path: str, meshes):
    """Write meshes in Mitsuba .serialized v4 format (for scene caching and
    round-trip tests)."""
    offsets = []
    with open(path, "wb") as f:
        for mesh in meshes:
            offsets.append(f.tell())
            flags = _F_SINGLE
            if mesh.normals is not None:
                flags |= _F_HAS_NORMALS
            if mesh.uvs is not None:
                flags |= _F_HAS_TEXCOORDS
            body = struct.pack("<I", flags) + b"mesh\0"
            body += struct.pack("<QQ", len(mesh.positions), len(mesh.indices))
            body += mesh.positions.astype(np.float32).tobytes()
            if mesh.normals is not None:
                body += mesh.normals.astype(np.float32).tobytes()
            if mesh.uvs is not None:
                body += mesh.uvs.astype(np.float32).tobytes()
            body += mesh.indices.astype(np.uint32).tobytes()
            f.write(struct.pack("<HH", MTS_FILEFORMAT_HEADER, 4))
            f.write(zlib.compress(body))
        for off in offsets:
            f.write(struct.pack("<Q", off))
        f.write(struct.pack("<I", len(offsets)))


# ---------------------------------------------------------------------------
# Built-in shapes (reference: src/shapes/{rectangle,cube,sphere,disk}.cpp)
# ---------------------------------------------------------------------------

def make_rectangle() -> Mesh:
    """Unit rectangle [-1,1]^2 in the xy-plane, normal +z."""
    p = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [2, 3, 0]], np.int32)
    return Mesh(p, idx, n, uv)


def make_cube() -> Mesh:
    """Unit cube [-1,1]^3 with per-face normals."""
    faces = []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            n = np.zeros(3, np.float32); n[axis] = sgn
            u = np.zeros(3, np.float32); u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            c = n  # face center
            quad = [c - u - v, c + u - v, c + u + v, c - u + v]
            faces.append((quad, n))
    pos, nrm, uvs, idx = [], [], [], []
    for quad, n in faces:
        base = len(pos)
        pos.extend(quad)
        nrm.extend([n] * 4)
        uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        idx.extend([[base, base + 1, base + 2], [base + 2, base + 3, base]])
    return Mesh(np.asarray(pos, np.float32), np.asarray(idx, np.int32),
                np.asarray(nrm, np.float32), np.asarray(uvs, np.float32))


def make_sphere(center=(0, 0, 0), radius=1.0, n_theta=64, n_phi=128) -> Mesh:
    """Lat-long tessellated sphere with exact per-vertex normals."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(TH) * np.cos(PH)
    y = np.sin(TH) * np.sin(PH)
    z = np.cos(TH)
    n = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    p = np.asarray(center, np.float32) + radius * n
    uv = np.stack([PH / (2 * np.pi), 1.0 - TH / np.pi], -1).reshape(-1, 2)
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
    return Mesh(p, np.asarray(tris, np.int32), n, uv.astype(np.float32))


def make_disk(n_seg=64) -> Mesh:
    """Unit disk in the xy-plane, normal +z."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_seg)], -1)
    p = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (n_seg + 1, 1))
    uv = (p[:, :2] * 0.5 + 0.5).astype(np.float32)
    tris = [(0, 1 + i, 1 + (i + 1) % n_seg) for i in range(n_seg)]
    return Mesh(p, np.asarray(tris, np.int32), n, uv)


def make_cylinder(p0=(0, 0, 0), p1=(0, 0, 1), radius=1.0,
                  n_seg=64) -> Mesh:
    """Open cylinder from p0 to p1 (src/shapes/cylinder.cpp semantics:
    no end caps), tessellated with exact per-vertex normals."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = float(np.linalg.norm(axis))
    axis = axis / max(length, 1e-12)
    # build an orthonormal frame around the axis
    h = np.array([1.0, 0, 0], np.float32) if abs(axis[0]) < 0.9 \
        else np.array([0, 1.0, 0], np.float32)
    s = np.cross(axis, h)
    s /= np.linalg.norm(s)
    t = np.cross(axis, s)
    ang = np.linspace(0, 2 * np.pi, n_seg + 1)
    ring_n = (np.cos(ang)[:, None] * s[None] +
              np.sin(ang)[:, None] * t[None]).astype(np.float32)
    bot = p0[None] + radius * ring_n
    top = p1[None] + radius * ring_n
    pos = np.concatenate([bot, top]).astype(np.float32)
    nrm = np.concatenate([ring_n, ring_n]).astype(np.float32)
    u = (ang / (2 * np.pi)).astype(np.float32)
    uv = np.concatenate([
        np.stack([u, np.zeros_like(u)], -1),
        np.stack([u, np.ones_like(u)], -1)]).astype(np.float32)
    W = n_seg + 1
    tris = []
    for j in range(n_seg):
        a, b, c, d = j, j + 1, W + j, W + j + 1
        tris.append((a, c, b))
        tris.append((b, c, d))
    return Mesh(pos, np.asarray(tris, np.int32), nrm, uv)


def load_hair(path: str):
    """Mitsuba .hair fiber file -> list of [k,3] float32 polylines.

    Both reference formats (src/shapes/hair.cpp fileformat docs):
      - binary: magic b"BINARY_HAIR", uint32 total vertex count, then a
        float stream where an +inf x-coordinate starts a new fiber
      - text: one "x y z" vertex per line, blank line separates fibers
    """
    fibers = []
    with open(path, "rb") as f:
        head = f.read(11)
        if head == b"BINARY_HAIR":
            (num,) = struct.unpack("<I", f.read(4))
            data = np.frombuffer(f.read(), np.float32)
            cur = []
            i = 0
            read = 0
            while read < num and i < len(data):
                x = data[i]
                if np.isinf(x):
                    if len(cur) >= 2:
                        fibers.append(np.asarray(cur, np.float32))
                    cur = []
                    i += 1
                    continue
                cur.append((x, data[i + 1], data[i + 2]))
                i += 3
                read += 1
            if len(cur) >= 2:
                fibers.append(np.asarray(cur, np.float32))
        else:
            cur = []
            for line in (head + f.read()).decode("utf-8",
                                                 "replace").splitlines():
                line = line.strip()
                if not line:
                    if len(cur) >= 2:
                        fibers.append(np.asarray(cur, np.float32))
                    cur = []
                    continue
                cur.append([float(tok) for tok in line.split()[:3]])
            if len(cur) >= 2:
                fibers.append(np.asarray(cur, np.float32))
    return fibers


def make_hair(fibers, radius=0.025, n_seg=6, reduction=0.0,
              seed=0) -> Mesh:
    """Hair fibers tessellated to capped tubes.

    TPU-native replacement for src/shapes/hair.cpp: the reference builds
    a dedicated HairKDTree with exact infinite-cylinder intersections
    per segment; here every fiber becomes an n_seg-sided tube swept
    along a parallel-transport (rotation-minimizing) frame, so hair
    rides the SAME BVH + MXU traversal as every other shape.  Shading
    normals are the exact radial tube normals, matching the reference's
    cylinder normals away from joints.  `reduction` drops that fraction
    of fibers (hair.cpp's reduction prop)."""
    if reduction > 0:
        rs = np.random.RandomState(seed)
        keep = rs.rand(len(fibers)) >= reduction
        fibers = [fb for fb, k in zip(fibers, keep) if k]
    if not fibers:
        raise ValueError("hair shape with zero fibers")

    # pad to [F, K, 3] for vectorized frame transport across fibers
    K = max(len(fb) for fb in fibers)
    F = len(fibers)
    v = np.zeros((F, K, 3), np.float32)
    klen = np.zeros(F, np.int32)
    for i, fb in enumerate(fibers):
        v[i, :len(fb)] = fb
        v[i, len(fb):] = fb[-1]       # pad by repeating the last vertex
        klen[i] = len(fb)

    seg = v[:, 1:] - v[:, :-1]                       # [F, K-1, 3]
    slen = np.linalg.norm(seg, axis=-1, keepdims=True)
    d = seg / np.maximum(slen, 1e-12)
    # per-vertex tangents: average of adjacent segment directions
    t = np.zeros_like(v)
    t[:, 0] = d[:, 0]
    t[:, -1] = d[:, -1]
    t[:, 1:-1] = d[:, :-1] + d[:, 1:]
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)

    # parallel transport an initial perpendicular along each fiber
    n = np.zeros_like(v)
    h = np.where(np.abs(t[:, 0, 0:1]) < 0.9,
                 np.asarray([[1, 0, 0]], np.float32),
                 np.asarray([[0, 1, 0]], np.float32))
    n0 = np.cross(t[:, 0], h)
    n[:, 0] = n0 / np.maximum(np.linalg.norm(n0, axis=-1, keepdims=True),
                              1e-12)
    for i in range(1, K):
        a = t[:, i - 1]
        b = t[:, i]
        axis = np.cross(a, b)
        s = np.linalg.norm(axis, axis=-1, keepdims=True)
        c = np.sum(a * b, -1, keepdims=True)
        ax = axis / np.maximum(s, 1e-12)
        prev = n[:, i - 1]
        rot = (prev * c + np.cross(ax, prev) * s +
               ax * np.sum(ax * prev, -1, keepdims=True) * (1.0 - c))
        n[:, i] = np.where(s > 1e-8, rot, prev)
        # re-orthogonalize against accumulated drift
        n[:, i] -= t[:, i] * np.sum(n[:, i] * t[:, i], -1, keepdims=True)
        n[:, i] /= np.maximum(
            np.linalg.norm(n[:, i], axis=-1, keepdims=True), 1e-12)
    bvec = np.cross(t, n)

    ang = (2 * np.pi * np.arange(n_seg) / n_seg).astype(np.float32)
    ring_dir = (np.cos(ang)[None, None, :, None] * n[:, :, None, :] +
                np.sin(ang)[None, None, :, None] * bvec[:, :, None, :])
    rings = v[:, :, None, :] + radius * ring_dir      # [F, K, S, 3]

    # flat vertex layout: per fiber, K rings of S + 2 cap centers
    S = n_seg
    per_fiber = K * S + 2
    pos = np.concatenate(
        [rings.reshape(F, K * S, 3), v[:, 0:1], v[:, -1:]],
        axis=1).reshape(-1, 3).astype(np.float32)
    nrm = np.concatenate(
        [ring_dir.reshape(F, K * S, 3), -t[:, 0:1], t[:, -1:]],
        axis=1).reshape(-1, 3).astype(np.float32)
    uu = np.broadcast_to(ang[None, None] / (2 * np.pi), (F, K, S))
    vv = np.broadcast_to(
        (np.arange(K, dtype=np.float32) / max(K - 1, 1))[None, :, None],
        (F, K, S))
    uvs = np.concatenate(
        [np.stack([uu, vv], -1).reshape(F, K * S, 2),
         np.zeros((F, 2, 2), np.float32)], axis=1).reshape(-1, 2)

    # vectorized index build (a python loop is minutes at 100k fibers)
    fib = np.arange(F, dtype=np.int64)
    base = fib * per_fiber
    jj = np.arange(K - 1, dtype=np.int64)
    ss = np.arange(S, dtype=np.int64)
    s2 = (ss + 1) % S
    r0 = (base[:, None, None] + jj[None, :, None] * S)      # [F, K-1, 1]
    A = r0 + ss[None, None, :]                              # [F, K-1, S]
    A2 = r0 + s2[None, None, :]
    B = A + S
    B2 = A2 + S
    tri1 = np.stack([A, B, A2], -1)
    tri2 = np.stack([A2, B, B2], -1)
    mask = np.broadcast_to(jj[None, :, None] <
                           (klen[:, None, None] - 1), A.shape)
    body = np.concatenate([tri1[mask], tri2[mask]])
    # caps: fans around the stored cap-center vertices
    c0 = base + K * S
    c1 = c0 + 1
    first = base[:, None] + ss[None, :]
    first2 = base[:, None] + s2[None, :]
    last = (base + (klen.astype(np.int64) - 1) * S)[:, None]
    cap0 = np.stack([np.broadcast_to(c0[:, None], first.shape),
                     first2, first], -1).reshape(-1, 3)
    cap1 = np.stack([np.broadcast_to(c1[:, None], first.shape),
                     last + ss[None, :], last + s2[None, :]],
                    -1).reshape(-1, 3)
    tris = np.concatenate([body, cap0, cap1]).astype(np.int32)
    return Mesh(pos, tris, nrm.astype(np.float32), uvs.astype(np.float32))


def make_heightfield(values: np.ndarray, shading_normals=True) -> Mesh:
    """Displaced grid over [-1,1]^2 in the xy-plane with z = values[y, x]
    (reference: src/shapes/heightfield.cpp, which ray-marches the bilinear
    patches directly; tessellating to triangles keeps the single BVH/
    traversal path of this framework — a documented deviation that
    converges to the same surface as the grid resolution)."""
    values = np.asarray(values, np.float32)
    H, W = values.shape
    xs = np.linspace(-1.0, 1.0, W, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, H, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pos = np.stack([X, Y, values], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([(X + 1) * 0.5, (Y + 1) * 0.5], -1).reshape(-1, 2)
    jj, ii = np.meshgrid(np.arange(H - 1), np.arange(W - 1), indexing="ij")
    a = (jj * W + ii).ravel()
    b = a + 1
    c = a + W
    d = c + 1
    tris = np.concatenate([np.stack([a, b, d], -1),
                           np.stack([a, d, c], -1)]).astype(np.int32)
    nrm = compute_vertex_normals(pos, tris) if shading_normals else None
    return Mesh(pos, tris, nrm, uv.astype(np.float32))


def vertex_curvature(positions: np.ndarray, indices: np.ndarray,
                     mode: str = "mean") -> np.ndarray:
    """Per-vertex discrete curvature (src/textures/curvature.cpp parity).

    mode="gaussian": angle-deficit estimate K = (2*pi - sum of incident
    angles) / A_mixed (Meyer et al. barycentric-area variant: one third
    of the incident triangle areas).
    mode="mean": cotangent-Laplacian estimate H = |sum_j (cot a + cot b)
    (p - p_j)| / (4*A_mixed), signed by the angle-weighted vertex normal
    (convex = positive).

    Pure numpy, vectorized over triangles; boundary vertices get the
    same formulas (no special boundary handling — the reference's
    estimates are equally approximate there)."""
    V = len(positions)
    p0 = positions[indices[:, 0]].astype(np.float64)
    p1 = positions[indices[:, 1]].astype(np.float64)
    p2 = positions[indices[:, 2]].astype(np.float64)
    fn = np.cross(p1 - p0, p2 - p0)
    a2 = np.linalg.norm(fn, axis=-1)              # 2x area
    area3 = np.maximum(a2, 1e-20) / 6.0           # A/3 per corner

    def corner(pa, pb, pc):
        """(angle at pa, cot of angle at pa)."""
        u, v = pb - pa, pc - pa
        c = np.einsum("ij,ij->i", u, v)
        s = np.linalg.norm(np.cross(u, v), axis=-1)
        return np.arctan2(s, c), c / np.maximum(s, 1e-20)

    ang0, cot0 = corner(p0, p1, p2)
    ang1, cot1 = corner(p1, p2, p0)
    ang2, cot2 = corner(p2, p0, p1)

    amix = np.zeros(V)
    for k in range(3):
        np.add.at(amix, indices[:, k], area3)
    amix = np.maximum(amix, 1e-20)

    if mode == "gaussian":
        asum = np.zeros(V)
        for k, ang in ((0, ang0), (1, ang1), (2, ang2)):
            np.add.at(asum, indices[:, k], ang)
        return ((2.0 * np.pi - asum) / amix).astype(np.float32)

    # mean: Laplace-Beltrami. Edge (i,j) opposite corner k contributes
    # cot(k) * (p_i - p_j) to vertex i (and the negation to j).
    lap = np.zeros((V, 3))
    nrm = np.zeros((V, 3))
    for (i, j, cot), (pi, pj) in (
            ((indices[:, 1], indices[:, 2], cot0), (p1, p2)),
            ((indices[:, 2], indices[:, 0], cot1), (p2, p0)),
            ((indices[:, 0], indices[:, 1], cot2), (p0, p1))):
        w = cot[:, None]
        np.add.at(lap, i, w * (pi - pj))
        np.add.at(lap, j, w * (pj - pi))
    for k, ang in ((0, ang0), (1, ang1), (2, ang2)):
        np.add.at(nrm, indices[:, k], ang[:, None] * fn /
                  np.maximum(a2, 1e-20)[:, None])
    h = np.linalg.norm(lap, axis=-1) / (4.0 * amix)
    # lap sums cot*(p - p_j) = -(Laplace-Beltrami)*2A, and Delta p =
    # -2 H n (n outward) — so lap points ALONG +n on a convex surface
    sign = np.where(np.einsum("ij,ij->i", lap, nrm) >= 0.0, 1.0, -1.0)
    return (sign * h).astype(np.float32)
