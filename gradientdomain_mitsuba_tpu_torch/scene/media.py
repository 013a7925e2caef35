"""Participating-media tables: medium plugins -> flat device arrays.

TPU-native replacement for the reference's Medium/PhaseFunction plugin
hierarchy (src/medium/{homogeneous,heterogeneous}.cpp, src/volume/
{constvolume,gridvolume}.cpp, src/phase/{isotropic,hg,rayleigh}.cpp):
media become rows of a small SoA table gathered per lane by the
volumetric wavefront (models/volpath.py, ops/medium.py).

Heterogeneous media carry a scalar density grid (all grids packed into
ONE flat array + per-row offset/resolution, so the device pytree keeps
a single static shape regardless of how many volumes the scene binds)
sampled by trilinear interpolation in ops/medium.py, with free flight
via spectral delta tracking against the row's majorant — the TPU analog
of heterogeneous.cpp's Woodcock tracking.  Albedo is per-row spectral
(constvolume; a gridvolume albedo collapses to its mean — documented
deviation), orientation volumes (microflake) are out of scope.
"""
from __future__ import annotations

import os
import struct
from typing import List, NamedTuple, Tuple

import numpy as np

from .ir import Plugin, spectrum_value

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_MICROFLAKE = 3   # fiber-like anisotropic media (microflake.cpp);
#                        realized as closed-form SGGX flakes (ops/medium.py)

# named scattering materials (subset of Mitsuba's materialdata.h lookup,
# data/ior-style presets used by <string name="material">): sigmaS,
# sigmaA per mm at unit scale
_MATERIALS = {
    # (sigma_s rgb, sigma_a rgb) — Jensen et al. 2001 measurements as
    # shipped in Mitsuba's materialdata.h (values in 1/mm)
    "skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
    "skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
}


class MediumTable(NamedTuple):
    """[M]-row medium table; M >= 1 (row 0 is a vacuum dummy when the
    scene has no media so gathers always compile).

    Heterogeneous rows (het == 1): sigma_* hold the PER-UNIT-DENSITY
    coefficients; the scalar density grid modulates them spatially.
    Homogeneous rows keep grid fields pointing at the shared 1-texel
    unit grid, so density_at() is an identity for them."""
    sigma_s: np.ndarray    # [M, 3]
    sigma_a: np.ndarray    # [M, 3]
    sigma_t: np.ndarray    # [M, 3]
    phase_kind: np.ndarray  # [M] i32 (PHASE_*)
    g: np.ndarray          # [M] HG asymmetry
    flake: np.ndarray      # [M, 4] microflake fiber axis xyz + SGGX sigma
    het: np.ndarray        # [M] i32: 1 = density-grid medium
    grid_data: np.ndarray  # [G] f32: all density grids, flattened
    grid_offset: np.ndarray  # [M] i32 into grid_data
    grid_res: np.ndarray   # [M, 3] i32 (nx, ny, nz)
    world_to_grid: np.ndarray  # [M, 4, 4] world -> [0,1]^3 volume space
    max_density: np.ndarray    # [M] majorant density
    # microflake orientation volumes (gridvolume-driven per-voxel fiber
    # axes, the reference's heterogeneous <volume name="orientation">
    # consumed by microflake.cpp): xyz-interleaved flattened vector
    # grids; offset -1 = constant axis from `flake` (ops/medium.flake_at)
    orient_data: np.ndarray = np.zeros(3, np.float32)   # [3*Go]
    orient_offset: np.ndarray = -np.ones(1, np.int32)   # [M] element offs
    orient_res: np.ndarray = np.ones((1, 3), np.int32)  # [M, 3]
    orient_w2g: np.ndarray = np.eye(4, dtype=np.float32)[None]  # [M,4,4]
    # linear part of (medium toWorld @ volume toWorld): grid-space fiber
    # vectors transform to WORLD space before normalization (the
    # reference's gridvolume lookupVector semantics)
    orient_l2w: np.ndarray = np.eye(3, dtype=np.float32)[None]  # [M,3,3]


_UNIT_GRID = np.ones(1, np.float32)
_EYE4 = np.eye(4, dtype=np.float32)


def _hom_grid_fields(m):
    return dict(
        het=np.zeros(m, np.int32),
        grid_data=_UNIT_GRID.copy(),
        grid_offset=np.zeros(m, np.int32),
        grid_res=np.ones((m, 3), np.int32),
        world_to_grid=np.broadcast_to(_EYE4, (m, 4, 4)).copy(),
        max_density=np.ones(m, np.float32))


def vacuum_table() -> MediumTable:
    z = np.zeros((1, 3), np.float32)
    return MediumTable(sigma_s=z, sigma_a=z, sigma_t=z,
                       phase_kind=np.zeros(1, np.int32),
                       g=np.zeros(1, np.float32),
                       flake=np.array([[0, 0, 1, 1]], np.float32),
                       **_hom_grid_fields(1))


def load_vol(path: str, average: bool = True
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Mitsuba .vol grid file (src/volume/gridvolume.cpp fileToVolume):
    'VOL' magic, version 3, int32 type (1 = float32), int32 xres/yres/
    zres, int32 channels, 6 float32 bbox, then data with x fastest.
    Returns (data [nz, ny, nx] scalar (multi-channel averaged) — or
    [nz, ny, nx, ch] raw channels when average=False (orientation
    volumes) — and bbox [2, 3])."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"{path}: not a Mitsuba .vol file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"{path}: unsupported .vol version {version}")
        dtype, nx, ny, nz, ch = struct.unpack("<5i", f.read(20))
        if dtype != 1:
            raise ValueError(f"{path}: only float32 volumes supported")
        bbox = np.array(struct.unpack("<6f", f.read(24)),
                        np.float32).reshape(2, 3)
        data = np.fromfile(f, dtype="<f4", count=nx * ny * nz * ch)
    data = data.reshape(nz, ny, nx, ch).astype(np.float32)
    if average:
        data = data.mean(-1)
    return data, bbox


class MediaBuilder:
    """Deduplicating builder: the same <medium> Plugin object (shared via
    <ref>) maps to one table row."""

    def __init__(self, base_dir: str = "."):
        self.rows: List[Tuple] = []
        self._by_node: dict = {}
        self.base_dir = base_dir
        # per-row grid payloads: (data [nz,ny,nx] or None, w2g [4,4])
        self.grids: List[Tuple] = []
        # per-row orientation payloads: (data [nz,ny,nx,3], w2g) or None
        self.orients: List = []

    def _volume_child(self, node: Plugin, name: str):
        v = node.get(name)
        if isinstance(v, Plugin) and v.kind == "volume":
            return v
        if name == "density":
            # a single unnamed <volume> child means the density volume
            vols = [c for c in node.children if c.kind == "volume"]
            if len(vols) == 1:
                return vols[0]
        return None

    def _load_density(self, node: Plugin):
        """Resolve the 'density' volume of a heterogeneous medium into
        ([nz,ny,nx] grid, world_to_grid)."""
        vol = self._volume_child(node, "density")
        med_tw = np.asarray(node.get("toWorld", np.eye(4)), np.float64)
        if vol is None:
            return np.ones((1, 1, 1), np.float32), np.linalg.inv(med_tw)
        if vol.type == "constvolume":
            v = spectrum_value(vol.get("value"), (1, 1, 1))
            return (np.full((1, 1, 1), float(np.mean(v)), np.float32),
                    np.linalg.inv(med_tw))
        if vol.type != "gridvolume":
            raise ValueError(
                f"volume type '{vol.type}' not supported "
                f"(constvolume/gridvolume)")
        data, bbox = load_vol(
            os.path.join(self.base_dir, vol.get("filename")))
        vol_tw = np.asarray(vol.get("toWorld", np.eye(4)), np.float64)
        # [0,1]^3 grid space -> bbox -> volume toWorld -> medium toWorld
        span = np.maximum(bbox[1] - bbox[0], 1e-12)
        g2b = np.eye(4)
        g2b[:3, :3] = np.diag(span)
        g2b[:3, 3] = bbox[0]
        w2g = np.linalg.inv(med_tw @ vol_tw @ g2b)
        return data, w2g

    def from_plugin(self, node: Plugin) -> int:
        # dedup by node identity; the dict also PINS the node object so
        # a freed Plugin's address can never alias a later one (id()
        # reuse would silently merge distinct media)
        key = id(node)
        if key in self._by_node:
            return self._by_node[key][0]
        if node.type not in ("homogeneous", "heterogeneous"):
            raise ValueError(
                f"medium type '{node.type}' not supported "
                f"(homogeneous/heterogeneous)")
        if node.type == "heterogeneous":
            return self._from_heterogeneous(node, key)
        scale = float(node.get("scale", 1.0))
        mat = node.get("material")
        if mat is not None:
            if mat not in _MATERIALS:
                raise ValueError(f"unknown medium material '{mat}'")
            sigma_s, sigma_a = (np.asarray(v, np.float32)
                                for v in _MATERIALS[mat])
        else:
            sigma_t = spectrum_value(node.get("sigmaT"))
            albedo = spectrum_value(node.get("albedo"))
            if sigma_t is not None:
                albedo = albedo if albedo is not None else np.full(
                    3, 0.75, np.float32)
                sigma_s = sigma_t * albedo
                sigma_a = sigma_t - sigma_s
            else:
                sigma_s = spectrum_value(node.get("sigmaS"), (1.0,) * 3)
                sigma_a = spectrum_value(node.get("sigmaA"), (0.0,) * 3)
        sigma_s = sigma_s * scale
        sigma_a = sigma_a * scale

        kind, g, flake = self._parse_phase(node)
        mid = len(self.rows)
        self.rows.append((sigma_s, sigma_a, kind, g, 0, flake))
        self.grids.append((None, None))
        self.orients.append(None)
        self._by_node[key] = (mid, node)
        return mid

    def _from_heterogeneous(self, node: Plugin, key) -> int:
        """heterogeneous.cpp: sigma_t(p) = density(p) * scale, sigma_s =
        albedo * sigma_t.  The row stores per-unit-density coefficients;
        the grid modulates them."""
        scale = float(node.get("scale", 1.0))
        albedo_vol = self._volume_child(node, "albedo")
        albedo = np.full(3, 0.75, np.float32)
        if albedo_vol is not None:
            if albedo_vol.type == "constvolume":
                albedo = np.asarray(
                    spectrum_value(albedo_vol.get("value"), (0.75,) * 3),
                    np.float32)
            elif albedo_vol.type == "gridvolume":
                data, _ = load_vol(os.path.join(
                    self.base_dir, albedo_vol.get("filename")))
                albedo = np.full(3, float(data.mean()), np.float32)
            else:
                raise ValueError(
                    f"albedo volume '{albedo_vol.type}' not supported")
        else:
            a = spectrum_value(node.get("albedo"))
            if a is not None:
                albedo = np.asarray(a, np.float32)
        sigma_t_unit = np.full(3, scale, np.float32)
        sigma_s = albedo * sigma_t_unit
        sigma_a = sigma_t_unit - sigma_s
        data, w2g = self._load_density(node)
        kind, g, flake = self._parse_phase(node)
        # <volume name="orientation">: per-voxel microflake fiber axes
        # (gridvolume.cpp lookupVector consumed by microflake.cpp).  A
        # constvolume vector just overrides the flake axis; a gridvolume
        # becomes a spatially-varying axis field (ops/medium.flake_at).
        orient = None
        ovol = self._volume_child(node, "orientation")
        if ovol is not None and kind == PHASE_MICROFLAKE:
            med_tw = np.asarray(node.get("toWorld", np.eye(4)), np.float64)
            if ovol.type == "constvolume":
                vec = np.asarray(
                    spectrum_value(ovol.get("value"), (0.0, 0.0, 1.0)),
                    np.float64)
                n = float(np.linalg.norm(vec))
                if n > 1e-9:
                    flake = np.array([vec[0] / n, vec[1] / n, vec[2] / n,
                                      flake[3]], np.float32)
            elif ovol.type == "gridvolume":
                data3, bbox = load_vol(
                    os.path.join(self.base_dir, ovol.get("filename")),
                    average=False)
                if data3.ndim != 4 or data3.shape[-1] != 3:
                    raise ValueError(
                        "orientation gridvolume must have 3 channels")
                vol_tw = np.asarray(ovol.get("toWorld", np.eye(4)),
                                    np.float64)
                span = np.maximum(bbox[1] - bbox[0], 1e-12)
                g2b = np.eye(4)
                g2b[:3, :3] = np.diag(span)
                g2b[:3, 3] = bbox[0]
                orient = (data3,
                          np.linalg.inv(med_tw @ vol_tw @ g2b),
                          (med_tw @ vol_tw)[:3, :3])
            else:
                raise ValueError(
                    f"orientation volume '{ovol.type}' not supported")
        mid = len(self.rows)
        self.rows.append((sigma_s, sigma_a, kind, g, 1, flake))
        self.grids.append((data, w2g))
        self.orients.append(orient)
        self._by_node[key] = (mid, node)
        return mid

    @staticmethod
    def _parse_phase(node: Plugin):
        phase = node.child("phase")
        if phase is None:
            for v in node.props.values():
                if isinstance(v, Plugin) and v.kind == "phase":
                    phase = v
                    break
        kind, g = PHASE_ISOTROPIC, 0.0
        flake = np.array([0, 0, 1, 1], np.float32)
        if phase is not None:
            if phase.type == "isotropic":
                kind = PHASE_ISOTROPIC
            elif phase.type == "hg":
                kind, g = PHASE_HG, float(phase.get("g", 0.0))
            elif phase.type == "rayleigh":
                kind = PHASE_RAYLEIGH
            elif phase.type == "microflake":
                # microflake.cpp: Gaussian flake-normal distribution of
                # width stddev around the great circle perpendicular to
                # the fiber axis.  Realized as an SGGX fiber (Heitz et
                # al. 2015) with sigma ~ stddev: closed-form NDF,
                # projected area and exact visible-normal sampling —
                # no rejection loops (documented deviation).  The
                # reference reads per-voxel orientations from a volume;
                # here the axis is a constant per medium ("orientation").
                kind = PHASE_MICROFLAKE
                axis = np.asarray(
                    phase.get("orientation", np.array([0.0, 0.0, 1.0])),
                    np.float32)
                axis = axis / max(float(np.linalg.norm(axis)), 1e-9)
                sig = float(np.clip(float(phase.get("stddev", 0.1)),
                                    0.02, 1.0))
                flake = np.array([axis[0], axis[1], axis[2], sig],
                                 np.float32)
            else:
                raise ValueError(
                    f"phase type '{phase.type}' not supported "
                    f"(isotropic/hg/rayleigh/microflake)")
        return kind, g, flake

    def finalize(self) -> MediumTable:
        if not self.rows:
            return vacuum_table()
        M = len(self.rows)
        ss = np.stack([r[0] for r in self.rows]).astype(np.float32)
        sa = np.stack([r[1] for r in self.rows]).astype(np.float32)
        het = np.asarray([r[4] for r in self.rows], np.int32)
        # pack all density grids into one flat array (x fastest)
        datas, offsets, res, w2gs, maxd = [], [], [], [], []
        cursor = 0
        for (data, w2g), h in zip(self.grids, het):
            if data is None:
                datas.append(_UNIT_GRID)
                offsets.append(cursor)
                cursor += 1
                res.append((1, 1, 1))
                w2gs.append(_EYE4)
                maxd.append(1.0)
            else:
                flat = data.ravel().astype(np.float32)  # z-major
                datas.append(flat)
                offsets.append(cursor)
                cursor += flat.size
                nz, ny, nx = data.shape
                res.append((nx, ny, nz))
                w2gs.append(np.asarray(w2g, np.float32))
                maxd.append(float(data.max()))
        # pack orientation grids (xyz-interleaved, x fastest)
        odatas, ooffs, ores, ow2g, ol2w = [], [], [], [], []
        ocur = 0
        for orient in self.orients:
            if orient is None:
                ooffs.append(-1)
                ores.append((1, 1, 1))
                ow2g.append(_EYE4)
                ol2w.append(np.eye(3, dtype=np.float32))
            else:
                d3, w2, l2w = orient
                flat = d3.ravel().astype(np.float32)
                odatas.append(flat)
                ooffs.append(ocur)
                ocur += flat.size
                nz, ny, nx = d3.shape[:3]
                ores.append((nx, ny, nz))
                ow2g.append(np.asarray(w2, np.float32))
                ol2w.append(np.asarray(l2w, np.float32))
        return MediumTable(
            sigma_s=ss, sigma_a=sa, sigma_t=ss + sa,
            phase_kind=np.asarray([r[2] for r in self.rows], np.int32),
            g=np.asarray([r[3] for r in self.rows], np.float32),
            flake=np.stack([r[5] for r in self.rows]).astype(np.float32),
            het=het,
            grid_data=np.concatenate(datas).astype(np.float32),
            grid_offset=np.asarray(offsets, np.int32),
            grid_res=np.asarray(res, np.int32),
            world_to_grid=np.stack(w2gs).astype(np.float32),
            max_density=np.asarray(maxd, np.float32),
            orient_data=(np.concatenate(odatas).astype(np.float32)
                         if odatas else np.zeros(3, np.float32)),
            orient_offset=np.asarray(ooffs, np.int32),
            orient_res=np.asarray(ores, np.int32),
            orient_w2g=np.stack(ow2g).astype(np.float32),
            orient_l2w=np.stack(ol2w).astype(np.float32))


def medium_node(plugin: Plugin, name: str):
    """Find a named medium attachment (<medium name="interior" ...> or
    <ref name="interior" id=...>) on a shape/sensor Plugin."""
    v = plugin.get(name)
    if isinstance(v, Plugin) and v.kind == "medium":
        return v
    return None


def unnamed_medium(plugin: Plugin):
    """First unnamed medium child (sensor <ref id="fog"/> pattern)."""
    for c in plugin.children:
        if c.kind == "medium":
            return c
    return None
