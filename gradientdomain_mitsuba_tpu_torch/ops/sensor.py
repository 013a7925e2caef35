"""Sensor (camera) sampling: perspective, thinlens, perspective_rdist,
orthographic, telecentric, spherical, radiancemeter, fluencemeter.

Counterpart of gradientdomain_mitsuba_tpu/ops/sensor.py (src/sensors/
{perspective,thinlens,orthographic,telecentric,spherical,radiancemeter,
fluencemeter,perspective_rdist}.cpp).  Positions are in CONTINUOUS film
coordinates (pixels); the matrices follow Mitsuba's cameraToSample
convention (scene/scene.py _build_sensor).

The reference is one branch-free kernel over all kinds (camera.kind
selects lanes).  Here a tracer reads the camera's kind, aperture and
radial distortion once, when it is built (describe: one host read), and
ray generation and importance run only the selected kind's branch; each
output equals the reference's lane for lane.

Properties of the reference kept as they are: the thin lens's importance
is the pinhole's cos^4 model with the aperture ignored, rdist's
importance is the undistorted model at the distorted film position, and
the meters' films record the MEAN sampled radiance (fluence / 4pi for
the fluencemeter), not the integrated W/m^2.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp

PERSPECTIVE, ORTHOGRAPHIC, SPHERICAL, RADIANCEMETER, FLUENCEMETER = range(5)


class SensorDesc(NamedTuple):
    """A camera with its kind read on the host once (describe)."""
    camera: object       # scene.Camera of tensors
    kind: int            # PERSPECTIVE .. FLUENCEMETER
    lens: bool           # aperture_radius > 0 (thin lens / telecentric)
    rdist: bool          # radial distortion (perspective_rdist) is on
    image_area: object   # 0-d tensor: image-plane area at z = 1
    ortho_area: object   # 0-d tensor: orthographic film area


def _film_corners(camera):
    dev = camera.sample_to_camera.device
    x0 = m.transform_point(camera.sample_to_camera,
                           torch.zeros(3, device=dev))
    x1 = m.transform_point(camera.sample_to_camera,
                           torch.tensor([1.0, 1.0, 0.0], device=dev))
    return x0, x1


def image_area(camera):
    """Area of the image plane at z = 1 in camera space (a 0-d tensor)."""
    x0, x1 = _film_corners(camera)
    x0 = x0 / x0[..., 2:3]
    x1 = x1 / x1[..., 2:3]
    return torch.abs((x1[..., 0] - x0[..., 0]) * (x1[..., 1] - x0[..., 1]))


def describe(camera):
    """Read the camera's kind, aperture and kc (one host read) and the
    film areas the importance needs.  Tracers call it once, when they are
    built."""
    kind, aperture, k1, k2 = torch.stack(
        [camera.kind.float(), camera.aperture_radius.float(),
         camera.kc[0].float(), camera.kc[1].float()]).tolist()
    x0, x1 = _film_corners(camera)
    ortho_area = torch.abs((x1[..., 0] - x0[..., 0]) *
                           (x1[..., 1] - x0[..., 1]))
    return SensorDesc(camera=camera, kind=int(kind), lens=aperture > 0.0,
                      rdist=int(kind) == PERSPECTIVE and (k1 != 0.0 or
                                                          k2 != 0.0),
                      image_area=image_area(camera), ortho_area=ortho_area)


def _undistort(camera, near):
    """perspective_rdist: the film records the DISTORTED projection
    xd = xu (1 + k1 r^2 + k2 r^4), so ray generation inverts the radial
    polynomial with four Newton steps on rd = ru f(ru)."""
    k1, k2 = camera.kc[0], camera.kc[1]
    z_im = near[..., 2:3]
    xy_d = near[..., 0:2] / torch.where(torch.abs(z_im) > 1e-9, z_im, 1.0)
    rd = torch.sqrt(torch.sum(xy_d * xy_d, -1, keepdim=True))
    ru = rd
    for _ in range(4):
        r2 = ru * ru
        g = ru * (1.0 + r2 * (k1 + k2 * r2)) - rd
        dg = 1.0 + r2 * (3.0 * k1 + 5.0 * k2 * r2)
        ru = ru - g / torch.where(torch.abs(dg) > 1e-6, dg, 1.0)
    undist = torch.where(rd > 1e-9, ru / torch.clamp_min(rd, 1e-9), 1.0)
    return m.normalize(torch.cat([xy_d * undist, torch.ones_like(z_im)],
                                 dim=-1))


def _lens_origin(camera, u_aperture):
    lens = (warp.square_to_uniform_disk_concentric(u_aperture) *
            camera.aperture_radius)
    return torch.stack([lens[..., 0], lens[..., 1],
                        torch.zeros_like(lens[..., 0])], dim=-1)


def _plus_z(like):
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return z


def sample_ray(desc, width, height, pos_film, u_aperture):
    """Camera rays of the described sensor.

    pos_film: [N, 2] continuous film position in pixels.
    u_aperture: [N, 2] lens samples (the thin lens and telecentric
    origins on the aperture disk; the fluencemeter's sphere direction).
    Returns (o_world [N,3], d_world [N,3])."""
    cam = desc.camera
    kind = desc.kind
    if kind in (PERSPECTIVE, ORTHOGRAPHIC):
        s = torch.stack([pos_film[..., 0] / width,
                         pos_film[..., 1] / height], dim=-1)
        near = m.transform_point(
            cam.sample_to_camera,
            torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1))
    if kind == PERSPECTIVE:
        d_cam = _undistort(cam, near) if desc.rdist else m.normalize(near)
        o_cam = torch.zeros_like(d_cam)
        if desc.lens:
            # thinlens.cpp: refocus through the focal plane
            o_cam = _lens_origin(cam, u_aperture)
            t_focus = cam.focus_distance / torch.clamp_min(d_cam[..., 2:3],
                                                           1e-9)
            d_cam = m.normalize(d_cam * t_focus - o_cam)
    elif kind == ORTHOGRAPHIC:
        # origin on the film plane, direction +z; telecentric = a lens
        # per pixel refocused through the pixel's focal point
        o_cam = torch.cat([near[..., 0:2], torch.zeros_like(near[..., 2:3])],
                          dim=-1)
        d_cam = _plus_z(o_cam)
        if desc.lens:
            p_focus = o_cam + d_cam * cam.focus_distance
            o_cam = o_cam + _lens_origin(cam, u_aperture)
            d_cam = m.normalize(p_focus - o_cam)
    elif kind == SPHERICAL:
        # lat-long film: d = (sin phi sin theta, cos theta, -cos phi
        # sin theta), phi = (1 - x/W) 2pi, theta = (y/H) pi
        phi = (1.0 - pos_film[..., 0] / width) * (2.0 * math.pi)
        theta = (pos_film[..., 1] / height) * math.pi
        st_, ct_ = torch.sin(theta), torch.cos(theta)
        d_cam = torch.stack([torch.sin(phi) * st_, ct_,
                             -torch.cos(phi) * st_], -1)
        o_cam = torch.zeros_like(d_cam)
    elif kind == RADIANCEMETER:
        # every film sample measures the same (origin, +z) ray
        o_cam = torch.zeros(pos_film.shape[:-1] + (3,),
                            device=pos_film.device)
        d_cam = _plus_z(o_cam)
    else:
        # fluencemeter: uniform-sphere directions from the origin
        d_cam = warp.square_to_uniform_sphere(u_aperture)
        o_cam = torch.zeros_like(d_cam)
    o_w = m.transform_point(cam.to_world, o_cam)
    d_w = m.normalize(m.transform_vector(cam.to_world, d_cam))
    return o_w, d_w


def importance_sample_direct(desc, width, height, p_world):
    """Project world points to the film and compute the sensor's
    importance, for BDPT's t=1 (light tracing) connections
    (perspective.cpp sampleDirect / evalDirection semantics).

    Returns (film_pos [N,2] pixels, We [N], in_frustum [N]): the
    perspective's We = 1 / (A_img cos^4 theta) in directional measure
    (the connection multiplies by the geometry term itself; thin lens
    and rdist alike), the orthographic's 1 / A_film, the spherical's
    1 / (2 pi^2 sin theta); zero outside the frustum and for the meters,
    which are marked invalid."""
    cam = desc.camera
    kind = desc.kind
    p_cam = m.transform_point(cam.world_to_camera, p_world)
    z = p_cam[..., 2]
    if kind == SPHERICAL:
        d_sph = m.normalize(p_cam)
        theta_s = torch.arccos(torch.clamp(d_sph[..., 1], -1.0, 1.0))
        phi_s = torch.remainder(torch.arctan2(d_sph[..., 0], -d_sph[..., 2]),
                                2.0 * math.pi)
        fx = torch.remainder(1.0 - phi_s / (2.0 * math.pi), 1.0)
        fy = theta_s / math.pi
        film = torch.stack([fx * width, fy * height], dim=-1)
        sin_t = torch.clamp_min(torch.sin(theta_s), 1e-6)
        we = 1.0 / (2.0 * math.pi ** 2 * sin_t)
        in_frustum = m.squared_length(p_cam) > 1e-12
        return film, torch.where(in_frustum, we, 0.0), in_frustum
    if desc.rdist:
        # forward-distort the image-plane point before the sample-space
        # transform
        k1, k2 = cam.kc[0], cam.kc[1]
        zc = torch.where(torch.abs(z) > 1e-9, z, 1.0)[..., None]
        xy_u = p_cam[..., 0:2] / zc
        r2 = torch.sum(xy_u * xy_u, -1, keepdim=True)
        f_rd = 1.0 + r2 * (k1 + k2 * r2)
        s = m.transform_point(cam.camera_to_sample, torch.cat(
            [xy_u * f_rd * zc, p_cam[..., 2:3]], dim=-1))
    else:
        s = m.transform_point(cam.camera_to_sample, p_cam)
    film = torch.stack([s[..., 0] * width, s[..., 1] * height], dim=-1)
    if kind >= RADIANCEMETER:
        # no meaningful light-tracing connection to an image plane
        no = torch.zeros_like(z, dtype=torch.bool)
        return film, torch.zeros_like(z), no
    in_frustum = ((z > 1e-6) & (s[..., 0] >= 0) & (s[..., 0] < 1) &
                  (s[..., 1] >= 0) & (s[..., 1] < 1))
    if kind == ORTHOGRAPHIC:
        we = (1.0 / torch.clamp_min(desc.ortho_area, 1e-12)).expand(
            z.shape)
    else:
        cos_theta = m.normalize(p_cam)[..., 2]
        we = 1.0 / torch.clamp_min(desc.image_area * cos_theta ** 4, 1e-12)
    return film, torch.where(in_frustum, we, 0.0), in_frustum
