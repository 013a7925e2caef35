"""Sensor (camera) ray generation.

Counterpart of gradientdomain_mitsuba_tpu/ops/sensor.py for the
perspective pinhole camera (src/sensors/perspective.cpp).  Positions are
in CONTINUOUS film coordinates (pixels); the matrices follow Mitsuba's
cameraToSample convention (scene/scene.py _build_sensor), and the
sensor importance BDPT's light tracing needs (importance_sample_direct).
Thinlens, orthographic, spherical, meter sensors and radial distortion
(perspective_rdist) are not ported yet (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import torch

from ..core import math as m


def check_supported(camera):
    """Raise unless the camera is a pinhole perspective one (kind 0, no
    aperture, no radial distortion).  One host read of four scalars."""
    kind, aperture, k1, k2 = torch.stack(
        [camera.kind.float(), camera.aperture_radius.float(),
         camera.kc[0].float(), camera.kc[1].float()]).tolist()
    if kind != 0.0 or aperture != 0.0 or k1 != 0.0 or k2 != 0.0:
        raise NotImplementedError(
            f"sensor kind {kind} (aperture {aperture}, kc {k1},{k2}): "
            "only the perspective pinhole is ported (ROADMAP Queue 1 "
            "item 14)")


def sample_ray(camera, width, height, pos_film, u_aperture):
    """Camera rays of a pinhole perspective camera.

    pos_film: [N, 2] continuous film position in pixels.
    u_aperture: [N, 2] lens samples (a pinhole ignores them; kept for the
    reference's signature).  Returns (o_world [N,3], d_world [N,3]).
    Raises for every other sensor kind."""
    check_supported(camera)
    s = torch.stack([pos_film[..., 0] / width, pos_film[..., 1] / height],
                    dim=-1)
    near = m.transform_point(
        camera.sample_to_camera,
        torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1))
    d_cam = m.normalize(near)
    o_cam = torch.zeros_like(d_cam)
    o_w = m.transform_point(camera.to_world, o_cam)
    d_w = m.normalize(m.transform_vector(camera.to_world, d_cam))
    return o_w, d_w


def image_area(camera):
    """Area of the image plane at z = 1 in camera space (a 0-d tensor)."""
    dev = camera.sample_to_camera.device
    x0 = m.transform_point(camera.sample_to_camera,
                           torch.zeros(3, device=dev))
    x1 = m.transform_point(camera.sample_to_camera,
                           torch.tensor([1.0, 1.0, 0.0], device=dev))
    x0 = x0 / x0[..., 2:3]
    x1 = x1 / x1[..., 2:3]
    return torch.abs((x1[..., 0] - x0[..., 0]) * (x1[..., 1] - x0[..., 1]))


def importance_sample_direct(camera, width, height, p_world):
    """Project world points to the film and compute the sensor's
    importance, for BDPT's t=1 (light tracing) connections
    (perspective.cpp sampleDirect / evalDirection semantics).

    Returns (film_pos [N,2] pixels, We [N] = 1 / (A_img cos^4 theta) in
    directional measure, zero outside the frustum, in_frustum [N]).
    Raises for every other sensor kind, perspective_rdist included
    (ROADMAP Queue 1 item 14)."""
    check_supported(camera)
    p_cam = m.transform_point(camera.world_to_camera, p_world)
    z = p_cam[..., 2]
    s = m.transform_point(camera.camera_to_sample, p_cam)
    in_frustum = ((z > 1e-6) & (s[..., 0] >= 0) & (s[..., 0] < 1) &
                  (s[..., 1] >= 0) & (s[..., 1] < 1))
    film = torch.stack([s[..., 0] * width, s[..., 1] * height], dim=-1)
    # the connection kernel multiplies by the geometry term itself
    cos_theta = m.normalize(p_cam)[..., 2]
    we = 1.0 / torch.clamp_min(image_area(camera) * cos_theta ** 4, 1e-12)
    return film, torch.where(in_frustum, we, 0.0), in_frustum
