"""Sensor (camera) ray generation.

Counterpart of gradientdomain_mitsuba_tpu/ops/sensor.py for the
perspective pinhole camera (src/sensors/perspective.cpp).  Positions are
in CONTINUOUS film coordinates (pixels); the matrices follow Mitsuba's
cameraToSample convention (scene/scene.py _build_sensor).  Thinlens,
orthographic, spherical, meter sensors and radial distortion are not
ported yet (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import torch

from ..core import math as m


def check_supported(camera):
    """Raise unless the camera is a pinhole perspective one (kind 0, no
    aperture, no radial distortion).  One host read of three scalars."""
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
