"""Perspective camera: ray generation and film-point lookup (port of
mitsubaer_tpu/models/sensor.py::sample_rays, perspective only, and project).

Camera space follows Mitsuba's lookAt frame: x = left, y = up, z = view
direction; film row 0 is the top of the image.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import not_ported
from ..core.math import dot, normalize
from ..core.transform import apply_point, apply_vector
from ..scene.types import SENSOR_PERSPECTIVE, Sensor


@dataclass(frozen=True)
class FilmSample:
    px: torch.Tensor               # continuous pixel x
    py: torch.Tensor
    valid: torch.Tensor            # inside the frustum and in front
    inv_pixel_omega: torch.Tensor  # 1 / solid angle of one pixel there
    d: torch.Tensor                # unit direction toward the camera


@dataclass(frozen=True)
class CameraRays:
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3) unit


def sample_rays(sensor: Sensor, px, py, width, height) -> CameraRays:
    """Pinhole rays through continuous pixel coordinates px in [0, W],
    py in [0, H] (perspective.cpp). Other sensor kinds raise."""
    if int(sensor.kind) != SENSOR_PERSPECTIVE:
        raise not_ported(f"sensor kind {int(sensor.kind)}", 9)
    ndc_x = 2.0 * px / width - 1.0    # -1 at image left
    ndc_y = 2.0 * py / height - 1.0   # -1 at image top
    d_cam = torch.stack([-ndc_x * sensor.tan_x, -ndc_y * sensor.tan_y,
                         torch.ones_like(ndc_x)], dim=-1)
    o = apply_point(sensor.to_world, torch.zeros_like(d_cam))
    return CameraRays(o=o, d=normalize(apply_vector(sensor.to_world, d_cam)))


def project(sensor: Sensor, p_world, width, height) -> FilmSample:
    """Project (N, 3) world points to film coordinates (light-image
    splatting; perspective.cpp samplePosition inverse)."""
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    q = p_world - t
    # p_cam = q @ R (R^T applied from the right), sums written out
    p_cam = [q[..., 0] * R[0, j] + q[..., 1] * R[1, j] + q[..., 2] * R[2, j]
             for j in range(3)]
    z = p_cam[2]
    valid = z > torch.clamp_min(sensor.near, 1e-6)
    inv_z = 1.0 / torch.where(valid, z, torch.ones_like(z))
    ndc_x = -p_cam[0] * inv_z / sensor.tan_x
    ndc_y = -p_cam[1] * inv_z / sensor.tan_y
    px = (ndc_x + 1.0) * 0.5 * width
    py = (ndc_y + 1.0) * 0.5 * height
    valid = valid & (px >= 0) & (px < width) & (py >= 0) & (py < height)

    to_cam = t - p_world
    d = to_cam * torch.rsqrt(torch.clamp_min(dot(to_cam, to_cam), 1e-20)
                             ).unsqueeze(-1)
    # solid angle of one pixel along d: (4 tanx tany / (W H)) cos^3(theta)
    cos_theta = dot(-d, normalize(R[:, 2]))
    A = 4.0 * sensor.tan_x * sensor.tan_y
    inv_omega = (width * height) / torch.clamp_min(
        A * (cos_theta * cos_theta * cos_theta), 1e-12)
    return FilmSample(px=px, py=py, valid=valid, inv_pixel_omega=inv_omega,
                      d=d)
