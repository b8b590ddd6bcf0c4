"""Sensors: ray generation for the nine sensor kinds and the film-point
lookup (port of mitsubaer_tpu/models/sensor.py).

Camera space follows Mitsuba's lookAt frame: x = left, y = up, z = view
direction; film row 0 is the top of the image. `project` is the
perspective camera's whatever the sensor kind, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

import math

from ..core import warp
from ..core.math import dot, normalize
from ..core.transform import apply_point, apply_vector
from ..scene.types import (SENSOR_FLUENCEMETER, SENSOR_IRRADIANCEMETER,
                           SENSOR_ORTHOGRAPHIC, SENSOR_PERSPECTIVE_RDIST,
                           SENSOR_RADIANCEMETER, SENSOR_SPHERICAL,
                           SENSOR_TELECENTRIC, SENSOR_THINLENS, Sensor)


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


def sample_rays(sensor: Sensor, px, py, width, height, u_lens=None,
                kind_hint: int = -1) -> CameraRays:
    """Rays through continuous pixel coordinates px in [0, W], py in
    [0, H] (src/sensors/): perspective, thin lens (aperture disk and focus
    plane; (N, 2) `u_lens`, (0.5, 0.5), the lens centre, where None),
    orthographic, spherical lat-long, radiance meter, radially distorted
    perspective, telecentric, fluence meter and irradiance meter.
    kind_hint: the config's sensor kind (-1 = any); only its model runs,
    as the JAX package compiles only it."""
    def on(*ks):
        return kind_hint < 0 or kind_hint in ks

    ndc_x = 2.0 * px / width - 1.0    # -1 at image left
    ndc_y = 2.0 * py / height - 1.0   # -1 at image top
    ones, zeros = torch.ones_like(ndc_x), torch.zeros_like(ndc_x)
    kind = sensor.kind

    def pick(k, new, old):
        return torch.where(kind == k, new, old)

    d_persp = torch.stack([-ndc_x * sensor.tan_x, -ndc_y * sensor.tan_y,
                           ones], dim=-1)
    d_cam, o_cam = d_persp, torch.zeros_like(d_persp)
    if on(SENSOR_THINLENS, SENSOR_TELECENTRIC):
        if u_lens is None:
            u_lens = torch.full(ndc_x.shape + (2,), 0.5,
                                device=ndc_x.device)
        lens = warp.square_to_uniform_disk_concentric(u_lens) * sensor.aperture
        o_lens = torch.stack([lens[..., 0], lens[..., 1], zeros], dim=-1)
        d_cam = pick(SENSOR_THINLENS, d_persp * sensor.focus - o_lens, d_cam)
        o_cam = pick(SENSOR_THINLENS, o_lens, o_cam)
    if on(SENSOR_ORTHOGRAPHIC, SENSOR_TELECENTRIC):
        # parallel rays; tan_x, tan_y are the half-extents
        o_ortho = torch.stack([-ndc_x * sensor.tan_x,
                               -ndc_y * sensor.tan_y, zeros], dim=-1)
        d_cam = pick(SENSOR_ORTHOGRAPHIC,
                     torch.stack([zeros, zeros, ones], dim=-1), d_cam)
        o_cam = pick(SENSOR_ORTHOGRAPHIC, o_ortho, o_cam)
    if on(SENSOR_SPHERICAL):
        phi = (1.0 - px / width) * 2.0 * math.pi
        theta = py / height * math.pi
        st = torch.sin(theta)
        d_cam = pick(SENSOR_SPHERICAL, torch.stack(
            [st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)],
            dim=-1), d_cam)
    if on(SENSOR_RADIANCEMETER):
        d_cam = pick(SENSOR_RADIANCEMETER,
                     torch.stack([zeros, zeros, ones], dim=-1), d_cam)
    if on(SENSOR_PERSPECTIVE_RDIST):
        # perspective_rdist.cpp: 1 + kc0 r^2 + kc1 r^4
        r2 = ndc_x * ndc_x + ndc_y * ndc_y
        dist = 1.0 + sensor.kc[0] * r2 + sensor.kc[1] * r2 * r2
        d_cam = pick(SENSOR_PERSPECTIVE_RDIST, torch.stack(
            [-ndc_x * dist * sensor.tan_x, -ndc_y * dist * sensor.tan_y,
             ones], dim=-1), d_cam)
    if on(SENSOR_TELECENTRIC):
        # telecentric.cpp: the orthographic footprint plus a thin lens
        o_tele = o_ortho + torch.stack([lens[..., 0], lens[..., 1], zeros],
                                       dim=-1)
        d_tele = (o_ortho + torch.stack([zeros, zeros, ones], dim=-1)
                  * sensor.focus) - o_tele
        d_cam = pick(SENSOR_TELECENTRIC, d_tele, d_cam)
        o_cam = pick(SENSOR_TELECENTRIC, o_tele, o_cam)
    if on(SENSOR_FLUENCEMETER, SENSOR_IRRADIANCEMETER):
        u_f = torch.remainder(torch.stack(
            [px / max(width, 1), py / max(height, 1)], dim=-1), 1.0)
    if on(SENSOR_FLUENCEMETER):
        # fluencemeter.cpp: uniform-sphere rays from the origin
        d_cam = pick(SENSOR_FLUENCEMETER,
                     warp.square_to_uniform_sphere(u_f), d_cam)
    if on(SENSOR_IRRADIANCEMETER):
        # irradiancemeter.cpp: cosine rays from the unit patch
        d_cam = pick(SENSOR_IRRADIANCEMETER,
                     warp.square_to_cosine_hemisphere(u_f), d_cam)
        o_cam = pick(SENSOR_IRRADIANCEMETER,
                     torch.stack([ndc_x, ndc_y, zeros], dim=-1), o_cam)
    return CameraRays(o=apply_point(sensor.to_world, o_cam),
                      d=normalize(apply_vector(sensor.to_world, d_cam)))


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
