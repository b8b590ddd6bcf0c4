"""Square-to-distribution warps (port of mitsubaer_tpu/core/warp.py).

`sample` is (..., 2) uniform in [0, 1)^2; directions come back as (..., 3)
in the local frame (+z up).
"""
from __future__ import annotations

import math

import torch

from .math import INV_PI, INV_TWOPI, safe_sqrt

_TWO_PI = 2.0 * math.pi


def _polar(r, phi, z):
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    return _polar(safe_sqrt(1.0 - z * z), _TWO_PI * sample[..., 1], z)


def square_to_uniform_hemisphere(sample):
    z = sample[..., 0]
    return _polar(safe_sqrt(1.0 - z * z), _TWO_PI * sample[..., 1], z)


def square_to_uniform_hemisphere_pdf():
    return INV_TWOPI


def square_to_uniform_disk(sample):
    r = torch.sqrt(sample[..., 0])
    phi = _TWO_PI * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_triangle(sample):
    """Barycentric (u, v) with u + v <= 1 (warp.cpp:88)."""
    a = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - a, a * sample[..., 1]], dim=-1)


def square_to_uniform_cone(cos_cutoff, sample):
    ct = (1.0 - sample[..., 0]) + sample[..., 0] * cos_cutoff
    return _polar(safe_sqrt(1.0 - ct * ct), _TWO_PI * sample[..., 1], ct)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWOPI / (1.0 - cos_cutoff)


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu concentric disk mapping (warp.cpp:62)."""
    r1 = 2.0 * sample[..., 0] - 1.0
    r2 = 2.0 * sample[..., 1] - 1.0
    use_r1 = torch.abs(r1) > torch.abs(r2)
    r = torch.where(use_r1, r1, r2)
    safe = torch.where(r == 0.0, 1.0, r)
    phi = torch.where(use_r1, (math.pi / 4.0) * (r2 / safe),
                      (math.pi / 2.0) - (r1 / safe) * (math.pi / 4.0))
    phi = torch.where(r == 0.0, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(sample):
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return INV_PI * torch.clamp_min(d[..., 2], 0.0)


def square_to_hg(g, sample):
    """Henyey-Greenstein inverse-CDF sample of cos(theta) about +z
    (hg.cpp:74-98); g is a tensor broadcastable to sample[..., 0]."""
    u0 = sample[..., 0]
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * u0)
    cos_aniso = (1.0 + g * g - sqr_term * sqr_term) / (
        2.0 * torch.where(g == 0, 1.0, g))
    cos_theta = torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * u0, cos_aniso)
    return _polar(safe_sqrt(1.0 - cos_theta * cos_theta),
                  _TWO_PI * sample[..., 1], cos_theta)
