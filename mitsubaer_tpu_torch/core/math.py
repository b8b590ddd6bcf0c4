"""Vector math on (..., 3) float32 tensors (port of mitsubaer_tpu/core/math.py).

Sums over the three components are written out as ((x + y) + z), so the
order of rounding is the same on every device.
"""
from __future__ import annotations

import torch

INV_FOURPI = 0.07957747154594767


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdim else r


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdim), 1e-30))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v/|v|; zero vectors give zeros, not NaN."""
    return v * torch.rsqrt(torch.clamp_min(dot(v, v, True), 1e-24))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 1e-12))
