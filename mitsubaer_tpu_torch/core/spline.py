"""Trilinear grid lookup (port of mitsubaer_tpu/core/spline.py::trilinear).

This is the plain PyTorch version of the density lookup; the CUDA kernel
that replaces it on the card is wrapped by models/medium.py::trilinear_lookup.
"""
from __future__ import annotations

import torch


def trilinear(data_zyx: torch.Tensor, aabb_min: torch.Tensor,
              aabb_max: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear value of a (nz, ny, nx) grid at (N, 3) world points; zero
    outside the grid's AABB (gridvolume.cpp semantics)."""
    nz, ny, nx = data_zyx.shape
    res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
    h = (aabb_max - aabb_min) / torch.clamp_min(res - 1.0, 1.0)
    x = (p - aabb_min) / h
    inside = torch.all((x >= 0.0) & (x <= res - 1.0), dim=-1)
    x = torch.minimum(torch.clamp_min(x, 0.0), res - 1.0)
    idx = torch.minimum(torch.clamp_min(torch.floor(x), 0.0),
                        torch.clamp_min(res - 2.0, 0.0)).to(torch.int64)
    t = x - idx
    ix, iy, iz = idx[..., 0], idx[..., 1], idx[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    flat = data_zyx.reshape(-1)
    # flat offsets of the two corners on each axis; the upper one is clamped
    # for a one-voxel axis (idx itself is already in range)
    x0, y0, z0 = ix, iy * nx, iz * (ny * nx)
    x1 = torch.clamp_max(ix + 1, nx - 1)
    y1 = torch.clamp_max(iy + 1, ny - 1) * nx
    z1 = torch.clamp_max(iz + 1, nz - 1) * (ny * nx)

    def lerp_x(zy):
        return flat[zy + x0] * (1 - tx) + flat[zy + x1] * tx

    c00 = lerp_x(z0 + y0)
    c01 = lerp_x(z0 + y1)
    c10 = lerp_x(z1 + y0)
    c11 = lerp_x(z1 + y1)
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    val = c0 * (1 - tz) + c1 * tz
    return torch.where(inside, val, torch.zeros_like(val))
