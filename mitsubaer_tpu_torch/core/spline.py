"""Grid interpolation (port of mitsubaer_tpu/core/spline.py): the cubic
B-spline field of the refractive-index and SDF grids, with its value,
gradient and Hessian (basisspline.h Spline<3>), and the trilinear lookup of
the density grid.

A B-spline lookup gathers the 4x4x4 coefficient neighbourhood of each point
from the flat coefficients with `torch.take`, whose backward is a
scatter-add (the backward of advanced indexing, an index_put_ that
accumulates, serialises where many points share a coefficient), and
contracts it with the per-axis basis weights. The prefilter that turns grid
samples into coefficients runs on the host in numpy at scene build time.

`trilinear` is the plain PyTorch version of the density lookup; the CUDA
kernel that replaces it on the card is wrapped by
models/medium.py::trilinear_lookup.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# prefilter (host side): samples -> B-spline coefficients, recursive
# filtering with the pole sqrt(3) - 2 and mirror boundaries
# ---------------------------------------------------------------------------
_POLE = np.sqrt(3.0) - 2.0


def _prefilter_axis(data: np.ndarray, axis: int) -> np.ndarray:
    c = np.moveaxis(np.asarray(data, np.float64), axis, 0).copy()
    n = c.shape[0]
    if n == 1:
        return np.moveaxis(c, 0, axis)
    z = _POLE
    c *= (1.0 - z) * (1.0 - 1.0 / z)
    # causal initial value: the mirror sum, truncated
    horizon = min(n, max(12, int(np.ceil(np.log(1e-9) / np.log(abs(z))))))
    zn = z
    c0 = c[0].copy()
    for k in range(1, horizon):
        c0 += zn * c[k]
        zn *= z
    c[0] = c0
    for k in range(1, n):
        c[k] += z * c[k - 1]
    # anticausal initial value
    c[n - 1] = (z / (z * z - 1.0)) * (z * c[n - 2] + c[n - 1])
    for k in range(n - 2, -1, -1):
        c[k] = z * (c[k + 1] - c[k])
    return np.moveaxis(c, 0, axis)


def prefilter(data: np.ndarray) -> np.ndarray:
    """Interpolating cubic B-spline coefficients of grid samples (float32)."""
    out = np.asarray(data, np.float64)
    for ax in range(out.ndim):
        out = _prefilter_axis(out, ax)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# basis weights of the coefficients at offsets -1, 0, 1, 2 from the cell,
# at the local coordinate t in [0, 1] (basisspline.h kernel<0|1|2>); t is
# (..., 3), one coordinate an axis, and each returns (..., 3, 4)
# ---------------------------------------------------------------------------
def _bspline_w(t):
    t2 = t * t
    t3 = t2 * t
    return torch.stack([(1.0 - 3.0 * t + 3.0 * t2 - t3) * (1.0 / 6.0),
                        (4.0 - 6.0 * t2 + 3.0 * t3) * (1.0 / 6.0),
                        (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) * (1.0 / 6.0),
                        t3 * (1.0 / 6.0)], dim=-1)


def _bspline_dw(t):
    t2 = t * t
    return torch.stack([(-1.0 + 2.0 * t - t2) * 0.5,
                        (-4.0 * t + 3.0 * t2) * 0.5,
                        (1.0 + 2.0 * t - 3.0 * t2) * 0.5,
                        t2 * 0.5], dim=-1)


def _bspline_d2w(t):
    return torch.stack([1.0 - t, -2.0 + 3.0 * t, 1.0 - 3.0 * t, t], dim=-1)


class SplineGrid3D(NamedTuple):
    """A B-spline field over an axis-aligned box; coeff is (nz, ny, nx)."""

    coeff: torch.Tensor     # (nz, ny, nx) float32
    aabb_min: torch.Tensor  # (3,) world-space box min (x, y, z)
    aabb_max: torch.Tensor  # (3,)


def _grid_coords(grid: SplineGrid3D, p):
    """(cell index (..., 3) int64, local t (..., 3), 1/h (3,)) of world
    points. Sample i sits at min + i h with h = extent / (n - 1); x is
    clamped to [0, n - 1] and the cell to [0, n - 2], so t reaches 1 on the
    upper face."""
    nz, ny, nx = grid.coeff.shape
    res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
    h = (grid.aabb_max - grid.aabb_min) / torch.clamp_min(res - 1.0, 1.0)
    x = (p - grid.aabb_min) / h
    x = torch.minimum(torch.clamp_min(x, 0.0), res - 1.0)
    idx = torch.minimum(torch.clamp_min(torch.floor(x), 0.0),
                        torch.clamp_min(res - 2.0, 0.0))
    return idx.to(torch.int64), x - idx, 1.0 / h


def _gather_neighborhood(grid: SplineGrid3D, idx):
    """The (..., 4z, 4y, 4x) coefficient neighbourhood of each cell, the
    neighbours clamped to the grid."""
    nz, ny, nx = grid.coeff.shape
    offs = torch.arange(-1, 3, device=idx.device)
    ix = torch.clamp(idx[..., 0, None] + offs, 0, nx - 1)
    iy = torch.clamp(idx[..., 1, None] + offs, 0, ny - 1)
    iz = torch.clamp(idx[..., 2, None] + offs, 0, nz - 1)
    flat = (iz[..., :, None, None] * (ny * nx) + iy[..., None, :, None] * nx
            + ix[..., None, None, :])
    return torch.take(grid.coeff, flat)


def _derivatives(grid: SplineGrid3D, p, order: int):
    """(T (..., K, K, K), 1/h) with K = order + 1: T[a, b, c] is the
    neighbourhood contracted with the a-th derivative of the x weights, the
    b-th of the y weights and the c-th of the z weights, in grid units.
    Three batched products form every combination at once."""
    idx, t, inv_h = _grid_coords(grid, p)
    # float32 coefficients promote to the points' dtype, as in JAX
    c = _gather_neighborhood(grid, idx).to(t.dtype)
    w = torch.stack([f(t) for f in (_bspline_w, _bspline_dw,
                                    _bspline_d2w)[:order + 1]],
                    dim=-1)                                # (..., 3, 4, K)
    cx = torch.matmul(c, w[..., 0, :, :].unsqueeze(-3))    # (..., z, y, a)
    cxy = torch.einsum("...zya,...yb->...zab", cx, w[..., 1, :, :])
    return torch.einsum("...zab,...zc->...abc", cxy, w[..., 2, :, :]), inv_h


def value(grid: SplineGrid3D, p):
    return _derivatives(grid, p, 0)[0][..., 0, 0, 0]


def value_gradient(grid: SplineGrid3D, p):
    """(value, world-space gradient) (basisspline.h valueAndGradient)."""
    T, inv_h = _derivatives(grid, p, 1)
    g = torch.stack([T[..., 1, 0, 0], T[..., 0, 1, 0], T[..., 0, 0, 1]], -1)
    return T[..., 0, 0, 0], g * inv_h


def value_gradient_hessian(grid: SplineGrid3D, p):
    """(value, gradient, symmetric Hessian) (basisspline.h
    valueGradientAndHessian)."""
    T, inv_h = _derivatives(grid, p, 2)
    g = torch.stack([T[..., 1, 0, 0], T[..., 0, 1, 0], T[..., 0, 0, 1]], -1)
    hxy, hxz, hyz = T[..., 1, 1, 0], T[..., 1, 0, 1], T[..., 0, 1, 1]
    H = torch.stack([T[..., 2, 0, 0], hxy, hxz,
                     hxy, T[..., 0, 2, 0], hyz,
                     hxz, hyz, T[..., 0, 0, 2]], -1).unflatten(-1, (3, 3))
    return T[..., 0, 0, 0], g * inv_h, H * (inv_h.unsqueeze(-1) * inv_h)


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
