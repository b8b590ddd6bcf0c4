"""Participating media on the ported paths (port of
mitsubaer_tpu/models/medium.py): medium parameters, the heterogeneous density
lookup (kernel A), Woodcock distance sampling, ratio-tracking
transmittance and homogeneous distance sampling.

Kernel A, `trilinear_lookup`, replaces the JAX package's
`DensityBricks.lookup` as a whole (the 8x4x4 apron-brick gather plus the
Pallas `_trilinear_brick_kernel`, medium.py:118-252). It reads a table of
corner-packed cells (`cell_table`): one record of the 8 corner values a
cell, so a lookup is one 32-byte (f32) or 16-byte (bf16) load. The table
takes about 8x the grid's f32 bytes (4x in bf16). The brick repack and the
bf16 weight product were TPU gather and VPU tricks and are not carried over;
where the JAX caller stores bricks in bf16, `DensityGrid(dtype=torch.bfloat16)`
rounds the grid to bf16 once so the values match, and keeps its table in
bf16.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core import rng, spline
from ..scene.types import Media

INF = 3.0e38


def trilinear_lookup_plain(grid, aabb6, p):
    """Plain PyTorch version of kernel A: trilinear value of the (nz, ny, nx)
    grid at (N, 3) points, zero outside the AABB aabb6 = [min xyz, max xyz]."""
    return spline.trilinear(grid, aabb6[:3], aabb6[3:], p)


def cell_table(grid, dtype=torch.float32):
    """Kernel A's cell records: for each of the max(nz-1,1) x max(ny-1,1) x
    max(nx-1,1) cells of the (nz, ny, nx) grid, its 8 corner values in the
    order the lerp reads them, (dz, dy, dx) = 000, 001, ..., 111, each corner
    index clamped to res - 1. Returns a contiguous (cz, cy, cx, 8) tensor."""
    def ends(res):      # the cells' lower and upper corner indices on an axis
        return slice(0, max(res - 1, 1)), slice(min(res - 1, 1), None)

    zs, ys, xs = (ends(r) for r in grid.shape)
    return torch.stack([grid[z, y, x] for z in zs for y in ys for x in xs],
                       dim=-1).to(dtype)


def trilinear_lookup(grid, cells, aabb6, p):
    """Kernel A (csrc/trilinear.cu) on the cell table `cells` of `grid` for a
    CUDA tensor p, the plain version on `grid` for a CPU one (`cells` is
    then not read). A lookup is a few microseconds of device time, so the
    checks stay few: each costs host time on every call."""
    if p.is_cpu:
        return trilinear_lookup_plain(grid, aabb6, p)
    if not p.is_cuda:
        raise ValueError(f"trilinear_lookup: unsupported device {p.device}")
    p = p.contiguous()
    kernels.require_cuda("trilinear_lookup", cells, aabb6, p)
    if p.dtype != torch.float32 or aabb6.dtype != torch.float32 or \
            cells.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"trilinear_lookup: expected float32 p and aabb6 "
                         f"and a float32 or bfloat16 table, got {p.dtype}, "
                         f"{aabb6.dtype} and {cells.dtype}")
    nz, ny, nx = grid.shape
    if p.dim() != 2 or p.shape[1] != 3 or cells.data_ptr() % 16 or \
            cells.shape != (max(nz - 1, 1), max(ny - 1, 1), max(nx - 1, 1), 8):
        raise ValueError("trilinear_lookup: expected p (N, 3) and the grid's "
                         "cell table")
    n = p.shape[0]
    out = p.new_empty((n,))
    if n == 0:
        return out
    with kernels.on_device(p):
        rc = kernels.library().mk_trilinear_lookup(
            p.data_ptr(), cells.data_ptr(), aabb6.data_ptr(), out.data_ptr(),
            n, nx, ny, nz, int(cells.dtype == torch.bfloat16),
            kernels.stream(p))
    kernels.check(rc, "trilinear_lookup")
    trilinear_lookup.launches += 1
    return out


trilinear_lookup.launches = 0


def params(media: Media, idx, sampling_weight: bool = False):
    """(kind, sigma_a, sigma_s, scale) of medium idx; kind is -1 for idx < 0.
    With sampling_weight, (kind, sigma_a, sigma_s, sampling_weight, scale),
    the JAX package's five values."""
    i = torch.clamp(idx, 0, media.kind.shape[0] - 1).to(torch.int64)
    kind = torch.where(idx >= 0, media.kind[i], -1)
    if sampling_weight:
        return (kind, media.sigma_a[i], media.sigma_s[i],
                media.sampling_weight[i], media.scale[i])
    return kind, media.sigma_a[i], media.sigma_s[i], media.scale[i]


class DensityGrid:
    """The heterogeneous density grid as kernel A reads it (replaces the
    JAX package's DensityBricks): the (nz, ny, nx) f32 grid for the plain
    version and its cell table for the kernel, built at the first lookup
    on the card (the plain version does not read it). dtype=torch.bfloat16
    rounds the stored values to bf16, as the JAX callers that store bf16
    bricks do, and keeps the table in bf16."""

    def __init__(self, media: Media, dtype=None):
        grid = media.density.data
        if dtype is not None:
            grid = grid.to(dtype).to(torch.float32)
        self.grid = grid.contiguous()
        self.aabb6 = torch.cat([media.density.aabb_min,
                                media.density.aabb_max]).to(torch.float32)
        self._table_dtype = dtype or torch.float32
        self._cells = None

    @property
    def cells(self):
        """Kernel A's cell table of the grid (`cell_table`), built once."""
        if self._cells is None:
            self._cells = cell_table(self.grid, self._table_dtype)
        return self._cells

    def lookup(self, p):
        cells = self.cells if p.is_cuda else None
        return trilinear_lookup(self.grid, cells, self.aabb6, p)


def density_at(media: Media, p):
    """Heterogeneous density at (N, 3) world points, zero outside the grid."""
    return DensityGrid(media).lookup(p)


def eval_transmittance_homogeneous(sigma_a, sigma_s, dist):
    return torch.exp(-(sigma_a + sigma_s) * dist.unsqueeze(-1))


def _mean3(x):
    return (x[..., 0] + x[..., 1] + x[..., 2]) / 3.0


def homog_strategy_pdfs(sigma_t, dist):
    """(pdf_success per unit length, pdf_failure) of the balance-strategy
    homogeneous distance sampler at `dist` (homogeneous.cpp pdfDistance /
    pdfFailure). The other strategies (cfg.medium_strategies) are not ported
    (ROADMAP Queue 1 step 7)."""
    tmp = torch.exp(-sigma_t * dist.unsqueeze(-1))
    return _mean3(sigma_t * tmp), _mean3(tmp)


def sample_distance_homogeneous(sigma_a, sigma_s, sampling_weight, t_max, u,
                                uc):
    """Balance-strategy distance sample: a channel picked by u, an
    exponential distance in it, gated into the medium with probability
    sampling_weight by uc. Returns (success, dist, weight, log_pdf)."""
    sigma_t = sigma_a + sigma_s
    w = sampling_weight
    in_medium = uc < w
    u_resc = torch.where(in_medium, uc / torch.clamp_min(w, 1e-9), 0.0)
    ch = torch.clamp((u * 3).to(torch.int64), 0, 2)
    dens = torch.clamp_min(
        torch.gather(sigma_t, -1, ch.unsqueeze(-1)).squeeze(-1), 1e-20)
    t_sample = torch.where(in_medium, -torch.log1p(-u_resc) / dens, INF)
    success = t_sample < t_max
    dist = torch.minimum(t_sample, t_max)
    pdf_succ, pdf_fail = homog_strategy_pdfs(sigma_t, dist)
    tr = torch.exp(-sigma_t * dist.unsqueeze(-1))
    pdf_succ = pdf_succ * w
    pdf_fail = w * pdf_fail + (1.0 - w)
    w_succ = sigma_s * tr / torch.clamp_min(pdf_succ, 1e-12).unsqueeze(-1)
    w_fail = tr / torch.clamp_min(pdf_fail, 1e-12).unsqueeze(-1)
    weight = torch.where(success.unsqueeze(-1), w_succ, w_fail)
    log_pdf = torch.log(torch.clamp_min(
        torch.where(success, pdf_succ, pdf_fail), 1e-30))
    return success, dist, weight, log_pdf


def transmittance_ratio_tracking(media: Media, sigma_a, sigma_s, scale, o, d,
                                 t_max, smp, active, max_steps: int = 4096,
                                 bricks=None):
    """Unbiased ratio-tracking transmittance along shadow segments. Every
    lane draws one number per step whether it runs or not, in steps of
    UNROLL as in the JAX package, so the streams stay aligned with it."""
    if bricks is None:
        bricks = DensityGrid(media)
    st_color = sigma_a + sigma_s
    majorant = torch.clamp_min(media.majorant * torch.amax(st_color, dim=-1),
                               1e-6)
    unroll = 4
    n = o.shape[0]
    t = torch.zeros((n,), dtype=torch.float32, device=o.device)
    tr = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    running = active
    it = 0
    while it < max_steps and bool(running.any()):
        for _ in range(unroll):
            u1, smp = rng.next_1d(smp)
            t_new = t - torch.log1p(-u1) / majorant
            escaped = t_new >= t_max
            p = o + t_new.unsqueeze(-1) * d
            dens = bricks.lookup(p) * scale
            factor = 1.0 - dens.unsqueeze(-1) * st_color \
                / majorant.unsqueeze(-1)
            tr = torch.where((running & ~escaped).unsqueeze(-1), tr * factor,
                             tr)
            t = torch.where(running, t_new, t)
            running = running & ~escaped
        it += 1
    return torch.clamp_min(tr, 0.0), smp


def sample_distance_woodcock(media: Media, sigma_a, sigma_s, scale, o, d,
                             t_max, smp, active, max_steps: int = 4096,
                             bricks=None):
    """Delta tracking along (o, d) up to t_max against the scene majorant
    (medium.py:534-607). Collisions are tested against the mean channel's
    extinction; the spectral weight takes sigma_s / sigma_t_mean at a real
    collision and (1 - sigma_t_c / majorant) / (1 - p_real) at a null one.
    Every lane draws two numbers per step whether it runs or not, UNROLL
    steps an iteration, so the streams stay aligned with the JAX package.
    Returns (hit, dist, weight, p, smp, iterations): dist is t_max where
    nothing was hit, p the last tested point. The JAX function's log_pdf
    (the score term of gradients) is not returned (ROADMAP Queue 1 step 8)."""
    if bricks is None:
        bricks = DensityGrid(media)
    st_color = sigma_a + sigma_s
    st_mean = _mean3(st_color)
    majorant = torch.clamp_min(media.majorant * torch.amax(st_color, dim=-1),
                               1e-6)
    w_real = sigma_s / torch.clamp_min(st_mean, 1e-12).unsqueeze(-1)
    unroll = 4
    n = o.shape[0]
    t = torch.zeros((n,), dtype=torch.float32, device=o.device)
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    w = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    running = active
    it = 0
    while it < max_steps and bool(running.any()):
        for _ in range(unroll):
            u1, smp = rng.next_1d(smp)
            u2, smp = rng.next_1d(smp)
            t_new = t - torch.log1p(-u1) / majorant
            escaped = t_new >= t_max
            dens = bricks.lookup(o + t_new.unsqueeze(-1) * d) * scale
            p_real = dens * st_mean / majorant
            real = u2 < p_real
            hit_new = running & ~escaped & real
            null_col = running & ~escaped & ~real
            w_null = (1.0 - dens.unsqueeze(-1) * st_color
                      / majorant.unsqueeze(-1)) \
                / torch.clamp_min(1.0 - p_real, 1e-12).unsqueeze(-1)
            w = torch.where(hit_new.unsqueeze(-1), w * w_real, w)
            w = torch.where(null_col.unsqueeze(-1), w * w_null, w)
            t = torch.where(running, t_new, t)
            hit = hit | hit_new
            running = null_col
        it += 1
    p = o + t.unsqueeze(-1) * d
    return hit, torch.where(hit, t, t_max), w, p, smp, it
