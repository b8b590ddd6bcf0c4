"""Participating media on the ported paths (port of
mitsubaer_tpu/models/medium.py): medium parameters, the heterogeneous density
lookup (kernel A) and its gradient (kernel A', `TrilinearLookup`), the
orientation field's per-lane axes, Woodcock
distance sampling, ratio-tracking transmittance and homogeneous distance
sampling under the four strategies of homogeneous.cpp, each with the
differentiable mode of the JAX package (detached sampling decisions,
attached weights, and the log-density of the decisions for the score
term).

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

from dataclasses import replace

import torch

from .. import kernels
from ..core import rng, spline
from ..core.math import take_rows
from ..scene.types import (STRAT_MANUAL, STRAT_MAXIMUM, STRAT_SINGLE,
                           Media)

INF = 3.0e38
UNROLL = 4      # collision tests a trip of the tracking loops, as in JAX
MAX_STEPS = 4096        # the tracking loops' trip cap in forward mode
SETTLE_EVERY = 8        # trips between the Woodcock loop's settled checks
# the longest Woodcock step, in units of 1 / majorant: -log1p(-u) for the
# largest uniform the samplers give (1 - 2^-24), 16.64, rounded up
_MAX_STEP = 17.0
DIFF_MAX_TESTS = 64     # the differentiable tracking loops' cap in tests


def bounded_while(running_of, body, state, max_trips: int,
                  differentiable: bool, skip, settled_of=None):
    """The tracking loops' host loop (medium.py:37-45): body(state) while
    some lane of running_of(state) runs, at most max_trips times. Returns
    (state, trips run). The JAX package runs a while loop in forward mode
    and, when it differentiates, a scan of exactly max_trips trips. The
    bodies mask themselves on their running flags, so a trip after the
    last lane stopped changes nothing but the sampler: every lane still
    draws its numbers. In differentiable mode skip(state, k) therefore
    stands for the k trips not run (it advances the samplers' dimensions),
    so the streams that follow stay the scan's. settled_of(state, k), where
    given, is checked every SETTLE_EVERY trips: true where some lane still
    runs and the k trips left are known to change nothing but the sampler
    and to run to the cap (the while loop's own end), which skip(state, k)
    then stands for."""
    trips = 0
    while trips < max_trips and bool(running_of(state).any()):
        state = body(state)
        trips += 1
        if (settled_of is not None and trips % SETTLE_EVERY == 0
                and trips < max_trips
                and settled_of(state, max_trips - trips)):
            return skip(state, max_trips - trips), max_trips
    if differentiable and trips < max_trips:
        state = skip(state, max_trips - trips)
    return state, trips


def skip_draws(smp: rng.Sampler, k: int) -> rng.Sampler:
    """The sampler after k draws whose values are not needed."""
    return replace(smp, dim=(smp.dim + k) & rng.M32)


def tracking_trips(max_steps: int, differentiable: bool) -> int:
    """The trip cap of a tracking loop: max_steps trips of UNROLL tests in
    forward mode, ceil(min(max_steps, 64) / UNROLL) in differentiable mode
    (medium.py:597-600, 646-649). A lane still running at the
    differentiable cap is truncated: it keeps the weights so far and, in
    Woodcock tracking, reports no hit."""
    if differentiable:
        return (min(max_steps, DIFF_MAX_TESTS) + UNROLL - 1) // UNROLL
    return max_steps


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


def _cell_weights(shape, aabb6, p):
    """Kernel A's cell arithmetic: (inside, cell (N, 3) int64, t (N, 3)) of
    (N, 3) points on an (nz, ny, nx) grid, per axis (x, y, z)."""
    nz, ny, nx = shape
    res = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
    h = (aabb6[3:] - aabb6[:3]) / torch.clamp_min(res - 1.0, 1.0)
    v = (p - aabb6[:3]) / h
    inside = torch.all((v >= 0.0) & (v <= res - 1.0), dim=-1)
    v = torch.minimum(torch.clamp_min(v, 0.0), res - 1.0)
    cell = torch.minimum(torch.clamp_min(torch.floor(v), 0.0),
                         torch.clamp_min(res - 2.0, 0.0))
    return inside, cell.to(torch.int64), v - cell


def trilinear_lookup_backward_plain(shape, aabb6, p, grad_out):
    """Plain PyTorch version of kernel A': the gradient of kernel A's
    lookups with respect to the (nz, ny, nx) grid of `shape`, for the
    (N,) gradient grad_out of the outputs at the (N, 3) points p. Each
    point inside the AABB adds grad_out * w_k to its 8 corner voxels, the
    weights formed in the order autograd forms them through the lerps
    ((g (1 - tz)) (1 - ty)) (1 - tx), ...; corner indices are clamped to
    res - 1, so on a one-voxel axis the two coinciding corners add both
    their weights to one voxel. One index_add_ scatters all 8 N terms."""
    nz, ny, nx = shape
    inside, cell, t = _cell_weights(shape, aabb6, p)
    g = torch.where(inside, grad_out, 0.0)
    tx, ty, tz = t.unbind(-1)
    x0, y0, z0 = cell.unbind(-1)
    x1 = torch.clamp_max(x0 + 1, nx - 1)
    y1 = torch.clamp_max(y0 + 1, ny - 1)
    z1 = torch.clamp_max(z0 + 1, nz - 1)
    idx, val = [], []
    for z, gz in ((z0, g * (1.0 - tz)), (z1, g * tz)):
        for y, gzy in ((y0, gz * (1.0 - ty)), (y1, gz * ty)):
            for x, w in ((x0, gzy * (1.0 - tx)), (x1, gzy * tx)):
                idx.append((z * ny + y) * nx + x)
                val.append(w)
    out = torch.zeros((nz * ny * nx,), dtype=grad_out.dtype, device=p.device)
    out.index_add_(0, torch.cat(idx), torch.cat(val))
    return out.reshape(nz, ny, nx)


def trilinear_lookup_backward(shape, aabb6, p, grad_out):
    """Kernel A' (csrc/trilinear.cu, `mk_trilinear_lookup_backward`): the
    grid gradient of kernel A's lookups, as trilinear_lookup_backward_plain
    computes it, for CUDA tensors; the plain version for CPU ones. The C
    entry zeroes the grid on the stream, and the kernel sums each voxel in
    fixed point (int64, scaled from the largest |grad_out|), so the result
    has the same bits on every run of the same inputs; it lies within
    float rounding of the plain version's float sums."""
    if p.is_cpu:
        return trilinear_lookup_backward_plain(shape, aabb6, p, grad_out)
    if not p.is_cuda:
        raise ValueError(f"trilinear_lookup_backward: unsupported device "
                         f"{p.device}")
    p, grad_out = p.contiguous(), grad_out.contiguous()
    kernels.require_cuda("trilinear_lookup_backward", p, grad_out, aabb6)
    if p.dtype != torch.float32 or grad_out.dtype != torch.float32 or \
            aabb6.dtype != torch.float32:
        raise ValueError(f"trilinear_lookup_backward: expected float32 "
                         f"tensors, got {p.dtype}, {grad_out.dtype} and "
                         f"{aabb6.dtype}")
    n = p.shape[0]
    if p.dim() != 2 or p.shape[1] != 3 or grad_out.shape != (n,):
        raise ValueError("trilinear_lookup_backward: expected p (N, 3) and "
                         "grad_out (N,)")
    nz, ny, nx = shape
    if n == 0:
        return torch.zeros((nz, ny, nx), dtype=torch.float32, device=p.device)
    grad = torch.empty((nz, ny, nx), dtype=torch.float32, device=p.device)
    acc = torch.empty((nz * ny * nx + 1,), dtype=torch.int64,
                      device=p.device)
    with kernels.on_device(p):
        rc = kernels.library().mk_trilinear_lookup_backward(
            p.data_ptr(), grad_out.data_ptr(), aabb6.data_ptr(),
            grad.data_ptr(), acc.data_ptr(), n, nx, ny, nz,
            kernels.stream(p))
    kernels.check(rc, "trilinear_lookup_backward")
    trilinear_lookup_backward.launches += 1
    return grad


trilinear_lookup_backward.launches = 0


class TrilinearLookup(torch.autograd.Function):
    """Kernel A with its gradient to the grid: forward is kernel A on the
    cell table `cells` (built from the detached grid), backward kernel A'.
    On CPU tensors both are the plain versions. The JAX package
    differentiates its unfused lookup with XLA; there the positions are
    detached (medium.py:506, 571), and here a p that requires grad raises
    rather than getting no gradient."""

    @staticmethod
    def forward(ctx, grid, cells, aabb6, p):
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[2]:
            raise ValueError("TrilinearLookup: no gradient flows to the "
                             "points or the AABB; detach them")
        ctx.save_for_backward(aabb6, p)
        ctx.shape = tuple(grid.shape)
        return trilinear_lookup(grid.detach(), cells, aabb6, p)

    @staticmethod
    def backward(ctx, grad_out):
        aabb6, p = ctx.saved_tensors
        grad = trilinear_lookup_backward(ctx.shape, aabb6, p, grad_out)
        return grad, None, None, None


def params(media: Media, idx, sampling_weight: bool = False):
    """(kind, sigma_a, sigma_s, scale) of medium idx; kind is -1 for idx < 0.
    With sampling_weight, (kind, sigma_a, sigma_s, sampling_weight, scale),
    the JAX package's five values."""
    i = torch.clamp(idx, 0, media.kind.shape[0] - 1).to(torch.int64)
    kind = torch.where(idx >= 0, media.kind[i], -1)
    sa, ss = take_rows(media.sigma_a, i), take_rows(media.sigma_s, i)
    if sampling_weight:
        return kind, sa, ss, media.sampling_weight[i], media.scale[i]
    return kind, sa, ss, media.scale[i]


class DensityGrid:
    """The heterogeneous density grid as kernel A reads it (replaces the
    JAX package's DensityBricks): the (nz, ny, nx) f32 grid for the plain
    version and its cell table for the kernel, built once, at the first
    lookup on the card, from the detached grid (the plain version does not
    read it). Where the grid requires grad and grad is enabled, lookups go
    through `TrilinearLookup` (kernel A forward, kernel A' backward); a
    checkpointed bounce that runs again finds the table built.
    dtype=torch.bfloat16 rounds the stored values to bf16, as the JAX
    callers that store bf16 bricks do, and keeps the table in bf16."""

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
            self._cells = cell_table(self.grid.detach(), self._table_dtype)
        return self._cells

    def lookup(self, p):
        cells = self.cells if p.is_cuda else None
        if self.grid.requires_grad and torch.is_grad_enabled():
            return TrilinearLookup.apply(self.grid, cells, self.aabb6, p)
        return trilinear_lookup(self.grid, cells, self.aabb6, p)


def density_at(media: Media, p):
    """Heterogeneous density at (N, 3) world points, zero outside the grid."""
    return DensityGrid(media).lookup(p)


def orientation_axis(media: Media, idx, p):
    """Per-lane fiber / flake axis at (N, 3) points from the orientation
    field (heterogeneous.cpp:164): a trilinear lookup of each of its three
    channels, normalised, and the medium's table axis where the field is
    (near) zero, outside its box, or absent."""
    ax = media.phase.axis
    base = take_rows(ax, torch.clamp(idx, 0, ax.shape[0] - 1).to(torch.int64))
    o = media.orient
    if o.data.shape[:3] == (1, 1, 1):
        return base
    v = torch.stack([spline.trilinear(o.data[..., c], o.aabb_min,
                                      o.aabb_max, p) for c in range(3)],
                    dim=-1)
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(nrm > 1e-6, v / torch.clamp_min(nrm, 1e-12), base)


def eval_transmittance_homogeneous(sigma_a, sigma_s, dist):
    return torch.exp(-(sigma_a + sigma_s) * dist.unsqueeze(-1))


def _mean3(x):
    return (x[..., 0] + x[..., 1] + x[..., 2]) / 3.0


def params_strategy(media: Media, idx):
    """(strategy, manual_density) of medium idx (medium.py:68-70)."""
    i = torch.clamp(idx, 0, media.kind.shape[0] - 1).to(torch.int64)
    return media.strategy[i], media.manual_density[i]


def _pick(x, k):
    """x[..., k] lane by lane for an (N,) index k."""
    return torch.gather(x, -1, k.unsqueeze(-1)).squeeze(-1)


def _maxexp_segments(sigma):
    """MaxExpDist (maxexp.h:28), the EMaximum strategy: the normalised
    upper envelope max_i sigma_i e^{-sigma_i t}. With the channels sorted
    descending, channel k leads on [t_k, t_{k+1}), the crossovers at
    ln(s_i / s_j) / (s_i - s_j), and equal channels (closer than 1e-9)
    cross at 0. Returns (sigma sorted (N, 3), edges (N, 4), the segments'
    unnormalised masses (N, 3), their sum Z (N,))."""
    s = torch.sort(sigma, dim=-1, descending=True).values
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]

    def crossover(a, b):
        same = torch.abs(a - b) < 1e-9
        return torch.where(
            same, 0.0,
            torch.log(torch.clamp_min(a, 1e-20) / torch.clamp_min(b, 1e-20))
            / torch.where(same, 1.0, a - b))

    t1 = torch.clamp_min(crossover(s0, s1), 0.0)
    t2 = torch.maximum(crossover(s1, s2), t1)
    edges = torch.stack([torch.zeros_like(t1), t1, t2,
                         torch.full_like(t1, 1e30)], dim=-1)
    mass = torch.stack([
        torch.exp(-s0 * edges[..., 0]) - torch.exp(-s0 * edges[..., 1]),
        torch.exp(-s1 * edges[..., 1]) - torch.exp(-s1 * edges[..., 2]),
        torch.exp(-s2 * edges[..., 2])], dim=-1)
    return s, edges, mass, mass.sum(-1)


def _maxexp_sample(sigma, u):
    """Inverse-CDF sample of the MaxExpDist: (t, pdf(t))."""
    s, edges, mass, Z = _maxexp_segments(sigma)
    target = u * Z
    c0 = mass[..., 0]
    c1 = c0 + mass[..., 1]
    seg = torch.where(target < c0, 0, torch.where(target < c1, 1, 2))
    sk, a = _pick(s, seg), _pick(edges, seg)
    prev = torch.where(seg == 0, 0.0, torch.where(seg == 1, c0, c1))
    # within the segment: e^{-sk a} - e^{-sk t} = target - prev
    expo = torch.clamp_min(torch.exp(-sk * a) - (target - prev), 1e-30)
    t = -torch.log(expo) / torch.clamp_min(sk, 1e-20)
    return t, sk * torch.exp(-sk * t) / torch.clamp_min(Z, 1e-20)


def _maxexp_pdf_cdf(sigma, t):
    """pdf and cdf of the MaxExpDist at t."""
    s, edges, mass, Z = _maxexp_segments(sigma)
    seg = torch.where(t < edges[..., 1], 0,
                      torch.where(t < edges[..., 2], 1, 2))
    sk, a = _pick(s, seg), _pick(edges, seg)
    prev = torch.where(seg == 0, 0.0,
                       torch.where(seg == 1, mass[..., 0],
                                   mass[..., 0] + mass[..., 1]))
    zc = torch.clamp_min(Z, 1e-20)
    cdf = (prev + torch.exp(-sk * a) - torch.exp(-sk * t)) / zc
    return sk * torch.exp(-sk * t) / zc, cdf


def homog_strategy_pdfs(sigma_t, dist, strategy=None, manual_density=None):
    """(pdf_success per unit length, pdf_failure) of the homogeneous
    distance sampler at `dist` (homogeneous.cpp pdfDistance / pdfFailure):
    balance where `strategy` is None, else each lane's STRAT_* with its
    manual density (medium.py:441-466). The refractive medium re-weights
    its straight sample at the curved arc length with these."""
    tmp = torch.exp(-sigma_t * dist.unsqueeze(-1))
    pdf_succ, pdf_fail = _mean3(sigma_t * tmp), _mean3(tmp)
    if strategy is None:
        return pdf_succ, pdf_fail
    md = torch.clamp_min(manual_density, 1e-20)
    s0 = sigma_t[..., 0]
    p_maxexp, c_maxexp = _maxexp_pdf_cdf(sigma_t, dist)
    for k, p, f in ((STRAT_SINGLE, s0 * torch.exp(-s0 * dist),
                     torch.exp(-s0 * dist)),
                    (STRAT_MANUAL, md * torch.exp(-md * dist),
                     torch.exp(-md * dist)),
                    (STRAT_MAXIMUM, p_maxexp, 1.0 - c_maxexp)):
        pdf_succ = torch.where(strategy == k, p, pdf_succ)
        pdf_fail = torch.where(strategy == k, f, pdf_fail)
    return pdf_succ, pdf_fail


def sample_distance_homogeneous(sigma_a, sigma_s, sampling_weight, t_max, u,
                                uc, strategy=None, manual_density=None):
    """Homogeneous distance sample (medium.py:468-525), gated into the
    medium with probability sampling_weight by uc. Balance where `strategy`
    is None: a channel picked by u, an exponential distance in it. Else
    each lane's STRAT_*: the first channel's exponential (single), the
    manual density's (manual) or the MaxExpDist of the three channels
    (maximum). Returns (success, dist, weight, log_pdf). The distance is
    detached and the weight keeps sigma attached; log_pdf is the attached
    log-density of the strategy's decision at the detached sample."""
    sigma_t = sigma_a + sigma_s
    w = sampling_weight
    in_medium = uc < w
    u_resc = torch.where(in_medium, uc / torch.clamp_min(w, 1e-9), 0.0)
    ch = torch.clamp((u * 3).to(torch.int64), 0, 2)
    dens = torch.clamp_min(_pick(sigma_t, ch), 1e-20).detach()
    t_sample = torch.where(in_medium, -torch.log1p(-u_resc) / dens, INF)
    md = None
    if strategy is not None:
        md = torch.clamp_min(manual_density, 1e-20)
        s0 = torch.clamp_min(sigma_t[..., 0], 1e-20)
        t_maxexp, _ = _maxexp_sample(sigma_t,
                                     torch.clamp(u_resc, 0.0, 0.9999994))
        t_alt = t_sample
        for k, t_k in ((STRAT_SINGLE, -torch.log1p(-u_resc) / s0),
                       (STRAT_MANUAL, -torch.log1p(-u_resc) / md),
                       (STRAT_MAXIMUM, t_maxexp)):
            t_alt = torch.where(strategy == k, t_k, t_alt)
        t_sample = torch.where(in_medium, t_alt.detach(), INF)
    success = t_sample < t_max
    dist = torch.minimum(t_sample, t_max).detach()
    pdf_succ, pdf_fail = homog_strategy_pdfs(sigma_t, dist, strategy, md)
    tr = torch.exp(-sigma_t * dist.unsqueeze(-1))
    pdf_succ = pdf_succ * w
    pdf_fail = w * pdf_fail + (1.0 - w)
    w_succ = sigma_s * tr / torch.clamp_min(pdf_succ, 1e-12).unsqueeze(-1)
    w_fail = tr / torch.clamp_min(pdf_fail, 1e-12).unsqueeze(-1)
    weight = torch.where(success.unsqueeze(-1), w_succ, w_fail)
    log_pdf = torch.log(torch.clamp_min(
        torch.where(success, pdf_succ, pdf_fail), 1e-30))
    return success, dist, weight, log_pdf


def _majorant(media: Media, st_color):
    """The tracking majorant of each lane, detached (medium.py:491)."""
    return torch.clamp_min(media.majorant * torch.amax(st_color, dim=-1),
                           1e-6).detach()


def transmittance_ratio_tracking(media: Media, sigma_a, sigma_s, scale, o, d,
                                 t_max, smp, active,
                                 max_steps: int = MAX_STEPS, bricks=None,
                                 differentiable: bool = False):
    """Unbiased ratio-tracking transmittance along shadow segments. Every
    lane draws one number per step whether it runs or not, in steps of
    UNROLL as in the JAX package, so the streams stay aligned with it. The
    tap positions are detached; the factors keep sigma and the density
    attached. `differentiable` caps the loop at 64 tests
    (`tracking_trips`)."""
    if bricks is None:
        bricks = DensityGrid(media)
    st_color = sigma_a + sigma_s
    majorant = _majorant(media, st_color)
    n = o.shape[0]
    o, d, t_max = o.detach(), d.detach(), t_max.detach()

    def body(state):
        t, tr, running, smp = state
        for _ in range(UNROLL):
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
        return t, tr, running, smp

    state = (torch.zeros((n,), dtype=torch.float32, device=o.device),
             torch.ones((n, 3), dtype=torch.float32, device=o.device),
             active, smp)
    (_, tr, _, smp), _ = bounded_while(
        lambda st: st[2], body, state,
        tracking_trips(max_steps, differentiable), differentiable,
        lambda st, k: st[:3] + (skip_draws(st[3], k * UNROLL),))
    return torch.clamp_min(tr, 0.0), smp


def sample_distance_woodcock(media: Media, sigma_a, sigma_s, scale, o, d,
                             t_max, smp, active, max_steps: int = MAX_STEPS,
                             bricks=None, differentiable: bool = False):
    """Delta tracking along (o, d) up to t_max against the scene majorant
    (medium.py:534-607). Collisions are tested against the mean channel's
    extinction; the spectral weight takes sigma_s / sigma_t_mean at a real
    collision and (1 - sigma_t_c / majorant) / (1 - p_real) at a null one.
    Every lane draws two numbers per step whether it runs or not, UNROLL
    steps an iteration, so the streams stay aligned with the JAX package.
    The majorant, distances, tap positions and accept/reject tests are
    detached; the weights keep sigma and the density attached.
    Returns (hit, dist, weight, p, smp, iterations, log_p): dist is t_max
    where nothing was hit, p the last tested point. With `differentiable`
    the loop stops at 64 tests (a lane still running there reports no hit,
    dist t_max and its null-collision weights so far) and log_p is the
    attached log-density of the lane's decisions, log p_real at a real
    collision and log(1 - p_real) at a null one; otherwise log_p is None.
    In forward mode a loop whose running lanes have all left the grid for
    good (they meet only zero density before t_max, which lies beyond the
    cap: a lane in a medium with no surface ahead, t_max 3e37 in bdpt's
    walks) stops there and advances the sampler by the trips left, with
    the cap's trip count and the same hits, distances and weights; p of
    such a lane is its point where the loop stopped."""
    if bricks is None:
        bricks = DensityGrid(media)
    st_color = sigma_a + sigma_s
    st_mean = _mean3(st_color)
    majorant = _majorant(media, st_color)
    w_real = sigma_s / torch.clamp_min(st_mean, 1e-12).unsqueeze(-1)
    n = o.shape[0]
    o, d, t_max = o.detach(), d.detach(), t_max.detach()

    def body(state):
        t, hit, running, smp, w, log_p = state
        for _ in range(UNROLL):
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
            if log_p is not None:
                log_p = log_p + torch.where(
                    hit_new, torch.log(torch.clamp_min(p_real, 1e-20)), 0.0
                ) + torch.where(null_col, torch.log(
                    torch.clamp_min(1.0 - p_real, 1e-20)), 0.0)
            t = torch.where(running, t_new, t)
            hit = hit | hit_new
            running = null_col
        return t, hit, running, smp, w, log_p

    def settled(state, trips_left):
        # every running lane's last tested point lies beyond the grid on an
        # axis it moves away from (monotone in t, a cell's 1e-3 clear of
        # the kernel's own test), so the density is 0 there and on: null
        # collisions of weight exactly 1; and t_max lies beyond the tests
        # left, so the lane runs to the cap, as JAX's while loop
        t, running = state[0], state[2]
        shape = bricks.grid.shape
        res = torch.tensor([shape[2], shape[1], shape[0]],
                           dtype=torch.float32, device=o.device)
        h = (bricks.aabb6[3:] - bricks.aabb6[:3]) / torch.clamp_min(
            res - 1.0, 1.0)
        v = (o + t.unsqueeze(-1) * d - bricks.aabb6[:3]) / h
        away = (((v > res - 1.0 + 1e-3) & (d >= 0))
                | ((v < -1e-3) & (d <= 0))).any(-1)
        far = t_max >= t + trips_left * UNROLL * _MAX_STEP / majorant
        return bool(running.any() & (~running | (away & far)).all())

    zeros = torch.zeros((n,), dtype=torch.float32, device=o.device)
    state = (zeros, torch.zeros((n,), dtype=torch.bool, device=o.device),
             active, smp,
             torch.ones((n, 3), dtype=torch.float32, device=o.device),
             zeros if differentiable else None)
    (t, hit, _, smp, w, log_p), it = bounded_while(
        lambda st: st[2], body, state,
        tracking_trips(max_steps, differentiable), differentiable,
        lambda st, k: st[:3] + (skip_draws(st[3], 2 * k * UNROLL),) + st[4:],
        None if differentiable else settled)
    p = o + t.unsqueeze(-1) * d
    return hit, torch.where(hit, t, t_max), w, p, smp, it, log_p
