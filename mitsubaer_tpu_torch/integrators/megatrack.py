"""Tracking-to-completion of the wavefront engine: Woodcock (extension) or
ratio (shadow) tracking with one-voxel stochastic-trilinear taps from a bf16
brick table (port of mitsubaer_tpu/integrators/megatrack.py).

Kernel C, `run`, is csrc/megatrack.cu: one thread per lane, looping
majorant jumps until its own lane resolves or `max_trips`. `run_plain` is the
same loop over all lanes at once. The JAX kernel loops per block of lanes
until the block resolves, but a resolved lane is frozen, so its per-lane
result equals this per-lane loop's; `lane` is the global lane index in all
three, so no result depends on the blocking.

Each tap draws five lowbias32 hashes from (lane, ctr, seed), moves t by an
exponential step of the majorant, picks one voxel per axis with probability
equal to its trilinear weight (corner = floor(x) + [u < frac(x)]) and reads
it from the table T[j, r] (voxel j of 8^3 brick r). Delta and ratio tracking
stay unbiased under that choice because each branch's weight is linear in
the sampled density.

Layout (the engine's contract, megatrack.py:32-46):
  rows (24, n) f32: 0:3 origin in voxel coordinates, 3:6 direction * inv_h,
    6 t, 7 t_lim, 8 majorant, 9 sigma_t mean * scale, 10:13 sigma_t colour
    * scale, 13:16 w_real, 16 is_shadow, 17 valid, 18:24 padding;
  ctr (1, n) int32: the per-lane tap counter (uint32 bits);
  out (8, n) f32: 0 t, 1:4 fac, 4 hit, 5 resolved, 6 taps, 7 zero;
  ctr_out (1, n) int32 = ctr + 5 * taps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..core.rng import M32, _hash_u32, mul32

W = 512  # voxels per 8x8x8 brick

C_IN = 24
C_OUT = 8


def build_table(d: torch.Tensor):
    """(nz, ny, nx) density -> ((W, R) bf16 table, (nbx, nby, nbz)).

    Each axis is zero-padded to a multiple of 8. T[j, r] is voxel j of brick
    r with r = (bz*nby + by)*nbx + bx and j = ((zi*8) + yi)*8 + xi."""
    nz, ny, nx = d.shape
    pz, py, px = [-(-s // 8) * 8 for s in (nz, ny, nx)]
    d = F.pad(d, (0, px - nx, 0, py - ny, 0, pz - nz))
    nbz, nby, nbx = pz // 8, py // 8, px // 8
    t = d.reshape(nbz, 8, nby, 8, nbx, 8).permute(0, 2, 4, 1, 3, 5)
    t = t.reshape(nbz * nby * nbx, W)
    return t.t().to(torch.bfloat16).contiguous(), (nbx, nby, nbz)


class MegaTable:
    """Voxel table plus the grid's static metadata."""

    def __init__(self, media):
        d = media.density.data
        nz, ny, nx = d.shape
        self.res = (nx, ny, nz)
        self.table, self.nb = build_table(d)
        self.aabb_min = media.density.aabb_min
        extent = media.density.aabb_max - media.density.aabb_min
        res_v = torch.tensor([nx, ny, nz], dtype=torch.float32,
                             device=d.device)
        self.inv_h = torch.clamp_min(res_v - 1.0, 1.0) \
            / torch.clamp_min(extent, 1e-30)

    @staticmethod
    def fits(media, max_voxels: int = 1 << 21) -> bool:
        """The JAX package's VMEM gate, kept for boxwalk's `supported`."""
        padded = 1
        for s in media.density.data.shape[:3]:
            padded *= -(-s // 8) * 8
        return padded <= max_voxels


def _unif(bits):
    """Top 24 bits -> [0, 1), the kernel's own uniform."""
    return (bits >> 8).to(torch.int32).to(torch.float32) \
        * 5.9604644775390625e-08


def run_plain(rows, ctr, table, seed: int, max_trips: int, res, nb):
    """Plain PyTorch version of kernel C: rows (24, n) f32, ctr (1, n)
    int32, table (512, R) bf16 -> ((8, n) f32, (1, n) int32)."""
    dev = rows.device
    n = rows.shape[1]
    nx, ny, nz = res
    nbx, nby, _ = nb
    R = table.shape[1]
    tab = table.to(torch.float32).reshape(-1)
    o, d = rows[0:3], rows[3:6]
    t = rows[6].clone()
    tlim = rows[7]
    maj = torch.clamp_min(rows[8], 1e-12)
    stm, stc, w_real = rows[9], rows[10:13], rows[13:16]
    is_sh = rows[16] > 0.5
    valid = rows[17] > 0.5
    ctr0 = ctr[0].to(torch.int64) & M32
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    lane_x = lane ^ 0x9E3779B9
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.float32,
                      device=dev)[:, None]
    fac = torch.ones((3, n), dtype=torch.float32, device=dev)
    live = valid.clone()
    hit = torch.zeros((n,), dtype=torch.float32, device=dev)
    taps = torch.zeros((n,), dtype=torch.float32, device=dev)
    for _ in range(max_trips):
        if not bool(live.any()):
            break
        c = (ctr0 + 5 * taps.to(torch.int64)) & M32
        b0 = _hash_u32((lane_x + mul32(c, 0x85EBCA6B) + seed) & M32)
        b1 = _hash_u32((b0 + 0x68E31DA4) & M32)
        b2 = _hash_u32((b1 + 0xB5297A4D) & M32)
        b3 = _hash_u32((b2 + 0x1B56C4E9) & M32)
        b4 = _hash_u32((b3 + 0x7F4A7C15) & M32)

        t_new = t - torch.log(torch.clamp_min(1.0 - _unif(b0), 1e-12)) / maj
        esc = t_new >= tlim
        p = o + t_new * d                                   # (3, n) voxels
        inside = ((p >= 0.0) & (p <= hi)).all(0)
        p = torch.minimum(torch.clamp_min(p, 0.0), hi)
        base = torch.floor(p)
        u = torch.stack([_unif(b1), _unif(b2), _unif(b3)])
        cidx = torch.minimum(base + (u < p - base).to(torch.float32), hi) \
            .to(torch.int64)
        cx, cy, cz = cidx
        r_idx = ((cz >> 3) * nby + (cy >> 3)) * nbx + (cx >> 3)
        j_idx = (((cz & 7) * 8) + (cy & 7)) * 8 + (cx & 7)
        S = torch.where(inside, tab[j_idx * R + r_idx], 0.0)

        p_real = S * stm / maj
        real = (_unif(b4) < p_real) & ~esc & ~is_sh & live
        factor = torch.clamp_min(1.0 - S * stc / maj, 0.0)   # (3, n)
        w_null = factor / torch.clamp_min(1.0 - p_real, 1e-12)
        nullc = live & ~esc & ~is_sh & ~real
        shc = live & ~esc & is_sh
        fac = torch.where(real, fac * w_real,
                          torch.where(nullc, fac * w_null,
                                      torch.where(shc, fac * factor, fac)))
        t = torch.where(live, torch.minimum(t_new, tlim), t)
        hit = torch.where(real, 1.0, hit)
        taps = taps + live.to(torch.float32)
        live = live & ~(esc | real)

    resolved = (valid & ~live).to(torch.float32)
    out = torch.cat([t[None], fac, hit[None], resolved[None], taps[None],
                     torch.zeros((1, n), dtype=torch.float32, device=dev)])
    ctr_out = (ctr0 + 5 * taps.to(torch.int64)) & M32
    return out, as_int32(ctr_out)[None]


def as_int32(x):
    """uint32 bits held in int64 -> the int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def run(rows, ctr, table, seed: int, max_trips: int, res, nb):
    """Kernel C (csrc/megatrack.cu) on CUDA tensors, run_plain on CPU ones.

    There is no size gate: the table lives in device memory (a 64^3 grid is
    512 KiB, L2-resident), so the JAX package's VMEM limit
    (`MegaTable.fits`) is not consulted and every grid size is served."""
    if rows.device.type == "cpu":
        return run_plain(rows, ctr, table, seed, max_trips, res, nb)
    if rows.device.type != "cuda":
        raise ValueError(f"megatrack.run: unsupported device {rows.device}")
    rows, ctr, table = (t.contiguous() for t in (rows, ctr, table))
    kernels.require_cuda("megatrack.run", rows, ctr, table)
    n = rows.shape[1]
    if (rows.dtype != torch.float32 or rows.shape[0] != C_IN
            or ctr.dtype != torch.int32 or tuple(ctr.shape) != (1, n)
            or table.dtype != torch.bfloat16 or table.shape[0] != W
            or table.shape[1] != nb[0] * nb[1] * nb[2]):
        raise ValueError("megatrack.run: expected rows (24, n) f32, ctr "
                         "(1, n) int32 and table (512, R) bf16")
    out = torch.empty((C_OUT, n), dtype=torch.float32, device=rows.device)
    ctr_out = torch.empty((1, n), dtype=torch.int32, device=rows.device)
    if n == 0:
        return out, ctr_out
    with kernels.on_device(rows):
        rc = kernels.library().mk_megatrack(
            rows.data_ptr(), ctr.data_ptr(), table.data_ptr(),
            out.data_ptr(), ctr_out.data_ptr(), n, seed & M32, max_trips,
            *res, *nb, kernels.stream(rows))
    kernels.check(rc, "megatrack.run")
    run.launches += 1
    return out, ctr_out


run.launches = 0
