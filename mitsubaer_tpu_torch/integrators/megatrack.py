"""The bf16 voxel table of the one-voxel density taps (host side of
mitsubaer_tpu/integrators/megatrack.py: `build_table`, `MegaTable`).

The tracking kernel of that module belongs to the wavefront engine and is not
ported yet (ROADMAP Queue 2); the boxwalk kernel reads this table.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

W = 512  # voxels per 8x8x8 brick


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
        padded = 1
        for s in media.density.data.shape[:3]:
            padded *= -(-s // 8) * 8
        return padded <= max_voxels
