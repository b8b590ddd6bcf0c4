"""Film accumulation (port of mitsubaer_tpu/models/film.py for the box
filter): each lane knows its pixel, so a box-filtered splat of one spp chunk
is the sum over its samples plus the sample count in the weight channel.
Gaussian and the other filters are not ported (ROADMAP Queue 1 step 4).
"""
from __future__ import annotations

import torch

from .. import not_ported
from ..scene.types import RenderConfig


def new_accumulator(cfg: RenderConfig, device=None):
    """(H, W, 4) accumulator: RGB sums plus the filter weight."""
    return torch.zeros((cfg.height, cfg.width, 4), dtype=torch.float32,
                       device=device)


def splat(accum, values, jitter, filter_name: str):
    """Add one chunk of (S, H, W, 3) samples with in-pixel offsets jitter
    (S, H, W, 2) in [0, 1)^2. The box filter weighs every sample 1."""
    if filter_name != "box":
        raise not_ported(f"the {filter_name!r} film filter", 4)
    w = torch.where((torch.abs(jitter[..., 0] - 0.5) <= 0.5)
                    & (torch.abs(jitter[..., 1] - 0.5) <= 0.5), 1.0, 0.0)
    plane = (w.unsqueeze(-1) * values).sum(0)
    return torch.cat([accum[..., :3] + plane,
                      (accum[..., 3] + w.sum(0)).unsqueeze(-1)], dim=-1)


def develop(accum):
    """Divide by the weight channel (ImageBlock develop)."""
    w = accum[..., 3:]
    return torch.where(w > 0, accum[..., :3] / torch.clamp_min(w, 1e-20), 0.0)
