"""Film accumulation (port of mitsubaer_tpu/models/film.py): each lane
knows its pixel, so filter reconstruction is a fixed set of shifted dense
adds. For every tap offset (dx, dy) within the filter's radius the samples
of one spp chunk are weighted, summed over the chunk and added, shifted by
(dx, dy), into the accumulator; its last channel sums the weights. The six
reconstruction filters of the JAX package (box, tent, gaussian, mitchell,
catmullrom, lanczos) are ported. The accumulator holds F frames of RGB
(F = cfg.n_frames: the time or bounce bins of a transient or bounce
decomposition, film.cpp:56-80) before the weight channel; `splat` fills
frame 0, `splat_frames` a whole (S, H, W, F, 3) block, `bin_index` gives a
contribution's frame (bdpt_proc.cpp:455-476), and `develop` divides every
frame by the weights.
"""
from __future__ import annotations

import math

import torch

from ..scene.types import RenderConfig
from ..utils import stats

_RADIUS = {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 2,
           "catmullrom": 2, "lanczos": 3}


def filter_radius(name: str) -> int:
    """The taps a filter reaches on each side of the sample's pixel."""
    return _RADIUS[name]


def _filter_eval(name: str, x):
    """1D reconstruction filter value at offset x (pixels)."""
    ax = torch.abs(x)
    if name == "box":
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if name == "tent":
        return torch.clamp_min(1.0 - ax, 0.0)
    if name == "gaussian":
        # stddev 0.5, radius 2, truncated (rfilters/gaussian.cpp)
        alpha = 2.0                     # 1 / (2 sigma^2) with sigma = 0.5
        tail = torch.exp(stats.to_device("film.filter", -alpha * 4.0,
                                         x.device))
        return torch.clamp_min(torch.exp(-alpha * x * x) - tail, 0.0)
    if name == "lanczos":
        # 3-lobed Lanczos-sinc window (rfilters/lanczos.cpp)
        pix = math.pi * ax
        sinc = torch.where(ax < 1e-4, 1.0,
                           torch.sin(pix) / torch.clamp_min(pix, 1e-9))
        wind = torch.where(ax < 1e-4, 1.0, torch.sin(pix / 3.0)
                           / torch.clamp_min(pix / 3.0, 1e-9))
        return torch.where(ax < 3.0, sinc * wind, 0.0)
    if name in ("mitchell", "catmullrom"):
        B, C = (1 / 3, 1 / 3) if name == "mitchell" else (0.0, 0.5)
        ax2, ax3 = ax * ax, ax * ax * ax
        v1 = ((12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2
              + (6 - 2 * B))
        v2 = ((-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2
              + (-12 * B - 48 * C) * ax + (8 * B + 24 * C))
        return torch.where(ax < 1, v1, torch.where(ax < 2, v2, 0.0)) / 6.0
    raise ValueError(name)


def new_accumulator(cfg: RenderConfig, device=None):
    """(H, W, 3F + 1) accumulator: F frames of RGB sums plus the filter
    weight."""
    return torch.zeros((cfg.height, cfg.width, 3 * cfg.n_frames + 1),
                       dtype=torch.float32, device=device)


def _shift2d(plane, dx: int, dy: int):
    """Shift an (H, W, C) plane by (dx, dy) pixels with zero fill: the
    sample's contribution to pixel (px + dx, py + dy) lands at that pixel."""
    if dx == 0 and dy == 0:
        return plane
    H, W, _ = plane.shape
    out = torch.zeros_like(plane)
    if abs(dx) < W and abs(dy) < H:
        out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
            plane[max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def splat(accum, values, jitter, filter_name: str):
    """Add one chunk of (S, H, W, 3) samples with in-pixel offsets jitter
    (S, H, W, 2) in [0, 1)^2 (x, y), weighing each sample's contribution to
    the pixel (dx, dy) away by the filter at its offset from that pixel's
    centre; the weight channel gets the weights, for `develop`. The span
    "film.splat" counts the samples."""
    with stats.span("film.splat", samples=values.numel() // values.shape[-1]):
        img, wsum = _splat_planes(accum[..., :3], accum[..., -1:], values,
                                  jitter, filter_name)
        return torch.cat([img, accum[..., 3:-1], wsum], dim=-1)


def _splat_planes(img, wsum, values, jitter, filter_name: str):
    """img (H, W, C) and wsum (H, W, 1) plus the filtered (S, H, W, C)
    samples and their weights."""
    r = filter_radius(filter_name)
    jx, jy = jitter[..., 0], jitter[..., 1]
    for dy in range(-r, r + 1):
        wy = _filter_eval(filter_name, jy - (dy + 0.5))        # (S, H, W)
        for dx in range(-r, r + 1):
            w = _filter_eval(filter_name, jx - (dx + 0.5)) * wy
            img = img + _shift2d((w.unsqueeze(-1) * values).sum(0), dx, dy)
            wsum = wsum + _shift2d(w.sum(0).unsqueeze(-1), dx, dy)
    return img, wsum


def splat_frames(accum, values, jitter, filter_name: str):
    """Add a whole decomposed (S, H, W, F, 3) block with the configured
    filter, as `splat` adds frame 0 (film.py:111-131)."""
    S, H, W, F, _ = values.shape
    img, wsum = _splat_planes(accum[..., :-1], accum[..., -1:],
                              values.reshape(S, H, W, F * 3), jitter,
                              filter_name)
    return torch.cat([img, wsum], dim=-1)


def develop(accum):
    """Divide every frame by the weight channel (ImageBlock develop):
    (H, W, 3F). While tracing, the span "film.develop" (synchronised at
    its edges) counts the pixels."""
    with stats.synced_span("film.develop", accum.device,
                           pixels=accum.shape[0] * accum.shape[1]):
        w = accum[..., -1:]
        return torch.where(w > 0, accum[..., :-1] / torch.clamp_min(w, 1e-20),
                           0.0)


def bin_index(cfg: RenderConfig, path_length):
    """(frame, inside) of a contribution of this path length (or depth):
    the floor bin clipped to the film's F frames, and whether the length
    lies in [min_bound, max_bound) (bdpt_proc.cpp:455-476)."""
    f = torch.floor((path_length - cfg.min_bound) / cfg.bin_width
                    ).to(torch.int64)
    inside = (path_length >= cfg.min_bound) & (path_length < cfg.max_bound)
    return torch.clamp(f, 0, cfg.n_frames - 1), inside
