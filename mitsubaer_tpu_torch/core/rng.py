"""Counter-based sampler, independent mode (port of mitsubaer_tpu/core/rng.py).

Every (seed, lane, sample_index, dimension) tuple hashes to one float, so a
render is order-independent and replayable, and the port reproduces the JAX
package's stream bit for bit.

uint32 arithmetic runs in int64 tensors masked to 32 bits: PyTorch's CPU
uint32 tensors lack `+`, `>>` and `<`. Products are split into 16-bit halves
so no intermediate leaves int64's range.

A draw hashes (seed, lane, index, dim) by `hash_combine`, whose prefix over
(seed, lane, index) does not change from draw to draw: the Sampler keeps it
as `key`, so a draw costs one combine step and the final hash.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import not_ported

# the JAX package's sampler modes by name; only INDEPENDENT is ported
INDEPENDENT, LDS, STRATIFIED, HALTON, HAMMERSLEY, SOBOL = range(6)
MODES = {"independent": INDEPENDENT, "lds": LDS, "ldsampler": LDS,
         "stratified": STRATIFIED, "halton": HALTON,
         "hammersley": HAMMERSLEY, "sobol": SOBOL}

M32 = 0xFFFFFFFF
_TWO_NEG_32 = 2.3283064365386963e-10   # 2^-32
_ONE_MINUS_EPS = 0.99999994            # largest float32 below 1


def u32(x, device=None) -> torch.Tensor:
    """A Python int or integer tensor as an int64 tensor holding uint32 bits."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c in [0, 2^32)."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (public-domain integer hash)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _hash_u32((x + mul32(h, 0x01000193)) & M32)


def hash_combine(*xs) -> torch.Tensor:
    ts = [x if isinstance(x, torch.Tensor) else u32(x) for x in xs]
    device = next((t.device for t in ts if t.dim() > 0), ts[0].device)
    h = u32(0x9E3779B9, device)
    for x in ts:
        h = _combine(h, x.to(device))
    return h


def _u32_to_float(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(x.to(torch.float32) * _TWO_NEG_32, _ONE_MINUS_EPS)


@dataclass(frozen=True)
class Sampler:
    """Stateless stream: `lane` names the pixel or ray, `index` the sample
    within it, `dim` the next dimension to draw; `key` is
    hash_combine(seed, lane, index). All int64 uint32 bits."""

    lane: torch.Tensor
    index: torch.Tensor
    dim: torch.Tensor
    seed: torch.Tensor
    key: torch.Tensor


def mode_of(name: str) -> int:
    """The sampler mode a config's `sampler` names; a name that is no mode
    means the independent sampler, as in the JAX package."""
    return MODES.get(name, INDEPENDENT)


def make_sampler(seed, lane, sample_index, mode: int = INDEPENDENT,
                 n_samples: int = 16) -> Sampler:
    """`n_samples` (the spp) only shapes the stratified samplers, which are
    not ported; it is accepted so callers read as the JAX package's."""
    if mode != INDEPENDENT:
        raise not_ported(f"sampler mode {mode} (only the independent "
                         "sampler is ported)", 1)
    lane = u32(lane)
    index = u32(sample_index, lane.device)
    seed = u32(seed, lane.device)
    return Sampler(lane=lane, index=index, dim=torch.zeros_like(lane),
                   seed=seed, key=hash_combine(seed, lane, index))


def restart(s: Sampler, where: torch.Tensor, lane: torch.Tensor,
            index: torch.Tensor) -> Sampler:
    """The sampler with the lanes `where` moved to (lane, index) at dim 0."""
    lane, index = u32(lane), u32(index)
    return replace(
        s, lane=torch.where(where, lane, s.lane),
        index=torch.where(where, index, s.index),
        dim=torch.where(where, 0, s.dim),
        key=torch.where(where, hash_combine(s.seed, lane, index), s.key))


def _independent_bits(s: Sampler, dim_offset: int) -> torch.Tensor:
    return _hash_u32(_combine(s.key, (s.dim + dim_offset) & M32))


def next_1d(s: Sampler):
    value = _u32_to_float(_independent_bits(s, 0))
    return value, replace(s, dim=(s.dim + 1) & M32)


def next_2d(s: Sampler):
    value = torch.stack([_u32_to_float(_independent_bits(s, 0)),
                         _u32_to_float(_independent_bits(s, 1))], dim=-1)
    return value, replace(s, dim=(s.dim + 2) & M32)
