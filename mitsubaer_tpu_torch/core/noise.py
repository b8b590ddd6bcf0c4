"""Perlin noise and its fractal sums (port of mitsubaer_tpu/core/noise.py).

The permutation table of Perlin's improved noise is a hash of the lattice
corner's integer coordinates, the gradient one of the 12 edge vectors that
the hash's low bits pick, and the fade curve 6t^5 - 15t^4 + 10t^3. The
hash's uint32 arithmetic runs in int64 tensors masked to 32 bits, as in
core/rng.py, so it is the JAX package's bit for bit.
"""
from __future__ import annotations

import torch

from .rng import M32, mul32


def _hash3(xi, yi, zi):
    h = (mul32(xi & M32, 0x9E3779B1) ^ mul32(yi & M32, 0x85EBCA77)
         ^ mul32(zi & M32, 0xC2B2AE3D))
    h = h ^ (h >> 15)
    h = mul32(h, 0x27D4EB2F)
    return h ^ (h >> 13)


def _grad(h, x, y, z):
    """Perlin 2002 gradient from the hash's low four bits."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where(h & 1 == 0, u, -u)
            + torch.where(h & 2 == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lerp(t, a, b):
    return a + t * (b - a)


def perlin(p):
    """Improved Perlin noise at (..., 3) points -> (...,) in [-1, 1]."""
    pf = torch.floor(p)
    xi, yi, zi = (pf[..., k].to(torch.int32).to(torch.int64)
                  for k in range(3))
    x, y, z = (p[..., k] - pf[..., k] for k in range(3))
    u, v, w = _fade(x), _fade(y), _fade(z)

    def corner(dx, dy, dz):
        return _grad(_hash3(xi + dx, yi + dy, zi + dz), x - dx, y - dy,
                     z - dz)

    return _lerp(w,
                 _lerp(v, _lerp(u, corner(0, 0, 0), corner(1, 0, 0)),
                       _lerp(u, corner(0, 1, 0), corner(1, 1, 0))),
                 _lerp(v, _lerp(u, corner(0, 0, 1), corner(1, 0, 1)),
                       _lerp(u, corner(0, 1, 1), corner(1, 1, 1))))


def _octaves(p, octaves, lacunarity, gain, fn):
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for _ in range(octaves):
        total = total + amp * fn(perlin(p * freq))
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def fbm(p, octaves: int = 4, lacunarity: float = 2.0, gain: float = 0.5):
    """Fractal Brownian motion: the octaves' sum over their amplitudes."""
    return _octaves(p, octaves, lacunarity, gain, lambda x: x)


def turbulence(p, octaves: int = 4, lacunarity: float = 2.0,
               gain: float = 0.5):
    """The |perlin| octaves' sum over their amplitudes, in [0, ~1]."""
    return _octaves(p, octaves, lacunarity, gain, torch.abs)
