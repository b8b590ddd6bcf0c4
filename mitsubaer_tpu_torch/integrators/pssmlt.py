"""Primary-sample-space Metropolis light transport (port of
mitsubaer_tpu/integrators/pssmlt.py; Kelemen et al. 2002, the reference's
src/integrators/pssmlt/).

Thousands of independent chains run as lanes. Each mutation round re-traces
every chain's path from its vector of primary-sample uniforms through the
VECTOR (replayable) sampler (core/rng.py), accepts by path luminance, and
splats both the proposal and the current state with Kelemen's MIS weights.
A bootstrap of ordinary Monte Carlo samples gives the normalisation b (the
mean luminance) and seeds the chains by systematic resampling in
proportion to luminance. The rounds are a Python loop of `li` calls on the
host, one call a round; the film adds go through render.add_rows, so a
render on the card is the same bits on every run.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..core import rng
from ..models import sensor as sensor_m
from ..scene.types import RenderConfig, Scene
from . import render as render_m
from .photonmap import lap

_LUM = (0.2126, 0.7152, 0.0722)
P_LARGE = 0.3        # the probability of a large step (a fresh vector)


def _lum(rgb):
    return rgb @ torch.tensor(_LUM, dtype=torch.float32, device=rgb.device)


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _trace(scene: Scene, cfg: RenderConfig, u):
    """The path estimator at the (n, D) primary-sample vectors u: dims 0-1
    pick the film position, 2-3 the lens, the rest feed `li` from dim 4.
    Returns (pixel ids (n,), rgb (n, 3)); "pssmlt_volpath" traces with
    volpath.li, every other name with path.li (pssmlt.py:32-54)."""
    n = u.shape[0]
    H, W = cfg.height, cfg.width
    px = u[:, 0] * W
    py = u[:, 1] * H
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H,
                                u_lens=u[:, 2:4])
    lane = torch.arange(n, dtype=torch.int64, device=u.device)
    smp = rng.make_sampler(0x4D4C54, lane, torch.zeros_like(lane),
                           mode=rng.VECTOR, table=u)
    smp = replace(smp, dim=torch.full_like(lane, 4))
    li = render_m.get_integrator(
        "volpath" if cfg.integrator == "pssmlt_volpath" else "path")
    ix, iy = px.to(torch.int64), py.to(torch.int64)
    sink = li(scene, cfg, rays.o, rays.d, smp, pixel=iy * W + ix)[0]
    pix = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
    return pix, sink.steady


def _mutate_small(u, key_bits, s1: float = 1.0 / 1024.0,
                  s2: float = 1.0 / 64.0):
    """Kelemen's exponential perturbation of every dimension, wrapped to
    [0, 1) by a floor modulo (pssmlt_sampler.cpp mutate)."""
    r1 = rng._u32_to_float(key_bits)
    r2 = rng._u32_to_float(rng._hash_u32(key_bits ^ 0xDECAF))
    log_ratio = torch.log(_f32(s2 / s1, u))
    mag = s2 * torch.exp(-log_ratio * r1)
    delta = torch.where(r2 < 0.5, mag, -mag)
    return torch.remainder(u + delta, 1.0)


def _uniform_rows(lanes, D: int, mul: int, tag):
    """(n, D) uniforms hash(lane * 0x9E3779B9 + dim * mul + tag)."""
    dims = torch.arange(D, dtype=torch.int64, device=lanes.device)
    bits = (rng.mul32(lanes, 0x9E3779B9).unsqueeze(1)
            + rng.mul32(dims, mul).unsqueeze(0) + tag) & rng.M32
    return rng._u32_to_float(rng._hash_u32(bits))


def _mutation_bits(bits, D: int):
    """The (n, D) per-dimension keys of a small step."""
    dims = torch.arange(D, dtype=torch.int64, device=bits.device)
    return rng._hash_u32((bits.unsqueeze(1) + dims.unsqueeze(0)) & rng.M32)


def _splat(film, pix, rgb, w, on):
    render_m.add_rows(film, pix, torch.where(
        on.unsqueeze(-1), rgb * w.unsqueeze(-1), 0.0))


def _pssmlt_run(scene: Scene, cfg: RenderConfig, n_chains: int, n_mut: int,
                D: int, seed: int, b, u0, rounds: list | None = None):
    """n_mut mutation rounds of n_chains chains from the bootstrap states
    u0, a round a `_trace`: returns the (H W, 3) film of expectation
    weights. Where `rounds` is a list, each round's (proposal, its pixel
    and rgb, accept) is appended to it."""
    H, W = cfg.height, cfg.width
    dev = u0.device
    key0 = rng.hash_combine(seed, 0x5EED).to(dev)
    lanes = torch.arange(n_chains, dtype=torch.int64, device=dev)
    p_large = _f32(P_LARGE, u0)
    u = u0
    pix, rgb = _trace(scene, cfg, u)
    lum = _lum(rgb)
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    for i in range(n_mut):
        tag = rng.hash_combine(key0, i)
        bits = rng._hash_u32((lanes + tag) & rng.M32)
        is_large = rng._u32_to_float(rng._hash_u32(bits)) < p_large
        u_prop = torch.where(
            is_large.unsqueeze(-1),
            _uniform_rows(lanes, D, 0x85EBCA6B, tag ^ 0xA11),
            _mutate_small(u, _mutation_bits(bits, D)))
        pix2, rgb2 = _trace(scene, cfg, u_prop)
        lum2 = _lum(rgb2)
        a = torch.clamp(lum2 / torch.clamp_min(lum, 1e-12), 0.0, 1.0)
        # Kelemen's MIS splat weights (pssmlt.cpp, expectations form)
        w_new = (a + is_large) / torch.clamp_min(lum2 / b + p_large, 1e-12)
        w_old = (1.0 - a) / torch.clamp_min(lum / b + p_large, 1e-12)
        _splat(film, pix2, rgb2, w_new, lum2 > 0)
        _splat(film, pix, rgb, w_old, lum > 0)
        accept = rng._u32_to_float(rng._hash_u32(bits ^ 0xACC)) < a
        if rounds is not None:
            rounds.append((u_prop, pix2, rgb2, accept))
        u = torch.where(accept.unsqueeze(-1), u_prop, u)
        pix = torch.where(accept, pix2, pix)
        rgb = torch.where(accept.unsqueeze(-1), rgb2, rgb)
        lum = torch.where(accept, lum2, lum)
    return film


def prefix_sum(x):
    """Inclusive prefix sums of the 1-D x in a fixed tree order (log2 n
    doubling steps), the same bits on every run: torch.cumsum on CUDA
    scans with CUB's look-back, whose association varies from run to run."""
    n, step = x.shape[0], 1
    while step < n:
        x = torch.cat([x[:step], x[step:] + x[:-step]])
        step *= 2
    return x


def bootstrap(scene: Scene, cfg: RenderConfig, nb: int, D: int, nc: int,
              seed: int, device):
    """Stage 1: nb ordinary samples at hashed primary-sample vectors give
    b = E[lum], and nc chain states resampled systematically in proportion
    to luminance (searchsorted on the left, as jnp). Returns (b, (nc, D))."""
    lanes = torch.arange(nb, dtype=torch.int64, device=device)
    u = _uniform_rows(lanes, D, 1, seed & rng.M32)
    _, rgb = _trace(scene, cfg, u)
    lum = _lum(rgb)
    cdf = prefix_sum(lum)
    total = torch.clamp_min(cdf[-1], 1e-20)
    chains = torch.arange(nc, dtype=torch.int64, device=device)
    jit = rng._u32_to_float(rng._hash_u32((chains + seed) & rng.M32))
    targets = (chains.to(torch.float32) + jit) / _f32(nc, u) * total
    idx = torch.clamp(torch.searchsorted(cdf, targets), 0, nb - 1)
    return lum.mean(), u[idx]


def chain_shape(cfg: RenderConfig, n_chains: int | None):
    """(n_chains, D): by default npix / 8 chains within [4096, 2^16], and
    D = 8 + 8 max_depth dims, at most 120."""
    npix = cfg.height * cfg.width
    if n_chains is None:
        n_chains = min(max(npix // 8, 4096), 1 << 16)
    return n_chains, min(8 + 8 * cfg.max_depth, 120)


def render_pssmlt(scene: Scene, cfg: RenderConfig, seed: int = 0,
                  n_chains: int | None = None, n_bootstrap: int = 1 << 16,
                  stats: dict | None = None):
    """Metropolis render on the scene's device: cfg.spp mutations a pixel
    on average. Returns (H, W, 3). If `stats` is a dict it gets the wall
    as "pssmlt_s", the bootstrap's seconds as "bootstrap_s" and the
    number of rounds as "rounds"."""
    H, W = cfg.height, cfg.width
    npix = H * W
    n_chains, D = chain_shape(cfg, n_chains)
    dev = scene.aabb_min.device
    t0 = lap(stats, None, dev, None)
    b, u0 = bootstrap(scene, cfg, n_bootstrap, D, n_chains, seed, dev)
    lap(stats, "bootstrap_s", dev, t0)
    b = torch.clamp_min(b, 1e-9)
    n_mut = max((cfg.spp * npix) // n_chains, 1)
    film = _pssmlt_run(scene, cfg, n_chains, n_mut, D, seed, b, u0)
    # each round deposits expectation-weighted contributions whose mean is
    # the image over the per-pixel sample density
    img = (film * (npix / (n_chains * n_mut))).reshape(H, W, 3)
    lap(stats, "pssmlt_s", dev, t0)
    if stats is not None:
        stats["rounds"] = n_mut
    return img
