"""Energy-redistribution path tracing (port of
mitsubaer_tpu/integrators/erpt.py; Cline, Talbot & Egbert 2005, the
reference's src/integrators/erpt/).

Seed paths from ordinary path tracing, then short Metropolis chains that
redistribute each bright seed's energy over its neighbourhood in primary
sample space: small steps only (no large steps keep chains local), and
every mutation deposits a fixed quantum e_d, split a : 1 - a between the
proposal and the current path with each path's own chromaticity
(equal deposition, Cline eq. 8). The chains reuse pssmlt's machinery: the
VECTOR sampler's `_trace`, `_mutate_small` and the bootstrap; the rounds
are a Python loop of `li` calls, the film adds go through render.add_rows.
Total deposited energy is b npix (b the mean seed luminance), so
e_d = b npix / (n_chains n_mut).
"""
from __future__ import annotations

import torch

from ..core import rng
from ..scene.types import RenderConfig, Scene
from .photonmap import lap
from .pssmlt import (_lum, _mutate_small, _mutation_bits, _splat, _trace,
                     bootstrap, chain_shape)


def _erpt_run(scene: Scene, cfg: RenderConfig, n_chains: int, n_mut: int,
              D: int, seed: int, e_d, u0, rounds: list | None = None):
    """n_mut small-step rounds of n_chains chains from u0, depositing the
    (n_chains,) quanta e_d: returns the (H W, 3) film. Where `rounds` is a
    list, each round's (proposal, its pixel and rgb, accept) is appended
    to it."""
    H, W = cfg.height, cfg.width
    dev = u0.device
    key0 = rng.hash_combine(seed, 0xE497).to(dev)
    lanes = torch.arange(n_chains, dtype=torch.int64, device=dev)
    u = u0
    pix, rgb = _trace(scene, cfg, u)
    lum = _lum(rgb)
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    for i in range(n_mut):
        tag = rng.hash_combine(key0, i)
        bits = rng._hash_u32((lanes + tag) & rng.M32)
        u_prop = _mutate_small(u, _mutation_bits(bits, D))
        pix2, rgb2 = _trace(scene, cfg, u_prop)
        lum2 = _lum(rgb2)
        a = torch.clamp(lum2 / torch.clamp_min(lum, 1e-12), 0.0, 1.0)
        # equal deposition: e_d a and e_d (1 - a), each in its path's
        # chromaticity
        chroma2 = rgb2 / torch.clamp_min(lum2, 1e-12).unsqueeze(-1)
        chroma = rgb / torch.clamp_min(lum, 1e-12).unsqueeze(-1)
        _splat(film, pix2, chroma2, e_d * a, lum2 > 0)
        _splat(film, pix, chroma, e_d * (1.0 - a), lum > 0)
        accept = rng._u32_to_float(rng._hash_u32(bits ^ 0xACC)) < a
        if rounds is not None:
            rounds.append((u_prop, pix2, rgb2, accept))
        u = torch.where(accept.unsqueeze(-1), u_prop, u)
        pix = torch.where(accept, pix2, pix)
        rgb = torch.where(accept.unsqueeze(-1), rgb2, rgb)
        lum = torch.where(accept, lum2, lum)
    return film


def render_erpt(scene: Scene, cfg: RenderConfig, seed: int = 0,
                n_chains: int | None = None, n_bootstrap: int = 1 << 16,
                n_mut: int | None = None, stats: dict | None = None):
    """ERPT render on the scene's device; cfg.spp is the average number of
    mutations a pixel. Returns (H, W, 3), zeros where the seeds carry no
    luminance (b <= 0, read back to the host). If `stats` is a dict it
    gets the wall as "erpt_s", the bootstrap's seconds as "bootstrap_s"
    and the number of rounds as "rounds"."""
    H, W = cfg.height, cfg.width
    npix = H * W
    n_chains, D = chain_shape(cfg, n_chains)
    dev = scene.aabb_min.device
    t0 = lap(stats, None, dev, None)
    b, u0 = bootstrap(scene, cfg, n_bootstrap, D, n_chains, seed, dev)
    lap(stats, "bootstrap_s", dev, t0)
    b = float(b)
    if n_mut is None:
        n_mut = max((cfg.spp * npix) // n_chains, 1)
    if b <= 0:
        img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    else:
        e_d = torch.full((n_chains,), b * npix / (n_chains * n_mut),
                         dtype=torch.float32, device=dev)
        img = _erpt_run(scene, cfg, n_chains, n_mut, D, seed, e_d,
                        u0).reshape(H, W, 3)
    lap(stats, "erpt_s", dev, t0)
    if stats is not None:
        stats["rounds"] = n_mut if b > 0 else 0
    return img
