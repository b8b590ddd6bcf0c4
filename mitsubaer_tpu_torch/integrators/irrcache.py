"""Irradiance caching (port of mitsubaer_tpu/integrators/irrcache.py; the
reference's src/integrators/misc/irrcache.cpp, a Ward/Krivanek cache
around a diffuse base integrator).

As in the JAX package the reference's lazily filled octree becomes a dense
two-pass scheme:
1. records: the cache sites are every k-th pixel's first camera hit
   (n_sites of them). Each site's indirect irradiance comes from n_hemi
   cosine-weighted gather rays through `path.li` at depth max(d - 1, 2)
   with the emitters hidden at the first hit (direct light is the camera
   pass's NEE); the harmonic mean of the gather rays' hit distances is the
   record's validity radius R_i (Ward's criterion).
2. interpolation: every pixel weighs every record, w_i = 1 / (|x - x_i| /
   R_i + sqrt(1 - n . n_i)), in one (npix, S) computation and blends the
   records with w_i > 1 / alpha; a pixel with none takes its nearest
   record by weight (the first of equal weights, as jnp.argmax).
Emitters seen by the camera and one-sample NEE at diffuse hits are added
on top. Biased-smooth like the reference. No kernel runs.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..core import rng, warp
from ..core.math import Frame, dot
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..scene import intersect as isect
from ..scene.types import BSDF_DIFFUSE, RenderConfig, Scene
from . import common
from .path import li as path_li
from .photonmap import camera_rays, diffuse_tables, lap
from .volpath import _is_null_surface, _shape_tables

INV_PI = 0.3183098861837907


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def _irrcache_pass(scene: Scene, cfg: RenderConfig, seed: int,
                   pass_idx: int, n_sites: int = 256, n_hemi: int = 32,
                   alpha: float = 0.35, stages: dict | None = None):
    """One pass: camera hits, their direct light, the records and the
    Ward blend. Returns (H W, 3). `stages` takes the seconds of "camera"
    (camera rays and NEE), "gather" (the records' gather through path.li)
    and "blend" (the Ward weights and the blend)."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    t0 = lap(stages, None, dev, None)

    # ---- camera hits ----
    rays, smp = camera_rays(scene, cfg, seed, pass_idx)
    hit = isect.intersect(scene.geo, rays.o, rays.d, eps.expand(npix),
                          isect.INF)
    b_idx, e_idx, _, _ = _shape_tables(scene, hit.shape_id)
    bk, refl = diffuse_tables(scene, b_idx)
    diffuse = hit.valid & (bk == BSDF_DIFFUSE) & ~_is_null_surface(scene,
                                                                   b_idx)
    zeros3 = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    L = _w3(hit.valid, zeros3, emitter_m.env_radiance(scene, rays.d))
    le = emitter_m.eval_hit(scene, e_idx, hit.ng, -rays.d)
    L = L + _w3(hit.valid & (e_idx >= 0), le, zeros3)

    # ---- direct NEE at diffuse hits ----
    u2, smp = rng.next_2d(smp)
    u1, smp = rng.next_1d(smp)
    ds = emitter_m.sample_direct(scene, hit.p, u2, u1)
    frame = Frame.from_normal(hit.ng)
    f = bsdf_m.eval(scene.bsdfs, b_idx, frame.to_local(-rays.d),
                    frame.to_local(ds.d), active=act)
    shit = isect.intersect(scene.geo, hit.p + ds.d * eps, ds.d,
                           (eps * 0.5).expand(npix),
                           torch.clamp_min(ds.dist - 2 * eps, 0.0))
    ok = diffuse & ~shit.valid & (ds.pdf > 0)
    L = L + _w3(ok, f * ds.value
                / torch.clamp_min(ds.pdf, 1e-12).unsqueeze(-1), zeros3)
    t0 = lap(stages, "camera", dev, t0)

    # ---- records: a stratified subset of the camera hits ----
    stride = max(npix // n_sites, 1)
    site_pix = (torch.arange(n_sites, device=dev) * stride
                + stride // 2) % npix
    sp, sn, s_ok = hit.p[site_pix], hit.ng[site_pix], diffuse[site_pix]
    # n_sites x n_hemi cosine-weighted gather rays
    lane = torch.arange(n_sites * n_hemi, dtype=torch.int64, device=dev)
    gs = rng.make_sampler(seed ^ 0x1CC, lane, pass_idx)
    ug, gs = rng.next_2d(gs)
    wo_w = Frame.from_normal(sn.repeat_interleave(n_hemi, 0)).to_world(
        warp.square_to_cosine_hemisphere(ug))
    go = sp.repeat_interleave(n_hemi, 0) + wo_w * eps
    # indirect only: a gather ray that sees an emitter first carries direct
    # light, which the camera pass's NEE added
    gcfg = replace(cfg, max_depth=max(cfg.max_depth - 1, 2),
                   hide_emitters=True)
    sink, _, _ = path_li(scene, gcfg, go, wo_w, gs)
    ghit = isect.intersect(scene.geo, go, wo_w,
                           eps.expand(n_sites * n_hemi), isect.INF)
    # E = pi mean(Li) under cosine sampling; R the harmonic mean distance
    Ei = torch.pi * torch.mean(sink.steady.reshape(n_sites, n_hemi, 3), 1)
    inv_t = torch.where(ghit.valid, 1.0 / torch.clamp_min(ghit.t, 1e-4), 0.0)
    denom = torch.sum(inv_t.reshape(n_sites, n_hemi), 1)
    Ri = torch.where(denom > 0, n_hemi / torch.clamp_min(denom, 1e-6), 1e3)
    ext = torch.amax(scene.aabb_max - scene.aabb_min)
    Ri = torch.clamp(Ri, 0.01 * ext, 0.5 * ext)
    t0 = lap(stages, "gather", dev, t0)

    # ---- the dense Ward blend over every record ----
    dx = hit.p[:, None, :] - sp[None, :, :]                 # (npix, S, 3)
    dist = torch.sqrt(dot(dx, dx))
    ndot = torch.clamp(dot(hit.ng[:, None, :], sn[None, :, :]), -1.0, 1.0)
    wi = 1.0 / torch.clamp_min(
        dist / Ri + torch.sqrt(torch.clamp_min(1.0 - ndot, 0.0)), 1e-6)
    wi = torch.where(s_ok & (ndot > 0), wi, 0.0)
    wsel = torch.where(wi > 1.0 / alpha, wi, 0.0)
    wsum = torch.sum(wsel, 1)
    E_blend = (torch.einsum("ps,sc->pc", wsel, Ei)
               / torch.clamp_min(wsum, 1e-12).unsqueeze(-1))
    E_near = Ei[torch.argmax(wi, 1)]                  # the first maximum
    E = _w3(wsum > 0, E_blend, E_near)
    L = L + _w3(diffuse, refl * INV_PI * E, zeros3)
    lap(stages, "blend", dev, t0)
    return L


def render_irrcache(scene: Scene, cfg: RenderConfig, seed: int = 0,
                    n_sites: int = 256, n_hemi: int = 32,
                    stats: dict | None = None):
    """Irradiance-cached render, (H, W, 3): max(spp / 4, 1) passes of
    jittered camera rays and fresh records, averaged. If `stats` is a dict
    it gets the wall as "irrcache_s" and each stage's seconds summed over
    the passes as "irrcache_stage_s" (_irrcache_pass)."""
    H, W = cfg.height, cfg.width
    dev = scene.aabb_min.device
    stages = None if stats is None else stats.setdefault(
        "irrcache_stage_s", {})
    t0 = lap(stats, None, dev, None)
    passes = max(cfg.spp // 4, 1)
    img = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    for i in range(passes):
        img = img + _irrcache_pass(scene, cfg, seed, i, n_sites=n_sites,
                                   n_hemi=n_hemi, stages=stages)
    img = img / torch.tensor(float(passes), device=dev)
    lap(stats, "irrcache_s", dev, t0)
    return img.reshape(H, W, 3)
