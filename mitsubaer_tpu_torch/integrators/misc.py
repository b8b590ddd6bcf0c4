"""Ambient occlusion, field extraction, the multichannel render and
adaptive sampling (port of mitsubaer_tpu/integrators/misc.py; reference
src/integrators/direct/ao.cpp, misc/field.cpp, misc/multichannel.cpp and
misc/adaptive.cpp).

`ao_li` and `field_li` take the loop road's camera rays and sampler, as
`render()` routes "ao" and "field" (render.py:127-131).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..core import rng, warp
from ..core.math import Frame
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import RenderConfig, Scene
from . import common

FIELDS = ("shNormal", "geoNormal", "position", "distance", "primIndex", "uv")


def _primary(scene: Scene, o, d):
    n = o.shape[0]
    eps = common.scene_epsilon(scene)
    return isect.intersect(scene.geo, o, d, eps.expand(n),
                           torch.full((n,), isect.INF, device=o.device)), eps


def ao_li(scene: Scene, cfg: RenderConfig, o, d, sampler: rng.Sampler,
          pixel=None, ray_length_frac: float = 0.05, n_samples: int = 4):
    """Ambient occlusion (ao.cpp): the share of n_samples cosine-weighted
    rays from the primary hit that travel ray_length_frac of the scene's
    diagonal unblocked; 1 where the camera ray escapes. Returns (sink,
    sampler); a film with frames bins it at the hit distance, depth 1."""
    n = o.shape[0]
    hit, eps = _primary(scene, o, d)
    max_dist = torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min
                                        ) * ray_length_frac
    frame = Frame.from_normal(hit.ng)
    occ_sum = torch.zeros((n,), device=o.device)
    smp = sampler
    for _ in range(n_samples):
        u2, smp = rng.next_2d(smp)
        wo = frame.to_world(warp.square_to_cosine_hemisphere(u2))
        blocked = isect.occluded(scene.geo, hit.p + wo * eps, wo,
                                 (eps * 0.1).expand(n), max_dist.expand(n))
        occ_sum = occ_sum + torch.where(blocked, 0.0, 1.0)
    vis = occ_sum / n_samples
    value = torch.where(hit.valid, vis, 1.0).unsqueeze(-1).expand(n, 3)
    return _primary_sink(cfg, value, hit, pixel), smp


def _primary_sink(cfg: RenderConfig, value, hit, pixel):
    """A new sink holding value on every lane, at the primary hit's
    distance (0 where the ray escaped) and depth 1 (misc.py:40-45)."""
    n = value.shape[0]
    dev = value.device
    return common.add_contribution(
        common.new_sink(cfg, n, pixel, dev), cfg, value,
        torch.where(hit.valid, hit.t, 0.0),
        torch.ones((n,), dtype=torch.int32, device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev))


def field_li(scene: Scene, cfg: RenderConfig, o, d, sampler: rng.Sampler,
             pixel=None, field: str = "shNormal"):
    """Field extraction (field.cpp): a geometric quantity of the primary
    hit as a color, zero where the ray escapes. Returns (sink, sampler)."""
    n = o.shape[0]
    hit, _ = _primary(scene, o, d)
    if field in ("shNormal", "geoNormal"):
        value = hit.ng * 0.5 + 0.5
    elif field == "position":
        value = hit.p
    elif field == "distance":
        value = torch.where(hit.valid, hit.t, 0.0).unsqueeze(-1).expand(n, 3)
    elif field == "primIndex":
        value = hit.prim.to(torch.float32).unsqueeze(-1).expand(n, 3)
    elif field == "uv":
        value = torch.cat([hit.uv, torch.zeros((n, 1), device=o.device)], -1)
    else:
        raise ValueError(f"unknown field {field}")
    value = torch.where(hit.valid.unsqueeze(-1), value, 0.0)
    return _primary_sink(cfg, value, hit, pixel), sampler


def render_multichannel(scene: Scene, cfg: RenderConfig, fields=None,
                        seed: int = 0, device=None):
    """The radiance image and field-extraction channels of the pixel
    centres' rays (multichannel.cpp), as (H, W, 3 (1 + len(fields)));
    fields default to shNormal and distance. Runs on the card unless
    device="cpu"."""
    from . import render as render_m

    fields = list(fields or ["shNormal", "distance"])
    H, W = cfg.height, cfg.width
    npix = H * W
    img = render_m.render(scene, cfg, seed=seed, device=device)[..., :3]
    scene = scene.to(img.device)
    pixel = torch.arange(npix, dtype=torch.int64, device=img.device)
    smp = rng.make_sampler(seed, pixel, torch.zeros_like(pixel))
    px = (pixel % W).to(torch.float32) + 0.5
    py = (pixel // W).to(torch.float32) + 0.5
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
    chans = [img]
    for f in fields:
        sink, _ = field_li(scene, cfg, rays.o, rays.d, smp, pixel=pixel,
                           field=f)
        chans.append(sink.steady.reshape(H, W, 3))
    return torch.cat(chans, dim=-1)


def render_adaptive(scene: Scene, cfg: RenderConfig, seed: int = 0,
                    max_error: float = 0.05, p_value: float = 0.05,
                    max_sample_factor: int = 8, base_spp: int | None = None,
                    device=None):
    """Error-controlled adaptive sampling (adaptive.cpp): render passes of
    base_spp samples (seed + 1000 i) and stop a pixel once the t-test
    confidence interval of its mean falls under max_error times its mean
    luminance; at most max_sample_factor passes. Converged pixels keep
    their mean (Welford over the pass images). One sync a pass, for the
    test of whether any pixel is still open. Runs on the card unless
    device="cpu"."""
    from scipy import stats as sstats

    from . import render as render_m

    dev = common.render_device(device)
    H, W = cfg.height, cfg.width
    base = base_spp or max(4, cfg.spp)
    mean = torch.zeros((H, W, 3), device=dev)
    m2 = torch.zeros((H, W, 3), device=dev)
    count = torch.zeros((H, W, 1), device=dev)
    active = torch.ones((H, W, 1), dtype=torch.bool, device=dev)
    for i in range(max_sample_factor):
        img = render_m.render(scene, replace(cfg, spp=base),
                              seed=seed + 1000 * i, device=dev)[..., :3]
        new_count = count + active
        delta = img - mean
        mean = torch.where(active,
                           mean + delta / torch.clamp_min(new_count, 1),
                           mean)
        m2 = torch.where(active, m2 + delta * (img - mean), m2)
        count = new_count
        if i >= 1:
            var = m2 / torch.clamp_min(count - 1, 1)
            sem = torch.sqrt(var / torch.clamp_min(count, 1))
            tq = float(sstats.t.ppf(1.0 - 0.5 * p_value, df=max(int(i), 1)))
            lum = torch.mean(mean, dim=-1, keepdim=True)
            ci = tq * torch.mean(sem, dim=-1, keepdim=True)
            conv = ci <= max_error * torch.clamp_min(lum, 1e-4)
            active = active & ~conv
            if not bool(active.any()):
                break
    return mean
