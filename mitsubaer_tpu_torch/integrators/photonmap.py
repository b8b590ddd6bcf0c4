"""Photon mapping: photonmapper and the progressive (ppm) and stochastic
progressive (sppm) variants (port of mitsubaer_tpu/integrators/
photonmap.py; the reference's src/integrators/photonmapper/).

The reference's kd-tree becomes a sorted uniform hash grid: photons are
binned to cells, sorted stably by cell id, and a cell's run is found by
searchsorted on the left. A gather scans the 27 neighbour cells with a
bounded budget of photons a cell, in sorted order, so the order within a
cell decides which photons an overfull cell drops. Photon tracing walks
light particles from `ptracer.sample_emitter_ray` and deposits at every
non-null surface hit; the camera walks through specular and null surfaces
to the first diffuse hit and gathers there. Iteration i uses the radius
r_i^2 = r_0^2 prod (j + alpha) / (j + 1) (Knaus-Zwicker) and the image is
the mean of the iterations. Media are ignored, as in the JAX package.
The gathers are plain PyTorch (the JAX package writes them in XLA, not
Pallas).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import rng
from ..core.math import Frame, dot, take_rows
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import BSDF_DIFFUSE, RenderConfig, Scene
from . import common
from .ptracer import sample_emitter_ray
from .volpath import _is_null_surface, _shape_tables

INV_PI = float(np.float32(1.0 / np.pi))
# the 27 neighbour offsets (dx, dy, dz), dx fastest
OFFSETS = tuple((dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1))


@dataclass(frozen=True)
class PhotonMap:
    pos: torch.Tensor       # (M, 3) sorted by cell id
    power: torch.Tensor     # (M, 3) photon power (flux / N_emitted)
    wi: torch.Tensor        # (M, 3) incident propagation direction
    valid: torch.Tensor     # (M,) bool
    cell_of: torch.Tensor   # (M,) int32 sorted cell ids
    grid_min: torch.Tensor  # (3,)
    cell_size: torch.Tensor  # ()
    res: int                # grid resolution an axis


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def lap(stats, key, dev, t0):
    """Where `stats` is a dict: synchronize the device, add the seconds
    since t0 to stats[key] (key None: none) and return the time now."""
    if stats is None:
        return None
    common.sync(dev)
    t1 = time.perf_counter()
    if key is not None:
        stats[key] = stats.get(key, 0.0) + t1 - t0
    return t1


def build_map(pos, power, wi, ok, lo, hi, radius, res: int) -> PhotonMap:
    """The sorted grid of cell size max(radius, extent / res): cell indices
    truncated toward zero and clipped, invalid photons after every cell,
    a stable sort by cell id (bre.py:_build_map, photonmap.py:108-121)."""
    extent = torch.amax(hi - lo)
    cell = torch.maximum(radius, extent / res)
    ci = torch.clamp(((pos - lo) / cell).to(torch.int32), 0, res - 1)
    cell_id = (ci[:, 2] * res + ci[:, 1]) * res + ci[:, 0]
    cell_id = torch.where(ok, cell_id, res * res * res)
    order = torch.argsort(cell_id, stable=True)
    return PhotonMap(pos=pos[order], power=power[order], wi=wi[order],
                     valid=ok[order], cell_of=cell_id[order], grid_min=lo,
                     cell_size=cell, res=res)


def trace_photons(scene: Scene, cfg: RenderConfig, n_photons: int, seed: int,
                  pass_idx: int, radius) -> PhotonMap:
    """Trace n_photons light particles, min(max_depth, 8) bounces, and
    build the surface photon map (res 128)."""
    return build_map(*surface_photons(scene, cfg, n_photons, seed, pass_idx),
                     scene.aabb_min, scene.aabb_max, radius, 128)


def surface_photons(scene: Scene, cfg: RenderConfig, n_photons: int,
                    seed: int, pass_idx: int):
    """The photons of n_photons light particles: one at every non-null
    surface hit (the reference's global map), min(max_depth, 8) bounces.
    Returns (position, power, incident direction, valid), bounce-major."""
    eps = common.scene_epsilon(scene)
    n = n_photons
    act = cfg.bsdf_kinds or None
    dev = scene.aabb_min.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed ^ 0x9407, lane, pass_idx)
    o, d, tp, _, smp, _, _ = sample_emitter_ray(scene, smp)
    alive = torch.any(tp > 0, dim=-1)
    P_pos, P_pow, P_wi, P_ok = [], [], [], []
    for i in range(min(cfg.max_depth, 8)):
        hit = isect.intersect(scene.geo, o, d, eps.expand(n), isect.INF)
        on_surface = alive & hit.valid
        b_idx = _shape_tables(scene, hit.shape_id)[0]
        is_null = _is_null_surface(scene, b_idx)
        frame = Frame.from_normal(hit.ng)
        dep = on_surface & ~is_null
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, frame.to_local(-d), u2, u1,
                           active=act)
        null_cross = on_surface & is_null
        new_d = _w3(null_cross, d, frame.to_world(bs.wo))
        w = _w3(null_cross, torch.ones_like(bs.weight), bs.weight)
        P_pos.append(hit.p)
        P_pow.append(_w3(dep, tp, torch.zeros_like(tp)))
        P_wi.append(d)
        P_ok.append(dep)
        tp2 = tp * w
        u_rr, smp = rng.next_1d(smp)
        tp_rr, survive = common.russian_roulette(
            tp2, torch.ones((n,), device=dev), u_rr,
            torch.full((n,), i, device=dev), cfg)
        tp2 = _w3(null_cross, tp2, tp_rr)
        alive = on_surface & torch.any(tp2 > 0, dim=-1) & (survive
                                                         | null_cross)
        o = hit.p + new_d * eps
        d, tp = new_d, tp2
    return (torch.cat(P_pos), torch.cat(P_pow), torch.cat(P_wi),
            torch.cat(P_ok))


def _cell_runs(pm: PhotonMap, p):
    """For each of the 27 neighbour cells of the (n, 3) points p (cell
    indices truncated toward zero, unclipped): (cell id, in-grid flag,
    first photon of the cell's run), in OFFSETS order."""
    res = pm.res
    ci = ((p - pm.grid_min) / pm.cell_size).to(torch.int32)
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=p.device)
    for off in offs:
        cc = ci + off
        inb = torch.all((cc >= 0) & (cc < res), dim=-1)
        cid = torch.where(inb, (cc[:, 2] * res + cc[:, 1]) * res + cc[:, 0],
                          res * res * res)
        yield cid, inb, torch.searchsorted(pm.cell_of, cid)


def gather_radiance(pm: PhotonMap, p, n_srf, refl, radius, n_emitted: int,
                    max_per_cell: int = 24):
    """Density estimate at surface points p: the power of the photons
    within `radius` that arrive on the front of n_srf, through the diffuse
    BRDF refl / pi, over pi r^2 N (photonmapper.cpp gather). At most
    max_per_cell photons of each of the 27 cells, in sorted order; photons
    of overfull cells are dropped (photonmap.cpp's lookup cap)."""
    r2 = radius * radius
    M = pm.cell_of.shape[0]
    total = torch.zeros_like(p)
    for cid, inb, start in _cell_runs(pm, p):
        for k in range(max_per_cell):
            j = torch.clamp_max(start + k, M - 1)
            d2 = torch.sum((pm.pos[j] - p) ** 2, dim=-1)
            sel = ((pm.cell_of[j] == cid) & inb & (d2 < r2)
                   & (dot(-pm.wi[j], n_srf) > 0))
            total = total + _w3(sel, pm.power[j], torch.zeros_like(total))
    return refl * INV_PI * total / (math.pi * r2 * n_emitted)


def camera_rays(scene: Scene, cfg: RenderConfig, seed: int, pass_idx: int):
    """One jittered ray a pixel (photonmap.py:191-197): (rays, sampler)."""
    H, W = cfg.height, cfg.width
    dev = scene.aabb_min.device
    pixel = torch.arange(H * W, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed, pixel, pass_idx, n_samples=max(cfg.spp, 1))
    jit2, smp = rng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jit2[:, 0]
    py = (pixel // W).to(torch.float32) + jit2[:, 1]
    return sensor_m.sample_rays(scene.sensor, px, py, W, H), smp


def diffuse_tables(scene: Scene, b_idx):
    """(bsdf kind, -1 where no bsdf; reflectance) of each lane's bsdf."""
    nb = scene.bsdfs.kind.shape[0]
    i = torch.clamp(b_idx, 0, nb - 1)
    return (torch.where(b_idx >= 0, take_rows(scene.bsdfs.kind, i), -1),
            take_rows(scene.bsdfs.reflectance, i))


def _pm_pass(scene: Scene, cfg: RenderConfig, n_photons: int, seed: int,
             pass_idx: int, radius, stages: dict | None = None):
    """One photon-map iteration: trace the photons, walk the camera rays
    through specular and null surfaces (4 bounces) to the first diffuse
    hit, add emitters seen on the way, and the photon density estimate at
    the diffuse hit (direct light comes from the photons too). Returns
    (H W, 3). `stages` takes the seconds of "trace", "build", "camera" and
    "gather"."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    t0 = lap(stages, None, dev, None)
    photons = surface_photons(scene, cfg, n_photons, seed, pass_idx)
    t0 = lap(stages, "trace", dev, t0)
    pm = build_map(*photons, scene.aabb_min, scene.aabb_max, radius, 128)
    t0 = lap(stages, "build", dev, t0)
    rays, smp = camera_rays(scene, cfg, seed, pass_idx)
    o, d = rays.o, rays.d
    zeros3 = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    tp = torch.ones_like(zeros3)
    L = zeros3
    alive = torch.ones((npix,), dtype=torch.bool, device=dev)
    found = torch.zeros_like(alive)
    hit_p = hit_n = hit_refl = zeros3
    for _ in range(4):
        hit = isect.intersect(scene.geo, o, d, eps.expand(npix), isect.INF)
        on_surface = alive & hit.valid
        b_idx, e_idx, _, _ = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        le = emitter_m.eval_hit(scene, e_idx, hit.ng, -d)
        L = L + _w3(on_surface & (e_idx >= 0), tp * le, zeros3)
        bk, refl = diffuse_tables(scene, b_idx)
        diffuse_hit = on_surface & (bk == BSDF_DIFFUSE) & ~found
        hit_p = _w3(diffuse_hit, hit.p, hit_p)
        hit_n = _w3(diffuse_hit, hit.ng, hit_n)
        hit_refl = _w3(diffuse_hit, tp * refl, hit_refl)
        found = found | diffuse_hit
        frame = Frame.from_normal(hit.ng)
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, frame.to_local(-d), u2, u1,
                           active=act)
        new_d = _w3(is_null, d, frame.to_world(bs.wo))
        w = _w3(is_null, torch.ones_like(bs.weight), bs.weight)
        cont = on_surface & ~found & (bs.delta | is_null)
        tp = _w3(cont, tp * w, tp)
        o = _w3(cont, hit.p + new_d * eps, o)
        d = _w3(cont, new_d, d)
        alive = cont
    t0 = lap(stages, "camera", dev, t0)
    L = L + gather_found(pm, found, hit_p, hit_n, hit_refl, radius,
                         n_photons)
    lap(stages, "gather", dev, t0)
    return L


def gather_found(pm: PhotonMap, found, hit_p, hit_n, hit_refl, radius,
                 n_emitted: int):
    """gather_radiance at the lanes that found a diffuse hit, zeros
    elsewhere (each query's estimate depends on its own lane only)."""
    out = torch.zeros_like(hit_p)
    idx = found.nonzero().squeeze(-1)
    out[idx] = gather_radiance(pm, hit_p[idx], hit_n[idx], hit_refl[idx],
                               radius, n_emitted)
    return out


def progressive_radii(r0: float, iters: int, alpha: float):
    """Each iteration's radius as float32: r_{i+1}^2 = r_i^2 (i + 1 +
    alpha) / (i + 2), in float64 on the host as in the JAX package."""
    r2, out = r0 * r0, []
    for i in range(iters):
        out.append(float(np.float32(np.sqrt(r2))))
        r2 = r2 * (i + 1 + alpha) / (i + 2)
    return out


def default_radius(scene: Scene, frac: float) -> float:
    """frac of the scene's largest extent."""
    return frac * float((scene.aabb_max - scene.aabb_min).max())


def render_photonmap(scene: Scene, cfg: RenderConfig, seed: int = 0,
                     n_photons: int | None = None,
                     initial_radius: float | None = None, alpha: float = 0.7,
                     stats: dict | None = None):
    """Photon-map render on the scene's device: max(spp / 4, 1) progressive
    iterations (ppm.cpp, sppm.cpp), alpha the Knaus-Zwicker shrink
    exponent. Returns (H, W, 3). If `stats` is a dict it gets the wall as
    "photonmap_s" and each stage's seconds (_pm_pass) summed over the
    iterations as "photonmap_stage_s"."""
    H, W = cfg.height, cfg.width
    dev = scene.aabb_min.device
    if n_photons is None:
        n_photons = max(H * W, 1 << 16)
    if initial_radius is None:
        initial_radius = default_radius(scene, 0.015)
    stages = None if stats is None else stats.setdefault(
        "photonmap_stage_s", {})
    t0 = lap(stats, None, dev, None)
    iters = max(cfg.spp // 4, 1)
    img = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    for i, r in enumerate(progressive_radii(initial_radius, iters, alpha)):
        img = img + _pm_pass(scene, cfg, n_photons, seed, i,
                             torch.tensor(r, dtype=torch.float32, device=dev),
                             stages)
    img = img / torch.tensor(float(iters), device=dev)
    lap(stats, "photonmap_s", dev, t0)
    return img.reshape(H, W, 3)
