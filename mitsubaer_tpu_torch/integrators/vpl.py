"""Instant radiosity with virtual point lights (port of
mitsubaer_tpu/integrators/vpl.py; the reference's src/integrators/vpl/
vpl.cpp).

A few light subpaths are traced from `ptracer.sample_emitter_ray`, every
vertex stored as a virtual point light (VPL), and every camera hit shaded
by the clamped contributions of all VPLs: per camera sample a host loop
over the VPLs, each step the whole (npix)-wide batch against one VPL
(camera-side BSDF, VPL-side kernel, clamped geometry term and a
media-aware visibility walk, `volpath.attenuated_visibility`). The steps
run in the VPLs' order and each draws its visibility walk's numbers from
the carried sampler, as the JAX package's lax.scan does, so the streams
stay the same.

Radiometry (every eval includes its cosine):
  L(x -> cam) = f_x(wi, w_xy) k_y(w_yx) V(x, y) Phi_y / max(d^2, c^2)
  k_y = cos_y / pi     area-emission VPLs    (Phi = L pi A / pdf)
      = 1 / (4 pi)     point-emission VPLs   (Phi = I 4 pi)
      = falloff(w_yx)  spot-emission VPLs    (Phi = I; the falloff of
                       the stored emitter, spot.cpp falloffCurve)
      = f_y(wi_y, w_yx) surface-bounce VPLs  (Phi = path throughput)
Directional, constant and environment emission vertices are direction
deltas and store no VPL (their bounce vertices do). The kernel kind of
each VPL is read to the host once a render, so a step evaluates only its
own kernel: an emission VPL's BSDF index -1 is never evaluated (the JAX
package evaluates it and discards it), and a VPL without flux only
advances the sampler through a visibility walk with no active lane.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import rng
from ..core.math import Frame, dot
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..scene import intersect as isect
from ..scene.types import EM_AREA, EM_POINT, EM_SPOT, RenderConfig, Scene
from . import common
from .photonmap import camera_rays, lap
from .ptracer import _emitter_ray
from .volpath import (_is_null_surface, _shape_tables, attenuated_visibility,
                      segment_transmittance)

K_AREA, K_POINT, K_SURFACE, K_SPOT = 0, 1, 2, 3


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def generate_vpls(scene: Scene, cfg: RenderConfig, n_paths: int, seed: int,
                  max_bounce: int = 3):
    """Trace n_paths light subpaths from stream seed ^ 0x1D5: a dict of
    the VPLs' stacked fields ("p", "n", "wi", "flux", "bsdf", "kern",
    "em"), NV = n_paths (1 + max_bounce) of them, emission vertices first,
    then each bounce's (a slot without a VPL has flux 0), and "n_paths"."""
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    dev = scene.aabb_min.device
    lane = torch.arange(n_paths, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed ^ 0x1D5, lane, torch.zeros_like(lane))
    o, d, w, med, smp, em_idx, em_kind, n_e = _emitter_ray(scene, smp)
    bricks = medium_m.DensityGrid(scene.media)
    is_area_e = em_kind == EM_AREA
    is_spot_e = em_kind == EM_SPOT
    emit_ok = is_area_e | (em_kind == EM_POINT) | is_spot_e
    # a spot VPL's flux is the bare intensity: its falloff kernel gives the
    # directional dependence (the walk's weight holds falloff times the
    # cone's solid angle, wrong as a VPL's flux)
    w_emit = _w3(is_spot_e, scene.emitters.radiance[em_idx], w)
    full = torch.full((n_paths,), -1, dtype=torch.int32, device=dev)
    vp, vn, vwi = [o], [n_e], [d]     # the emission kernels read no wi
    vflux = [_w3(emit_ok, w_emit, torch.zeros_like(w))]
    vbsdf, vem = [full], [em_idx.to(torch.int32)]
    vkern = [torch.where(is_area_e, K_AREA, torch.where(
        is_spot_e, K_SPOT, K_POINT)).to(torch.int32)]

    tp = w
    alive = torch.any(tp > 0, dim=-1)
    # a media-aware walk: each step takes one surface event; a real scatter
    # stores a VPL and samples the BSDF, a null boundary passes straight
    # through into the other medium; the segment's transmittance
    # attenuates tp either way
    for _ in range(max_bounce):
        hit = isect.intersect(scene.geo, o, d, eps.expand(n_paths), isect.INF)
        seg = torch.where(hit.valid, hit.t, 0.0)
        tr_seg, smp = segment_transmittance(scene, med, o, d, seg, smp,
                                            alive & hit.valid, bricks=bricks)
        tp = tp * _w3(alive & hit.valid, tr_seg, torch.ones_like(tp))
        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        ok = alive & hit.valid & ~is_null & torch.any(tp > 0, dim=-1)
        crossing = alive & hit.valid & is_null
        frame = Frame.from_normal(hit.ng)
        wi_l = frame.to_local(-d)
        vp.append(hit.p)
        vn.append(hit.ng)
        vwi.append(wi_l)
        vflux.append(_w3(ok, tp, torch.zeros_like(tp)))
        vbsdf.append(torch.where(ok, b_idx, 0).to(torch.int32))
        vkern.append(torch.full_like(full, K_SURFACE))
        vem.append(full)
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_l, u2, u1, active=act)
        d_new = _w3(crossing, d, frame.to_world(bs.wo))
        tp = tp * _w3(ok, bs.weight, torch.ones_like(tp))
        entering = dot(d_new, hit.ng) < 0
        med = torch.where(crossing, torch.where(entering, m_in, m_ex), med)
        d = d_new
        o = hit.p + d * eps
        alive = ((ok & (bs.pdf > 0)) | crossing) & torch.any(tp > 0, dim=-1)
    return dict(p=torch.cat(vp), n=torch.cat(vn), wi=torch.cat(vwi),
                flux=torch.cat(vflux), bsdf=torch.cat(vbsdf),
                kern=torch.cat(vkern), em=torch.cat(vem), n_paths=n_paths)


@dataclass(frozen=True)
class VplSet:
    """A render's VPLs (generate_vpls' dict), each one's kernel kind and
    whether it carries flux (read on the host once), the squared clamp
    distance, 1 / n_paths and the density grid of the visibility walks."""
    vpls: dict
    host: list
    c2: torch.Tensor
    inv_paths: torch.Tensor
    grid: medium_m.DensityGrid


def make_vpl_set(scene: Scene, cfg: RenderConfig, seed: int,
                 n_paths: int | None = None,
                 clamp: float | None = None) -> VplSet:
    """n_paths (default max(8, min(128, 4 spp))) light subpaths of
    max(1, min(max_depth - 1, 3)) bounces; the clamp (the least distance
    of the geometry term, vpl.cpp's bias for variance) by default 2% of
    the scene's diagonal."""
    dev = scene.aabb_min.device
    if n_paths is None:
        n_paths = max(8, min(128, cfg.spp * 4))
    if clamp is None:
        diag = scene.aabb_max - scene.aabb_min
        c2 = 0.02 * torch.sqrt(dot(diag, diag))
        c2 = c2 * c2
    else:
        c2 = torch.tensor(clamp * clamp, dtype=torch.float32, device=dev)
    vpls = generate_vpls(scene, cfg, n_paths, seed,
                         max_bounce=max(1, min(cfg.max_depth - 1, 3)))
    host = list(zip(vpls["kern"].tolist(),
                    torch.any(vpls["flux"] > 0, dim=-1).tolist()))
    return VplSet(vpls=vpls, host=host, c2=c2,
                  inv_paths=1.0 / torch.tensor(float(n_paths), device=dev),
                  grid=medium_m.DensityGrid(scene.media))


def camera_sample(scene: Scene, cfg: RenderConfig, seed: int, s_idx: int,
                  grid):
    """Camera sample s_idx of each pixel (stream seed): its ray walks
    through up to 3 null medium boundaries, tracking the medium and its
    segments' transmittance (in-scattering along it is not modelled, the
    usual VPL preview). Returns (the emitters it sees directly, the
    camera hits' state for shade(), the sampler)."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    rays, smp = camera_rays(scene, cfg, seed, s_idx)
    med = scene.camera_medium.to(torch.int32).expand(npix)
    o = rays.o
    tr0 = torch.ones((npix, 3), dtype=torch.float32, device=dev)
    walking = torch.ones((npix,), dtype=torch.bool, device=dev)
    for _ in range(3 + 1):
        hit = isect.intersect(scene.geo, o, rays.d, eps.expand(npix),
                              isect.INF)
        seg = torch.where(hit.valid, hit.t, 0.0)
        tr_seg, smp = segment_transmittance(scene, med, o, rays.d, seg, smp,
                                            walking & hit.valid, bricks=grid)
        tr0 = tr0 * _w3(walking & hit.valid, tr_seg, torch.ones_like(tr0))
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        crossing = walking & hit.valid & _is_null_surface(scene, b_idx)
        entering = dot(rays.d, hit.ng) < 0
        med = torch.where(crossing, torch.where(entering, m_in, m_ex), med)
        o = _w3(crossing, hit.p + rays.d * eps, o)
        walking = crossing
    frame = Frame.from_normal(hit.ng)
    valid = hit.valid & ~_is_null_surface(scene, b_idx)
    # emitters seen directly (the VPLs carry reflected light only)
    le = emitter_m.eval_hit(scene, e_idx, hit.ng, -rays.d)
    L = _w3(valid & (e_idx >= 0), le * tr0, torch.zeros_like(tr0))
    env = emitter_m.env_radiance(scene, rays.d)
    L = L + _w3(hit.valid, torch.zeros_like(tr0), env * tr0)
    cam = (hit, b_idx, tr0, med, valid, frame, frame.to_local(-rays.d))
    return L, cam, smp


def shade(scene: Scene, cfg: RenderConfig, vs: VplSet, v: int, cam, smp):
    """One shading step: every pixel's contribution from VPL v through its
    visibility walk. Returns (the (npix, 3) contribution, None where the
    VPL has no flux; the sampler)."""
    hit, b_idx, tr0, med, valid, frame, wi_l = cam
    vpls = vs.vpls
    kern, has_flux = vs.host[v]
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    npix = hit.p.shape[0]
    to_y = vpls["p"][v] - hit.p
    d2 = dot(to_y, to_y)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
    w_xy = to_y / dist[..., None]
    if not has_flux:
        # no VPL here: nothing adds, but the walk's numbers are drawn
        none = torch.zeros((npix,), dtype=torch.bool, device=hit.p.device)
        _, smp = attenuated_visibility(scene, eps, hit.p + w_xy * eps, w_xy,
                                       dist - 2 * eps, med, smp, none,
                                       bricks=vs.grid)
        return None, smp
    f_x = bsdf_m.eval(scene.bsdfs, b_idx, wi_l, frame.to_local(w_xy),
                      active=act)
    w_yx_l = Frame.from_normal(vpls["n"][v].expand(npix, 3)).to_local(-w_xy)
    if kern == K_AREA:
        k = (torch.clamp_min(w_yx_l[..., 2], 0.0) / math.pi)[..., None]
    elif kern == K_POINT:
        k = torch.full((npix, 1), 1.0 / (4.0 * math.pi), device=hit.p.device)
    elif kern == K_SPOT:
        # the falloff of the stored emitter (spot.cpp falloffCurve)
        em = scene.emitters
        e = torch.clamp(vpls["em"][v], 0, em.kind.shape[0] - 1).to(
            torch.int64)
        cutoff = em.cutoff_cos[e]
        ct = dot(-w_xy, em.direction[e])
        k = torch.clamp((ct - cutoff) / torch.clamp_min(
            em.beam_falloff_cos[e] - cutoff, 1e-6), 0.0, 1.0)[..., None]
    else:
        k = bsdf_m.eval(scene.bsdfs, vpls["bsdf"][v].expand(npix),
                        vpls["wi"][v].expand(npix, 3), w_yx_l, active=act)
    g = 1.0 / torch.maximum(d2, vs.c2)
    contrib = (f_x * k * (vpls["flux"][v].expand(npix, 3)
                          * (g * vs.inv_paths)[..., None]) * tr0)
    ok = (valid & torch.any(contrib > 0, dim=-1)
          & torch.isfinite(contrib).all(-1))
    tr, smp = attenuated_visibility(scene, eps, hit.p + w_xy * eps, w_xy,
                                    dist - 2 * eps, med, smp, ok,
                                    bricks=vs.grid)
    return _w3(ok, contrib * tr, torch.zeros_like(contrib)), smp


def render_vpl(scene: Scene, cfg: RenderConfig, seed: int = 0,
               n_paths: int | None = None, clamp: float | None = None,
               stats: dict | None = None):
    """VPL render, (H, W, 3): the VPLs of make_vpl_set, then cfg.spp
    camera samples a pixel (stream seed), each shaded by every VPL in
    order. If `stats` is a dict it gets the wall as "vpl_s", the VPLs'
    count as "vpls" and the stages' seconds as "vpl_stage_s" ("generate",
    "camera", "shading")."""
    H, W = cfg.height, cfg.width
    dev = scene.aabb_min.device
    stages = None if stats is None else stats.setdefault("vpl_stage_s", {})
    t0 = lap(stats, None, dev, None)
    ts = lap(stages, None, dev, None)
    vs = make_vpl_set(scene, cfg, seed, n_paths, clamp)
    if stats is not None:
        stats["vpls"] = len(vs.host)
    ts = lap(stages, "generate", dev, ts)
    img = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        L, cam, smp = camera_sample(scene, cfg, seed, s, vs.grid)
        ts = lap(stages, "camera", dev, ts)
        for v in range(len(vs.host)):
            add, smp = shade(scene, cfg, vs, v, cam, smp)
            if add is not None:
                L = L + add
        img = img + L
        ts = lap(stages, "shading", dev, ts)
    img = img / torch.tensor(float(cfg.spp), device=dev)
    lap(stats, "vpl_s", dev, t0)
    return img.reshape(H, W, 3)
