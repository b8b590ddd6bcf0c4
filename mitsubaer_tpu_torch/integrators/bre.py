"""Beam radiance estimate (BRE) volumetric photon mapping (port of
mitsubaer_tpu/integrators/bre.py; the reference's
src/integrators/photonmapper/bre.cpp).

Volume photons are traced with the path tracers' distance sampling
(Woodcock tracking through `DensityGrid`, kernel A on the card, in a
heterogeneous medium) and binned into photonmap.py's sorted hash grid at
res 64, with one fixed gather radius. A camera segment's beam integral is
a stratified quadrature of M_BEAM jittered points, each a bounded 27-cell
gather with the phase function, weighted by the segment's transmittance
from a fixed 16-step midpoint quadrature of the density (`_segment_tau`,
kernel A again). Surface radiance is photonmap.py's emitter hits and
diffuse gather on a surface map traced beside it. The gathers are plain
PyTorch (the JAX package writes them in XLA, not Pallas).
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.math import Frame, dot
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..scene import intersect as isect
from ..scene.types import (BSDF_DIFFUSE, MED_HETEROGENEOUS, MED_HOMOGENEOUS,
                           RenderConfig, Scene)
from . import common
from .photonmap import (PhotonMap, _cell_runs, _w3, build_map, camera_rays,
                        default_radius, diffuse_tables, gather_found, lap,
                        progressive_radii, surface_photons)
from .ptracer import sample_emitter_ray
from .volpath import _is_null_surface, _shape_tables

M_BEAM = 8       # stratified beam-quadrature points a segment
TAU_STEPS = 16   # midpoint steps of a segment's optical depth
# jnp.linspace(0, 1, 17) in float32: k / 16, exact
_TAU_T = tuple(k / TAU_STEPS for k in range(TAU_STEPS + 1))


def trace_volume_photons(scene: Scene, cfg: RenderConfig, n: int, seed: int,
                         pass_idx: int, radius, max_bounce: int = 8
                         ) -> PhotonMap:
    """The volume photon map (res 64) of n light particles through the
    media, max_bounce events."""
    return build_map(*volume_photons(scene, cfg, n, seed, pass_idx,
                                     max_bounce),
                     scene.aabb_min, scene.aabb_max, radius, 64)


def volume_photons(scene: Scene, cfg: RenderConfig, n: int, seed: int,
                   pass_idx: int, max_bounce: int = 8):
    """n light particles through the media, max_bounce events: a volume
    photon at every medium scatter, its power the throughput arriving there
    (Jensen's convention). Returns (position, power, incident direction,
    valid), event-major."""
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    dev = scene.aabb_min.device
    bricks = medium_m.DensityGrid(scene.media)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed ^ 0xBBE, lane, pass_idx)
    o, d, tp, med, smp, _, _ = sample_emitter_ray(scene, smp)
    alive = torch.any(tp > 0, dim=-1)
    ones = torch.ones((n,), device=dev)
    P_pos, P_pow, P_wi, P_ok = [], [], [], []
    for b in range(max_bounce):
        hit = isect.intersect(scene.geo, o, d, eps.expand(n), isect.INF)
        _, t_scene = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
        t_max = torch.where(hit.valid, hit.t, torch.clamp_min(t_scene, 0.0))
        kind, sa, ss, sw, scale = medium_m.params(scene.media, med,
                                                  sampling_weight=True)
        in_hom = alive & (kind == MED_HOMOGENEOUS)
        in_het = alive & (kind == MED_HETEROGENEOUS)
        u1, smp = rng.next_1d(smp)
        uc, smp = rng.next_1d(smp)
        hs, ht, hw, _ = medium_m.sample_distance_homogeneous(
            sa, ss, sw, t_max, u1, uc)
        wh, wt, ww, _, smp, _, _ = medium_m.sample_distance_woodcock(
            scene.media, sa, ss, scale, o, d, t_max, smp, in_het,
            bricks=bricks)
        scat = torch.where(in_het, wh, in_hom & hs)
        t_ev = torch.where(in_het, wt, torch.where(in_hom, ht, t_max))
        w_ev = _w3(in_het, ww, _w3(in_hom, hw, torch.ones_like(hw)))
        # deposit at medium scatters (the power before the event's weight)
        m_p = o + t_ev.unsqueeze(-1) * d
        dep = alive & scat
        P_pos.append(m_p)
        P_pow.append(_w3(dep, tp, torch.zeros_like(tp)))
        P_wi.append(d)
        P_ok.append(dep)
        tp = tp * _w3(alive, w_ev, torch.ones_like(w_ev))
        # continue: a phase sample at a scatter, the surface event else
        u2, smp = rng.next_2d(smp)
        u1b, smp = rng.next_1d(smp)
        ps = phase_m.sample(scene.media.phase, med, d, u2, active=pact)
        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        on_surface = alive & ~scat & hit.valid
        frame = Frame.from_normal(hit.ng)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, frame.to_local(-d), u2, u1b,
                           active=act)
        d_srf = _w3(is_null, d, frame.to_world(bs.wo))
        w_srf = _w3(is_null, torch.ones_like(bs.weight), bs.weight)
        new_d = _w3(scat, ps.wo, d_srf)
        tp = tp * _w3(scat, ps.weight.unsqueeze(-1),
                      _w3(on_surface, w_srf, torch.ones_like(w_srf)))
        cross = on_surface & (is_null
                              | (dot(new_d, hit.ng) * dot(-d, hit.ng) < 0))
        med = torch.where(cross, torch.where(dot(new_d, hit.ng) < 0, m_in,
                                             m_ex), med)
        o = _w3(scat, m_p, hit.p) + new_d * eps
        d = new_d
        u_rr, smp = rng.next_1d(smp)
        tp_rr, survive = common.russian_roulette(
            tp, ones, u_rr, torch.full((n,), b + 1, device=dev), cfg)
        tp = _w3(scat, tp, tp_rr)
        alive = ((scat | on_surface) & torch.any(tp > 0, dim=-1)
                 & (scat | survive | is_null))
    return (torch.cat(P_pos), torch.cat(P_pow), torch.cat(P_wi),
            torch.cat(P_ok))


def gather_beam(pm: PhotonMap, scene: Scene, med, x, w_out, radius,
                n_emitted: int, pact, max_per_cell: int = 16):
    """In-scattered radiance at the points x toward w_out: the sum of
    phase(wi_p -> w_out) power_p over the photons within `radius` (at most
    max_per_cell of each of the 27 cells, in sorted order), over
    4/3 pi r^3 N."""
    r2 = radius * radius
    M = pm.cell_of.shape[0]
    total = torch.zeros_like(x)
    for cid, inb, start in _cell_runs(pm, x):
        for k in range(max_per_cell):
            j = torch.clamp_max(start + k, M - 1)
            d2 = torch.sum((pm.pos[j] - x) ** 2, dim=-1)
            rho = phase_m.eval(scene.media.phase, med, pm.wi[j], w_out,
                               active=pact)
            sel = (pm.cell_of[j] == cid) & inb & (d2 < r2)
            total = total + _w3(sel, pm.power[j] * rho.unsqueeze(-1),
                                torch.zeros_like(total))
    return total / ((4.0 / 3.0) * torch.pi * r2 * radius * n_emitted)


def _segment_tau(scene: Scene, bricks, med, o, d, seg):
    """Deterministic optical depth along [0, seg] of each lane: analytic in
    a homogeneous medium, a midpoint quadrature of the density grid of
    TAU_STEPS steps in a heterogeneous one. Returns (the prefix points ts
    (n, TAU_STEPS + 1), tau at them (n, TAU_STEPS + 1, 3))."""
    kind, sa, ss, scale = medium_m.params(scene.media, med)
    st = sa + ss
    ts = torch.tensor(_TAU_T, dtype=torch.float32,
                      device=o.device).unsqueeze(0) * seg.unsqueeze(1)
    mid = 0.5 * (ts[:, 1:] + ts[:, :-1])
    p_mid = o.unsqueeze(1) + mid.unsqueeze(-1) * d.unsqueeze(1)
    dens = bricks.lookup(p_mid.reshape(-1, 3)).reshape(mid.shape) \
        * scale.unsqueeze(1)
    dtau = dens * (ts[:, 1:] - ts[:, :-1])
    # the prefix sums one step at a time, in float32, as XLA's cumsum
    cum = [torch.zeros_like(ts[:, 0])]
    for k in range(TAU_STEPS):
        cum.append(cum[-1] + dtau[:, k])
    cum = torch.stack(cum, dim=1)
    is_het = (kind == MED_HETEROGENEOUS).view(-1, 1, 1)
    is_hom = (kind == MED_HOMOGENEOUS).view(-1, 1, 1)
    tau = torch.where(is_het, cum.unsqueeze(-1) * st.unsqueeze(1),
                      torch.where(is_hom, ts.unsqueeze(-1) * st.unsqueeze(1),
                                  0.0))
    return ts, tau


def _beam(scene: Scene, vol_pm, tau, med, o, d, seg, u_b, radius,
          n_photons: int, pact):
    """The beam term of each lane's segment [0, seg]: M_BEAM stratified
    points jittered by u_b, each gathering the volume map (gather_beam)
    weighted by exp(-tau) interpolated from _segment_tau's prefix values
    tau (n, TAU_STEPS + 1, 3). Returns (n, 3)."""
    S = tau.shape[1] - 1
    jf = (torch.arange(M_BEAM, dtype=torch.float32, device=o.device) + 0.5) \
        / M_BEAM
    fj = jf.unsqueeze(0) + (u_b.unsqueeze(1) - 0.5) / M_BEAM     # (n, M)
    fidx = torch.clamp(fj * S, 0.0, S - 1e-3)
    i0 = fidx.to(torch.int64)
    fr = (fidx - i0.to(torch.float32)).unsqueeze(-1)
    tau0 = torch.gather(tau, 1, i0.unsqueeze(-1).expand(-1, -1, 3))
    tau1 = torch.gather(tau, 1, (i0 + 1).unsqueeze(-1).expand(-1, -1, 3))
    tau_j = tau0 * (1 - fr) + tau1 * fr                         # (n, M, 3)
    t_j = fj * seg.unsqueeze(1)
    x_j = (o.unsqueeze(1) + t_j.unsqueeze(-1) * d.unsqueeze(1)).reshape(-1, 3)
    g = gather_beam(vol_pm, scene, med.repeat_interleave(M_BEAM), x_j,
                    (-d).repeat_interleave(M_BEAM, dim=0), radius, n_photons,
                    pact).reshape(-1, M_BEAM, 3)
    return torch.sum(torch.exp(-tau_j) * g, dim=1) \
        * (seg / M_BEAM).unsqueeze(-1)


def _bre_pass(scene: Scene, cfg: RenderConfig, n_photons: int, seed: int,
              pass_idx: int, radius, stages: dict | None = None):
    """One BRE iteration: the volume and surface photon maps, then each
    pixel's camera ray through 4 segments (through specular and null
    surfaces only): the beam term of each medium segment, emitters seen,
    and the surface gather at the first diffuse hit. Returns (H W, 3).
    `stages` takes the seconds of "volume_photons", "surface_photons",
    "beam" (the camera walk with its beam gathers) and "surface_gather"."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    bricks = medium_m.DensityGrid(scene.media)
    lo, hi = scene.aabb_min, scene.aabb_max
    t0 = lap(stages, None, dev, None)
    vol_pm = trace_volume_photons(scene, cfg, n_photons, seed, pass_idx,
                                  radius)
    t0 = lap(stages, "volume_photons", dev, t0)
    srf_pm = build_map(*surface_photons(scene, cfg, n_photons, seed,
                                        pass_idx), lo, hi, radius, 128)
    t0 = lap(stages, "surface_photons", dev, t0)
    rays, smp = camera_rays(scene, cfg, seed, pass_idx)
    o, d = rays.o, rays.d
    med = scene.camera_medium.to(torch.int64).expand(npix)
    zeros3 = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    tp = torch.ones_like(zeros3)
    L = zeros3
    alive = torch.ones((npix,), dtype=torch.bool, device=dev)
    found = torch.zeros_like(alive)
    hit_p = hit_n = hit_refl = zeros3
    for _ in range(4):
        hit = isect.intersect(scene.geo, o, d, eps.expand(npix), isect.INF)
        _, t_scene = isect.ray_aabb(o, d, lo, hi)
        seg = torch.where(hit.valid, hit.t, torch.clamp_min(t_scene, 0.0))
        kind = medium_m.params(scene.media, med)[0]
        in_med = alive & ((kind == MED_HOMOGENEOUS)
                          | (kind == MED_HETEROGENEOUS))
        # the segment's optical depth on every lane (as the JAX package),
        # its beam term on the lanes in a medium (a lane's term reads its
        # own lane only)
        tau = _segment_tau(scene, bricks, med, o, d, seg)[1]
        u_b, smp = rng.next_1d(smp)
        idx = in_med.nonzero().squeeze(-1)
        beam = _beam(scene, vol_pm, tau[idx], med[idx], o[idx], d[idx],
                     seg[idx], u_b[idx], radius, n_photons, pact)
        L = L.index_add(0, idx, tp[idx] * beam)
        tp = tp * _w3(in_med, torch.exp(-tau[:, -1]), torch.ones_like(tp))
        # the surface event
        on_surface = alive & hit.valid
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        le = emitter_m.eval_hit(scene, e_idx, hit.ng, -d)
        L = L + _w3(on_surface & (e_idx >= 0), tp * le, zeros3)
        bk, refl = diffuse_tables(scene, b_idx)
        diffuse_hit = on_surface & (bk == BSDF_DIFFUSE) & ~found & ~is_null
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
        cross = on_surface & (is_null
                              | (dot(new_d, hit.ng) * dot(-d, hit.ng) < 0))
        med = torch.where(cross & cont, torch.where(
            dot(new_d, hit.ng) < 0, m_in, m_ex), med)
        tp = _w3(cont, tp * w, tp)
        o = _w3(cont, hit.p + new_d * eps, o)
        d = _w3(cont, new_d, d)
        alive = cont
    t0 = lap(stages, "beam", dev, t0)
    L = L + gather_found(srf_pm, found, hit_p, hit_n, hit_refl, radius,
                         n_photons)
    lap(stages, "surface_gather", dev, t0)
    return L


def render_bre(scene: Scene, cfg: RenderConfig, seed: int = 0,
               n_photons: int | None = None,
               initial_radius: float | None = None, alpha: float = 0.7,
               stats: dict | None = None):
    """BRE render on the scene's device: max(spp / 4, 1) progressive
    iterations with the Knaus-Zwicker radius shrink. Returns (H, W, 3). If
    `stats` is a dict it gets the wall as "bre_s" and each stage's seconds
    (_bre_pass) summed over the iterations as "bre_stage_s"."""
    H, W = cfg.height, cfg.width
    dev = scene.aabb_min.device
    if n_photons is None:
        n_photons = max(H * W, 1 << 16)
    if initial_radius is None:
        initial_radius = default_radius(scene, 0.03)
    stages = None if stats is None else stats.setdefault("bre_stage_s", {})
    t0 = lap(stats, None, dev, None)
    iters = max(cfg.spp // 4, 1)
    img = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    for i, r in enumerate(progressive_radii(initial_radius, iters, alpha)):
        img = img + _bre_pass(scene, cfg, n_photons, seed, i,
                              torch.tensor(r, dtype=torch.float32,
                                           device=dev), stages)
    img = img / torch.tensor(float(iters), device=dev)
    lap(stats, "bre_s", dev, t0)
    return img.reshape(H, W, 3)
