"""Volumetric path tracer with attenuated NEE + MIS and beam ("collimated")
next-event estimation (port of mitsubaer_tpu/integrators/volpath.py): the
loop engine `li`, its shadow transmittance through null boundaries and the
collimated-beam helpers that the boxwalk and wavefront roads share.

`li` advances every lane a bounce at a time. Lanes in a medium sample a
distance (analytic when homogeneous, Woodcock tracking through kernel A
when heterogeneous), lanes on surfaces run the surface logic, and null
boundaries cross without using up path depth. Every vertex makes one
emitter NEE connection and, with `cfg.has_beam`, one beam NEE connection
(an equiangular point on the beam, joined through one extra medium
vertex); both shadow segments are walked in one batched
`attenuated_visibility` call. The bounce loop runs on the host, one `body`
a bounce, while some lane is active and `iters < 2 max_depth + 8`: the
JAX `li`'s while loop, with one device sync a bounce.

`li(..., differentiable=True)` is the JAX package's differentiable mode
(diff/render.py): sampling decisions detached, weights attached, the
log-density of the decisions carried as `log_p` and added to every
contribution as a score surrogate, the tracking loops capped at 64 tests,
and each bounce run under `torch.utils.checkpoint` (the counterpart of
JAX's checkpointed scan), so the stored graph is one bounce's. The RNG is
a stateless hash, so a recomputed bounce draws the same numbers and its
host-synced trip counts come out the same. Transient and CW-ToF sinks
(step 10), `medium_strategies` (step 7) and direct sampling of area, spot
and directional emitters (step 9) raise `not_ported` with their ROADMAP
Queue 1 step.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from .. import not_ported
from ..core import rng
from ..core.math import Frame, dot, length, mis_weight_power
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..scene import intersect as isect
from ..scene.types import (BSDF_NULL, EM_COLLIMATED, EM_CONSTANT, EM_POINT,
                           MED_HETEROGENEOUS, MED_HOMOGENEOUS, RenderConfig,
                           Scene)
from . import common


def _shape_tables(scene: Scene, shape_id):
    """(bsdf, emitter, interior, exterior) of each shape id (-1 for none)."""
    sh = scene.shapes
    i = torch.clamp(shape_id, 0, sh.bsdf.shape[0] - 1).to(torch.int64)
    ok = shape_id >= 0
    return tuple(torch.where(ok, a[i], -1)
                 for a in (sh.bsdf, sh.emitter, sh.interior, sh.exterior))


def _is_null_surface(scene: Scene, bsdf_idx):
    kinds = scene.bsdfs.kind
    kind = kinds[torch.clamp(bsdf_idx, 0, kinds.shape[0] - 1).to(torch.int64)]
    return (bsdf_idx < 0) | (kind == BSDF_NULL)


def segment_transmittance(scene: Scene, medium_idx, o, d, dist, smp, active,
                          bricks=None, differentiable: bool = False):
    """Transmittance of straight segments inside medium `medium_idx` (-1 is
    vacuum): analytic when homogeneous, ratio tracking when heterogeneous
    (capped at 64 tests with `differentiable`)."""
    media = scene.media
    kind, sa, ss, scale = medium_m.params(media, medium_idx)
    tr = torch.ones((o.shape[0], 3), dtype=torch.float32, device=o.device)
    hom = active & (kind == MED_HOMOGENEOUS)
    tr_h = medium_m.eval_transmittance_homogeneous(sa, ss, dist)
    tr = torch.where(hom.unsqueeze(-1), tr_h, tr)
    het = active & (kind == MED_HETEROGENEOUS)
    tr_r, smp = medium_m.transmittance_ratio_tracking(
        media, sa, ss, scale, o, d, dist, smp, het, bricks=bricks,
        differentiable=differentiable)
    return torch.where(het.unsqueeze(-1), tr_r, tr), smp


def attenuated_visibility(scene: Scene, eps, o, d, dist, medium_idx, smp,
                          active, max_crossings: int = 4, bricks=None,
                          differentiable: bool = False):
    """Transmittance along shadow segments, walking through null medium
    boundaries (Scene::evalTransmittanceAll); opaque surfaces give 0. At
    most max_crossings segments a lane, in either mode."""
    n = o.shape[0]

    def crossing_trip(state):
        cur_o, remaining, med, tr, running, smp = state
        hit = isect.intersect(scene.geo, cur_o, d, eps * 0.5, remaining - eps)
        seg = torch.where(hit.valid, hit.t, remaining)
        tr_seg, smp = segment_transmittance(scene, med, cur_o, d, seg, smp,
                                            running, bricks=bricks,
                                            differentiable=differentiable)
        tr = torch.where(running.unsqueeze(-1), tr * tr_seg, tr)
        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        blocked = running & hit.valid & ~is_null
        tr = torch.where(blocked.unsqueeze(-1), 0.0, tr)
        crossing = running & hit.valid & is_null
        entering = dot(d, hit.ng) < 0
        med = torch.where(crossing, torch.where(entering, m_in, m_ex), med)
        cur_o = torch.where(crossing.unsqueeze(-1), hit.p + d * eps, cur_o)
        remaining = torch.where(crossing, remaining - seg - eps, remaining)
        running = crossing & (remaining > eps)
        return cur_o, remaining, med, tr, running, smp

    # a crossing trip not run would have drawn a ratio-tracking loop's
    # numbers on every lane
    draws = medium_m.tracking_trips(medium_m.MAX_STEPS,
                                      differentiable) * medium_m.UNROLL
    state = (o, dist, medium_idx,
             torch.ones((n, 3), dtype=torch.float32, device=o.device),
             active, smp)
    (_, _, _, tr, _, smp), _ = medium_m.bounded_while(
        lambda st: st[4], crossing_trip, state, max_crossings, differentiable,
        lambda st, k: st[:5] + (medium_m.skip_draws(st[5], k * draws),))
    return tr, smp


@dataclass(frozen=True)
class Beam:
    exists: torch.Tensor   # () bool
    o: torch.Tensor        # (3,)
    d: torch.Tensor        # (3,) unit
    power: torch.Tensor    # (3,)
    s0: torch.Tensor       # () beam parameter where it enters the scene box
    s1: torch.Tensor       # ()
    medium: torch.Tensor   # () medium the beam threads


def get_beam(scene: Scene) -> Beam:
    em = scene.emitters
    is_coll = em.kind == EM_COLLIMATED
    e = torch.argmax(is_coll.to(torch.int32))      # first collimated emitter
    o, d = em.position[e], em.direction[e]
    tn, tf = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
    s0 = torch.clamp_min(tn, 0.0)
    s1 = torch.maximum(tf, s0)
    # the medium the beam threads: interior medium of the first shape it enters
    hit = isect.intersect(scene.geo, o[None, :], d[None, :], 0.0, 3e38)
    _, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
    entering = dot(d[None, :], hit.ng) < 0
    med = torch.where(hit.valid, torch.where(entering, m_in, m_ex), -1)[0]
    return Beam(exists=torch.any(is_coll), o=o, d=d, power=em.radiance[e],
                s0=s0, s1=s1, medium=med)


def sample_beam_point(beam: Beam, p, u):
    """Equiangular sample of a point y on the beam as seen from (N, 3)
    points p. Returns (y, s, pdf_s, dist_to_p, dir_y_to_p)."""
    delta = dot(p - beam.o, beam.d)
    closest = beam.o + delta.unsqueeze(-1) * beam.d
    h = torch.clamp_min(length(p - closest), 1e-6)
    theta_a = torch.atan2(beam.s0 - delta, h)
    theta_b = torch.atan2(beam.s1 - delta, h)
    theta = theta_a + u * (theta_b - theta_a)
    s_rel = h * torch.tan(theta)
    s = delta + s_rel
    pdf = h / torch.clamp_min((theta_b - theta_a) * (h * h + s_rel * s_rel),
                              1e-12)
    y = beam.o + s.unsqueeze(-1) * beam.d
    to_p = p - y
    dist = torch.clamp_min(length(to_p), 1e-6)
    return y, s, pdf, dist, to_p / dist.unsqueeze(-1)


def build_beam_tau(scene: Scene, beam: Beam, bricks, n: int = 256):
    """(n, 8) table along the beam by midpoint quadrature:
    row i = [tau_rgb(s_i), tau_rgb(s_i+1) - tau_rgb(s_i), density(s_i)*scale, 0].
    On a grid that requires grad the lookups are attached, so the density
    gradient reaches the table (kernel A' in its backward)."""
    dev = beam.o.device
    si = beam.s0 + (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) \
        / n * (beam.s1 - beam.s0)
    pts = beam.o[None, :] + si[:, None] * beam.d[None, :]
    bmed = beam.medium.expand(n)
    kind, sa, ss, scale = medium_m.params(scene.media, bmed)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    dens = torch.where(kind == MED_HETEROGENEOUS, bricks.lookup(pts) * scale,
                       torch.where(kind == MED_HOMOGENEOUS, ones, 0.0 * ones))
    dtau = (sa + ss) * dens[:, None] * ((beam.s1 - beam.s0) / n)
    tau = torch.cumsum(dtau, dim=0) - 0.5 * dtau
    tau_next = torch.cat([tau[1:], tau[-1:]], dim=0)
    return torch.cat([tau, tau_next - tau, dens[:, None],
                      torch.zeros((n, 1), device=dev)], dim=-1)


def beam_transmittance(beam: Beam, tau_table, s, with_density: bool = False):
    """Tr(beam origin -> s) by one row lookup and a lerp of the table; with
    with_density also the row's density(s) * scale."""
    n = tau_table.shape[0]
    f = (s - beam.s0) / torch.clamp_min(beam.s1 - beam.s0, 1e-9) * n - 0.5
    f = torch.clamp(f, 0.0, n - 1.0)
    i0 = torch.floor(f).to(torch.int64)
    t = (f - i0).unsqueeze(-1)
    row = tau_table[i0]
    tau = row[:, 0:3] + row[:, 3:6] * t
    tau = torch.where((s < beam.s0).unsqueeze(-1), 0.0, tau)
    if with_density:
        return torch.exp(-tau), row[:, 6]
    return torch.exp(-tau)


# ---------------------------------------------------------------------------
# The loop engine
# ---------------------------------------------------------------------------
_DIRECT = {EM_POINT, EM_CONSTANT, EM_COLLIMATED}   # sample_direct's kinds


def check_supported(scene: Scene, cfg: RenderConfig) -> None:
    """Raise for what the loop engine does not port yet."""
    if cfg.n_frames != 1 or cfg.modulation != "none":
        raise not_ported("transient and CW-ToF sinks", 10)
    if cfg.medium_strategies:
        raise not_ported("cfg.medium_strategies", 7)
    if rng.mode_of(cfg.sampler) != rng.INDEPENDENT:
        raise not_ported(f"the {cfg.sampler!r} sampler", 1)
    kinds = set(scene.emitters.kind.tolist())
    if kinds - _DIRECT:
        raise not_ported(f"direct sampling of emitter kinds "
                         f"{sorted(kinds - _DIRECT)}", 9)


@dataclass(frozen=True)
class PassTables:
    """What `li` builds once a pass: the f32 density grid every lookup
    goes through (one cell table for kernel A, as the JAX `li` gathers one
    DensityBricks), the beam and its tau table (with cfg.has_beam), and the
    ray epsilon."""
    bricks: medium_m.DensityGrid
    beam: Beam | None
    beam_tau: torch.Tensor | None
    eps: torch.Tensor


@dataclass(frozen=True)
class State:
    """A bounce's lane state; log_p (the log-density of the lane's
    parameter-dependent decisions so far) only in differentiable mode."""
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    sink: torch.Tensor          # (N, 3) steady-state radiance
    active: torch.Tensor
    depth: torch.Tensor
    eta_scale: torch.Tensor
    last_pdf: torch.Tensor
    last_delta: torch.Tensor
    medium: torch.Tensor
    log_p: torch.Tensor | None
    iters: int
    sampler: rng.Sampler


def pass_tables(scene: Scene, cfg: RenderConfig) -> PassTables:
    bricks = medium_m.DensityGrid(scene.media)
    beam = get_beam(scene) if cfg.has_beam else None
    return PassTables(
        bricks=bricks, beam=beam,
        beam_tau=build_beam_tau(scene, beam, bricks) if cfg.has_beam else None,
        eps=common.scene_epsilon(scene))


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def visibility_sampler(smp: rng.Sampler, k: int, iters: int) -> rng.Sampler:
    """The decorrelated stream of a bounce's k batched shadow segments
    (volpath.py:429-436): segment i of lane j draws as lane
    (lane_j + i 0x9E37) mod 2^32 at dim 0, seeded by the bounce counter."""
    lane = torch.cat([(smp.lane + i * 0x9E37) & rng.M32 for i in range(k)])
    index = torch.cat([smp.index] * k)
    seed = rng.hash_combine(smp.seed, 0x51BB, iters)
    return rng.Sampler(lane=lane, index=index, dim=torch.zeros_like(lane),
                       seed=seed, key=rng.hash_combine(seed, lane, index))


def body(scene: Scene, cfg: RenderConfig, s: State, tabs: PassTables,
         simple: bool = False, differentiable: bool = False):
    """One bounce of every lane (volpath.py:292-564). Returns the next
    state and the Woodcock tracking iterations it ran. With
    `differentiable` the tracking loops stop at 64 tests and log_p
    accumulates at the medium sample (volpath.py:326-328) and the phase
    sample (:504-506) and feeds every contribution's score surrogate."""
    n = s.o.shape[0]
    eps, bricks, beam = tabs.eps, tabs.bricks, tabs.beam
    media = scene.media
    smp = s.sampler
    hit = isect.intersect(scene.geo, s.o, s.d, eps.expand(n), isect.INF)
    # bound medium marching for escaped rays by the scene AABB exit
    _, t_scene = isect.ray_aabb(s.o, s.d, scene.aabb_min, scene.aabb_max)
    t_far = torch.where(hit.valid, hit.t, torch.clamp_min(t_scene, 0.0))

    # ---------- medium distance sampling ----------
    in_medium = s.active & (s.medium >= 0)
    kind, sa, ss, sw, scale = medium_m.params(media, s.medium,
                                              sampling_weight=True)
    u_hom, smp = rng.next_1d(smp)
    uc_hom, smp = rng.next_1d(smp)
    hs, ht, hw, h_logp = medium_m.sample_distance_homogeneous(
        sa, ss, sw, t_far, u_hom, uc_hom)
    het = in_medium & (kind == MED_HETEROGENEOUS)
    ws, wt, ww, _, smp, wood_iters, w_logp = medium_m.sample_distance_woodcock(
        media, sa, ss, scale, s.o, s.d, t_far, smp, het, bricks=bricks,
        differentiable=differentiable)
    is_hom = kind == MED_HOMOGENEOUS
    log_p = None
    if differentiable:
        log_p = s.log_p + torch.where(
            in_medium, torch.where(is_hom, h_logp, w_logp), 0.0)
    scattered = in_medium & torch.where(is_hom, hs, ws)
    m_t = torch.where(is_hom, ht, wt)
    m_weight = _w3(in_medium, _w3(is_hom, hw, ww), 1.0)
    throughput = s.throughput * m_weight
    m_p = s.o + m_t.unsqueeze(-1) * s.d
    reached = s.active & ~scattered            # surface and escaped lanes

    # ---------- escaped lanes: environment ----------
    escaped = reached & ~hit.valid
    env = emitter_m.env_radiance(scene, s.d)
    env_pdf = emitter_m.pdf_direct_env(scene, s.d)
    w_env = torch.where(s.last_delta, 1.0,
                        0.0 if simple else mis_weight_power(s.last_pdf,
                                                            env_pdf))
    sink = common.add_contribution(s.sink, throughput * env
                                   * w_env.unsqueeze(-1), escaped, log_p)

    # ---------- surface tables ----------
    b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
    on_surface = reached & hit.valid
    is_null = _is_null_surface(scene, b_idx)

    # ---------- emitter hit ----------
    hit_emitter = on_surface & (e_idx >= 0)
    le = emitter_m.eval_hit(scene, e_idx, hit.ng, -s.d)
    lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, s.o, hit.p, hit.ng)
    w_hit = torch.where(s.last_delta, 1.0,
                        0.0 if simple else mis_weight_power(s.last_pdf,
                                                            lum_pdf))
    shown = ~(s.depth == 1) if cfg.hide_emitters else True
    sink = common.add_contribution(sink, throughput * le
                                   * w_hit.unsqueeze(-1), hit_emitter & shown,
                                   log_p)

    depth_ok = s.depth < cfg.max_depth

    # =========== NEE (shared by medium and surface vertices) ===========
    vtx_p = _w3(scattered, m_p, hit.p)
    nee_active = (scattered | (on_surface & ~is_null)) & depth_ok
    u2e, smp = rng.next_2d(smp)
    u1e, smp = rng.next_1d(smp)
    ds = emitter_m.sample_direct(scene, vtx_p, u2e, u1e)
    frame = Frame.from_normal(hit.ng)
    wi_srf = frame.to_local(-s.d)
    f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, frame.to_local(ds.d))
    pdf_srf = bsdf_m.pdf(scene.bsdfs, b_idx, wi_srf, frame.to_local(ds.d))
    pdf_med = phase_m.eval(media.phase, s.medium, s.d, ds.d)
    f_vtx = _w3(scattered, pdf_med.unsqueeze(-1), f_srf)
    pdf_vtx = torch.where(scattered, pdf_med, pdf_srf)
    # medium vertices stay in their medium; surface shadow rays start in
    # the medium on the light's side of the interface
    srf_med = torch.where(dot(ds.d, hit.ng) < 0, m_in, m_ex)
    nee_med = torch.where(scattered, s.medium, srf_med)
    vis_needed = (nee_active & (ds.pdf > 0) & torch.any(f_vtx > 0, dim=-1)
                  & torch.any(ds.value > 0, dim=-1))

    # every shadow segment of the bounce in one visibility call: emitter
    # NEE and, with a beam, the beam-NEE connection
    seg_o, seg_d = [vtx_p + ds.d * eps], [ds.d]
    seg_dist, seg_med, seg_act = [ds.dist - 2 * eps], [nee_med], [vis_needed]
    if cfg.has_beam:
        u_b, smp = rng.next_1d(smp)
        y_b, s_b, pdf_sb, dist_b, d_yp = sample_beam_point(beam, vtx_p, u_b)
        bmed = beam.medium.expand(n)
        seg_o.append(y_b + d_yp * eps)
        seg_d.append(d_yp)
        seg_dist.append(dist_b - 2 * eps)
        seg_med.append(bmed)
        seg_act.append(nee_active)
    vis_smp = visibility_sampler(smp, len(seg_o), s.iters)
    tr_all, _ = attenuated_visibility(
        scene, eps, torch.cat(seg_o), torch.cat(seg_d), torch.cat(seg_dist),
        torch.cat(seg_med), vis_smp, torch.cat(seg_act), bricks=bricks,
        differentiable=differentiable)

    w_nee = torch.where(ds.delta, 1.0, mis_weight_power(ds.pdf, pdf_vtx))
    if simple:
        w_nee = torch.ones_like(w_nee)
    contrib = (throughput * f_vtx * ds.value * tr_all[:n]
               * (w_nee / torch.clamp_min(ds.pdf, 1e-12)).unsqueeze(-1))
    sink = common.add_contribution(sink, contrib, vis_needed, log_p)

    # =========== beam NEE ===========
    if cfg.has_beam:
        tr_beam = beam_transmittance(beam, tabs.beam_tau, s_b)
        kind_b, _, ss_b, scale_b = medium_m.params(media, bmed)
        dens_b = torch.where(kind_b == MED_HETEROGENEOUS,
                             bricks.lookup(y_b) * scale_b, 1.0)
        rho_y = phase_m.eval(media.phase, bmed, beam.d.expand(n, 3), d_yp)
        bval = (beam.power * tr_beam * (ss_b * dens_b.unsqueeze(-1))
                * tr_all[n:] * (rho_y / torch.clamp_min(
                    pdf_sb * dist_b * dist_b, 1e-12)).unsqueeze(-1))
        # light reaches the vertex along d_yp (y -> p); the direction from
        # the vertex toward the beam point is -d_yp
        f_srf_b = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf,
                              frame.to_local(-d_yp))
        f_med_b = phase_m.eval(media.phase, s.medium, s.d, -d_yp)
        f_b = _w3(scattered, f_med_b.unsqueeze(-1), f_srf_b)
        sink = common.add_contribution(sink, throughput * f_b * bval,
                                       nee_active, log_p)

    # =========== direction sampling ===========
    u2p, smp = rng.next_2d(smp)
    u1p, smp = rng.next_1d(smp)
    ps = phase_m.sample(media.phase, s.medium, s.d, u2p)
    bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u2p, u1p)
    new_d = _w3(scattered, ps.wo, frame.to_world(bs.wo))
    scatter_w = _w3(scattered, ps.weight.unsqueeze(-1), bs.weight)
    if differentiable:
        log_p = log_p + torch.where(
            scattered, torch.log(torch.clamp_min(ps.pdf, 1e-30)), 0.0)
    new_pdf = torch.where(scattered, ps.pdf, bs.pdf)
    new_delta = ~scattered & bs.delta
    # null surfaces: pass straight through, no weight, no depth
    null_hit = on_surface & is_null
    new_d = _w3(null_hit, s.d, new_d)
    scatter_w = _w3(null_hit, 1.0, scatter_w)
    new_delta = torch.where(null_hit, s.last_delta, new_delta)
    new_pdf = torch.where(null_hit, s.last_pdf, new_pdf)
    # medium transitions at any crossing surface (null or refractive)
    cos_new = dot(new_d, hit.ng)
    crossing = on_surface & (is_null | (cos_new * dot(-s.d, hit.ng) < 0))
    new_medium = torch.where(crossing,
                             torch.where(cos_new < 0, m_in, m_ex), s.medium)

    throughput2 = throughput * scatter_w
    active = ((scattered | on_surface) & depth_ok
              & ~torch.all(throughput2 <= 0, dim=-1))
    # roulette (not at null crossings: their transmittance stays cheap)
    eta_scale = s.eta_scale * torch.where(on_surface, bs.eta, 1.0)
    u_rr, smp = rng.next_1d(smp)
    tp_rr, survive = common.russian_roulette(throughput2, eta_scale, u_rr,
                                             s.depth, cfg)
    throughput2 = _w3(null_hit, throughput2, tp_rr)
    active = active & (survive | null_hit)
    inc_depth = (scattered | (on_surface & ~is_null)) & active
    # NaN firewall: retire lanes whose state went non-finite
    active = active & (torch.all(torch.isfinite(vtx_p), dim=-1)
                       & torch.all(torch.isfinite(new_d), dim=-1)
                       & torch.all(torch.isfinite(throughput2), dim=-1))
    throughput2 = torch.nan_to_num(throughput2, posinf=0.0, neginf=0.0)
    new_o = torch.nan_to_num(vtx_p, posinf=0.0, neginf=0.0) \
        + torch.nan_to_num(new_d) * eps
    return State(
        o=_w3(active, new_o, s.o), d=_w3(active, torch.nan_to_num(new_d), s.d),
        throughput=_w3(active, throughput2, s.throughput), sink=sink,
        active=active, depth=torch.where(inc_depth, s.depth + 1, s.depth),
        eta_scale=torch.where(active, eta_scale, s.eta_scale),
        last_pdf=torch.where(active, new_pdf, s.last_pdf),
        last_delta=torch.where(active, new_delta, s.last_delta),
        medium=torch.where(active, new_medium, s.medium),
        log_p=None if log_p is None else torch.where(active, log_p, s.log_p),
        iters=s.iters + 1, sampler=smp), wood_iters


def _checkpointed(step, s: State):
    """step(s) with its graph dropped after the forward and recomputed in
    the backward (non-reentrant checkpoint; the sampler is a stateless
    hash, so torch's RNG state need not be kept)."""
    return torch.utils.checkpoint.checkpoint(
        step, s, use_reentrant=False, preserve_rng_state=False)


def li(scene: Scene, cfg: RenderConfig, o, d, sampler: rng.Sampler,
       simple: bool = False, differentiable: bool = False):
    """Radiance along the (N, 3) camera rays (o, d): the bounce loop of the
    JAX `li` on the host. `simple` is volpath_simple (no MIS: emitters seen
    by a non-delta bounce count 0, NEE counts in full). `differentiable`
    is the JAX `li(differentiable=True)`: the sink carries gradients to the
    scene's medium parameters, each bounce under a checkpoint. Returns the
    (N, 3) sink, the sampler after the last bounce and [bounces, Woodcock
    tracking iterations]."""
    check_supported(scene, cfg)
    n = o.shape[0]
    dev = o.device
    tabs = pass_tables(scene, cfg)
    s = State(
        o=o, d=d, throughput=torch.ones((n, 3), device=dev),
        sink=common.new_sink(n, dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.ones((n,), dtype=torch.int32, device=dev),
        eta_scale=torch.ones((n,), device=dev),
        last_pdf=torch.zeros((n,), device=dev),
        last_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        medium=scene.camera_medium.to(torch.int64).expand(n),
        log_p=torch.zeros((n,), device=dev) if differentiable else None,
        iters=0, sampler=sampler)
    step = functools.partial(body, scene, cfg, tabs=tabs, simple=simple,
                             differentiable=differentiable)
    wood = 0
    while s.iters < 2 * cfg.max_depth + 8 and bool(s.active.any()):
        s, k = _checkpointed(step, s) if differentiable else step(s)
        wood += k
    return s.sink, s.sampler, [s.iters, wood]
