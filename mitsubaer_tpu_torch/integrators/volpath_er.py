"""Refractive radiative transfer: volumetric path tracing with curved rays
through a refractive-index field (port of
mitsubaer_tpu/integrators/volpath_er.py).

Camera paths travel straight outside the refractive body, refract into it
through an h-dielectric boundary (Fresnel by the RIF at the hit point),
march curved rays inside (kernel D) with the medium's homogeneous
coefficients, connect scatter vertices to the emitters by solving the
curved boundary value problem (kernel E inside the Levenberg solve), and
refract or reflect out. Radiance is compressed by (n_end / n_start)^2 along
each curved segment, and failed connections are russian-rouletted, as in
the reference (edge.cpp:91-92, heterogeneousrefractive.cpp:1146-1155).

`li` runs the bounce loop on the host, one `body` a bounce, until no lane
is active: the JAX `li`'s while loop, with `iters` counted as it counts
them (the BVP restart seed hashes it). `li(differentiable=True)` is the JAX
`li`'s differentiable mode: the curved marches and the final integration of
each BVP solve stay attached to the RIF (its parameter tensor or spline
coefficients) and to the medium's sigma_a, sigma_s and phase, so the sink
carries their gradients; each bounce runs under a checkpoint, as JAX's
checkpointed scan.

`cfg.medium_strategies` samples the refractive medium's straight distance
with its homogeneous strategy and re-weights it at the curved arc length
with that strategy's pdfs. `cfg.er_f64` runs the eikonal core (the march,
the boundary refinement and the BVP solve) in float64 through the plain
loops, and casts its results back to the float32 path state once an event,
where the JAX package does. The light image (`render_er_light_image`,
`trace_er_particles`) traces light particles from any emitter kind
through the medium and joins every scatter vertex to the camera by
the sensor-side BVP. Each lane carries its optical path length and depth
into the sink (common.Sink), for transient, bounce and CW-ToF films.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, fields, replace

import torch
import torch.utils.checkpoint

from ..core import rng
from ..core.math import (Frame, dot, fresnel_dielectric, mis_weight_power,
                         normalize)
from ..core.rng import M32, mul32
from ..models import bsdf as bsdf_m
from ..models import eikonal as ek
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import EM_CONSTANT, MED_REFRACTIVE, RenderConfig, Scene
from . import common, ptracer


@dataclass(frozen=True)
class State:
    o: torch.Tensor
    v: torch.Tensor            # scaled velocity: |v| = n(p) inside, 1 outside
    inside: torch.Tensor       # (N,) bool: inside the refractive medium
    throughput: torch.Tensor
    sink: common.Sink
    active: torch.Tensor
    depth: torch.Tensor
    plen: torch.Tensor         # optical path length
    last_pdf: torch.Tensor
    last_delta: torch.Tensor
    from_medium: torch.Tensor  # (N,) bool: the last non-delta event was a
    #   medium scatter; its transport to area emitters belongs to curved NEE
    iters: int
    sampler: rng.Sampler


def _refractive_params(scene: Scene):
    """(any, sigma_a, sigma_s, sampling_weight, index) of the (single)
    refractive medium."""
    media = scene.media
    is_ref = media.kind == MED_REFRACTIVE
    idx = torch.argmax(is_ref.to(torch.int32))
    return (is_ref.any(), media.sigma_a[idx], media.sigma_s[idx],
            media.sampling_weight[idx], idx)


def new_state(cfg: RenderConfig, o, d, sampler, pixel=None) -> State:
    n = o.shape[0]
    dev = o.device
    falses = torch.zeros((n,), dtype=torch.bool, device=dev)
    return State(
        o=o, v=d, inside=falses, throughput=torch.ones_like(o),
        sink=common.new_sink(cfg, n, pixel, dev), active=~falses,
        depth=torch.ones((n,), dtype=torch.int32, device=dev),
        plen=torch.zeros((n,), device=dev), last_pdf=torch.zeros((n,),
                                                                 device=dev),
        last_delta=~falses, from_medium=falses, iters=0, sampler=sampler)


def max_iters(cfg: RenderConfig) -> int:
    return 2 * cfg.max_depth + 8


def _strategy(scene: Scene, cfg: RenderConfig, med_idx, n: int):
    """(strategy, manual density) of the refractive medium on n lanes
    where cfg.medium_strategies, else (None, None): the balance
    strategy."""
    if not cfg.medium_strategies:
        return None, None
    return medium_m.params_strategy(scene.media, med_idx.expand(n))


def _to_f32(bvp: ek.BVPResult) -> ek.BVPResult:
    """The BVP result's floating fields as float32 (after an er_f64
    solve)."""
    return replace(bvp, **{f.name: getattr(bvp, f.name).to(torch.float32)
                           for f in fields(bvp)
                           if getattr(bvp, f.name).is_floating_point()})


# sampler dimensions a bounce draws, on every lane
DRAWS_PER_BOUNCE = 16


def body(scene: Scene, cfg: RenderConfig, s: State, rif: ek.RifField,
         sdf: ek.SdfField, differentiable: bool = False,
         solves: dict | None = None) -> State:
    """One bounce of every lane (volpath_er.py:131-452). `solves` keeps the
    differentiable BVP solve's connections by bounce (solve_bvp's memo)."""
    n = s.o.shape[0]
    dev = s.o.device
    eps = common.scene_epsilon(scene)
    media = scene.media
    has_ref, sigma_a, sigma_s, samp_w, med_idx = _refractive_params(scene)
    sigma_t = sigma_a + sigma_s
    h = cfg.er_stepsize
    smp = s.sampler
    ones = torch.ones((n,), device=dev)
    med_lanes = med_idx.expand(n)

    # ================= outside lanes: straight transport =================
    d_out = normalize(s.v)
    out_act = s.active & ~s.inside
    hit = isect.intersect(scene.geo, s.o, d_out, eps.expand(n),
                          torch.full((n,), isect.INF, device=dev))
    escaped = out_act & ~hit.valid
    env = emitter_m.env_radiance(scene, d_out)
    env_pdf = emitter_m.pdf_direct_env(scene, d_out)
    w_env = torch.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf,
                                                            env_pdf))
    sink = common.add_contribution(
        s.sink, cfg, s.throughput * env * w_env.unsqueeze(-1), s.plen,
        s.depth, escaped)

    sh = scene.shapes
    sid = torch.clamp(hit.shape_id, 0, sh.bsdf.shape[0] - 1)
    ok_s = hit.shape_id >= 0
    b_idx = torch.where(ok_s, sh.bsdf[sid], -1)
    e_idx = torch.where(ok_s, sh.emitter[sid], -1)
    m_in = torch.where(ok_s, sh.interior[sid], -1)
    is_ref_boundary = ok_s & (m_in == med_idx) & has_ref

    hide = cfg.hide_emitters & (s.depth == 1)
    # medium-scatter -> area-emitter transport is owned by curved NEE
    hit_emitter = out_act & hit.valid & (e_idx >= 0) & ~s.from_medium
    le = emitter_m.eval_hit(scene, e_idx, hit.ng, -d_out)
    lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, s.o, hit.p, hit.ng)
    w_hit = torch.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf,
                                                            lum_pdf))
    plen_srf = s.plen + torch.where(hit.valid, hit.t, 0.0)
    sink = common.add_contribution(
        sink, cfg, s.throughput * le * w_hit.unsqueeze(-1), plen_srf,
        s.depth, hit_emitter & ~hide)

    depth_ok = s.depth < cfg.max_depth

    # --- ordinary surfaces: NEE and BSDF sampling ---
    srf = out_act & hit.valid & ~is_ref_boundary & depth_ok & (b_idx >= 0)
    frame = Frame.from_normal(hit.ng)
    wi_l = frame.to_local(-d_out)
    u2e, smp = rng.next_2d(smp)
    u1e, smp = rng.next_1d(smp)
    ds = emitter_m.sample_direct(scene, hit.p, u2e, u1e)
    wo_nee = frame.to_local(ds.d)
    act = cfg.bsdf_kinds or None
    f_nee = bsdf_m.eval(scene.bsdfs, b_idx, wi_l, wo_nee, active=act)
    pdf_dir = bsdf_m.pdf(scene.bsdfs, b_idx, wi_l, wo_nee, active=act)
    vis = (srf & (ds.pdf > 0) & torch.any(f_nee > 0, dim=-1)
           & torch.any(ds.value > 0, dim=-1))
    blocked = isect.occluded(scene.geo, hit.p + ds.d * eps, ds.d,
                             (eps * 0.1).expand(n), ds.dist - 2 * eps)
    w_nee = torch.where(ds.delta, 1.0, mis_weight_power(ds.pdf, pdf_dir))
    sink = common.add_contribution(
        sink, cfg, s.throughput * f_nee * ds.value
        * (w_nee / torch.clamp_min(ds.pdf, 1e-12)).unsqueeze(-1),
        plen_srf + ds.dist, s.depth + 1, vis & ~blocked)
    u2b, smp = rng.next_2d(smp)
    u1b, smp = rng.next_1d(smp)
    bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_l, u2b, u1b, active=act)
    wo_srf = frame.to_world(bs.wo)

    # --- refractive boundary crossing (h-dielectric entry) ---
    entering = out_act & hit.valid & is_ref_boundary & depth_ok
    n_at = ek.rif_value(rif, hit.p)
    cos_i = dot(-d_out, hit.ng)  # > 0 when hitting the outside face
    F, _ = fresnel_dielectric(cos_i, n_at)
    u_f, smp = rng.next_1d(smp)
    do_reflect = u_f < F
    v_refl = d_out - 2.0 * dot(d_out, hit.ng, True) * hit.ng
    N_in = torch.where((cos_i > 0).unsqueeze(-1), hit.ng, -hit.ng)
    v_refr, _ = ek.boundary_velocity(d_out, N_in, ones, n_at)

    # ================= inside lanes: curved transport =================
    in_act = s.active & s.inside
    u_d, smp = rng.next_1d(smp)
    uc_d, smp = rng.next_1d(smp)
    strat = _strategy(scene, cfg, med_idx, n)
    want_scatter, t_samp, _, _ = medium_m.sample_distance_homogeneous(
        sigma_a.expand(n, 3), sigma_s.expand(n, 3), samp_w.expand(n),
        torch.full((n,), 1e7, device=dev), u_d, uc_d, *strat)
    march_dist = torch.where(want_scatter, t_samp, 1e6)
    n_start = ek.rif_value(rif, s.o)
    # er_f64: the march, the refinement and the BVP in float64, cast back
    # to the float32 path state once an event (volpath_er.py:238-260)
    erf = torch.float64 if cfg.er_f64 else torch.float32
    p_m, v_m, opt_m, geo_m, exited_m, _ = ek.trace_curved(
        rif, sdf, s.o.to(erf), s.v.to(erf), march_dist.to(erf), h,
        cfg.er_maxsteps, in_act, differentiable=differentiable)
    scattered = in_act & want_scatter & ~exited_m
    exited = in_act & (exited_m | ~want_scatter)
    # boundary refinement for exiting lanes
    p_b, v_b, opt_b, adv_b = ek.refine_boundary(rif, sdf, p_m, v_m, h)
    ex = exited.unsqueeze(-1)
    p_m = torch.where(ex, p_b, p_m)
    v_m = torch.where(ex, v_b, v_m)
    opt_m = torch.where(exited, opt_m + opt_b, opt_m)
    geo_m = torch.where(exited, geo_m + adv_b, geo_m)
    p_m, v_m, opt_m, geo_m = (t.to(torch.float32)
                              for t in (p_m, v_m, opt_m, geo_m))

    n_end = ek.rif_value(rif, p_m)
    ref_ratio_sq = (n_end / torch.clamp_min(n_start, 1e-6)) ** 2
    tr_seg = torch.exp(-sigma_t * geo_m.unsqueeze(-1))
    # the strategy pdfs re-evaluated at the CURVED arc length
    pdf_succ, pdf_fail = medium_m.homog_strategy_pdfs(sigma_t.expand(n, 3),
                                                      geo_m, *strat)
    w_sc = sigma_s * tr_seg / torch.clamp_min(pdf_succ * samp_w,
                                              1e-12).unsqueeze(-1)
    w_ex = tr_seg / torch.clamp_min(samp_w * pdf_fail + (1.0 - samp_w),
                                    1e-12).unsqueeze(-1)
    seg_w = torch.where(scattered.unsqueeze(-1), w_sc,
                        torch.where(ex, w_ex, 1.0)) * torch.where(
        in_act.unsqueeze(-1), ref_ratio_sq.unsqueeze(-1), 1.0)
    throughput = s.throughput * seg_w
    plen_med = s.plen + torch.where(in_act, opt_m, 0.0)

    # --- curved NEE from scatter vertices (BVP) ---
    u2n, smp = rng.next_2d(smp)
    u1n, smp = rng.next_1d(smp)
    dsm = emitter_m.sample_direct(scene, p_m, u2n, u1n)
    nee_in = (scattered & depth_ok & (dsm.pdf > 0)
              & torch.any(dsm.value > 0, dim=-1)
              & (scene.emitters.kind[dsm.emitter] != EM_CONSTANT))
    chord = normalize(dsm.p - p_m)
    # the restart stream is decorrelated from the path sampler by hashing
    # (lane, sample index, seed, bounce)
    seed_bits = rng._hash_u32(
        (smp.lane + mul32(smp.index, 0x9E3779B9) + mul32(smp.seed, 0xC2B2AE35)
         + ((s.iters * 0x85EBCA6B) & M32)) & M32)
    bvp = ek.solve_bvp(
        rif, sdf, p_m.to(erf), dsm.p.to(erf), chord.to(erf),
        h * cfg.er_bvp_hscale,
        max(int(cfg.er_maxsteps / cfg.er_bvp_hscale), 16), nee_in,
        tol2=cfg.bvp_tol2, differentiable=differentiable,
        rr_weight=cfg.rr_weight, seed_bits=seed_bits,
        max_restarts=cfg.bvp_restarts,
        memo=None if solves is None else solves.setdefault(s.iters, {}))
    if cfg.er_f64:
        bvp = _to_f32(bvp)
    conn_w = torch.where(bvp.converged, bvp.weight, 0.0)
    d_in_m = normalize(v_m)
    ph_val = phase_m.eval(media.phase, med_lanes, d_in_m, bvp.dir_to_target)
    tr_conn = torch.exp(-sigma_t * bvp.geo_inside.unsqueeze(-1))
    # radiance compression along the connection: the light is outside (n=1)
    nee_ratio = (ek.rif_value(rif, p_m) / 1.0) ** 2
    # the emitter's straight 1/d^2 falloff becomes 1/geo_len^2
    d_straight = torch.clamp_min(dsm.dist, 1e-6)
    falloff_fix = (d_straight * d_straight) / torch.clamp_min(
        bvp.geo_total * bvp.geo_total, 1e-9)
    contrib = (throughput * ph_val.unsqueeze(-1) * dsm.value * tr_conn
               * (nee_ratio * falloff_fix * conn_w
                  / torch.clamp_min(dsm.pdf, 1e-12)).unsqueeze(-1))
    sink = common.add_contribution(sink, cfg, contrib,
                                   plen_med + bvp.opt_len, s.depth + 1,
                                   nee_in & bvp.converged)

    # --- phase sampling at scatter vertices ---
    u2p, smp = rng.next_2d(smp)
    ps = phase_m.sample(media.phase, med_lanes, d_in_m, u2p)
    v_scatter = ps.wo * n_end.unsqueeze(-1)

    # --- boundary exit: Fresnel / TIR through the h-dielectric ---
    N_out = normalize(ek.sdf_gradient(sdf, p_m))
    cos_exit = dot(normalize(v_m), N_out)
    F_exit, _ = fresnel_dielectric(-cos_exit, n_end)
    u_fx, smp = rng.next_1d(smp)
    v_exit_refr, tir_x = ek.boundary_velocity(v_m, N_out, n_end, ones)
    exit_reflect = (u_fx < F_exit) | tir_x
    v_exit_refl = v_m - 2.0 * dot(v_m, N_out, True) * N_out

    # ================= merge state =================
    def sel(c, a, b):
        return torch.where(c.unsqueeze(-1) if a.dim() > c.dim() else c, a, b)

    # outside, ordinary surface bounce
    cont_srf = srf & torch.any(bs.weight > 0, dim=-1)
    new_o = sel(cont_srf, hit.p + wo_srf * eps, s.o)
    new_v = sel(cont_srf, wo_srf, s.v)
    new_delta = sel(cont_srf, bs.delta, s.last_delta)
    new_pdf = sel(cont_srf, bs.pdf, s.last_pdf)
    throughput = sel(cont_srf, throughput * bs.weight, throughput)
    # outside, boundary: reflect off it
    refl_b = entering & do_reflect
    new_o = sel(refl_b, hit.p + v_refl * eps, new_o)
    new_v = sel(refl_b, v_refl, new_v)
    new_delta = new_delta | refl_b
    # outside, boundary: enter the medium (scaled velocity, marches next)
    enter_b = entering & ~do_reflect
    new_o = sel(enter_b, hit.p - hit.ng * (eps * 0.5)
                + normalize(v_refr) * eps, new_o)
    new_v = sel(enter_b, v_refr, new_v)
    new_inside = s.inside | enter_b
    new_delta = new_delta | enter_b
    # inside: scattered, continue curved
    new_o = sel(scattered, p_m, new_o)
    new_v = sel(scattered, v_scatter, new_v)
    new_delta = new_delta & ~scattered
    new_pdf = sel(scattered, ps.pdf, new_pdf)
    # inside: reflect at or leave through the boundary
    stay = exited & exit_reflect
    leave = exited & ~exit_reflect
    new_o = sel(stay, p_m - N_out * (2.0 * eps), new_o)
    new_v = sel(stay, v_exit_refl, new_v)
    new_delta = new_delta | stay
    d_leave = normalize(v_exit_refr)
    new_o = sel(leave, p_m + N_out * eps + d_leave * eps, new_o)
    new_v = sel(leave, d_leave, new_v)
    new_inside = new_inside & ~leave
    new_delta = new_delta | leave

    plen_new = torch.where(in_act, plen_med,
                           torch.where(out_act, plen_srf, s.plen))
    moved = cont_srf | refl_b | enter_b | scattered | stay | leave
    active = s.active & moved & depth_ok
    active = active & ~torch.all(throughput <= 0, dim=-1)
    u_rr, smp = rng.next_1d(smp)
    throughput, survive = common.russian_roulette(throughput, ones, u_rr,
                                                  s.depth, cfg)
    active = active & survive
    inc = (cont_srf | scattered | enter_b | leave) & active
    # NaN firewall: retire lanes whose state went non-finite and scrub the
    # stored values
    finite = (torch.all(torch.isfinite(new_o), dim=-1)
              & torch.all(torch.isfinite(new_v), dim=-1)
              & torch.all(torch.isfinite(throughput), dim=-1))
    active = active & finite
    new_o = torch.nan_to_num(new_o, nan=0.0, posinf=0.0, neginf=0.0)
    new_v = torch.nan_to_num(new_v, nan=1.0, posinf=1.0, neginf=-1.0)
    throughput = torch.nan_to_num(throughput, nan=0.0, posinf=0.0, neginf=0.0)
    new_from_medium = torch.where(scattered, True,
                                  torch.where(cont_srf, False, s.from_medium))
    return State(
        o=sel(active, new_o, s.o), v=sel(active, new_v, s.v),
        inside=sel(active, new_inside, s.inside),
        throughput=sel(active, throughput, s.throughput),
        sink=sink, active=active,
        depth=torch.where(inc, s.depth + 1, s.depth),
        plen=sel(active, plen_new, s.plen),
        last_pdf=sel(active, new_pdf, s.last_pdf),
        last_delta=sel(active, new_delta, s.last_delta),
        from_medium=sel(active, new_from_medium, s.from_medium),
        iters=s.iters + 1, sampler=smp)


def _checkpointed(step, s: State) -> State:
    """step(s) with its graph dropped after the forward and recomputed in
    the backward (non-reentrant checkpoint). The sampler is a stateless
    hash and `iters` rides in the state, so the recomputed bounce draws the
    same numbers and seeds the same BVP restarts."""
    return torch.utils.checkpoint.checkpoint(
        step, s, use_reentrant=False, preserve_rng_state=False)


# li(differentiable=True) keeps each bounce's solved BVP connections in a
# fresh dict, so that the backward's recomputed bounce reuses them. While
# this is a dict, every such call uses it instead: a call after the first at
# the same seed then holds the first call's connections (their directions,
# convergence and weights), as a finite difference at fixed connections
# needs. Not part of li's interface.
_held_solves: dict | None = None


def li(scene: Scene, cfg: RenderConfig, o, d, sampler: rng.Sampler,
       pixel=None, differentiable: bool = False):
    """Radiance along the (N, 3) camera rays (o, d) (volpath_er.py:82-127).
    `pixel` is each lane's pixel, which a film with frames needs.
    `differentiable`: each bounce under a
    checkpoint and the marches attached, so the sink carries gradients to
    the RIF and the medium's coefficients; the backward's recomputed
    bounce reuses the forward's solved BVP connections. JAX's
    differentiable loop is a scan of exactly max_iters(cfg) trips; a trip
    after the last lane stopped changes nothing but the sampler, so the
    loop stops there and advances the sampler by the draws of the trips
    not run. Returns the sink (common.Sink), the sampler and the bounces
    run."""
    rif = ek.rif_from_media(scene.media)
    sdf = ek.sdf_from_media(scene.media)
    solves = None
    if differentiable:
        solves = {} if _held_solves is None else _held_solves
    step = functools.partial(body, scene, cfg, rif=rif, sdf=sdf,
                             differentiable=differentiable, solves=solves)
    s = new_state(cfg, o, d, sampler, pixel)
    while s.iters < max_iters(cfg) and bool(s.active.any()):
        s = _checkpointed(step, s) if differentiable else step(s)
    smp = s.sampler
    if differentiable:
        smp = medium_m.skip_draws(
            smp, DRAWS_PER_BOUNCE * (max_iters(cfg) - s.iters))
    return s.sink, smp, s.iters


def render_er_pass(scene: Scene, cfg: RenderConfig, sppc: int, seed: int,
                   pass_idx: int):
    """One spp chunk through `li`; returns (the sink of its sppc * npix
    lanes, their (sppc * npix, 2) jitter, bounces run)."""
    rays, jitter, smp = common.camera_samples(scene, cfg, sppc, seed,
                                              pass_idx)
    sink, _, bounces = li(scene, cfg, rays.o, rays.d, smp,
                          pixel=common.lane_pixels(cfg, sppc,
                                                   rays.o.device))
    return sink, jitter, bounces


# ---------------------------------------------------------------------------
# the light image: sensor-side curved connections (makeSensorDirectConnections,
# heterogeneousrefractive.cpp:960-992; volpath_er.py:498-694)
# ---------------------------------------------------------------------------
def trace_er_particles(scene: Scene, cfg: RenderConfig, n_particles: int,
                       seed: int, pass_idx: int):
    """One wavefront of n_particles light particles through the refractive
    medium (volpath_er.py:523-676); returns the (H * W, 3) splat sum (the
    light image is it over the particles traced). A particle flies straight
    to the medium's boundary, refracts in (or reflects off and ends),
    marches curved (kernel D), and at every scatter vertex solves the BVP
    to the camera (kernel E in the Levenberg solve), whose arrival
    direction picks the pixel it splats; a particle that leaves the medium
    ends. JAX runs all 2 max_depth + 6 trips; a trip after the last
    particle ended splats nothing, so the loop stops there. The splat adds
    with index_add_, in a varying order on CUDA."""
    H, W = cfg.height, cfg.width
    n = n_particles
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    rif = ek.rif_from_media(scene.media)
    sdf = ek.sdf_from_media(scene.media)
    _, sigma_a, sigma_s, samp_w, med_idx = _refractive_params(scene)
    sigma_t = sigma_a + sigma_s
    h = cfg.er_stepsize
    media = scene.media
    med_lanes = med_idx.expand(n)
    cam_p = scene.sensor.to_world[:3, 3].expand(n, 3)
    ones = torch.ones((n,), device=dev)
    strat = _strategy(scene, cfg, med_idx, n)

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed ^ 0xE51, lane, pass_idx)
    o, v, tp, _, smp, _, _ = ptracer.sample_emitter_ray(scene, smp)
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    inside = torch.zeros((n,), dtype=torch.bool, device=dev)
    active = torch.any(tp > 0, dim=-1)
    # the BVP's restart stream: the same on every trip, as in JAX
    seed_bits = rng._hash_u32((lane + mul32(smp.index, 0x9E3779B9)) & M32)
    for _ in range(2 * cfg.max_depth + 6):
        if not bool(active.any()):
            break
        # ---- outside: straight flight to the refractive boundary ----
        d_out = normalize(v)
        hit = isect.intersect(scene.geo, o, d_out, eps.expand(n),
                              torch.full((n,), isect.INF, device=dev))
        sh = scene.shapes
        sid = torch.clamp(hit.shape_id, 0, sh.bsdf.shape[0] - 1)
        ok_s = hit.shape_id >= 0
        m_in = torch.where(ok_s, sh.interior[sid], -1)
        out_act = active & ~inside
        entering = out_act & hit.valid & ok_s & (m_in == med_idx)
        dead_out = out_act & ~entering
        n_at = ek.rif_value(rif, hit.p)
        cos_i = dot(-d_out, hit.ng)
        F, _ = fresnel_dielectric(cos_i, n_at)
        u_f, smp = rng.next_1d(smp)
        refl = u_f < F
        N_in = torch.where((cos_i > 0).unsqueeze(-1), hit.ng, -hit.ng)
        v_refr, _ = ek.boundary_velocity(d_out, N_in, ones, n_at)

        # ---- inside: curved free flight ----
        in_act = active & inside
        u_d, smp = rng.next_1d(smp)
        uc_d, smp = rng.next_1d(smp)
        hs, t_samp, _, _ = medium_m.sample_distance_homogeneous(
            sigma_a.expand(n, 3), sigma_s.expand(n, 3), samp_w.expand(n),
            torch.full((n,), 1e7, device=dev), u_d, uc_d, *strat)
        march = torch.where(hs, t_samp, 1e6)
        p_m, v_m, _, geo_m, exited_m, _ = ek.trace_curved(
            rif, sdf, o, v, march, h, cfg.er_maxsteps, in_act)
        scattered = in_act & hs & ~exited_m
        exited = in_act & (exited_m | ~hs)
        p_b, v_b, _, adv_b = ek.refine_boundary(rif, sdf, p_m, v_m, h)
        ex = exited.unsqueeze(-1)
        p_m = torch.where(ex, p_b, p_m)
        v_m = torch.where(ex, v_b, v_m)
        geo_m = torch.where(exited, geo_m + adv_b, geo_m)
        tr_seg = torch.exp(-sigma_t * geo_m.unsqueeze(-1))
        pdf_succ, pdf_fail = medium_m.homog_strategy_pdfs(
            sigma_t.expand(n, 3), geo_m, *strat)
        w_sc = sigma_s * tr_seg / torch.clamp_min(pdf_succ * samp_w,
                                                  1e-12).unsqueeze(-1)
        w_ex = tr_seg / torch.clamp_min(samp_w * pdf_fail + (1.0 - samp_w),
                                        1e-12).unsqueeze(-1)
        tp_in = tp * torch.where(scattered.unsqueeze(-1), w_sc,
                                 torch.where(ex, w_ex, 1.0))

        # ---- sensor-side curved connection from scatter vertices ----
        chord = normalize(cam_p - p_m)
        bvp = ek.solve_bvp(
            rif, sdf, p_m, cam_p, chord, h * cfg.er_bvp_hscale,
            max(int(cfg.er_maxsteps / cfg.er_bvp_hscale), 16), scattered,
            tol2=cfg.bvp_tol2, rr_weight=cfg.rr_weight, seed_bits=seed_bits,
            max_restarts=cfg.bvp_restarts)
        d_in_m = normalize(v_m)
        ph_val = phase_m.eval(media.phase, med_lanes, d_in_m,
                              bvp.dir_to_target)
        tr_conn = torch.exp(-sigma_t * bvp.geo_inside.unsqueeze(-1))
        # radiance compression from the medium out to n = 1
        ref_ratio = (1.0 / torch.clamp_min(ek.rif_value(rif, p_m),
                                           1e-6)) ** 2
        # the pixel that looks back along the connection's last segment
        fs = sensor_m.project(scene.sensor, cam_p + bvp.rev_dir, W, H)
        ok_c = scattered & bvp.converged & fs.valid
        val = tp_in * ph_val.unsqueeze(-1) * tr_conn * (
            ref_ratio * bvp.weight * fs.inv_pixel_omega
            / torch.clamp_min(bvp.geo_total ** 2, 1e-9)).unsqueeze(-1)
        ok_c = ok_c & torch.all(torch.isfinite(val), dim=-1)
        val = torch.where(ok_c.unsqueeze(-1), val, 0.0)
        px = torch.clamp(torch.nan_to_num(fs.px).to(torch.int64), 0, W - 1)
        py = torch.clamp(torch.nan_to_num(fs.py).to(torch.int64), 0, H - 1)
        film.index_add_(0, py * W + px, val)

        # ---- phase sampling to go on inside ----
        u2p, smp = rng.next_2d(smp)
        ps = phase_m.sample(media.phase, med_lanes, d_in_m, u2p)
        v_scat = ps.wo * ek.rif_value(rif, p_m).unsqueeze(-1)

        # ---- merge: enter, scatter; reflected and leaving particles end
        enter = (entering & ~refl).unsqueeze(-1)
        new_o = torch.where(enter, hit.p - hit.ng * (eps * 0.5)
                            + normalize(v_refr) * eps, o)
        new_v = torch.where(enter, v_refr, v)
        inside = inside | (entering & ~refl)
        sc = scattered.unsqueeze(-1)
        new_o = torch.where(sc, p_m, new_o)
        new_v = torch.where(sc, v_scat, new_v)
        tp = torch.where(in_act.unsqueeze(-1), tp_in, tp)
        active = active & ~dead_out & ~exited & ~(entering & refl)
        active = active & (torch.all(torch.isfinite(new_o), dim=-1)
                           & torch.all(torch.isfinite(new_v), dim=-1)
                           & torch.all(torch.isfinite(tp), dim=-1))
        o = torch.nan_to_num(new_o)
        v = torch.nan_to_num(new_v, nan=1.0)
        tp = torch.nan_to_num(tp)
    return film


def render_er_light_image(scene: Scene, cfg: RenderConfig, seed: int = 0,
                          n_passes: int = 2, device=None):
    """The light image (the t = 1 family) through the refractive medium
    (volpath_er.py:679-694): n_passes wavefronts of H * W particles, their
    splats summed and divided by the particles traced; an (H, W, 3) image.
    Runs on the CUDA card unless device="cpu" is passed."""
    scene = scene.to(common.render_device(device))
    H, W = cfg.height, cfg.width
    film = torch.zeros((H * W, 3), dtype=torch.float32,
                       device=scene.aabb_min.device)
    for i in range(n_passes):
        film = film + trace_er_particles(scene, cfg, H * W, seed, i)
    return (film / float(n_passes * H * W)).reshape(H, W, 3)
