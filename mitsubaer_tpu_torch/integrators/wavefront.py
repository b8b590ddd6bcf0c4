"""Persistent-wavefront volumetric path tracer (port of
mitsubaer_tpu/integrators/wavefront.py: `make_engine` with the event pass,
`tracking_mega`, `cond` and `finalize`, and `render_wavefront`).

One lane per pixel runs sppc camera samples of a rotating pixel assignment
(sample j of lane i serves pixel (i + j * (104729 % npix)) mod npix, a
bijection per sample) through a loop of super-iterations:

  super-iteration = full event pass + wf_mini_passes x (transition pass +
                    tracking-to-completion)

The event pass does every per-bounce event of the lanes whose extension or
shadow tracking resolved (emitter and environment terms, NEE setup toward an
emitter or the collimated beam, phase/BSDF sampling, Russian roulette,
null-boundary crossings, intersection, analytic media, sample flush and
regeneration). The transition pass (`mini=True`) does only the
administrative events. Tracking runs every pending heterogeneous majorant
jump through kernel C (megatrack.run).

The host drives `while pending and it < max_super` with one `.item()`
sync per super-iteration, as the JAX `cond`. The JAX engine skips the
tracking call under a `lax.cond` when no lane has tracking work; here the
call is made anyway (with no work it changes nothing), so that the loop
needs no second sync.

Surfaces read every BSDF kind (only the lobes of cfg.bsdf_kinds run); as
in the JAX engine, textures and normal maps are not read on this road.

Every `rng.next_*` draw advances `dim` on every lane, so the draws are made
unconditionally and in the JAX order: a full pass draws u_nee2 (2), u_nee1,
u_fam, u_b (beam scenes only), u_dir2 (2), u_dir1, u_rr; after regeneration
(dim = 0 on the new samples) every pass draws u_jit (2), u_lens (2), u_hom,
uc_hom. `tap_seed` decorrelates the tracking streams across passes.

Left out (TPU-only variants, ROADMAP): tracking_full, tracking_ladder,
tracking_compact, tracking_dda / MacroMajorant, WF_ABLATE and the in-loop
epoch drain of wf_epoch_ring < sppc (the ring always has sppc slots, so no
barrier exists).

Row-block sharding (parallel/driver.py): with row0 and full_height the
engine renders rows [row0, row0 + height) of a full_height-row image; its
lanes key their samplers and camera rays by the global pixel id, and row0
enters the tracking seed mix, as in the JAX engine (wavefront.py:205, 554).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core import rng
from ..core.math import Frame, dot, mis_weight_power
from ..core.rng import M32
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import (MED_HETEROGENEOUS, MED_HOMOGENEOUS, RenderConfig,
                           Scene)
from . import common, megatrack
from .boxwalk import pass_seed
from .volpath import (_is_null_surface, _shape_tables, beam_transmittance,
                      build_beam_tau, get_beam, sample_beam_point)



@dataclass(frozen=True)
class WFState:
    # path / extension segment
    o: torch.Tensor             # (n, 3) current ray origin
    d: torch.Tensor             # (n, 3) current ray direction
    t_far: torch.Tensor         # (n,) segment end (surface hit or scene exit)
    hit_valid: torch.Tensor     # (n,) segment ends on a surface
    hit_shape: torch.Tensor     # (n,) int64
    hit_ng: torch.Tensor        # (n, 3)
    throughput: torch.Tensor    # (n, 3)
    medium: torch.Tensor        # (n,) int64 current medium (-1 vacuum)
    depth: torch.Tensor         # (n,) int64
    eta_scale: torch.Tensor     # (n,)
    last_pdf: torch.Tensor      # (n,)
    last_delta: torch.Tensor    # (n,) bool
    sample_idx: torch.Tensor    # (n,) int64 sample of this pass (-1 = none)
    path_alive: torch.Tensor    # (n,) bool
    ext_tracking: torch.Tensor  # (n,) bool heterogeneous tracking in flight
    ext_done: torch.Tensor      # (n,) bool outcome ready
    ext_scat: torch.Tensor      # (n,) bool outcome: medium scatter
    ext_t: torch.Tensor         # (n,) tracking position / sampled distance
    ext_w: torch.Tensor         # (n, 3) free-flight estimator weight
    # shadow ray (one slot; the NEE family is chosen per bounce)
    sh_active: torch.Tensor     # (n,) bool
    sh_need_isect: torch.Tensor  # (n,) bool
    sh_o: torch.Tensor          # (n, 3)
    sh_d: torch.Tensor          # (n, 3)
    sh_remaining: torch.Tensor  # (n,) distance to the light still to cover
    sh_seg: torch.Tensor        # (n,) current subsegment length
    sh_t: torch.Tensor          # (n,) tracking position in the subsegment
    sh_med: torch.Tensor        # (n,) int64
    sh_tr: torch.Tensor         # (n, 3) running transmittance
    sh_val: torch.Tensor        # (n, 3) contribution if unoccluded
    sh_hit_null: torch.Tensor   # (n,) subsegment ends at a null crossing
    sh_cross_p: torch.Tensor    # (n, 3) crossing point
    sh_cross_med: torch.Tensor  # (n,) int64 medium beyond the crossing
    # outputs / misc
    pix: torch.Tensor           # (n,) int64 pixel of the current sample
    sample_open: torch.Tensor   # (n,) bool a sample is in flight / unflushed
    L: torch.Tensor             # (n, 3) current-sample radiance
    pend: torch.Tensor          # (sppc, n, 3) flushed radiance by sample
    #   epoch, in lane order; finalize rolls each epoch to its pixels. The
    #   event passes add to it in place (the one large buffer).
    tap_ctr: torch.Tensor       # (n,) int64 uint32 tracking-RNG counter
    sampler: rng.Sampler        # event-pass sampler
    n_segments: torch.Tensor    # () int64 ray segments (extension + shadow)
    n_taps: torch.Tensor        # () int64 density taps
    it: int                     # super-iterations so far
    pending: torch.Tensor       # () bool any work left


def check_supported(scene: Scene, cfg: RenderConfig) -> None:
    """Raise for what the fast engines (wavefront and boxwalk) cannot
    render: a film with frames or a CW-ToF weight. They keep one steady
    (H W, 3) image, so render() takes them only for steady films; the JAX
    package's engine="wavefront" with frames or modulation gives a steady
    image (and fails to add a beam's frames to it), so the port raises."""
    if cfg.n_frames != 1 or cfg.modulation != "none":
        raise ValueError(
            f"engine='wavefront' renders a steady film only: "
            f"decomposition={cfg.decomposition!r} with {cfg.n_frames} "
            f"frames and modulation={cfg.modulation!r} need engine='loop' "
            f"or 'auto'")


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def pack_rows(scene: Scene, mega: megatrack.MegaTable, st: WFState):
    """(do_sh, need, rows): the (24, n) rows kernel C takes, packed from
    each lane's pending shadow tracking (which has priority) or extension
    tracking (wavefront.py:729-759)."""
    n = st.o.shape[0]
    do_sh = st.sh_active & ~st.sh_need_isect & (st.sh_t < st.sh_seg)
    need = do_sh | st.ext_tracking
    med = torch.where(do_sh, st.sh_med, st.medium)
    _, sa, ss, scale = medium_m.params(scene.media, med)
    st_color = sa + ss
    st_mean = medium_m._mean3(st_color)
    majorant = torch.clamp_min(
        scene.media.majorant * torch.amax(st_color, dim=-1), 1e-6)
    w_real = ss / torch.clamp_min(st_mean, 1e-12).unsqueeze(-1)
    t_cur = torch.where(do_sh, st.sh_t, st.ext_t)
    o_vox = (_w3(do_sh, st.sh_o, st.o) - mega.aabb_min) * mega.inv_h
    d_vox = _w3(do_sh, st.sh_d, st.d) * mega.inv_h
    t_lim = torch.where(do_sh, st.sh_seg, st.t_far)
    stc = st_color * scale.unsqueeze(-1)
    rows = torch.cat([
        o_vox.t(), d_vox.t(), t_cur[None], t_lim[None], majorant[None],
        (st_mean * scale)[None], stc.t(), w_real.t(),
        do_sh[None].to(torch.float32), need[None].to(torch.float32),
        torch.zeros((6, n), dtype=torch.float32, device=st.o.device)])
    return do_sh, need, rows.contiguous()


def make_engine(scene: Scene, cfg: RenderConfig, sppc: int, seed: int,
                pass_idx: int, n_lanes: int | None = None,
                has_direct: bool = True, any_het: bool = True,
                row0=None, full_height: int | None = None):
    """The engine pieces of one render pass: (state, event_pass,
    tracking_mega, cond, finalize), so that callers can step it.

    any_het switches tracking on: kernel C tracks every heterogeneous jump,
    so the JAX package's `wf_track_iters` is only an on/off flag there and
    is derived from any_het here. Beam NEE runs where `cfg.has_beam` is
    set, as in the JAX engine: `volumetric_box` sets it for its beam, the
    scene builder does not, so a builder-made beam scene renders without
    beam NEE in both packages."""
    row0 = int(row0 or 0)
    H, W = cfg.height, cfg.width
    H_full = full_height or H
    npix = H * W
    n = npix if n_lanes is None else n_lanes
    if n != npix:
        raise ValueError("make_engine: one lane per pixel")
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    media = scene.media
    has_beam = cfg.has_beam
    if has_beam:
        beam = get_beam(scene)
        beam_tau = build_beam_tau(
            scene, beam, medium_m.DensityGrid(media, dtype=torch.bfloat16))
    mega = megatrack.MegaTable(media) if any_het else None
    tap_seed = pass_seed(seed, pass_idx, row0)
    stride = 104729 % npix
    max_super = sppc * (6 * cfg.max_depth + 16) + 64
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    f0 = torch.zeros((n,), dtype=torch.float32, device=dev)
    f3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    b0 = torch.zeros((n,), dtype=torch.bool, device=dev)
    i0 = torch.zeros((n,), dtype=torch.int64, device=dev)
    d0 = f3.clone()
    d0[:, 2] = 1.0
    st = WFState(
        o=f3, d=d0, t_far=f0, hit_valid=b0, hit_shape=i0 - 1, hit_ng=f3,
        throughput=f3, medium=i0 - 1, depth=i0, eta_scale=f0 + 1.0,
        last_pdf=f0, last_delta=~b0, sample_idx=i0 - 1, path_alive=b0,
        ext_tracking=b0, ext_done=b0, ext_scat=b0, ext_t=f0, ext_w=f3 + 1.0,
        sh_active=b0, sh_need_isect=b0, sh_o=f3, sh_d=f3, sh_remaining=f0,
        sh_seg=f0, sh_t=f0, sh_med=i0 - 1, sh_tr=f3, sh_val=f3,
        sh_hit_null=b0, sh_cross_p=f3, sh_cross_med=i0 - 1,
        pix=i0, sample_open=b0, L=f3,
        pend=torch.zeros((sppc, n, 3), dtype=torch.float32, device=dev),
        tap_ctr=i0, sampler=rng.make_sampler(seed, lane, i0,
                                             mode=rng.mode_of(cfg.sampler),
                                             n_samples=cfg.spp),
        n_segments=torch.zeros((), dtype=torch.int64, device=dev),
        n_taps=torch.zeros((), dtype=torch.int64, device=dev),
        it=0, pending=torch.ones((), dtype=torch.bool, device=dev))

    def event_pass(st: WFState, mini: bool = False) -> WFState:
        """The full event pass, or (mini=True) the transition pass: shadow
        subsegment completion, null crossings, environment escapes, flush
        and regeneration, intersection and analytic media only. Lanes whose
        extension outcome is a scatter or a real surface bounce wait for
        the next full pass (wavefront.py:240-700)."""
        smp = st.sampler

        # ---------- stage 1: shadow subsegment completion ----------
        sh_done = st.sh_active & ~st.sh_need_isect & (st.sh_t >= st.sh_seg)
        tr_dead = torch.amax(st.sh_tr, dim=-1) <= 0.0
        complete = sh_done & ~st.sh_hit_null
        L = st.L + _w3(complete, st.sh_val * st.sh_tr, 0.0)
        crossing = sh_done & st.sh_hit_null & ~tr_dead
        sh_o = _w3(crossing, st.sh_cross_p + st.sh_d * eps, st.sh_o)
        sh_remaining = torch.where(crossing, st.sh_remaining - st.sh_seg - eps,
                                   st.sh_remaining)
        sh_med = torch.where(crossing, st.sh_cross_med, st.sh_med)
        still = crossing & (sh_remaining > eps)
        sh_need_isect = st.sh_need_isect | still
        sh_active = torch.where(sh_done, still, st.sh_active)
        sh_active = sh_active & ~(st.sh_active & tr_dead)

        # ---------- stage 2: extension outcome processing ----------
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, st.hit_shape)
        is_null = _is_null_surface(scene, b_idx)
        proc = st.ext_done & ~sh_active & ~sh_need_isect & st.path_alive
        if mini:
            proc = proc & ~st.ext_scat & (~st.hit_valid
                                          | (is_null & (e_idx < 0)))
        m_p = st.o + st.ext_t.unsqueeze(-1) * st.d
        tp = st.throughput * _w3(proc, st.ext_w, 1.0)
        scattered = proc & st.ext_scat
        escaped = proc & ~st.ext_scat & ~st.hit_valid
        on_surface = proc & ~st.ext_scat & st.hit_valid
        hit_p = st.o + st.t_far.unsqueeze(-1) * st.d

        env = emitter_m.env_radiance(scene, st.d)
        env_pdf = emitter_m.pdf_direct_env(scene, st.d)
        w_env = torch.where(st.last_delta, 1.0,
                            mis_weight_power(st.last_pdf, env_pdf))
        L = L + _w3(escaped, tp * env * w_env.unsqueeze(-1), 0.0)

        if not mini:
            hit_em = on_surface & (e_idx >= 0)
            le = emitter_m.eval_hit(scene, e_idx, st.hit_ng, -st.d)
            lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, st.o, hit_p,
                                               st.hit_ng)
            w_hit = torch.where(st.last_delta, 1.0,
                                mis_weight_power(st.last_pdf, lum_pdf))
            hide = (st.depth == 1) & cfg.hide_emitters
            L = L + _w3(hit_em & ~hide, tp * le * w_hit.unsqueeze(-1), 0.0)

        depth_ok = st.depth < cfg.max_depth
        vtx = _w3(scattered, m_p, hit_p)
        nee_ok = (scattered | (on_surface & ~is_null)) & depth_ok

        if not mini:
            frame = Frame.from_normal(st.hit_ng)
            wi_srf = frame.to_local(-st.d)
            u_nee2, smp = rng.next_2d(smp)
            u_nee1, smp = rng.next_1d(smp)
            u_fam, smp = rng.next_1d(smp)

        new_sh_active = b0
        new_sh_d, new_sh_o = st.sh_d, st.sh_o
        new_sh_rem, new_sh_med, new_sh_val = (st.sh_remaining, st.sh_med,
                                              st.sh_val)
        if mini:
            use_beam, fam_w = b0, 1.0
        elif has_direct and has_beam:
            use_beam, fam_w = u_fam < 0.5, 2.0
        elif has_beam:
            use_beam, fam_w = ~b0, 1.0
        else:
            use_beam, fam_w = b0, 1.0

        if has_direct and not mini:
            ds = emitter_m.sample_direct(scene, vtx, u_nee2, u_nee1)
            wo_srf = frame.to_local(ds.d)
            f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, wo_srf,
                                active=act)
            pdf_srf = bsdf_m.pdf(scene.bsdfs, b_idx, wi_srf, wo_srf,
                                 active=act)
            ax_ov = (medium_m.orientation_axis(media, st.medium, m_p)
                     if cfg.phase_orient else None)
            f_med = phase_m.eval(media.phase, st.medium, st.d, ds.d,
                                 active=pact, axis_override=ax_ov
                                 ).unsqueeze(-1)
            f_vtx = _w3(scattered, f_med, f_srf)
            pdf_vtx = torch.where(scattered, f_med[..., 0], pdf_srf)
            w_nee = torch.where(ds.delta, 1.0,
                                mis_weight_power(ds.pdf, pdf_vtx))
            val = (tp * f_vtx * ds.value
                   * (fam_w * w_nee
                      / torch.clamp_min(ds.pdf, 1e-12)).unsqueeze(-1))
            ok = (nee_ok & ~use_beam & (ds.pdf > 0)
                  & torch.any(f_vtx > 0, dim=-1)
                  & torch.any(ds.value > 0, dim=-1))
            srf_entering = dot(ds.d, st.hit_ng) < 0
            nee_med = torch.where(scattered, st.medium,
                                  torch.where(srf_entering, m_in, m_ex))
            new_sh_active = new_sh_active | ok
            new_sh_d = _w3(ok, ds.d, new_sh_d)
            new_sh_o = _w3(ok, vtx + ds.d * eps, new_sh_o)
            new_sh_rem = torch.where(ok, ds.dist - 2 * eps, new_sh_rem)
            new_sh_med = torch.where(ok, nee_med, new_sh_med)
            new_sh_val = _w3(ok, val, new_sh_val)

        if has_beam and not mini:
            u_b, smp = rng.next_1d(smp)
            y_b, s_b, pdf_sb, dist_b, d_yp = sample_beam_point(beam, vtx, u_b)
            bmed = beam.medium.expand(n)
            kind_b, _, ss_b, _ = medium_m.params(scene.media, bmed)
            tr_beam, dens_tab = beam_transmittance(beam, beam_tau, s_b,
                                                   with_density=True)
            dens_b = torch.where(kind_b == MED_HETEROGENEOUS, dens_tab, 1.0)
            sigma_s_y = ss_b * dens_b.unsqueeze(-1)
            rho_y = phase_m.eval(media.phase, bmed, beam.d.expand(n, 3), d_yp)
            bval = (beam.power * tr_beam * sigma_s_y
                    * (rho_y / torch.clamp_min(pdf_sb * dist_b * dist_b,
                                               1e-12)).unsqueeze(-1))
            f_srf_b = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf,
                                  frame.to_local(-d_yp), active=act)
            f_med_b = phase_m.eval(media.phase, st.medium, st.d, -d_yp,
                                   active=pact).unsqueeze(-1)
            val_b = tp * _w3(scattered, f_med_b, f_srf_b) * bval * fam_w
            ok_b = nee_ok & use_beam & torch.any(val_b > 0, dim=-1)
            new_sh_active = new_sh_active | ok_b
            new_sh_d = _w3(ok_b, d_yp, new_sh_d)
            new_sh_o = _w3(ok_b, y_b + d_yp * eps, new_sh_o)
            new_sh_rem = torch.where(ok_b, dist_b - 2 * eps, new_sh_rem)
            new_sh_med = torch.where(ok_b, bmed, new_sh_med)
            new_sh_val = _w3(ok_b, val_b, new_sh_val)

        # commit the new shadow ray on processed lanes
        setup = proc & new_sh_active
        sh_active = sh_active | setup
        sh_need_isect = sh_need_isect | setup
        sh_o = _w3(setup, new_sh_o, sh_o)
        sh_d = _w3(setup, new_sh_d, st.sh_d)
        sh_remaining = torch.where(setup, new_sh_rem, sh_remaining)
        sh_med = torch.where(setup, new_sh_med, sh_med)
        sh_val = _w3(setup, new_sh_val, st.sh_val)
        sh_tr = _w3(setup, 1.0, st.sh_tr)

        # ---------- direction sampling ----------
        if mini:
            # transition lanes escape or cross a null boundary: the ray
            # continues unchanged
            new_d = st.d
            scatter_w = torch.ones((n, 3), dtype=torch.float32, device=dev)
            new_delta, new_pdf = st.last_delta, st.last_pdf
        else:
            u_dir2, smp = rng.next_2d(smp)
            u_dir1, smp = rng.next_1d(smp)
            ax_ov = (medium_m.orientation_axis(media, st.medium, m_p)
                     if cfg.phase_orient else None)
            ps = phase_m.sample(media.phase, st.medium, st.d, u_dir2,
                                active=pact, axis_override=ax_ov)
            bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u_dir2, u_dir1,
                               active=act)
            new_d = _w3(scattered, ps.wo, frame.to_world(bs.wo))
            scatter_w = _w3(scattered, ps.weight.unsqueeze(-1), bs.weight)
            new_pdf = torch.where(scattered, ps.pdf, bs.pdf)
            new_delta = torch.where(scattered, False, bs.delta)
            null_cross = on_surface & is_null
            new_d = _w3(null_cross, st.d, new_d)
            scatter_w = _w3(null_cross, 1.0, scatter_w)
            new_delta = torch.where(null_cross, st.last_delta, new_delta)
            new_pdf = torch.where(null_cross, st.last_pdf, new_pdf)

        cos_new = dot(new_d, st.hit_ng)
        cross = on_surface & (is_null | (cos_new * dot(-st.d, st.hit_ng) < 0))
        new_medium = torch.where(cross, torch.where(cos_new < 0, m_in, m_ex),
                                 st.medium)

        tp2 = tp * scatter_w
        cont = (scattered | on_surface) & depth_ok
        dead = torch.all(tp2 <= 0, dim=-1)
        if mini:
            eta_scale = st.eta_scale
            keep = cont & ~dead
        else:
            eta_scale = st.eta_scale * torch.where(on_surface, bs.eta, 1.0)
            u_rr, smp = rng.next_1d(smp)
            tp_rr, survive = common.russian_roulette(tp2, eta_scale, u_rr,
                                                     st.depth, cfg)
            tp2 = _w3(null_cross, tp2, tp_rr)
            keep = cont & ~dead & (survive | null_cross)

        finite = (torch.isfinite(vtx).all(-1) & torch.isfinite(new_d).all(-1)
                  & torch.isfinite(tp2).all(-1))
        keep = keep & finite
        tp2 = torch.nan_to_num(tp2, posinf=0.0, neginf=0.0)
        inc_depth = (scattered | (on_surface & ~is_null)) & keep
        new_d = torch.nan_to_num(new_d)
        new_o = torch.nan_to_num(vtx) + new_d * eps

        go = proc & keep
        path_alive = torch.where(proc, keep, st.path_alive)
        o = _w3(go, new_o, st.o)
        d = _w3(go, new_d, st.d)
        throughput = _w3(proc, tp2, st.throughput)
        depth = torch.where(inc_depth, st.depth + 1, st.depth)
        last_pdf = torch.where(go, new_pdf, st.last_pdf)
        last_delta = torch.where(go, new_delta, st.last_delta)
        medium = torch.where(go, new_medium, st.medium)
        ext_need = go
        ext_done = st.ext_done & ~proc

        # ---------- sample flush + regeneration ----------
        flush = (st.sample_open & ~path_alive & ~sh_active & ~sh_need_isect
                 & ~st.ext_tracking & ~ext_need)
        pend = st.pend
        pend[st.sample_idx.clamp_min(0), lane] += _w3(flush, L, 0.0)
        L = _w3(flush, 0.0, L)
        sample_open = st.sample_open & ~flush

        want = (~sample_open & ~path_alive & (st.sample_idx + 1 < sppc)
                & ~sh_active & ~sh_need_isect & ~st.ext_tracking)
        new_idx = st.sample_idx + 1
        sample_idx = torch.where(want, new_idx, st.sample_idx)
        pix = torch.where(want, (lane + new_idx * stride) % npix, st.pix)
        sample_open = sample_open | want
        gpix = pix + row0 * W       # the global pixel id (row blocks)
        smp = rng.restart(smp, want, gpix, pass_idx * sppc + sample_idx)
        u_jit, smp = rng.next_2d(smp)
        u_lens, smp = rng.next_2d(smp)
        px = (gpix % W).to(torch.float32) + u_jit[:, 0]
        py = (gpix // W).to(torch.float32) + u_jit[:, 1]
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H_full,
                                    u_lens=u_lens,
                                    kind_hint=cfg.sensor_kind)
        o = _w3(want, rays.o, o)
        d = _w3(want, rays.d, d)
        throughput = _w3(want, 1.0, throughput)
        medium = torch.where(want, scene.camera_medium.to(torch.int64),
                             medium)
        depth = torch.where(want, 1, depth)
        eta_scale = torch.where(want, 1.0, eta_scale)
        last_pdf = torch.where(want, 0.0, last_pdf)
        last_delta = last_delta | want
        path_alive = path_alive | want
        ext_need = ext_need | want

        # ---------- stage 3: extension intersect + analytic media ----------
        hit = isect.intersect(scene.geo, o, d, eps, isect.INF)
        _, t_scene = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
        seg_far = torch.where(hit.valid, hit.t, torch.clamp_min(t_scene, 0.0))
        t_far = torch.where(ext_need, seg_far, st.t_far)
        hit_valid = torch.where(ext_need, hit.valid, st.hit_valid)
        hit_shape = torch.where(ext_need, hit.shape_id, st.hit_shape)
        hit_ng = _w3(ext_need, hit.ng, st.hit_ng)

        kind_m, sa_m, ss_m, sw_m, _ = medium_m.params(
            scene.media, medium, sampling_weight=True)
        u_hom, smp = rng.next_1d(smp)
        uc_hom, smp = rng.next_1d(smp)
        strat = (medium_m.params_strategy(scene.media, medium)
                 if cfg.medium_strategies else (None, None))
        hs, ht, hw, _ = medium_m.sample_distance_homogeneous(
            sa_m, ss_m, sw_m, t_far, u_hom, uc_hom, *strat)
        in_hom = ext_need & (kind_m == MED_HOMOGENEOUS)
        in_het = ext_need & (kind_m == MED_HETEROGENEOUS)
        in_vac = ext_need & ~in_hom & ~in_het
        ext_done = ext_done | in_hom | in_vac
        ext_scat = torch.where(in_hom, hs, st.ext_scat & ~in_vac)
        ext_t = torch.where(in_hom, ht, torch.where(in_vac, t_far, st.ext_t))
        ext_w = _w3(in_hom, hw, _w3(in_vac, 1.0, st.ext_w))
        ext_tracking = torch.where(ext_need, in_het, st.ext_tracking)
        ext_t = torch.where(in_het, 0.0, ext_t)
        ext_w = _w3(in_het, 1.0, ext_w)

        # ---------- stage 4: shadow intersect + analytic subsegments -------
        # every lane is intersected; all uses are masked by shx (the JAX
        # engine skips the call under a lax.cond when no lane needs it)
        shx = sh_need_isect & sh_active
        shit = isect.intersect(scene.geo, sh_o, sh_d, eps * 0.5,
                               torch.clamp_min(sh_remaining - eps, 0.0))
        sb_idx, _, sm_in, sm_ex = _shape_tables(scene, shit.shape_id)
        s_null = _is_null_surface(scene, sb_idx)
        sh_active = sh_active & ~(shx & shit.valid & ~s_null)
        hitting = shx & shit.valid & s_null
        sh_seg = torch.where(shx, torch.where(shit.valid, shit.t,
                                              sh_remaining), st.sh_seg)
        sh_hit_null = torch.where(shx, hitting, st.sh_hit_null)
        s_enter = dot(sh_d, shit.ng) < 0
        sh_cross_med = torch.where(hitting, torch.where(s_enter, sm_in, sm_ex),
                                   st.sh_cross_med)
        sh_cross_p = _w3(hitting, shit.p, st.sh_cross_p)

        skind, ssa, sss, _ = medium_m.params(scene.media, sh_med)
        s_hom = shx & sh_active & (skind == MED_HOMOGENEOUS)
        s_het = shx & sh_active & (skind == MED_HETEROGENEOUS)
        s_vac = shx & sh_active & ~s_hom & ~s_het
        tr_h = medium_m.eval_transmittance_homogeneous(ssa, sss, sh_seg)
        sh_tr = _w3(s_hom, sh_tr * tr_h, sh_tr)
        sh_t = torch.where(s_hom | s_vac, sh_seg,
                           torch.where(s_het, 0.0, st.sh_t))
        sh_need_isect = sh_need_isect & ~shx

        n_segments = st.n_segments + ext_need.sum() + shx.sum()
        pending = torch.any(path_alive | sh_active | sh_need_isect
                            | ext_tracking | ext_done | sample_open
                            | (sample_idx + 1 < sppc))
        return replace(
            st, o=o, d=d, t_far=t_far, hit_valid=hit_valid,
            hit_shape=hit_shape, hit_ng=hit_ng, throughput=throughput,
            medium=medium, depth=depth, eta_scale=eta_scale,
            last_pdf=last_pdf, last_delta=last_delta, sample_idx=sample_idx,
            path_alive=path_alive, ext_tracking=ext_tracking,
            ext_done=ext_done, ext_scat=ext_scat, ext_t=ext_t, ext_w=ext_w,
            sh_active=sh_active, sh_need_isect=sh_need_isect, sh_o=sh_o,
            sh_d=sh_d, sh_remaining=sh_remaining, sh_seg=sh_seg, sh_t=sh_t,
            sh_med=sh_med, sh_tr=sh_tr, sh_val=sh_val,
            sh_hit_null=sh_hit_null, sh_cross_p=sh_cross_p,
            sh_cross_med=sh_cross_med, pix=pix, sample_open=sample_open, L=L,
            pend=pend, sampler=smp, n_segments=n_segments,
            it=st.it + (0 if mini else 1), pending=pending)

    def tracking_mega(st: WFState) -> WFState:
        """Every pending majorant jump through kernel C, outcomes merged
        (wavefront.py:723-793)."""
        do_sh, need, rows = pack_rows(scene, mega, st)
        ctr = megatrack.as_int32(st.tap_ctr)[None]
        out, ctr_out = megatrack.run(rows, ctr, mega.table, tap_seed,
                                     cfg.wf_mega_trips, mega.res, mega.nb)
        t_b = out[0]
        fac_b = out[1:4].t()
        res_b = (out[5] > 0.5) & need
        p_ext = need & ~do_sh
        p_sh = need & do_sh
        ext_resolved = p_ext & res_b
        return replace(
            st,
            ext_tracking=st.ext_tracking & ~ext_resolved,
            ext_done=st.ext_done | ext_resolved,
            ext_scat=torch.where(ext_resolved, out[4] > 0.5, st.ext_scat),
            ext_t=torch.where(p_ext, t_b, st.ext_t),
            ext_w=_w3(p_ext, st.ext_w * fac_b, st.ext_w),
            sh_tr=_w3(p_sh, torch.clamp_min(st.sh_tr * fac_b, 0.0), st.sh_tr),
            sh_t=torch.where(p_sh, t_b, st.sh_t),
            tap_ctr=torch.where(need, ctr_out[0].to(torch.int64) & M32,
                                st.tap_ctr),
            n_taps=st.n_taps + torch.where(need, out[6], 0.0)
            .to(torch.int64).sum())

    def cond(st: WFState) -> bool:
        """The outer loop's condition; one device sync."""
        return st.it < max_super and bool(st.pending)

    def finalize(st: WFState):
        """((npix, 3) radiance sum, int64 stats [segments, taps,
        super-iterations, unfinished])."""
        unfinished = (st.sample_open | (st.sample_idx + 1 < sppc)).sum()
        film = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        for j in range(sppc):
            film = film + torch.roll(st.pend[j], j * stride, dims=0)
        stats = torch.stack([st.n_segments, st.n_taps,
                             torch.full_like(st.n_taps, st.it), unfinished])
        return film, stats

    return st, event_pass, tracking_mega, cond, finalize


def render_wavefront(scene: Scene, cfg: RenderConfig, sppc: int, seed: int,
                     pass_idx: int, n_lanes: int | None = None,
                     has_direct: bool = True, any_het: bool = True,
                     row0=None, full_height: int | None = None):
    """sppc samples a pixel; returns ((npix, 3) radiance sum, stats) with
    stats = int64 [segments, taps, super-iterations, unfinished]. Each
    super-iteration is E [M T] * wf_mini_passes, or E T when that is 0 (T
    only when the scene has a heterogeneous medium)."""
    st, event_pass, tracking_mega, cond, finalize = make_engine(
        scene, cfg, sppc, seed, pass_idx, n_lanes=n_lanes,
        has_direct=has_direct, any_het=any_het, row0=row0,
        full_height=full_height)
    while cond(st):
        st = event_pass(st)
        for _ in range(cfg.wf_mini_passes):
            st = event_pass(st, mini=True)
            if any_het:
                st = tracking_mega(st)
        if cfg.wf_mini_passes == 0 and any_het:
            st = tracking_mega(st)
    return finalize(st)
