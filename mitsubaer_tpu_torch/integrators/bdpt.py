"""Bidirectional path tracer with per-(s, t) connections and MIS (port of
mitsubaer_tpu/integrators/bdpt.py; the reference's primary integrator,
bdpt_proc.cpp:140-480, on libbidir's PathVertex and PathEdge).

* Subpaths are fixed-depth stacked tensors (n, K, ...): `_surface_walk`
  runs K masked steps from the host (JAX's fixed-length scan), every lane
  in lockstep, then moves the null-boundary pass-throughs to the end so
  that array index k is the k-th real vertex.
* The (s, t) double loop is static: each connection is one masked
  visibility walk (`volpath.attenuated_visibility`) and arithmetic over
  the whole wavefront of H W lanes, lane i the pixel i.
* MIS weights use the area-measure pdf-ratio recursion (Path::miWeight,
  pbrt-v3's MISWeight) from the stored pdfFwd / pdfRev with the four
  junction pdfs recomputed for each (s, t), in JAX's float32 order; delta
  vertices gate terms as vertex.cpp's EDeltaDirection logic.
* t = 1 strategies splat into the light image through the sensor's
  (perspective) projection, one index_add_ (one index_put_ with frames)
  for each s, in a varying order on CUDA.
* Each vertex carries its path length, so each (s, t) contribution lands
  in the transient frame of its total length (`_transient_slot`, which
  truncates and clips, and unlike the common sink does not drop lengths
  outside [min_bound, max_bound)), or is weighted by the CW-ToF
  correlation.

Media: homogeneous (analytic distance sampling) and heterogeneous
(Woodcock tracking and ratio-tracked connections through kernel A). In
the refractive medium the walks march curved rays (`eikonal.trace_curved`,
kernel D), record medium vertices arriving along the curved exit velocity
(vertex.cpp:250-256), treat the boundary as an h-dielectric delta vertex
(hdielectric.cpp:115) and sum optical path length; a connection with an
endpoint inside it goes through the batched BVP solve (`eikonal.solve_bvp`,
kernel E in the Levenberg solve; edge.cpp:473-643), and a t = 1 strategy
from inside it solves the sensor-side BVP and splats at the pixel of the
arrival direction (edge.cpp:535-543). The JAX package's approximations are
kept: walk-internal reverse pdfs use the straight chord between stored
vertices, and the outside tail of a curved connection is not tested for
occlusion.

`render_bdpt` renders spp passes of one sample a pixel each (the
independent sampler whatever cfg.sampler says, the pixel jittered, no film
filter) and returns eye / spp + splat / (spp H W): (H, W, 3F).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from ..core import rng, warp
from ..core.math import Frame, dot, fresnel_dielectric, normalize
from ..models import bsdf as bsdf_m
from ..models import eikonal as ek
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..models import tof
from ..scene import intersect as isect
from ..scene.types import (EM_AREA, EM_COLLIMATED, EM_DIRECTIONAL, EM_POINT,
                           MED_HETEROGENEOUS, MED_HOMOGENEOUS, MED_REFRACTIVE,
                           RenderConfig, Scene)
from . import common
from .volpath import _is_null_surface, _shape_tables, attenuated_visibility
from .volpath_er import _refractive_params

_FAR = 3e37            # "no surface" along a walk segment


@dataclass(frozen=True)
class SubPath:
    """Stacked vertex tensors; index k is the k-th real (surface or
    medium) vertex of the walk (pbrt vertex k + 1). Medium vertices carry
    is_med, their phase medium in `med`, a zero ng, and the distance
    pdf factors for MIS."""
    p: torch.Tensor          # (n, K, 3)
    ng: torch.Tensor         # (n, K, 3) geometric normal (0 in a medium)
    d_in: torch.Tensor       # (n, K, 3) unit direction the walk arrived in
    beta: torch.Tensor       # (n, K, 3) cumulative weight at the vertex
    pdf_fwd: torch.Tensor    # (n, K) generalised-measure pdf of making it
    pdf_rev: torch.Tensor    # (n, K) pdf of making it backward
    delta: torch.Tensor      # (n, K) arrived through a delta lobe
    spec: torch.Tensor       # (n, K) its own sample took a delta lobe
    bsdf: torch.Tensor       # (n, K) (-1 at medium vertices)
    emitter: torch.Tensor    # (n, K)
    valid: torch.Tensor      # (n, K)
    plen: torch.Tensor       # (n, K) path length from the walk's origin
    is_med: torch.Tensor     # (n, K) a medium interaction
    med: torch.Tensor        # (n, K) the medium at the vertex
    shape: torch.Tensor      # (n, K) hit shape (-1 at medium vertices)
    seg_psucc: torch.Tensor  # (n, K) arrival segment's distance pdfs:
    seg_pfail: torch.Tensor  #   scattering at it, passing through
    rdepth: torch.Tensor     # (n, K) real vertices in [0, k]


@dataclass(frozen=True)
class LightStart:
    p: torch.Tensor            # (n, 3) y_0
    ng: torch.Tensor           # (n, 3)
    beta1: torch.Tensor        # (n, 3) cumulative weight at y_1
    inv_pdf_pos: torch.Tensor  # (n,) 1 / (area pdf * pick)
    pdf_pos: torch.Tensor
    pdf_dir: torch.Tensor      # emission solid-angle pdf
    radiance: torch.Tensor     # (n, 3) emitted radiance or intensity
    is_area: torch.Tensor
    delta_pos: torch.Tensor    # a Dirac position (point, collimated,
    #   directional): the s' = 0 family cannot hit it
    delta_dir: torch.Tensor    # a Dirac emission direction (collimated,
    #   directional): s = 1 connections are impossible
    emitter: torch.Tensor


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def _remap0(x):
    return torch.where(x > 0, x, 1.0)


def _mean3(x):
    return torch.mean(x, dim=-1)


def _to_area(pdf_dir, p_from, p_to, ng_to, is_med_to=None):
    """Solid angle to the generalised area / volume measure: |cos| / d^2
    onto a surface, 1 / d^2 into a medium (vertex.cpp:1339)."""
    dvec = p_to - p_from
    d2 = torch.clamp_min(torch.sum(dvec * dvec, -1), 1e-12)
    w = dvec / torch.sqrt(d2).unsqueeze(-1)
    cos_t = torch.abs(dot(w, ng_to))
    if is_med_to is not None:
        cos_t = torch.where(is_med_to, 1.0, cos_t)
    return pdf_dir * cos_t / d2


def _seg_pdf_factors(scene: Scene, med_seg, dist):
    """The balance strategy's distance pdfs of a segment of length dist in
    medium med_seg (homogeneous.cpp:275-350): (scattering at dist, per
    length; passing through). 1 and 1 in vacuum and in heterogeneous media
    (the JAX package's deterministic model: the MIS weights stay a
    partition of unity)."""
    kind, sa, ss, sw, _ = medium_m.params(scene.media, med_seg,
                                          sampling_weight=True)
    stc = sa + ss
    tmp = torch.exp(-stc * dist.unsqueeze(-1))
    hom = kind == MED_HOMOGENEOUS
    pdf_succ = torch.where(hom, sw * _mean3(stc * tmp), 1.0)
    pdf_fail = torch.where(hom, (1.0 - sw) + sw * _mean3(tmp), 1.0)
    return pdf_succ, pdf_fail


def _conn_medium(scene: Scene, is_med_v, med_v, shape_v, ng_v, wconn):
    """The medium a connection leaving a vertex toward wconn starts in: the
    vertex's own at medium vertices, the shape's interior or exterior by
    the side crossed at surfaces."""
    _, _, m_in, m_ex = _shape_tables(scene, shape_v)
    srf_med = torch.where(dot(wconn, ng_v) < 0, m_in, m_ex)
    return torch.where(is_med_v, med_v, srf_med)


@dataclass(frozen=True)
class _Er:
    """What the walks and connections read of the refractive medium."""
    rif: ek.RifField
    sdf: ek.SdfField
    sa: torch.Tensor
    ss: torch.Tensor
    sw: torch.Tensor
    idx: torch.Tensor
    shape: torch.Tensor     # the shape whose interior it is
    exterior: torch.Tensor  # that shape's exterior medium

    @property
    def st(self):
        return self.sa + self.ss


def _er_tables(scene: Scene) -> _Er:
    _, sa, ss, sw, idx = _refractive_params(scene)
    shape = torch.argmax((scene.shapes.interior == idx).to(torch.int32))
    return _Er(rif=ek.rif_from_media(scene.media),
               sdf=ek.sdf_from_media(scene.media), sa=sa, ss=ss, sw=sw,
               idx=idx, shape=shape, exterior=scene.shapes.exterior[shape])


def _walk_step(scene: Scene, cfg: RenderConfig, carry, eps, bricks,
               any_het: bool, er: _Er | None):
    """One step of every lane of a walk (bdpt.py:206-429): returns the next
    carry and the step's vertex fields."""
    (o, d, beta, pdf_dir, alive, plen, prev_delta, med, lr_p, fail_since,
     smp) = carry
    n = o.shape[0]
    dev = o.device
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    media = scene.media
    hit = isect.intersect(scene.geo, o, d, eps.expand(n), isect.INF)
    t_surf = torch.where(hit.valid, hit.t, _FAR)
    kind, sa, ss, sw, scale = medium_m.params(media, med, sampling_weight=True)
    if er is not None:
        # lanes inside the refractive medium travel curved: their straight
        # intersection means nothing
        er_ln = alive & (kind == MED_REFRACTIVE)
        t_surf = torch.where(er_ln, _FAR, t_surf)
        hit_valid = hit.valid & ~er_ln
    else:
        er_ln = torch.zeros((n,), dtype=torch.bool, device=dev)
        hit_valid = hit.valid
    u_h, smp = rng.next_1d(smp)
    uc_h, smp = rng.next_1d(smp)
    hs, ht, hw, _ = medium_m.sample_distance_homogeneous(sa, ss, sw, t_surf,
                                                         u_h, uc_h)
    hom = kind == MED_HOMOGENEOUS
    if any_het:
        het = kind == MED_HETEROGENEOUS
        ws, wt, ww, _, smp, _, _ = medium_m.sample_distance_woodcock(
            media, sa, ss, scale, o, d, t_surf, smp, alive & het,
            bricks=bricks)
        hs = torch.where(het, ws, hs)
        ht = torch.where(het, wt, ht)
        hw = _w3(het, ww, hw)
        in_medium = hom | het
    else:
        in_medium = hom
    scat = alive & in_medium & hs
    dist_w = _w3(in_medium, hw, 1.0)
    valid_srf = alive & hit_valid & ~scat

    exit_er = torch.zeros((n,), dtype=torch.bool, device=dev)
    if er is not None:
        # ---- the curved march inside the refractive medium ----
        march_dist = torch.where(hs, ht, 1e6)
        n_start = torch.clamp_min(ek.rif_value(er.rif, o), 1e-6)
        p_m, v_m, opt_m, geo_m, exited_m, _ = ek.trace_curved(
            er.rif, er.sdf, o, d * n_start.unsqueeze(-1), march_dist,
            cfg.er_stepsize, cfg.er_maxsteps, er_ln)
        scat_er = er_ln & hs & ~exited_m
        exit_er = er_ln & (exited_m | ~hs)
        p_b, v_b, opt_b, adv_b = ek.refine_boundary(er.rif, er.sdf, p_m, v_m,
                                                    cfg.er_stepsize)
        p_m = _w3(exit_er, p_b, p_m)
        v_m = _w3(exit_er, v_b, v_m)
        opt_m = torch.where(exit_er, opt_m + opt_b, opt_m)
        geo_m = torch.where(exit_er, geo_m + adv_b, geo_m)
        n_end_er = torch.clamp_min(ek.rif_value(er.rif, p_m), 1e-6)
        d_arr_er = normalize(v_m)
        N_out = normalize(ek.sdf_gradient(er.sdf, p_m))
        # the balance strategy's estimator weights at the curved arc length
        tr_er = torch.exp(-er.st[None, :] * geo_m.unsqueeze(-1))
        pdf_fail_er = (1.0 - er.sw) + er.sw * _mean3(tr_er)
        pdf_succ_er = er.sw * _mean3(er.st[None, :] * tr_er)
        w_sc_er = er.ss[None, :] * tr_er \
            / torch.clamp_min(pdf_succ_er, 1e-12).unsqueeze(-1)
        w_ex_er = tr_er / torch.clamp_min(pdf_fail_er, 1e-12).unsqueeze(-1)
        rrsq = (n_end_er / n_start) ** 2
        dist_w_er = _w3(scat_er, w_sc_er, w_ex_er) * rrsq.unsqueeze(-1)
        scat = scat | scat_er
        dist_w = _w3(er_ln, dist_w_er, dist_w)
    valid = scat | valid_srf | exit_er
    t_v = torch.where(scat, ht, t_surf)
    p_v = _w3(scat, o + t_v.unsqueeze(-1) * d, hit.p)
    ng_v = _w3(scat, 0.0, hit.ng)
    plen_here = plen + torch.where(valid, t_v, 0.0)
    if er is not None:
        t_v = torch.where(er_ln, geo_m, t_v)
        p_v = _w3(er_ln, p_m, p_v)
        ng_v = _w3(exit_er, N_out, ng_v)
        # optical path length inside the medium (bdpt_proc.cpp:396-399)
        plen_here = torch.where(er_ln & valid, plen + opt_m, plen_here)

    # the arrival segment's distance pdfs (exact for homogeneous media, 1
    # otherwise). Null crossings are compacted out after the walk, so the
    # stored factors span the whole null run (its pass probabilities
    # multiply in) and the measure conversion starts at the last real
    # vertex, exactly, since a pass-through keeps the direction.
    stc = sa + ss
    tmp = torch.exp(-stc * t_v.unsqueeze(-1))
    seg_psucc = fail_since * torch.where(hom, sw * _mean3(stc * tmp), 1.0)
    seg_pfail = fail_since * torch.where(hom, (1.0 - sw) + sw * _mean3(tmp),
                                         1.0)
    if er is not None:
        seg_psucc = torch.where(er_ln, fail_since * pdf_succ_er, seg_psucc)
        seg_pfail = torch.where(er_ln, fail_since * pdf_fail_er, seg_pfail)
    seg_p = torch.where(scat, seg_psucc, seg_pfail)
    pdf_fwd = _to_area(pdf_dir, lr_p, p_v, ng_v, is_med_to=scat) * seg_p
    if er is not None:
        # the curved measure conversion: |cos| / geo^2 at the curved arc
        # length and arrival direction (vertex.cpp:1339)
        cos_b = torch.abs(dot(d_arr_er, N_out))
        pdf_fwd_er = (pdf_dir * torch.where(exit_er, cos_b, 1.0)
                      / torch.clamp_min(geo_m * geo_m, 1e-12) * seg_p)
        pdf_fwd = torch.where(er_ln, pdf_fwd_er, pdf_fwd)

    sh = scene.shapes
    sid = torch.clamp(hit.shape_id, 0, sh.bsdf.shape[0] - 1).to(torch.int64)
    raw_b = sh.bsdf[sid]
    b_idx = torch.where(valid_srf, raw_b, -1)
    e_idx = torch.where(valid_srf, sh.emitter[sid], -1)
    _, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)

    frame = Frame.from_normal(hit.ng)
    wi_l = frame.to_local(-d)
    u2, smp = rng.next_2d(smp)
    u1, smp = rng.next_1d(smp)
    bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_l, u2, u1, active=act)
    d_ph = _w3(er_ln, d_arr_er, d) if er is not None else d
    ps = phase_m.sample(media.phase, med, d_ph, u2, active=pact)
    # null (medium-boundary) surfaces pass straight through as delta
    # vertices of weight 1, gated out of every connectible strategy
    null_srf = valid_srf & _is_null_surface(scene, raw_b)
    if er is not None:
        # the refractive medium's boundary is an h-dielectric, not a null
        # pass-through (shape.cpp:129-180)
        bnd_entry = valid_srf & ((m_in == er.idx) | (m_ex == er.idx))
        null_srf = null_srf & ~bnd_entry
    wo_w = _w3(scat, ps.wo, frame.to_world(bs.wo))
    wo_w = _w3(null_srf, d, wo_w)
    if er is not None:
        # entry: Fresnel with the RIF's eta at the hit (hdielectric.cpp:
        # 115-118)
        ones = torch.ones((n,), device=dev)
        n_at = torch.clamp_min(ek.rif_value(er.rif, hit.p), 1e-6)
        cos_i = dot(-d, hit.ng)
        F_in, _ = fresnel_dielectric(cos_i, n_at)
        refl_in = u1 < F_in
        v_refl_in = d - 2.0 * dot(d, hit.ng, True) * hit.ng
        N_in = _w3(cos_i > 0, hit.ng, -hit.ng)
        v_refr_in, _ = ek.boundary_velocity(d, N_in, ones, n_at)
        wo_w = _w3(bnd_entry, _w3(refl_in, v_refl_in, normalize(v_refr_in)),
                   wo_w)
        # exit: the curved march reached the boundary
        u_fx, smp = rng.next_1d(smp)
        F_x, _ = fresnel_dielectric(-dot(d_arr_er, N_out), n_end_er)
        v_refr_x, tir_x = ek.boundary_velocity(v_m, N_out, n_end_er, ones)
        refl_x = (u_fx < F_x) | tir_x
        v_refl_x = v_m - 2.0 * dot(v_m, N_out, True) * N_out
        wo_w = _w3(exit_er, _w3(refl_x, normalize(v_refl_x),
                                normalize(v_refr_x)), wo_w)
        bnd_any = bnd_entry | exit_er
    # the density of sampling the incoming direction back from the
    # outgoing one (the reverse walk), for the predecessor's pdf_rev
    pdf_rev_bs = bsdf_m.pdf(scene.bsdfs, b_idx, bs.wo, wi_l, active=act)
    pdf_rev_ph = phase_m.eval(media.phase, med, -ps.wo, -d_ph, active=pact)
    pdf_rev_dir = torch.where(scat, pdf_rev_ph, pdf_rev_bs)
    step_w = _w3(scat, ps.weight.unsqueeze(-1), bs.weight)
    step_w = _w3(null_srf, 1.0, step_w)
    spec = torch.where(scat, False, torch.where(null_srf, True, bs.delta))
    pdf_next = torch.where(scat, ps.pdf, torch.where(null_srf, 1.0, bs.pdf))
    goes_on = scat | (b_idx >= 0) | null_srf
    if er is not None:
        pdf_rev_dir = torch.where(bnd_any, 1.0, pdf_rev_dir)
        step_w = _w3(bnd_any, 1.0, step_w)
        spec = torch.where(bnd_any, True, spec)
        pdf_next = torch.where(bnd_any, 1.0, pdf_next)
        goes_on = goes_on | bnd_any
    beta_here = beta * dist_w
    beta_next = beta_here * step_w
    cont = valid & goes_on & torch.any(step_w > 0, dim=-1)

    # the medium changes at surface crossings (null pass-throughs too)
    cos_wo = dot(wo_w, hit.ng)
    crossed = valid_srf & (cos_wo * dot(-d, hit.ng) < 0)
    med_next = torch.where(crossed, torch.where(cos_wo < 0, m_in, m_ex), med)
    if er is not None:
        med_next = torch.where(exit_er, torch.where(refl_x, med, er.exterior),
                               med_next)

    is_real = valid & ~null_srf
    shape = torch.where(valid_srf, hit.shape_id, -1)
    if er is not None:
        shape = torch.where(exit_er, er.shape.to(shape.dtype), shape)
    vert = dict(
        p=p_v, ng=ng_v, d_in=_w3(er_ln, d_arr_er, d) if er is not None else d,
        beta=beta_here, pdf_fwd=torch.where(valid, pdf_fwd, 0.0),
        pdf_rev_dir=torch.where(valid, pdf_rev_dir, 0.0), delta=prev_delta,
        spec=spec, bsdf=b_idx, emitter=e_idx, valid=valid, plen=plen_here,
        is_med=scat, med=torch.where(scat, med, med_next), shape=shape,
        seg_psucc=seg_psucc, seg_pfail=seg_pfail, is_real=is_real)
    o2 = p_v + wo_w * eps
    if er is not None:
        o2 = _w3(exit_er & ~refl_x, p_m + N_out * eps + wo_w * eps, o2)
        o2 = _w3(exit_er & refl_x, p_m - N_out * eps + wo_w * eps, o2)
    # carried across null runs: the last real vertex, the pass
    # probabilities so far, the arrival delta
    carry = (o2, wo_w, beta_next, torch.where(is_real, pdf_next, pdf_dir),
             cont, plen_here, torch.where(null_srf, prev_delta, spec),
             med_next, _w3(is_real, p_v, lr_p),
             torch.where(is_real, 1.0,
                         torch.where(valid, seg_pfail, fail_since)), smp)
    return carry, vert


def _surface_walk(scene: Scene, cfg: RenderConfig, o0, d0, beta1, pdf0_dir,
                  origin_p, origin_ng, smp, K: int, eps, bricks, med0=None,
                  any_het: bool = False, er: _Er | None = None):
    """Walk K vertices (surface and medium interactions) from the rays
    (o0, d0) (bdpt.py:170-486): K masked steps, every lane drawing its
    numbers whether it lives or not, as JAX's scan. pdf0_dir is the solid-
    angle pdf of d0; origin_ng the origin's normal, for its reverse pdf.
    Returns (SubPath with the null crossings moved to the end, the reverse
    pdf of the origin from vertex 0, the sampler)."""
    n = o0.shape[0]
    dev = o0.device
    if med0 is None:
        med0 = scene.camera_medium.to(torch.int64).expand(n)
    carry = (o0, d0, beta1, pdf0_dir,
             torch.ones((n,), dtype=torch.bool, device=dev),
             torch.zeros((n,), device=dev),
             torch.zeros((n,), dtype=torch.bool, device=dev), med0,
             origin_p, torch.ones((n,), device=dev), smp)
    steps = []
    for _ in range(K):
        carry, vert = _walk_step(scene, cfg, carry, eps, bricks, any_het, er)
        steps.append(vert)
    smp = carry[-1]
    verts = {k: torch.stack([v[k] for v in steps], dim=1) for k in steps[0]}

    # ---- the null pass-throughs move to the end; real vertices keep
    # their order, so the (s, t) machinery sees real neighbours ----
    realv = verts["is_real"]
    kidx = torch.arange(K, dtype=torch.int64, device=dev).expand(n, K)
    order = torch.argsort(torch.where(realv, kidx, K + kidx), dim=1)

    def cpk(x):
        if x.dim() == 3:
            return torch.gather(x, 1, order.unsqueeze(-1).expand(-1, -1, 3))
        return torch.gather(x, 1, order)

    nreal = realv.sum(dim=1)
    slot_ok = kidx < nreal.unsqueeze(-1)
    p, ng = cpk(verts["p"]), cpk(verts["ng"])
    is_med = cpk(verts["is_med"]) & slot_ok
    seg_psucc, seg_pfail = cpk(verts["seg_psucc"]), cpk(verts["seg_pfail"])
    pdf_rev_dir = cpk(verts["pdf_rev_dir"])
    # pdf_rev[k]: vertex k made again from vertex k + 1, whose walk step
    # found the reverse direction pdf; converted at k, times the shared
    # segment's distance pdf (symmetric in homogeneous media)
    pdf_rev = torch.zeros((n, K), device=dev)
    if K > 1:
        pdf_rev[:, :-1] = _to_area(
            pdf_rev_dir[:, 1:], p[:, 1:], p[:, :-1], ng[:, :-1],
            is_med_to=is_med[:, :-1]) * torch.where(
                is_med[:, :-1], seg_psucc[:, 1:], seg_pfail[:, 1:])
    # the reverse pdf onto the walk's origin (y_0) from vertex 0
    rev_to_origin = _to_area(pdf_rev_dir[:, 0], p[:, 0], origin_p,
                             origin_ng) * seg_pfail[:, 0]
    valid = cpk(verts["valid"]) & slot_ok
    sub = SubPath(
        p=p, ng=ng, d_in=cpk(verts["d_in"]), beta=cpk(verts["beta"]),
        pdf_fwd=cpk(verts["pdf_fwd"]), pdf_rev=pdf_rev,
        delta=cpk(verts["delta"]), spec=cpk(verts["spec"]),
        bsdf=cpk(verts["bsdf"]), emitter=cpk(verts["emitter"]), valid=valid,
        plen=cpk(verts["plen"]), is_med=is_med, med=cpk(verts["med"]),
        shape=cpk(verts["shape"]), seg_psucc=seg_psucc, seg_pfail=seg_pfail,
        rdepth=torch.cumsum(valid.to(torch.int32), dim=1))
    return sub, rev_to_origin, smp


def _sample_light_vertex(scene: Scene, smp: rng.Sampler):
    """y_0 and its emission ray (Scene::sampleEmitterRay, bdpt.py:489-541):
    area emitters a uniform point and a cosine direction, every other
    kind its position and a uniform-sphere direction, collimated and
    directional emitters their own direction (pdf_dir 1, delta in
    position and direction: every MIS term through them is gated)."""
    em = scene.emitters
    ne = em.kind.shape[0]
    u_sel, smp = rng.next_1d(smp)
    u_pos, smp = rng.next_2d(smp)
    u_dir, smp = rng.next_2d(smp)
    e_idx = torch.clamp((u_sel * ne).to(torch.int64), 0, ne - 1)
    u_tri = torch.clamp_max(u_sel * ne - e_idx, 0.9999994)
    kind = em.kind[e_idx]
    radiance = em.radiance[e_idx]
    p_area, n_area, pdf_area = emitter_m._sample_area_position(
        scene, e_idx, u_pos, u_tri)
    d_cos = Frame.from_normal(n_area).to_world(
        warp.square_to_cosine_hemisphere(u_dir))
    d_sph = warp.square_to_uniform_sphere(u_dir)
    is_area = kind == EM_AREA
    is_beam = (kind == EM_COLLIMATED) | (kind == EM_DIRECTIONAL)
    edir = em.direction[e_idx]
    p0 = _w3(is_area, p_area, em.position[e_idx])
    ng0 = _w3(is_beam, edir, _w3(is_area, n_area, d_sph))
    d0 = _w3(is_beam, edir, _w3(is_area, d_cos, d_sph))
    cos0 = torch.clamp_min(dot(d0, n_area), 1e-8)
    pdf_pos = torch.where(is_area, pdf_area, 1.0) / ne
    pdf_dir = torch.where(is_area, cos0 / math.pi, 1.0 / (4.0 * math.pi))
    pdf_dir = torch.where(is_beam, 1.0, pdf_dir)
    denom = torch.clamp_min(pdf_pos * pdf_dir, 1e-12)
    beta1 = _w3(is_area, radiance * (cos0 / denom).unsqueeze(-1),
                radiance / denom.unsqueeze(-1))
    return LightStart(
        p=p0, ng=ng0, beta1=beta1,
        inv_pdf_pos=1.0 / torch.clamp_min(pdf_pos, 1e-12), pdf_pos=pdf_pos,
        pdf_dir=pdf_dir, radiance=radiance, is_area=is_area,
        delta_pos=(kind == EM_POINT) | is_beam, delta_dir=is_beam,
        emitter=e_idx), d0, smp


def _bsdf_pdf_at(scene: Scene, cfg: RenderConfig, sub: SubPath, k: int,
                 wi_w, wo_w):
    """The scattering pdf at vertex k for wi_w -> wo_w (both pointing away
    from it): the BSDF's at surfaces, the phase function's at medium
    vertices."""
    frame = Frame.from_normal(sub.ng[:, k])
    p_srf = bsdf_m.pdf(scene.bsdfs, sub.bsdf[:, k], frame.to_local(wi_w),
                       frame.to_local(wo_w), active=cfg.bsdf_kinds or None)
    p_med = phase_m.eval(scene.media.phase, sub.med[:, k], -wi_w, wo_w,
                         active=cfg.phase_kinds or None)
    return torch.where(sub.is_med[:, k], p_med, p_srf)


def _bsdf_f_at(scene: Scene, cfg: RenderConfig, sub: SubPath, k: int, wi_w,
               wo_w):
    """The vertex's throughput for wi_w -> wo_w: the BSDF (with its |cos
    wo|) at surfaces, the bare phase function at medium vertices (the
    distance weight already holds sigma_s)."""
    frame = Frame.from_normal(sub.ng[:, k])
    f_srf = bsdf_m.eval(scene.bsdfs, sub.bsdf[:, k], frame.to_local(wi_w),
                        frame.to_local(wo_w), active=cfg.bsdf_kinds or None)
    f_med = phase_m.eval(scene.media.phase, sub.med[:, k], -wi_w, wo_w,
                         active=cfg.phase_kinds or None)
    return _w3(sub.is_med[:, k], f_med.unsqueeze(-1), f_srf)


def _mis_weight(cam: SubPath, lt: SubPath, light0: LightStart, s: int,
                t: int, ov_cam, ov_cam2, ov_lt, ov_lt2, rev_lt_origin,
                npix: int):
    """The balance heuristic over the strategies of one path length
    (bdpt.py:573-649): pbrt-v3's MISWeight on z_1 .. z_{t-1} (cam[0 ..
    t-2]) and y_0 .. y_{s-1} (light0, lt[0 .. s-2]) with the junction
    reverse pdfs ov_cam (z_{t-1}), ov_cam2 (z_{t-2}), ov_lt (y_{s-1}) and
    ov_lt2 (y_{s-2}). Count-weighted (Veach 9.2.4): the light-image family
    (t' = 1) takes npix times the samples of a pixel's own families, so
    its terms weigh npix times more, and a t = 1 strategy's competitors
    1 / npix."""
    n = light0.p.shape[0]
    sum_ri = torch.zeros((n,), device=light0.p.device)
    F = torch.zeros((n,), dtype=torch.bool, device=light0.p.device)

    def cam_rev(i):
        if i == t - 1:
            return ov_cam
        if i == t - 2:
            return ov_cam2
        return cam.pdf_rev[:, i - 1]

    def cam_delta(i):
        # z_{t-1} is the junction: connectible by construction
        return F if i == t - 1 else cam.delta[:, i - 1]

    ri = torch.ones((n,), device=light0.p.device)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(cam_rev(i)) / _remap0(cam.pdf_fwd[:, i - 1])
        # z_0, the pinhole: the t' = 1 light-image strategy is valid
        d_prev = cam_delta(i - 1) if i - 1 >= 1 else F
        scale = npix if i == 1 else 1.0
        sum_ri = sum_ri + torch.where(~cam_delta(i) & ~d_prev, ri * scale,
                                      0.0)

    def lt_fwd(i):
        return light0.pdf_pos if i == 0 else lt.pdf_fwd[:, i - 1]

    def lt_rev(i):
        if i == s - 1:
            return ov_lt
        if i == s - 2:
            return ov_lt2
        return rev_lt_origin if i == 0 else lt.pdf_rev[:, i - 1]

    def lt_delta(i):
        # y_0's own "lobe" is its emission direction: a point light is
        # delta in position yet freely connectable
        if i == s - 1:
            return F
        return light0.delta_dir if i == 0 else lt.delta[:, i - 1]

    ri = torch.ones((n,), device=light0.p.device)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(lt_rev(i)) / _remap0(lt_fwd(i))
        # the i = 0 term is the s' = 0 family (the camera path hits the
        # light): it needs a light it can hit
        d_origin = light0.delta_pos if i == 0 else lt_delta(i - 1)
        sum_ri = sum_ri + torch.where(~lt_delta(i) & ~d_origin, ri, 0.0)
    if t == 1:
        sum_ri = sum_ri / npix      # this strategy's own count is npix x
    return 1.0 / (1.0 + sum_ri)


def _transient_slot(cfg: RenderConfig, contrib, plen, base):
    """base (n, 3F) plus each lane's contribution in the frame of its path
    length (bdpt.py:689-698): the bin truncated and clipped to [0, F - 1],
    so a length outside [min_bound, max_bound) lands in the first or last
    frame. With one frame, base + contrib."""
    nF = cfg.n_frames
    if nF == 1:
        return base + contrib
    idx = torch.clamp(((plen - cfg.min_bound) / cfg.bin_width
                       ).to(torch.int32), 0, nF - 1).to(torch.int64)
    n = contrib.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=contrib.device)
    return base.view(n, nF, 3).index_put_((lane, idx), contrib,
                                          accumulate=True).view(n, 3 * nF)


def _bdpt_pass(scene: Scene, eye_img, splat_img, cfg: RenderConfig,
               T_MAX: int, S_MAX: int, seed: int, pass_idx: int,
               any_het: bool = False, any_er: bool = False):
    """One sample a pixel (bdpt.py:717-1159): the camera and light
    subpaths, then every (s, t) strategy into eye_img (H W, 3F) and the
    t = 1 strategies into splat_img; both are updated in place and
    returned."""
    H, W = cfg.height, cfg.width
    npix = H * W
    n = npix
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    cam_p = scene.sensor.to_world[:3, 3]
    cam_pn = cam_p.expand(n, 3)
    bricks = medium_m.DensityGrid(scene.media)
    er = _er_tables(scene) if any_er else None
    if any_er:
        h_bvp = cfg.er_stepsize * cfg.er_bvp_hscale
        bvp_steps = max(int(cfg.er_maxsteps / cfg.er_bvp_hscale), 16)
    mod_w = None
    if cfg.modulation != "none":
        def mod_w(plen):
            return tof.correlation_function(cfg, plen)

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed, lane, pass_idx)

    # ---------------- the camera subpath ----------------
    u_jit, smp = rng.next_2d(smp)
    px = (lane % W).to(torch.float32) + u_jit[:, 0]
    py = (lane // W).to(torch.float32) + u_jit[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H,
                                kind_hint=cfg.sensor_kind)
    # the camera's direction pdf: uniform over the pixel's solid angle
    pdf_cam_dir = sensor_m.project(scene.sensor, rays.o + rays.d, W,
                                   H).inv_pixel_omega
    zeros3 = torch.zeros((n, 3), device=dev)
    cam, _, smp = _surface_walk(
        scene, cfg, rays.o, rays.d, torch.ones((n, 3), device=dev),
        pdf_cam_dir, rays.o, zeros3, smp, T_MAX, eps, bricks,
        any_het=any_het, er=er)

    # ---------------- the light subpath ----------------
    light0, d0, smp = _sample_light_vertex(scene, smp)
    # area emitters start in their shape's exterior, the others in the
    # camera's medium
    se = scene.emitters.shape_id[light0.emitter].to(torch.int64)
    ext = scene.shapes.exterior
    med_l0 = torch.where(se >= 0, ext[torch.clamp(se, 0, ext.shape[0] - 1)],
                         scene.camera_medium.to(ext.dtype).expand(n))
    lt, rev_lt_origin, smp = _surface_walk(
        scene, cfg, light0.p + d0 * eps, d0, light0.beta1, light0.pdf_dir,
        light0.p, light0.ng, smp, max(S_MAX - 1, 1), eps, bricks,
        med0=med_l0, any_het=any_het, er=er)

    F = torch.zeros((n,), dtype=torch.bool, device=dev)
    ones = torch.ones((n,), device=dev)

    # ---------------- s = 0: the camera path hits an emitter ----------
    for t in range(2, T_MAX + 2):
        k = t - 2                      # array index of z_{t-1}
        if k >= T_MAX or t - 1 > cfg.max_depth:
            break
        e_idx = cam.emitter[:, k]
        ok = (cam.valid[:, k] & (e_idx >= 0)
              & (cam.rdepth[:, k] <= cfg.max_depth))
        le = emitter_m.eval_hit(scene, e_idx, cam.ng[:, k], -cam.d_in[:, k])
        contrib = cam.beta[:, k] * le
        # junction pdfs: z_{t-1} made again as a light origin, z_{t-2} by
        # emission from z_{t-1}
        earea = scene.emitters.area[torch.clamp(
            e_idx, 0, scene.emitters.area.shape[0] - 1).to(torch.int64)]
        ne = scene.emitters.kind.shape[0]
        pdf_light_origin = 1.0 / torch.clamp_min(earea * ne, 1e-12)
        if t >= 3:
            prev_p, prev_ng = cam.p[:, k - 1], cam.ng[:, k - 1]
        else:
            prev_p, prev_ng = cam_pn, zeros3
        cos_l = torch.clamp_min(dot(normalize(prev_p - cam.p[:, k]),
                                    cam.ng[:, k]), 0.0)
        if t >= 3:
            ov_cam2 = _to_area(cos_l / math.pi, cam.p[:, k], prev_p, prev_ng,
                               is_med_to=cam.is_med[:, k - 1]) * torch.where(
                cam.is_med[:, k - 1], cam.seg_psucc[:, k],
                cam.seg_pfail[:, k])
        else:
            ov_cam2 = ones
        w = _mis_weight(cam, lt, light0, 0, t, pdf_light_origin, ov_cam2,
                        ones, ones, rev_lt_origin, npix)
        val = contrib * w.unsqueeze(-1)
        ok = ok & torch.all(torch.isfinite(val), dim=-1)
        eye_img = _transient_slot(cfg, _w3(ok, val, 0.0), cam.plen[:, k],
                                  eye_img)

    # ---------------- t >= 2, s >= 1: connections ----------------
    for t in range(2, T_MAX + 2):
        kc = t - 2
        if kc >= T_MAX:
            break
        for s in range(1, S_MAX + 1):
            if s + t - 1 > cfg.max_depth:
                continue
            if s == 1:
                yp, yng = light0.p, light0.ng
                y_valid = torch.ones((n,), dtype=torch.bool, device=dev)
                s_real = 1
            else:
                kl = s - 2
                if kl >= lt.p.shape[1]:
                    continue
                yp, yng = lt.p[:, kl], lt.ng[:, kl]
                y_valid = lt.valid[:, kl]
                s_real = 1 + lt.rdepth[:, kl]
            eye_img, smp = _connect(
                scene, cfg, cam, lt, light0, rev_lt_origin, s, t, kc,
                kl if s >= 2 else -1, yp, yng, y_valid, s_real, eye_img,
                smp, eps, bricks, er, npix, mod_w,
                (h_bvp, bvp_steps) if any_er else None)

    # ---------------- t = 1: the light image ----------------
    for s in range(1, S_MAX + 2):
        if s > cfg.max_depth:
            break
        if s >= 2 and s - 2 >= lt.p.shape[1]:
            break
        splat_img, smp = _light_image(
            scene, cfg, lt, light0, rev_lt_origin, s, cam, splat_img, smp,
            eps, bricks, er, npix, mod_w,
            (h_bvp, bvp_steps) if any_er else None)
    return eye_img, splat_img


def _connect(scene: Scene, cfg: RenderConfig, cam: SubPath, lt: SubPath,
             light0: LightStart, rev_lt_origin, s: int, t: int, kc: int,
             kl: int, yp, yng, y_valid, s_real, eye_img, smp, eps, bricks,
             er: _Er | None, npix: int, mod_w, bvp_cfg):
    """The (s, t) strategy with t >= 2, s >= 1 (bdpt.py:823-1021): join
    z_{t-1} = cam[kc] to y_{s-1} (light0 or lt[kl]), through the BVP where
    an endpoint lies in the refractive medium; returns eye_img and the
    sampler."""
    n = yp.shape[0]
    dev = yp.device
    F = torch.zeros((n,), dtype=torch.bool, device=dev)
    ones = torch.ones((n,), device=dev)
    zp, zng = cam.p[:, kc], cam.ng[:, kc]
    t_real = 1 + cam.rdepth[:, kc]
    ok = cam.valid[:, kc] & y_valid & (s_real + t_real - 1 <= cfg.max_depth)
    dvec = yp - zp
    d2 = torch.clamp_min(torch.sum(dvec * dvec, -1), 1e-12)
    dist = torch.sqrt(d2)
    wconn = dvec / dist.unsqueeze(-1)
    er_conn = F
    if er is not None:
        # the curved connection (edge.cpp:473-643) where an endpoint is a
        # medium vertex in the refractive medium: its directions feed the
        # endpoint f terms, its optical length the transient length, and
        # refRatioSq compresses the radiance (bdpt_proc.cpp:396-399)
        z_er = cam.is_med[:, kc] & (cam.med[:, kc] == er.idx)
        y_er = (lt.is_med[:, kl] & (lt.med[:, kl] == er.idx)) if s >= 2 \
            else F
        er_conn = ok & (z_er | y_er)
        from_z = z_er          # solve from the camera side when inside
        p1 = _w3(from_z, zp, yp)
        p2 = _w3(from_z, yp, zp)
        seed_er = rng._hash_u32((smp.lane + rng.mul32(smp.seed, 0xC2B2AE35)
                                 + (s * 131 + t * 31337)) & rng.M32)
        bvp = ek.solve_bvp(er.rif, er.sdf, p1, p2, normalize(p2 - p1),
                           bvp_cfg[0], bvp_cfg[1], er_conn,
                           tol2=cfg.bvp_tol2, rr_weight=cfg.rr_weight,
                           seed_bits=seed_er, max_restarts=cfg.bvp_restarts)
        er_ok = er_conn & bvp.converged
        wconn_z = _w3(er_conn, _w3(from_z, bvp.dir_to_target, bvp.rev_dir),
                      wconn)
        wconn_y = _w3(er_conn, _w3(from_z, bvp.rev_dir, bvp.dir_to_target),
                      -wconn)
        g2 = torch.clamp_min(bvp.geo_total * bvp.geo_total, 1e-12)
        # the radiance compression (n_receiver / n_source)^2, the camera
        # side receiving
        n_z = torch.where(z_er, torch.clamp_min(ek.rif_value(er.rif, zp),
                                                1e-6), 1.0)
        n_y = torch.where(y_er, torch.clamp_min(ek.rif_value(er.rif, yp),
                                                1e-6), 1.0)
        tmp_er = torch.exp(-er.st[None, :] * bvp.geo_inside.unsqueeze(-1))
        tr_er_conn = tmp_er * ((n_z / n_y) ** 2 * bvp.weight).unsqueeze(-1)
    else:
        wconn_z, wconn_y = wconn, -wconn
    # f carries the |cos| of its side (bsdf eval); what is left of the
    # geometry is 1 / d^2, and for s = 1 the emission cosine of an area
    # light
    f_c = _bsdf_f_at(scene, cfg, cam, kc, -cam.d_in[:, kc], wconn_z)
    if s == 1:
        cos_y = torch.clamp_min(dot(wconn_y, light0.ng), 0.0)
        f_y = _w3(light0.is_area, light0.radiance
                  * torch.where(cos_y > 0, 1.0, 0.0).unsqueeze(-1),
                  light0.radiance)
        beta_y = light0.inv_pdf_pos.unsqueeze(-1) * torch.ones(
            (n, 3), device=dev)
        G = torch.where(light0.is_area, cos_y / d2, 1.0 / d2)
        # a delta emission direction cannot be connected to; point lights
        # are delta in position only and connect freely
        ok = ok & ~light0.delta_dir
    else:
        f_y = _bsdf_f_at(scene, cfg, lt, kl, -lt.d_in[:, kl], wconn_y)
        G = 1.0 / d2
        beta_y = lt.beta[:, kl]
    if er is not None:
        G = torch.where(er_conn, G * d2 / g2, G)   # curved falloff
    contrib = cam.beta[:, kc] * f_c * beta_y * f_y * G.unsqueeze(-1)
    ok = ok & torch.any(contrib > 0, dim=-1)
    # transmittance and occlusion through null boundaries
    conn_med = _conn_medium(scene, cam.is_med[:, kc], cam.med[:, kc],
                            cam.shape[:, kc], zng, wconn)
    tr_conn, smp = attenuated_visibility(
        scene, eps, zp + wconn * eps, wconn, dist - 2 * eps, conn_med, smp,
        ok & ~er_conn, bricks=bricks, block_refractive=er is not None)
    if er is not None:
        # the in-medium transmittance of the curved connection
        tr_conn = _w3(er_conn, tr_er_conn, tr_conn)
        ok = ok & (~er_conn | er_ok)
    contrib = contrib * tr_conn
    ok = ok & torch.any(tr_conn > 0, dim=-1)
    c_psucc, c_pfail = _seg_pdf_factors(scene, conn_med, dist)
    if er is not None:
        c_psucc = torch.where(er_conn, _mean3(er.st[None, :] * tmp_er),
                              c_psucc)
        c_pfail = torch.where(er_conn, _mean3(tmp_er), c_pfail)

    # ---- the junction reverse pdfs ----
    # z_{t-1} from y_{s-1}
    if s == 1:
        cos_y1 = torch.clamp_min(dot(wconn_y, light0.ng), 1e-8)
        pdf_y_dir = torch.where(light0.is_area, cos_y1 / math.pi,
                                1.0 / (4.0 * math.pi))
    else:
        pdf_y_dir = _bsdf_pdf_at(scene, cfg, lt, kl, -lt.d_in[:, kl],
                                 wconn_y)
    ov_cam = _to_area(pdf_y_dir, yp, zp, zng, is_med_to=cam.is_med[:, kc]) \
        * torch.where(cam.is_med[:, kc], c_psucc, c_pfail)
    if er is not None:
        ov_cam = torch.where(er_conn, ov_cam * d2 / g2, ov_cam)
    # z_{t-2} from z_{t-1}
    pdf_z_back = _bsdf_pdf_at(scene, cfg, cam, kc, wconn_z, -cam.d_in[:, kc])
    if t >= 3:
        ov_cam2 = _to_area(pdf_z_back, zp, cam.p[:, kc - 1],
                           cam.ng[:, kc - 1], is_med_to=cam.is_med[:, kc - 1]
                           ) * torch.where(cam.is_med[:, kc - 1],
                                           cam.seg_psucc[:, kc],
                                           cam.seg_pfail[:, kc])
    else:
        ov_cam2 = ones
    # y_{s-1} from z_{t-1}
    pdf_z_dir = _bsdf_pdf_at(scene, cfg, cam, kc, -cam.d_in[:, kc], wconn_z)
    y_is_med = lt.is_med[:, kl] if s >= 2 else F
    ov_lt = _to_area(pdf_z_dir, zp, yp, yng, is_med_to=y_is_med) \
        * torch.where(y_is_med, c_psucc, c_pfail)
    if er is not None:
        ov_lt = torch.where(er_conn, ov_lt * d2 / g2, ov_lt)
    # y_{s-2} from y_{s-1}
    if s >= 2:
        if s == 2:
            prev_lp, prev_lng, prev_l_med = light0.p, light0.ng, F
        else:
            prev_lp, prev_lng = lt.p[:, kl - 1], lt.ng[:, kl - 1]
            prev_l_med = lt.is_med[:, kl - 1]
        pdf_y_back = _bsdf_pdf_at(scene, cfg, lt, kl, wconn_y,
                                  -lt.d_in[:, kl])
        ov_lt2 = _to_area(pdf_y_back, yp, prev_lp, prev_lng,
                          is_med_to=prev_l_med) * torch.where(
            prev_l_med, lt.seg_psucc[:, kl], lt.seg_pfail[:, kl])
    else:
        ov_lt2 = ones
    w = _mis_weight(cam, lt, light0, s, t, ov_cam, ov_cam2, ov_lt, ov_lt2,
                    rev_lt_origin, npix)
    conn_len = dist
    if er is not None:
        # the optical connection length (bdpt_proc.cpp:396-399)
        conn_len = torch.where(er_conn, bvp.opt_len, dist)
    plen_tot = cam.plen[:, kc] + conn_len
    if s >= 2:
        plen_tot = plen_tot + lt.plen[:, kl]
    val = contrib * w.unsqueeze(-1)
    if mod_w is not None:
        val = val * mod_w(plen_tot).unsqueeze(-1)
    ok = ok & torch.all(torch.isfinite(val), dim=-1)
    return _transient_slot(cfg, _w3(ok, val, 0.0), plen_tot, eye_img), smp


def _light_image(scene: Scene, cfg: RenderConfig, lt: SubPath,
                 light0: LightStart, rev_lt_origin, s: int, cam: SubPath,
                 splat_img, smp, eps, bricks, er: _Er | None, npix: int,
                 mod_w, bvp_cfg):
    """The (s, 1) strategy (bdpt.py:1024-1157): join y_{s-1} to the camera
    and splat at its pixel, through the sensor-side BVP from inside the
    refractive medium (the pixel of the arrival direction); returns
    splat_img and the sampler."""
    H, W = cfg.height, cfg.width
    n = light0.p.shape[0]
    dev = light0.p.device
    F = torch.zeros((n,), dtype=torch.bool, device=dev)
    ones = torch.ones((n,), device=dev)
    cam_pn = scene.sensor.to_world[:3, 3].expand(n, 3)
    if s == 1:
        kl = -1
        yp, yng = light0.p, light0.ng
        ok = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        kl = s - 2
        yp, yng = lt.p[:, kl], lt.ng[:, kl]
        ok = lt.valid[:, kl] & (1 + lt.rdepth[:, kl] <= cfg.max_depth)
    to_c = cam_pn - yp
    d2 = torch.clamp_min(torch.sum(to_c * to_c, -1), 1e-12)
    dist = torch.sqrt(d2)
    d_c = to_c / dist.unsqueeze(-1)
    y_er1 = F
    if er is not None and s >= 2:
        # the curved sensor-side connection from a light vertex in the
        # medium (edge.cpp:535-543); the pixel is the arrival direction's
        y_er1 = ok & lt.is_med[:, kl] & (lt.med[:, kl] == er.idx)
        seed_t1 = rng._hash_u32((smp.lane + rng.mul32(smp.seed, 0x85EBCA6B)
                                 + (s * 977 + 13)) & rng.M32)
        bvp1 = ek.solve_bvp(er.rif, er.sdf, yp, cam_pn, d_c, bvp_cfg[0],
                            bvp_cfg[1], y_er1, tol2=cfg.bvp_tol2,
                            rr_weight=cfg.rr_weight, seed_bits=seed_t1,
                            max_restarts=cfg.bvp_restarts)
        y_er1_ok = y_er1 & bvp1.converged
        d_c = _w3(y_er1, bvp1.dir_to_target, d_c)
        proj_p = _w3(y_er1, cam_pn + bvp1.rev_dir, yp)
        fs = sensor_m.project(scene.sensor, proj_p, W, H)
        ok = ok & fs.valid & (~y_er1 | y_er1_ok)
    else:
        fs = sensor_m.project(scene.sensor, yp, W, H)
        ok = ok & fs.valid
    if s == 1:
        # y_0 itself: its emitted radiance toward the camera over pdf_pos
        cos_y0 = torch.clamp_min(dot(d_c, light0.ng), 0.0)
        f_y = _w3(light0.is_area, light0.radiance * cos_y0.unsqueeze(-1),
                  0.0)
        beta_y = light0.inv_pdf_pos.unsqueeze(-1) * torch.ones((n, 3),
                                                               device=dev)
        ok = ok & light0.is_area & (cos_y0 > 0)
    else:
        f_y = _bsdf_f_at(scene, cfg, lt, kl, -lt.d_in[:, kl], d_c)
        beta_y = lt.beta[:, kl]
    y_is_med = lt.is_med[:, kl] if s >= 2 else F
    conn_med = _conn_medium(
        scene, y_is_med,
        lt.med[:, kl] if s >= 2 else torch.zeros((n,), dtype=torch.int64,
                                                 device=dev),
        lt.shape[:, kl] if s >= 2 else torch.full((n,), -1, device=dev),
        yng, d_c)
    tr_c, smp = attenuated_visibility(
        scene, eps, yp + d_c * eps, d_c, dist - 2 * eps, conn_med, smp,
        ok & ~y_er1, bricks=bricks, block_refractive=er is not None)
    geom_t1 = fs.inv_pixel_omega / d2
    if er is not None and s >= 2:
        tmp1 = torch.exp(-er.st[None, :] * bvp1.geo_inside.unsqueeze(-1))
        n_y1 = torch.clamp_min(ek.rif_value(er.rif, yp), 1e-6)
        tr_c = _w3(y_er1, tmp1 * ((1.0 / n_y1) ** 2
                                  * bvp1.weight).unsqueeze(-1), tr_c)
        g_tot2 = torch.clamp_min(bvp1.geo_total ** 2, 1e-9)
        geom_t1 = torch.where(y_er1, fs.inv_pixel_omega / g_tot2, geom_t1)
    ok = ok & torch.any(tr_c > 0, dim=-1)
    val = beta_y * f_y * tr_c * geom_t1.unsqueeze(-1)
    c_psucc, c_pfail = _seg_pdf_factors(scene, conn_med, dist)
    if er is not None and s >= 2:
        c_psucc = torch.where(y_er1, _mean3(er.st[None, :] * tmp1), c_psucc)
        c_pfail = torch.where(y_er1, _mean3(tmp1), c_pfail)
    # junction pdfs: y_{s-1} made again from the camera
    ov_lt = _to_area(fs.inv_pixel_omega, cam_pn, yp, yng,
                     is_med_to=y_is_med) * torch.where(y_is_med, c_psucc,
                                                       c_pfail)
    if er is not None and s >= 2:
        ov_lt = torch.where(y_er1, ov_lt * d2 / g_tot2, ov_lt)
    if s >= 3:
        if s == 3:
            prev_lp, prev_lng, prev_l_med = light0.p, light0.ng, F
        else:
            prev_lp, prev_lng = lt.p[:, kl - 1], lt.ng[:, kl - 1]
            prev_l_med = lt.is_med[:, kl - 1]
        pdf_y_back = _bsdf_pdf_at(scene, cfg, lt, kl, d_c, -lt.d_in[:, kl])
        ov_lt2 = _to_area(pdf_y_back, yp, prev_lp, prev_lng,
                          is_med_to=prev_l_med) * torch.where(
            prev_l_med, lt.seg_psucc[:, kl], lt.seg_pfail[:, kl])
    elif s == 2:
        # y_0 made again from y_1, whose incoming is now the camera
        # direction: the BSDF pdf at y_1 from d_c toward y_0
        pdf_y0 = _bsdf_pdf_at(scene, cfg, lt, 0, d_c,
                              normalize(light0.p - lt.p[:, 0]))
        ov_lt2 = _to_area(pdf_y0, lt.p[:, 0], light0.p, light0.ng)
    else:
        ov_lt2 = ones
    w = _mis_weight(cam, lt, light0, s, 1, ones, ones, ov_lt, ov_lt2,
                    rev_lt_origin, npix)
    conn_len1 = dist
    if er is not None and s >= 2:
        conn_len1 = torch.where(y_er1, bvp1.opt_len, dist)
    plen_tot = conn_len1 + (lt.plen[:, kl] if s >= 2 else 0.0)
    val = val * w.unsqueeze(-1)
    if mod_w is not None:
        val = val * mod_w(plen_tot).unsqueeze(-1)
    ok = ok & torch.all(torch.isfinite(val), dim=-1)
    val = _w3(ok, val, 0.0)
    pxi = torch.clamp(torch.nan_to_num(fs.px).to(torch.int64), 0, W - 1)
    pyi = torch.clamp(torch.nan_to_num(fs.py).to(torch.int64), 0, H - 1)
    pix = pyi * W + pxi
    nF = cfg.n_frames
    if nF == 1:
        return splat_img.index_add_(0, pix, val), smp
    fidx = torch.clamp(((plen_tot - cfg.min_bound) / cfg.bin_width
                        ).to(torch.int32), 0, nF - 1).to(torch.int64)
    splat_img.view(n, nF, 3).index_put_((pix, fidx), val, accumulate=True)
    return splat_img, smp


def render_bdpt(scene: Scene, cfg: RenderConfig, seed: int = 0,
                t_max: int | None = None, s_max: int | None = None,
                stats: dict | None = None):
    """The bidirectional render (bdpt.py:652-686) on the scene's device:
    spp passes of one sample a pixel; (H, W, 3F), eye / spp plus
    splat / (spp H W) (every light subpath can splat anywhere). t_max and
    s_max bound the camera and light vertices (min(max_depth, 8) + 2 each
    by default: the +2 slots absorb null-boundary crossings). If `stats`
    is a dict it gets "passes" (one [] a pass) and "bdpt_s", the passes'
    seconds."""
    H, W = cfg.height, cfg.width
    npix = H * W
    T_MAX = t_max or min(cfg.max_depth, 8) + 2
    S_MAX = s_max or min(cfg.max_depth, 8) + 2
    kinds = scene.media.kind
    any_het = bool((kinds == MED_HETEROGENEOUS).any())
    any_er = bool((kinds == MED_REFRACTIVE).any())
    dev = scene.aabb_min.device
    nF = cfg.n_frames
    eye = torch.zeros((npix, 3 * nF), dtype=torch.float32, device=dev)
    splat = torch.zeros((npix, 3 * nF), dtype=torch.float32, device=dev)
    if stats is not None:
        common.sync(dev)
        t0 = time.perf_counter()
    for i in range(cfg.spp):
        eye, splat = _bdpt_pass(scene, eye, splat, cfg, T_MAX, S_MAX, seed,
                                i, any_het=any_het, any_er=any_er)
    if stats is not None:
        common.sync(dev)
        stats.setdefault("passes", []).extend([[]] * cfg.spp)
        stats["bdpt_s"] = stats.get("bdpt_s", 0.0) + (
            time.perf_counter() - t0)
    img = eye / cfg.spp + splat / (cfg.spp * npix)
    return img.reshape(H, W, 3 * nF)
