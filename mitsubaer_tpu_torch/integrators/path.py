"""Surface path tracer with next-event estimation and MIS (port of
mitsubaer_tpu/integrators/path.py, the reference's MIPathTracer,
path.cpp): emitter hits weighted against direct sampling, NEE against
BSDF sampling with the power heuristic, and roulette scaled by the
refraction's eta^2. Media are not read.

`li` advances every lane a bounce at a time, as the JAX `li`'s while loop
does, from the host: one `body` a bounce while some lane is active, one
device sync a bounce. A bounce draws NEE's 2D and 1D numbers, the BSDF's
2D and 1D, then roulette's, on every lane. Textures and normal or bump
maps are read where the config says the scene has them
(cfg.has_textures, cfg.has_normal_tex), and only the lobes of the scene's
BSDF kinds run (cfg.bsdf_kinds). Each lane carries its path length and
depth into the sink (common.Sink), for transient, bounce and CW-ToF
films.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng
from ..core.math import Frame, mis_weight_power, normalize
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import texture as texture_m
from ..scene import intersect as isect
from ..scene.types import RenderConfig, Scene
from ..utils import stats as stats_m
from . import common


@dataclass(frozen=True)
class State:
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    sink: common.Sink
    active: torch.Tensor
    depth: torch.Tensor        # starts at 1
    plen: torch.Tensor         # path length so far
    eta_scale: torch.Tensor
    last_pdf: torch.Tensor     # pdf of the previous BSDF sample
    last_delta: torch.Tensor   # the previous bounce was a delta lobe
    sampler: rng.Sampler


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def body(scene: Scene, cfg: RenderConfig, s: State, eps) -> State:
    """One bounce of every lane (path.py:62-159)."""
    n = s.o.shape[0]
    smp = s.sampler
    hit = isect.intersect(scene.geo, s.o, s.d, eps.expand(n), isect.INF,
                          need_uv=cfg.has_textures)
    hide = (s.depth == 1) if cfg.hide_emitters else torch.zeros_like(
        s.active)
    plen_at_hit = s.plen + torch.where(hit.valid, hit.t, 0.0)

    # escaped rays: the environment
    escaped = s.active & ~hit.valid
    env = emitter_m.env_radiance(scene, s.d)
    env_pdf = emitter_m.pdf_direct_env(scene, s.d)
    w_env = torch.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf,
                                                            env_pdf))
    sink = common.add_contribution(
        s.sink, cfg, s.throughput * env * w_env.unsqueeze(-1), s.plen,
        s.depth, escaped & ~hide)

    # emitter hits
    sh = scene.shapes
    sid = torch.clamp(hit.shape_id, 0, sh.emitter.shape[0] - 1)
    ok_s = hit.shape_id >= 0
    shape_em = torch.where(ok_s, sh.emitter[sid], -1)
    le = emitter_m.eval_hit(scene, shape_em, hit.ng, -s.d)
    lum_pdf = emitter_m.pdf_direct_hit(scene, shape_em, s.o, hit.p, hit.ng)
    w_hit = torch.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf,
                                                            lum_pdf))
    sink = common.add_contribution(
        sink, cfg, s.throughput * le * w_hit.unsqueeze(-1), plen_at_hit,
        s.depth, s.active & hit.valid & (shape_em >= 0) & ~hide)

    active = s.active & hit.valid & (s.depth < cfg.max_depth)

    # the local frame; a normal or bump map tilts it in the uv frame
    b_idx = torch.where(ok_s, sh.bsdf[sid], -1)
    frame = Frame.from_normal(hit.ng)
    n_pert = texture_m.shading_normal(scene, b_idx, hit.tex_uv,
                                      enabled=cfg.has_normal_tex)
    if n_pert is not None:
        frame = Frame.from_normal(normalize(
            texture_m.uv_tangent_frame(scene, hit).to_world(n_pert)))
    wi = frame.to_local(-s.d)
    act = cfg.bsdf_kinds or None
    rscale = texture_m.bsdf_refl_scale(scene, b_idx, hit.tex_uv, hit.uv,
                                       enabled=cfg.has_textures)

    # next-event estimation
    u2, smp = rng.next_2d(smp)
    u1, smp = rng.next_1d(smp)
    ds = emitter_m.sample_direct(scene, hit.p, u2, u1)
    wo_local = frame.to_local(ds.d)
    f_nee = bsdf_m.eval(scene.bsdfs, b_idx, wi, wo_local, refl_scale=rscale,
                        active=act)
    pdf_dir = bsdf_m.pdf(scene.bsdfs, b_idx, wi, wo_local, refl_scale=rscale,
                         active=act)
    vis_needed = active & (ds.pdf > 0) & torch.any(f_nee > 0, dim=-1)
    blocked = isect.occluded(scene.geo, hit.p + ds.d * eps, ds.d,
                             (eps * 0.1).expand(n), ds.dist - 2 * eps)
    w_nee = torch.where(ds.delta, 1.0, mis_weight_power(ds.pdf, pdf_dir))
    sink = common.add_contribution(
        sink, cfg, s.throughput * f_nee * ds.value
        * (w_nee / torch.clamp_min(ds.pdf, 1e-12)).unsqueeze(-1),
        plen_at_hit + ds.dist, s.depth + 1, vis_needed & ~blocked)

    # BSDF sampling
    u2b, smp = rng.next_2d(smp)
    u1b, smp = rng.next_1d(smp)
    bs = bsdf_m.sample(scene.bsdfs, b_idx, wi, u2b, u1b, refl_scale=rscale,
                       active=act)
    wo_world = frame.to_world(bs.wo)
    throughput = s.throughput * bs.weight
    active = active & ~torch.all(throughput <= 0, dim=-1)

    # Russian roulette, eta-aware
    eta_scale = s.eta_scale * bs.eta
    u_rr, smp = rng.next_1d(smp)
    throughput, survive = common.russian_roulette(throughput, eta_scale,
                                                  u_rr, s.depth, cfg)
    active = active & survive
    return State(
        o=_w3(active, hit.p + wo_world * eps, s.o),
        d=_w3(active, wo_world, s.d),
        throughput=_w3(active, throughput, s.throughput), sink=sink,
        active=active, depth=torch.where(active, s.depth + 1, s.depth),
        plen=torch.where(active, plen_at_hit, s.plen),
        eta_scale=torch.where(active, eta_scale, s.eta_scale),
        last_pdf=torch.where(active, bs.pdf, s.last_pdf),
        last_delta=torch.where(active, bs.delta, s.last_delta),
        sampler=smp)


def li(scene: Scene, cfg: RenderConfig, o, d, sampler: rng.Sampler,
       pixel=None):
    """Radiance along the (N, 3) rays (o, d). Returns the sink
    (common.Sink), the sampler after the last bounce and [bounces].
    `pixel` is each lane's pixel, which a film with frames needs."""
    n = o.shape[0]
    dev = o.device
    s = State(
        o=o, d=d, throughput=torch.ones((n, 3), device=dev),
        sink=common.new_sink(cfg, n, pixel, dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.ones((n,), dtype=torch.int32, device=dev),
        plen=torch.zeros((n,), device=dev),
        eta_scale=torch.ones((n,), device=dev),
        last_pdf=torch.zeros((n,), device=dev),
        last_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        sampler=sampler)
    eps = common.scene_epsilon(scene)
    bounces = 0
    # while tracing, the same one read counts the active lanes
    read = stats_m.count_of if stats_m.on() else stats_m.any_of
    while live := stats_m.host_read("path.bounce", read, s.active):
        with stats_m.span("path.bounce", lanes=n, active=int(live)):
            s = body(scene, cfg, s, eps)
        bounces += 1
    return s.sink, s.sampler, [bounces]
