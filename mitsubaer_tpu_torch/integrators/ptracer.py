"""The adjoint particle tracer: light tracing with a camera connection at
every vertex (port of mitsubaer_tpu/integrators/ptracer.py; the
reference's ptracer, ptracer_proc.cpp).

Particles start at the emitters (`sample_emitter_ray`, also the eikonal
light image's start), walk the scene, and join every vertex to the
camera, splatting importance-weighted radiance onto the film: the
(s >= 1, t = 1) light-image family of bdpt. `trace_particles` advances a
fixed wavefront of particles a bounce at a time from the host, one device
sync a bounce (JAX's while loop over bounces: dead particles stay masked
lanes); the camera connections walk `volpath.attenuated_visibility` (ratio
tracking through kernel A in a heterogeneous medium) and land through one
index_add_ a bounce, in a varying order on CUDA. `render_ptracer` traces
H W particles a pass, spp passes, and divides the summed film by the
particles traced.
"""
from __future__ import annotations

import math
import time

import torch

from ..core import rng, warp
from ..core.math import Frame, dot, normalize
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import (EM_AREA, EM_COLLIMATED, EM_CONSTANT,
                           EM_DIRECTIONAL, EM_ENVMAP, EM_SPOT,
                           MED_HETEROGENEOUS, MED_HOMOGENEOUS, RenderConfig,
                           Scene)
from . import common
from .volpath import _is_null_surface, _shape_tables, attenuated_visibility


def _w3(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def sample_emitter_ray(scene: Scene, smp: rng.Sampler):
    """Pick an emitter uniformly and sample an emission ray (the reference's
    Scene::sampleEmitterRay). Draws u_sel (1D), u_pos (2D) and u_dir (2D)
    on every lane, whatever the emitter, as the JAX function does. Returns
    (o, d, power weight (N, 3), medium (N,), smp, emitter index, kind): the
    weight is emitted power over pdf, so that a splat of weight * f * W_e
    summed over Np particles and divided by Np is unbiased, times the
    number of emitters (the uniform pick).
    - area: a uniform point (the pick's remainder picks the triangle),
      a cosine-weighted direction about its normal; weight L pi A; starts
      in the shape's exterior medium;
    - point: the uniform sphere, weight I 4 pi;
    - spot: the cutoff cone uniformly, weight I falloff times the cone's
      solid angle;
    - collimated: along its direction, its power as the weight;
    - directional, constant, environment map: from a disk of the scene's
      bounding sphere facing the direction of travel (the directional's
      own, the uniform sphere's or the map's importance sample), weights
      E pi R^2, L 4 pi^2 R^2 and L pi R^2 / pdf.
    Every kind but area starts in the camera's medium."""
    o, d, w, med, smp, e_idx, kind, _ = _emitter_ray(scene, smp)
    return o, d, w, med, smp, e_idx, kind


def _emitter_ray(scene: Scene, smp: rng.Sampler):
    """sample_emitter_ray's values and the sampled area position's
    normal."""
    em = scene.emitters
    ne = em.kind.shape[0]
    u_sel, smp = rng.next_1d(smp)
    u_pos, smp = rng.next_2d(smp)
    u_dir, smp = rng.next_2d(smp)
    n = u_sel.shape[0]
    e_idx = torch.clamp((u_sel * ne).to(torch.int64), 0, ne - 1)
    u_tri = torch.clamp_max(u_sel * ne - e_idx, 0.9999994)
    kind = em.kind[e_idx]
    radiance = em.radiance[e_idx]
    pos = em.position[e_idx]
    edir = em.direction[e_idx]

    # area: L pi A (the cosine and its pdf cancel)
    p_area, n_area, _ = emitter_m._sample_area_position(scene, e_idx, u_pos,
                                                        u_tri)
    d_cos = Frame.from_normal(n_area).to_world(
        warp.square_to_cosine_hemisphere(u_dir))
    w_area = radiance * (math.pi * em.area[e_idx]).unsqueeze(-1)
    # point: I 4 pi
    d_sph = warp.square_to_uniform_sphere(u_dir)
    w_point = radiance * (4.0 * math.pi)
    # spot: the cone uniformly, falloff times its solid angle
    cutoff = em.cutoff_cos[e_idx]
    beam = em.beam_falloff_cos[e_idx]
    ct_cone = 1.0 - u_dir[..., 0] * (1.0 - cutoff)
    st_cone = torch.sqrt(torch.clamp_min(1.0 - ct_cone * ct_cone, 0.0))
    phi = 2.0 * math.pi * u_dir[..., 1]
    d_cone = Frame.from_normal(edir).to_world(torch.stack(
        [st_cone * torch.cos(phi), st_cone * torch.sin(phi), ct_cone], -1))
    falloff = torch.clamp((ct_cone - cutoff)
                          / torch.clamp_min(beam - cutoff, 1e-6), 0.0, 1.0)
    w_spot = radiance * (falloff * (2.0 * math.pi * (1.0 - cutoff))
                         ).unsqueeze(-1)

    is_area = kind == EM_AREA
    is_spot = kind == EM_SPOT
    is_dir = kind == EM_DIRECTIONAL
    is_const = kind == EM_CONSTANT
    is_env = kind == EM_ENVMAP
    # distant emitters (constant.cpp / envmap.cpp sampleRay): a direction
    # of travel de, then a uniform point of the bounding sphere's disk
    # facing it, pushed back outside the sphere
    center = 0.5 * (scene.aabb_min + scene.aabb_max)
    R = 0.5 * torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min) * 1.01
    if emitter_m._has_envmap(scene):
        d_env, pdf_env, L_env = emitter_m.sample_env_direction(scene, u_pos)
    else:
        d_env, pdf_env, L_env = d_sph, torch.ones_like(u_sel), radiance
    de = _w3(is_dir, edir, _w3(is_env, -d_env, -d_sph))
    disk2 = warp.square_to_uniform_disk_concentric(u_dir)
    p_disk = (center - de * R + Frame.from_normal(de).to_world(torch.cat(
        [disk2 * R, torch.zeros_like(disk2[..., :1])], dim=-1)))
    disk_area = math.pi * R * R
    w_dir = radiance * disk_area
    w_const = radiance * (4.0 * math.pi * disk_area)
    w_env = L_env * (disk_area / torch.clamp_min(pdf_env, 1e-12)
                     ).unsqueeze(-1)

    distant = is_dir | is_const | is_env
    is_coll = kind == EM_COLLIMATED
    o = _w3(distant, p_disk, _w3(is_area, p_area, pos))
    d = _w3(is_spot, d_cone, _w3(is_area, d_cos, d_sph))
    d = _w3(is_coll, edir, _w3(distant, de, d))
    w = _w3(is_spot, w_spot, _w3(is_area, w_area, w_point))
    w = _w3(is_coll, radiance, w)
    w = _w3(is_env, w_env, _w3(is_const, w_const, _w3(is_dir, w_dir, w)))
    w = w * float(ne)
    se = em.shape_id[e_idx].to(torch.int64)
    ext = scene.shapes.exterior
    med_area = torch.where(se >= 0, ext[torch.clamp(se, 0, ext.shape[0] - 1)],
                           -1)
    med = torch.where(is_area, med_area,
                      scene.camera_medium.to(med_area.dtype).expand(n))
    return o, d, w, med, smp, e_idx, kind, n_area


def _connect(scene: Scene, cfg: RenderConfig, film, vtx, f_vtx, tp, med_v,
             smp, ok, eps, bricks):
    """Join vertices to the camera and splat tp f Tr W_e / d^2 at their
    pixels (ptracer.py:148-169); W_e = inv_pixel_omega turns the
    connection into the pixel's mean radiance."""
    H, W = cfg.height, cfg.width
    to_c = scene.sensor.to_world[:3, 3] - vtx
    dist = torch.sqrt(torch.clamp_min(torch.sum(to_c * to_c, -1), 1e-12))
    d_c = to_c / dist.unsqueeze(-1)
    fs = sensor_m.project(scene.sensor, vtx, W, H)
    ok = ok & fs.valid
    tr, smp = attenuated_visibility(scene, eps, vtx + d_c * eps, d_c,
                                    dist - 2 * eps, med_v, smp, ok,
                                    bricks=bricks)
    val = tp * f_vtx * tr * (fs.inv_pixel_omega / torch.clamp_min(
        dist * dist, 1e-12)).unsqueeze(-1)
    ok = ok & torch.all(torch.isfinite(val), dim=-1)
    val = torch.where(ok.unsqueeze(-1), val, 0.0)
    px = torch.clamp(torch.nan_to_num(fs.px).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.nan_to_num(fs.py).to(torch.int64), 0, H - 1)
    film.index_add_(0, py * W + px, val)
    return smp


def trace_particles(scene: Scene, cfg: RenderConfig, n_particles: int,
                    seed: int, pass_idx: int):
    """One wavefront of n_particles light particles (ptracer.py:128-262);
    returns the (H W, 3) splat sum (the film is it over the particles
    traced). The emission vertex of an area emitter connects first (the
    (s = 1, t = 1) strategy, its kernel cos / pi toward the camera); then
    every bounce intersects, samples a medium distance (analytic when
    homogeneous, Woodcock tracking through kernel A when heterogeneous),
    connects the medium or non-null surface vertex to the camera, samples
    the phase function or the BSDF (null surfaces pass straight through)
    and plays roulette, while some particle lives and fewer than
    cfg.max_depth bounces have run."""
    H, W = cfg.height, cfg.width
    n = n_particles
    dev = scene.aabb_min.device
    eps = common.scene_epsilon(scene)
    media = scene.media
    bricks = medium_m.DensityGrid(media)
    cam_p = scene.sensor.to_world[:3, 3]
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed ^ 0x97AC, lane, pass_idx)
    o, d, tp, med, smp, e_idx, _, n_e = _emitter_ray(scene, smp)
    is_area_e = scene.emitters.kind[e_idx] == EM_AREA
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    alive = torch.any(tp > 0, dim=-1)

    # the emission vertex itself, seen by the camera: with tp = L pi A the
    # emitted kernel toward the camera is cos / pi
    cos_e = torch.clamp_min(dot(n_e, normalize(cam_p.expand(n, 3) - o)), 0.0)
    f_emit = (cos_e / math.pi).unsqueeze(-1).expand(n, 3)
    smp = _connect(scene, cfg, film, o + n_e * eps, f_emit, tp, med, smp,
                   alive & is_area_e & (cos_e > 0), eps, bricks)

    depth = 0
    while depth < cfg.max_depth and bool(alive.any()):
        hit = isect.intersect(scene.geo, o, d, eps.expand(n), isect.INF)
        _, t_scene = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
        t_far = torch.where(hit.valid, hit.t, torch.clamp_min(t_scene, 0.0))

        # medium transport along the segment
        kind_m, sa, ss, sw, scale = medium_m.params(media, med,
                                                    sampling_weight=True)
        u_h, smp = rng.next_1d(smp)
        uc_h, smp = rng.next_1d(smp)
        hs, ht, hw, _ = medium_m.sample_distance_homogeneous(
            sa, ss, sw, t_far, u_h, uc_h)
        in_hom = alive & (kind_m == MED_HOMOGENEOUS)
        in_het = alive & (kind_m == MED_HETEROGENEOUS)
        whit, wdist, ww, _, smp, _, _ = medium_m.sample_distance_woodcock(
            media, sa, ss, scale, o, d, t_far, smp, in_het, bricks=bricks)
        scattered = (in_hom & hs) | (in_het & whit)
        m_t = torch.where(in_het, wdist, ht)
        m_w = torch.where(in_het.unsqueeze(-1), ww,
                          torch.where(in_hom.unsqueeze(-1), hw, 1.0))
        tp = tp * torch.where(alive.unsqueeze(-1), m_w, 1.0)
        m_p = o + m_t.unsqueeze(-1) * d

        on_surface = alive & ~scattered & hit.valid
        escaped = alive & ~scattered & ~hit.valid
        vtx = torch.where(scattered.unsqueeze(-1), m_p, hit.p)
        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        frame = Frame.from_normal(hit.ng)
        wi_srf = frame.to_local(-d)

        # the camera connection at this vertex
        to_c = normalize(cam_p - vtx)
        f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, frame.to_local(to_c),
                            active=act)
        f_med = phase_m.eval(media.phase, med, d, to_c, active=pact)
        f_vtx = torch.where(scattered.unsqueeze(-1), f_med.unsqueeze(-1),
                            f_srf)
        ok = ((scattered | (on_surface & ~is_null))
              & torch.any(f_vtx > 0, dim=-1))
        med_v = torch.where(scattered, med,
                            torch.where(dot(to_c, hit.ng) > 0, m_ex, m_in))
        smp = _connect(scene, cfg, film, vtx, f_vtx, tp, med_v, smp, ok, eps,
                       bricks)

        # the walk goes on
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        ps = phase_m.sample(media.phase, med, d, u2, active=pact)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u2, u1, active=act)
        new_d = torch.where(scattered.unsqueeze(-1), ps.wo,
                            frame.to_world(bs.wo))
        w_scat = torch.where(scattered.unsqueeze(-1),
                             ps.weight.unsqueeze(-1), bs.weight)
        null_cross = on_surface & is_null
        new_d = torch.where(null_cross.unsqueeze(-1), d, new_d)
        w_scat = torch.where(null_cross.unsqueeze(-1), 1.0, w_scat)
        cos_new = dot(new_d, hit.ng)
        cross = on_surface & (is_null | (cos_new * dot(-d, hit.ng) < 0))
        med = torch.where(cross, torch.where(cos_new < 0, m_in, m_ex), med)

        tp = tp * torch.where((scattered | on_surface).unsqueeze(-1), w_scat,
                              1.0)
        u_rr, smp = rng.next_1d(smp)
        tp_rr, survive = common.russian_roulette(
            tp, torch.ones((n,), device=dev), u_rr,
            torch.full((n,), depth, dtype=torch.int32, device=dev), cfg)
        tp = torch.where(null_cross.unsqueeze(-1), tp, tp_rr)
        alive = ((scattered | on_surface) & ~escaped
                 & torch.any(tp > 0, dim=-1) & (survive | null_cross))
        o = vtx + new_d * eps
        d = torch.where(alive.unsqueeze(-1), new_d, d)
        depth += 1
    return film


def render_ptracer(scene: Scene, cfg: RenderConfig, seed: int = 0,
                   stats: dict | None = None):
    """The light-traced image (ptracer.py:265-302): spp passes of H W
    particles, the film summed and divided by the particles traced; an
    (H, W, 3) image on the scene's device. If `stats` is a dict it gets
    "passes" (one [] a pass) and "ptracer_s", the passes' seconds."""
    H, W = cfg.height, cfg.width
    n_pass = max(cfg.spp, 1)
    dev = scene.aabb_min.device
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    if stats is not None:
        common.sync(dev)
        t0 = time.perf_counter()
    for i in range(n_pass):
        film = film + trace_particles(scene, cfg, H * W, seed, i)
    if stats is not None:
        common.sync(dev)
        stats.setdefault("passes", []).extend([[]] * n_pass)
        stats["ptracer_s"] = stats.get("ptracer_s", 0.0) + (
            time.perf_counter() - t0)
    return (film / float(n_pass * H * W)).reshape(H, W, 3)
