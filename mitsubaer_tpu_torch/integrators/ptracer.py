"""Emission-ray sampling of the light tracer (port of
mitsubaer_tpu/integrators/ptracer.py::_sample_emitter_ray), for the
eikonal light image (`volpath_er.trace_er_particles`). The tracer itself,
`trace_particles`, is ROADMAP Queue 1 step 12.
"""
from __future__ import annotations

import math

import torch

from ..core import rng, warp
from ..core.math import Frame
from ..models import emitter as emitter_m
from ..scene.types import (EM_AREA, EM_COLLIMATED, EM_CONSTANT,
                           EM_DIRECTIONAL, EM_ENVMAP, EM_SPOT, Scene)


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
    return o, d, w, med, smp, e_idx, kind
