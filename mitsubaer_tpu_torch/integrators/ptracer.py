"""Emission-ray sampling of the light tracer (port of
mitsubaer_tpu/integrators/ptracer.py::_sample_emitter_ray, its point and
collimated branches), for the eikonal light image
(`volpath_er.trace_er_particles`). The tracer itself, `trace_particles`, is
ROADMAP Queue 1 step 12; the area, spot, directional, constant and
environment emitters' branches are step 9 and raise.
"""
from __future__ import annotations

import math

import torch

from .. import not_ported
from ..core import rng, warp
from ..scene.types import EM_COLLIMATED, EM_POINT, Scene

_KINDS = {EM_POINT, EM_COLLIMATED}


def check_supported(scene: Scene) -> None:
    """Raise unless every emitter is a point or a collimated one."""
    kinds = set(scene.emitters.kind.tolist()) - _KINDS
    if kinds:
        raise not_ported(f"emission rays of emitter kinds {sorted(kinds)}",
                         9)


def sample_emitter_ray(scene: Scene, smp: rng.Sampler):
    """Pick an emitter uniformly and sample an emission ray (the reference's
    Scene::sampleEmitterRay). Draws u_sel (1D), u_pos (2D) and u_dir (2D)
    on every lane, whatever the emitter, as the JAX function does. Returns
    (o, d, power weight (N, 3), medium (N,), smp, emitter index, kind): the
    weight is emitted power over pdf, so that a splat of weight * f * W_e
    summed over Np particles and divided by Np is unbiased. A point emitter
    emits uniformly over the sphere with weight I 4 pi; a collimated beam
    along its direction with its power as the weight; both times the
    number of emitters (the uniform pick). Emission starts in the camera's
    medium."""
    check_supported(scene)
    em = scene.emitters
    ne = em.kind.shape[0]
    u_sel, smp = rng.next_1d(smp)
    _, smp = rng.next_2d(smp)           # u_pos: area emitters' position
    u_dir, smp = rng.next_2d(smp)
    n = u_sel.shape[0]
    e_idx = torch.clamp((u_sel * ne).to(torch.int64), 0, ne - 1)
    kind = em.kind[e_idx]
    radiance = em.radiance[e_idx]
    is_coll = (kind == EM_COLLIMATED).unsqueeze(-1)
    d = torch.where(is_coll, em.direction[e_idx],
                    warp.square_to_uniform_sphere(u_dir))
    w = torch.where(is_coll, radiance, radiance * (4.0 * math.pi))
    w = w * float(ne)
    med = scene.camera_medium.to(torch.int32).expand(n)
    return em.position[e_idx], d, w, med, smp, e_idx, kind
