"""Emitters (port of mitsubaer_tpu/models/emitter.py): direct sampling of
point and constant-environment emitters, area-emitter hits and the
constant-environment terms.

Direct sampling picks an emitter uniformly, as Scene::sampleEmitterDirect
does (scene.cpp:812-850); pdfs include that pick probability, and a
collimated beam gives zero (its NEE is the beam family's). Area, spot,
directional and map environment emitters are not ported (ROADMAP Queue 1
step 9): `check_supported`, which the eikonal pass calls, raises on every
kind but the point emitter.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import not_ported
from ..core import warp
from ..core.math import INV_FOURPI, dot, length
from ..scene.types import EM_AREA, EM_COLLIMATED, EM_CONSTANT, EM_POINT, Scene

_BIG = 1.0e7   # distance to an emitter at infinity


@dataclass(frozen=True)
class DirectSample:
    d: torch.Tensor        # (N, 3) unit direction from the reference point
    dist: torch.Tensor     # (N,) distance to the emitter sample
    pdf: torch.Tensor      # (N,) pdf, with the emitter pick probability
    value: torch.Tensor    # (N, 3) intensity / d^2
    emitter: torch.Tensor  # (N,) int64
    delta: torch.Tensor    # (N,) bool
    p: torch.Tensor        # (N, 3) emitter position
    n: torch.Tensor        # (N, 3) -d


def check_supported(scene: Scene) -> None:
    """Raise unless every emitter is a point emitter."""
    kinds = set(scene.emitters.kind.tolist())
    if kinds - {EM_POINT}:
        raise not_ported(f"direct sampling of emitter kinds "
                         f"{sorted(kinds - {EM_POINT})}", 9)


def sample_direct(scene: Scene, ref_p, u2, u_sel) -> DirectSample:
    """A direct connection from (N, 3) `ref_p` to one emitter: u_sel picks
    the emitter; a point emitter gives I / d^2 toward it, a constant
    environment a uniform direction u2 at distance _BIG, a collimated beam
    zero."""
    em = scene.emitters
    ne = em.kind.shape[0]
    e_idx = torch.clamp((u_sel * ne).to(torch.int64), 0, ne - 1)
    kind = em.kind[e_idx]
    radiance = em.radiance[e_idx]
    to_pt = em.position[e_idx] - ref_p
    dist = length(to_pt)
    d = to_pt / torch.clamp_min(dist, 1e-12).unsqueeze(-1)
    value = radiance / torch.clamp_min(dist * dist, 1e-12).unsqueeze(-1)
    is_const = kind == EM_CONSTANT
    d = torch.where(is_const.unsqueeze(-1), warp.square_to_uniform_sphere(u2),
                    d)
    dist = torch.where(is_const, _BIG, dist)
    value = torch.where(is_const.unsqueeze(-1), radiance, value)
    value = torch.where((kind == EM_COLLIMATED).unsqueeze(-1), 0.0, value)
    pdf = torch.where(is_const, INV_FOURPI, 1.0) * (1.0 / ne)
    return DirectSample(
        d=d, dist=dist, pdf=pdf, value=value, emitter=e_idx,
        delta=(kind == EM_POINT) | (kind == EM_COLLIMATED),
        p=em.position[e_idx], n=-d)


def eval_hit(scene: Scene, emitter_id, ng, wi_world):
    """Radiance of an area emitter seen from wi_world (pointing away from
    the surface); zero on the back side and off emitters."""
    em = scene.emitters
    e = torch.clamp(emitter_id, 0, em.kind.shape[0] - 1).to(torch.int64)
    ok = (em.kind[e] == EM_AREA) & (dot(wi_world, ng) > 0) & (emitter_id >= 0)
    return torch.where(ok.unsqueeze(-1), em.radiance[e], 0.0)


def pdf_direct_hit(scene: Scene, emitter_id, ref_p, p, ng):
    """Solid-angle pdf of direct-sampling the point p of area emitter
    `emitter_id` from ref_p (MIS of BSDF-sampled emitter hits)."""
    em = scene.emitters
    ne = em.kind.shape[0]
    e = torch.clamp(emitter_id, 0, ne - 1).to(torch.int64)
    to_p = p - ref_p
    d2 = dot(to_p, to_p)
    cos_l = -dot(to_p, ng) / torch.sqrt(torch.clamp_min(d2, 1e-20))
    pdf = torch.where(
        cos_l > 1e-6,
        d2 / (torch.clamp_min(cos_l, 1e-6)
              * torch.clamp_min(em.area[e], 1e-12)), 0.0)
    return pdf / ne


def env_radiance(scene: Scene, d_world):
    """Radiance of constant environment emitters for escaped rays."""
    em = scene.emitters
    total = torch.where((em.kind == EM_CONSTANT).unsqueeze(-1), em.radiance,
                        0.0).sum(0)
    return total.expand(d_world.shape)


def pdf_direct_env(scene: Scene, d_world):
    em = scene.emitters
    ne = em.kind.shape[0]
    has_const = (em.kind == EM_CONSTANT).any()
    return torch.where(has_const, INV_FOURPI / ne, 0.0).expand(
        d_world.shape[:-1])
