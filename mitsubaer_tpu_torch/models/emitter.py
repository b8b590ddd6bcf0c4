"""Emitters (port of mitsubaer_tpu/models/emitter.py): direct sampling of
area, point, spot, directional and constant-environment emitters, area
emitter hits and the constant-environment terms.

Direct sampling picks an emitter uniformly, as Scene::sampleEmitterDirect
does (scene.cpp:812-850), then a point on it: an area emitter picks a
triangle from its segment of the area cdf table with the pick's remainder
and a uniform point on it. pdfs are solid-angle densities that include the
pick probability; a collimated beam gives zero (its NEE is the beam
family's). The environment map (EM_ENVMAP) is not ported (ROADMAP Queue 1
step 9): `check_supported`, which every road calls, raises on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import not_ported
from ..core import warp
from ..core.math import INV_FOURPI, dot, length
from ..scene.types import (EM_AREA, EM_COLLIMATED, EM_CONSTANT,
                           EM_DIRECTIONAL, EM_ENVMAP, EM_POINT, EM_SPOT,
                           Scene)

_BIG = 1.0e7   # distance to an emitter at infinity


@dataclass(frozen=True)
class DirectSample:
    d: torch.Tensor        # (N, 3) unit direction from the reference point
    dist: torch.Tensor     # (N,) distance to the emitter sample
    pdf: torch.Tensor      # (N,) pdf, with the emitter pick probability
    value: torch.Tensor    # (N, 3) radiance, or intensity / d^2, or E
    emitter: torch.Tensor  # (N,) int64
    delta: torch.Tensor    # (N,) bool (point, spot, directional, collimated)
    p: torch.Tensor        # (N, 3) emitter position
    n: torch.Tensor        # (N, 3) emitter normal at the sample (area), -d


def check_supported(scene: Scene) -> None:
    """Raise on an environment-map emitter."""
    if EM_ENVMAP in scene.emitters.kind.tolist():
        raise not_ported("the environment-map emitter (EM_ENVMAP)", 9)


def _sample_area_position(scene: Scene, e_idx, u2, u_tri):
    """A uniform point on area emitter e_idx: the first triangle of its
    segment whose cdf is >= u_tri (the segment's last where none is), then
    uniform barycentrics. Returns (p, n, pdf_area). The segments follow the
    emitters' order, so 2 emitter + cdf is sorted across the whole table
    (in float64, where the sum is exact)."""
    em = scene.emitters
    M = em.tri_cdf.shape[0]
    off = em.tri_offset[e_idx].to(torch.int64)
    end = off + em.tri_count[e_idx].to(torch.int64)
    key = em.tri_emitter.to(torch.float64) * 2.0 + em.tri_cdf.to(
        torch.float64)
    first = torch.searchsorted(key, e_idx.to(torch.float64) * 2.0
                               + u_tri.to(torch.float64))
    has = (first >= off) & (first < end)
    slot = torch.where(has, first, torch.clamp(end - 1, 0, M - 1))
    tri = em.tri_index[slot].to(torch.int64)
    geo = scene.geo
    b = warp.square_to_uniform_triangle(u2)
    p = geo.v0[tri] + b[..., 0:1] * geo.e1[tri] + b[..., 1:2] * geo.e2[tri]
    pdf_area = 1.0 / torch.clamp_min(em.area[e_idx], 1e-12)
    return p, geo.ng[tri], pdf_area


def sample_direct(scene: Scene, ref_p, u2, u_sel) -> DirectSample:
    """A direct connection from (N, 3) `ref_p` to one emitter: u_sel picks
    the emitter (and, with its remainder, an area emitter's triangle), u2
    the point on it or the environment's direction."""
    em = scene.emitters
    ne = em.kind.shape[0]
    e_idx = torch.clamp((u_sel * ne).to(torch.int64), 0, ne - 1)
    kind = em.kind[e_idx]
    radiance = em.radiance[e_idx]
    pos = em.position[e_idx]

    # point: intensity / d^2 toward it
    to_pt = pos - ref_p
    dist = length(to_pt)
    d = to_pt / torch.clamp_min(dist, 1e-12).unsqueeze(-1)
    value = radiance / torch.clamp_min(dist * dist, 1e-12).unsqueeze(-1)
    pdf = torch.ones_like(dist)
    # area: a triangle by the pick's remainder, a uniform point on it
    u_tri = torch.clamp_max(u_sel * ne - e_idx, 0.9999994)
    p_a, n_a, pdf_area = _sample_area_position(scene, e_idx, u2, u_tri)
    to_p = p_a - ref_p
    dist_a = length(to_p)
    d_a = to_p / torch.clamp_min(dist_a, 1e-12).unsqueeze(-1)
    cos_l = -dot(d_a, n_a)
    is_area = kind == EM_AREA
    # area pdf to solid angle: pdf_A d^2 / cos
    pdf = torch.where(is_area, torch.where(
        cos_l > 1e-6, pdf_area * dist_a * dist_a
        / torch.clamp_min(cos_l, 1e-6), 0.0), pdf)
    value = torch.where(is_area.unsqueeze(-1), torch.where(
        (cos_l > 1e-6).unsqueeze(-1), radiance, 0.0), value)
    d = torch.where(is_area.unsqueeze(-1), d_a, d)
    dist = torch.where(is_area, dist_a, dist)
    p = torch.where(is_area.unsqueeze(-1), p_a, pos)
    # spot.cpp: the point's value times the beam falloff
    edir = em.direction[e_idx]
    cutoff = em.cutoff_cos[e_idx]
    falloff = torch.clamp(
        (dot(-d, edir) - cutoff)
        / torch.clamp_min(em.beam_falloff_cos[e_idx] - cutoff, 1e-6),
        0.0, 1.0)
    value = torch.where((kind == EM_SPOT).unsqueeze(-1),
                        value * falloff.unsqueeze(-1), value)
    # directional: from -direction at infinity; the value is the irradiance
    is_dir = kind == EM_DIRECTIONAL
    d = torch.where(is_dir.unsqueeze(-1), -em.direction[e_idx], d)
    value = torch.where(is_dir.unsqueeze(-1), radiance, value)
    is_const = kind == EM_CONSTANT
    d = torch.where(is_const.unsqueeze(-1),
                    warp.square_to_uniform_sphere(u2), d)
    value = torch.where(is_const.unsqueeze(-1), radiance, value)
    pdf = torch.where(is_const, INV_FOURPI, pdf)
    dist = torch.where(is_dir | is_const, _BIG, dist)
    value = torch.where((kind == EM_COLLIMATED).unsqueeze(-1), 0.0, value)
    return DirectSample(
        d=d, dist=dist, pdf=pdf * (1.0 / ne), value=value, emitter=e_idx,
        delta=((kind == EM_POINT) | (kind == EM_SPOT)
               | (kind == EM_DIRECTIONAL) | (kind == EM_COLLIMATED)),
        p=p, n=torch.where(is_area.unsqueeze(-1), n_a, -d))


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
