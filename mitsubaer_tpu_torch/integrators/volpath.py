"""Shadow transmittance and collimated-beam helpers of the volumetric path
tracer (port of the parts of mitsubaer_tpu/integrators/volpath.py that the
boxwalk road uses). The loop engine's `li` is not ported yet (ROADMAP Queue 1
step 4).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.math import dot, length
from ..models import medium as medium_m
from ..scene import intersect as isect
from ..scene.types import (BSDF_NULL, EM_COLLIMATED, MED_HETEROGENEOUS,
                           MED_HOMOGENEOUS, Scene)


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
                          bricks=None):
    """Transmittance of straight segments inside medium `medium_idx` (-1 is
    vacuum): analytic when homogeneous, ratio tracking when heterogeneous."""
    media = scene.media
    kind, sa, ss, scale = medium_m.params(media, medium_idx)
    tr = torch.ones((o.shape[0], 3), dtype=torch.float32, device=o.device)
    hom = active & (kind == MED_HOMOGENEOUS)
    tr_h = medium_m.eval_transmittance_homogeneous(sa, ss, dist)
    tr = torch.where(hom.unsqueeze(-1), tr_h, tr)
    het = active & (kind == MED_HETEROGENEOUS)
    tr_r, smp = medium_m.transmittance_ratio_tracking(
        media, sa, ss, scale, o, d, dist, smp, het, bricks=bricks)
    return torch.where(het.unsqueeze(-1), tr_r, tr), smp


def attenuated_visibility(scene: Scene, eps, o, d, dist, medium_idx, smp,
                          active, max_crossings: int = 4, bricks=None):
    """Transmittance along shadow segments, walking through null medium
    boundaries (Scene::evalTransmittanceAll); opaque surfaces give 0."""
    n = o.shape[0]
    cur_o, remaining, med = o, dist, medium_idx
    tr = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    running = active
    it = 0
    while it < max_crossings and bool(running.any()):
        hit = isect.intersect(scene.geo, cur_o, d, eps * 0.5, remaining - eps)
        seg = torch.where(hit.valid, hit.t, remaining)
        tr_seg, smp = segment_transmittance(scene, med, cur_o, d, seg, smp,
                                            running, bricks=bricks)
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
        it += 1
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
    row i = [tau_rgb(s_i), tau_rgb(s_i+1) - tau_rgb(s_i), density(s_i)*scale, 0]."""
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
