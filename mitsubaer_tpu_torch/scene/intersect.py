"""Ray-scene intersection (port of mitsubaer_tpu/scene/intersect.py).

Below the scene builder's BVH threshold (512 triangles, scene/build.py)
every triangle is tested: the JAX package's per-triangle Moller-Trumbore
loop becomes (N, _CHUNK) broadcasts with the same component arithmetic,
chunk after chunk; ties go to the lower triangle index in both. A scene
with a BVH walks it (scene/bvh.py). Spheres are analytic. `need_uv` adds
the interpolated texture coordinates of the hit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.math import normalize
from ..utils import stats
from . import bvh as bvh_m
from .types import Geometry

INF = 3.0e38
SPHERE_FLAG = 1 << 30


@dataclass(frozen=True)
class Hit:
    t: torch.Tensor         # (N,) distance, INF on a miss
    valid: torch.Tensor     # (N,) bool
    prim: torch.Tensor      # (N,) triangle id, or sphere id | SPHERE_FLAG
    shape_id: torch.Tensor  # (N,) int, -1 on a miss
    p: torch.Tensor         # (N, 3) hit position (o on a miss)
    ng: torch.Tensor        # (N, 3) unit geometric normal
    uv: torch.Tensor        # (N, 2) barycentric coordinates
    tex_uv: torch.Tensor    # (N, 2) texture coordinates (need_uv), else uv


# triangles a brute-force broadcast tests at once: an (N, _CHUNK) f32
# temporary at 2^20 lanes is 256 MiB
_CHUNK = 64


def _chunk(v0, e1, e2, o, d):
    """Closest hit with t > 0 of (N, 3) rays against (C, 3) triangles:
    (t, index in the chunk, u, v), t = INF on a miss."""
    v0, e1, e2 = (a.unsqueeze(0) for a in (v0, e1, e2))
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    tx = ox - v0[..., 0]
    ty = oy - v0[..., 1]
    tz = oz - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = torch.where(hit, t, torch.full_like(t, INF))
    prim = torch.argmin(t, dim=-1)              # first of equal minima
    pick = prim.unsqueeze(1)
    return (torch.gather(t, 1, pick).squeeze(1), prim,
            torch.gather(u, 1, pick).squeeze(1),
            torch.gather(v, 1, pick).squeeze(1))


def _triangles(geo: Geometry, o, d, t_min, t_max):
    """Closest triangle hit: (t, prim, u, v, ok). Brute force takes the
    closest hit with t > 0 and keeps it only inside [t_min, t_max] (as the
    JAX package does: a closer hit below t_min masks a farther one); the
    BVH takes the closest hit inside [t_min, t_max]."""
    T = geo.v0.shape[0]
    if geo.bvh.nodes.shape[0] > 0:
        t, packed, u, v = bvh_m.intersect_bvh(geo.bvh, o, d, t_min, t_max)
        prim = geo.bvh.tri_id[torch.clamp(
            packed, 0, geo.bvh.tri_id.shape[0] - 1)].to(torch.int64)
        ok = (t < INF) & (geo.shape_id[torch.clamp(prim, 0, T - 1)] >= 0)
        return t, prim, u, v, ok
    t, prim, u, v = _chunk(geo.v0[:_CHUNK], geo.e1[:_CHUNK],
                           geo.e2[:_CHUNK], o, d)
    for s in range(_CHUNK, T, _CHUNK):
        tc, pc, uc, vc = _chunk(geo.v0[s:s + _CHUNK], geo.e1[s:s + _CHUNK],
                                geo.e2[s:s + _CHUNK], o, d)
        closer = tc < t
        t = torch.where(closer, tc, t)
        prim = torch.where(closer, pc + s, prim)
        u = torch.where(closer, uc, u)
        v = torch.where(closer, vc, v)
    in_range = (t >= t_min) & (t <= t_max) & (t < INF)
    return t, prim, u, v, in_range & (geo.shape_id[prim] >= 0)


def _spheres(geo: Geometry, o, d, t_min, t_max):
    n = o.shape[0]
    best_t = torch.full((n,), INF, device=o.device)
    best = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for i in range(geo.sph_center.shape[0]):
        c, r = geo.sph_center[i], geo.sph_radius[i]
        oc = o - c
        b = oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1] + oc[:, 2] * d[:, 2]
        ct = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2] \
            - r * r
        disc = b * b - ct
        sq = torch.sqrt(torch.clamp_min(disc, 1e-12))
        t0, t1 = -b - sq, -b + sq
        t = torch.where((t0 >= t_min) & (t0 <= t_max), t0, t1)
        closer = (disc > 0) & (t >= t_min) & (t <= t_max) & (r > 0) \
            & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best = torch.where(closer, i, best)
    return best_t, best, best_t < INF


def _lane_range(t, device):
    """t (a tensor or a Python number; the number sent to the device is
    the host read "intersect.range") as a float32 tensor on device."""
    if isinstance(t, torch.Tensor):
        return torch.as_tensor(t, dtype=torch.float32, device=device)
    return stats.to_device("intersect.range", t, device, torch.float32)


def intersect(geo: Geometry, o, d, t_min, t_max,
              need_uv: bool = False) -> Hit:
    """Closest hit over triangles and spheres of (N, 3) rays; with need_uv
    the hit's interpolated texture coordinates (a sphere's lat-long)."""
    n = o.shape[0]
    t_min, t_max = (_lane_range(t, o.device).expand(n) for t in (t_min, t_max))
    tt, tprim, tu, tv, tok = _triangles(geo, o, d, t_min, t_max)
    st, sprim, sok = _spheres(geo, o, d, t_min, t_max)
    inf = torch.full_like(tt, INF)
    use_sph = sok & (st < torch.where(tok, tt, inf))
    t = torch.where(use_sph, st, torch.where(tok, tt, inf))
    valid = tok | sok
    prim = torch.where(use_sph, sprim | SPHERE_FLAG, tprim)
    p = o + torch.where(valid, t, torch.zeros_like(t)).unsqueeze(-1) * d
    sph_ng = normalize(p - geo.sph_center[sprim])
    ng = torch.where(use_sph.unsqueeze(-1), sph_ng, geo.ng[tprim])
    shape_id = torch.where(use_sph, geo.sph_shape_id[sprim],
                           geo.shape_id[tprim]).to(torch.int64)
    uv = torch.stack([tu, tv], dim=-1)
    tex_uv = uv
    if need_uv:
        tri_uv = (geo.uv0[tprim] + tu.unsqueeze(-1) * geo.uve1[tprim]
                  + tv.unsqueeze(-1) * geo.uve2[tprim])
        sph_u = 0.5 + torch.atan2(sph_ng[:, 1], sph_ng[:, 0]) / (2 * math.pi)
        sph_v = 0.5 - torch.asin(torch.clamp(sph_ng[:, 2], -1, 1)) / math.pi
        tex_uv = torch.where(use_sph.unsqueeze(-1),
                             torch.stack([sph_u, sph_v], dim=-1), tri_uv)
    return Hit(t=t, valid=valid, prim=prim,
               shape_id=torch.where(valid, shape_id, -1), p=p, ng=ng,
               uv=uv, tex_uv=tex_uv)


def occluded(geo: Geometry, o, d, t_min, t_max) -> torch.Tensor:
    """Shadow query: True where something lies on o + t d, t in range."""
    return intersect(geo, o, d, t_min, t_max).valid


def ray_aabb(o, d, aabb_min, aabb_max):
    """Slab test: (t_near, t_far) of the box interval (empty when
    t_near > t_far)."""
    tiny = torch.where(d >= 0, 1e-20, -1e-20)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
    t0 = (aabb_min - o) * inv
    t1 = (aabb_max - o) * inv
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tn, tf
