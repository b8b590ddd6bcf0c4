"""Emitters (port of mitsubaer_tpu/models/emitter.py): direct sampling of
area, point, spot, directional, constant and environment-map emitters,
area emitter hits, the environment's radiance and pdf terms, and the
Preetham sky baked to an environment map (`make_sky_envmap`).

Direct sampling picks an emitter uniformly, as Scene::sampleEmitterDirect
does (scene.cpp:812-850), then a point on it: an area emitter picks a
triangle from its segment of the area cdf table with the pick's remainder
and a uniform point on it. pdfs are solid-angle densities that include the
pick probability; a collimated beam gives zero (its NEE is the beam
family's). The environment map is a lat-long image, importance-sampled by
its rows' and then its columns' luminance cdfs (envmap.cpp).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

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
    if _has_envmap(scene):
        is_env = kind == EM_ENVMAP
        d_e, pdf_e, val_e = sample_env_direction(scene, u2)
        d = torch.where(is_env.unsqueeze(-1), d_e, d)
        dist = torch.where(is_env, _BIG, dist)
        value = torch.where(is_env.unsqueeze(-1), val_e, value)
        pdf = torch.where(is_env, pdf_e, pdf)
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


def _rot(R, v):
    """(N, 3) v times the (3, 3) R's columns: R^T v for each row."""
    return torch.stack([v[..., 0] * R[0, j] + v[..., 1] * R[1, j]
                        + v[..., 2] * R[2, j] for j in range(3)], dim=-1)


def _env_uv(scene: Scene, d_world):
    """World direction -> lat-long (u, v) in [0, 1)^2 (envmap.cpp)."""
    d = _rot(scene.emitters.env_to_world, d_world)   # world -> env frame
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    return torch.remainder(phi / (2.0 * math.pi), 1.0), theta / math.pi


def _f32(x, like):
    """x as a float32 scalar tensor: a true division by it (torch on CUDA
    multiplies by the rounded reciprocal of a Python scalar divisor)."""
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _env_lookup(scene: Scene, d_world):
    """Bilinear lookup of the shared lat-long map, times its scale."""
    em = scene.emitters
    He, We = em.env_map.shape[:2]
    u, v = _env_uv(scene, d_world)
    x = u * We - 0.5
    y = v * He - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)
    img = em.env_map.reshape(-1, 3)
    xi0, xi1 = torch.remainder(x0, We), torch.remainder(x0 + 1, We)
    yi0 = torch.clamp(y0, 0, He - 1) * We
    yi1 = torch.clamp(y0 + 1, 0, He - 1) * We
    val = ((img[yi0 + xi0] * (1 - fx) + img[yi0 + xi1] * fx) * (1 - fy)
           + (img[yi1 + xi0] * (1 - fx) + img[yi1 + xi1] * fx) * fy)
    return val * em.env_scale


def _env_pmf(em, row, col):
    """(pmf of the row, pmf of the column within it)."""
    We = em.env_map.shape[1]
    rows, cond = em.env_cdf_rows, em.env_cdf_cond.reshape(-1)
    lo_r = torch.where(row > 0, rows[torch.clamp_min(row - 1, 0)], 0.0)
    flat = row * We + col
    lo_c = torch.where(col > 0, cond[torch.clamp_min(flat - 1, 0)], 0.0)
    return rows[row] - lo_r, cond[flat] - lo_c, lo_r, lo_c


def _texel_pdf(pmf_row, pmf_col, He, We, st):
    """texel pmf -> solid-angle density: pmf (He We) / (2 pi^2 sin)."""
    return (pmf_row * pmf_col * He * We
            / torch.clamp_min((2.0 * math.pi * math.pi) * st, 1e-8))


def sample_env_direction(scene: Scene, u2):
    """Importance-sample the lat-long map by luminance (envmap.cpp): a row
    by the marginal cdf, then a column by the row's conditional cdf.
    Returns (d_world, solid-angle pdf, radiance). The column search runs
    over all rows at once on the key row * 2 + cdf (float64, exact), so no
    lane gathers its row; a u past the row's last cdf takes its last
    column, as the JAX package's clip does."""
    em = scene.emitters
    He, We = em.env_map.shape[:2]
    row = torch.clamp(torch.searchsorted(em.env_cdf_rows,
                                         u2[..., 0].contiguous()),
                      0, He - 1)
    key = (torch.arange(He, dtype=torch.float64, device=row.device)
           .repeat_interleave(We) * 2.0
           + em.env_cdf_cond.reshape(-1).to(torch.float64))
    first = torch.searchsorted(key, row.to(torch.float64) * 2.0
                               + u2[..., 1].to(torch.float64))
    col = torch.clamp(first - row * We, 0, We - 1)
    pmf_row, pmf_col, lo_r, lo_c = _env_pmf(em, row, col)
    ur = (u2[..., 0] - lo_r) / torch.clamp_min(pmf_row, 1e-12)
    uc = (u2[..., 1] - lo_c) / torch.clamp_min(pmf_col, 1e-12)
    v = (row.to(torch.float32) + torch.clamp(ur, 0.0, 0.9999)) / _f32(He, u2)
    u = (col.to(torch.float32) + torch.clamp(uc, 0.0, 0.9999)) / _f32(We, u2)
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    st = torch.sin(theta)
    d_env = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                         torch.cos(theta)], dim=-1)
    d_world = _rot(em.env_to_world.t(), d_env)
    return (d_world, _texel_pdf(pmf_row, pmf_col, He, We, st),
            _env_lookup(scene, d_world))


def env_pdf_direction(scene: Scene, d_world):
    """Solid-angle pdf of sample_env_direction having produced d_world."""
    em = scene.emitters
    He, We = em.env_map.shape[:2]
    u, v = _env_uv(scene, d_world)
    row = torch.clamp((v * He).to(torch.int64), 0, He - 1)
    col = torch.clamp((u * We).to(torch.int64), 0, We - 1)
    pmf_row, pmf_col, _, _ = _env_pmf(em, row, col)
    st = torch.sin(torch.clamp(v, 1e-4, 1 - 1e-4) * math.pi)
    return _texel_pdf(pmf_row, pmf_col, He, We, st)


def _has_envmap(scene: Scene) -> bool:
    """The shared map is (1, 1, 3) where no environment-map emitter is."""
    return scene.emitters.env_map.shape[0] > 1


def env_radiance(scene: Scene, d_world):
    """Radiance of the environment (constant and environment-map emitters)
    for escaped rays."""
    em = scene.emitters
    total = torch.where((em.kind == EM_CONSTANT).unsqueeze(-1), em.radiance,
                        0.0).sum(0)
    out = total.expand(d_world.shape)
    if _has_envmap(scene):
        out = out + _env_lookup(scene, d_world)
    return out


def pdf_direct_env(scene: Scene, d_world):
    em = scene.emitters
    ne = em.kind.shape[0]
    has_const = (em.kind == EM_CONSTANT).any()
    out = torch.where(has_const, INV_FOURPI / ne, 0.0).expand(
        d_world.shape[:-1])
    if _has_envmap(scene):
        out = out + env_pdf_direction(scene, d_world) / ne
    return out


def make_sky_envmap(sun_dir, turbidity: float = 3.0, res: int = 128,
                    sun_scale: float = 1.0, sky_scale: float = 1.0,
                    with_sun: bool = True):
    """The Preetham analytic sky (sky.cpp, sun.cpp, sunsky.cpp) baked on the
    host into a (res, 2 res, 3) float32 lat-long map, z-up; sun_dir points
    toward the sun. A copy of the JAX package's numpy construction."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    T = float(turbidity)
    theta_s = np.arccos(np.clip(sun_dir[2], -1.0, 1.0))
    # Preetham zenith values (xyY)
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192
    ts = theta_s
    tv = np.array([ts ** 3, ts ** 2, ts, 1.0])
    xz = np.array([0.00166, -0.00375, 0.00209, 0.0]) @ tv * T * T + \
        np.array([-0.02903, 0.06377, -0.03202, 0.00394]) @ tv * T + \
        np.array([0.11693, -0.21196, 0.06052, 0.25886]) @ tv
    yz = np.array([0.00275, -0.00610, 0.00317, 0.0]) @ tv * T * T + \
        np.array([-0.04214, 0.08970, -0.04153, 0.00516]) @ tv * T + \
        np.array([0.15346, -0.26756, 0.06670, 0.26688]) @ tv

    def perez(A, B, C, D, E, ct, gamma):
        return ((1.0 + A * np.exp(B / np.maximum(ct, 0.01)))
                * (1.0 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2))

    # Perez coefficients (Y, x, y)
    cY = (0.1787 * T - 1.4630, -0.3554 * T + 0.4275, -0.0227 * T + 5.3251,
          0.1206 * T - 2.5771, -0.0670 * T + 0.3703)
    cx = (-0.0193 * T - 0.2592, -0.0665 * T + 0.0008, -0.0004 * T + 0.2125,
          -0.0641 * T - 0.8989, -0.0033 * T + 0.0452)
    cy = (-0.0167 * T - 0.2608, -0.0950 * T + 0.0092, -0.0079 * T + 0.2102,
          -0.0441 * T - 1.6537, -0.0109 * T + 0.0529)

    H, W = res, 2 * res
    theta = (np.arange(H) + 0.5) / H * np.pi
    phi = (np.arange(W) + 0.5) / W * 2.0 * np.pi
    TT, PP = np.meshgrid(theta, phi, indexing="ij")
    ct = np.cos(TT)
    d = np.stack([np.sin(TT) * np.cos(PP), np.sin(TT) * np.sin(PP), ct], -1)
    cg = np.clip(d @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cg)

    vis = ct > 0.0
    ctc = np.maximum(ct, 0.01)
    fY = perez(*cY, ctc, gamma) / perez(*cY, 1.0, theta_s)
    fx = perez(*cx, ctc, gamma) / perez(*cx, 1.0, theta_s)
    fy = perez(*cy, ctc, gamma) / perez(*cy, 1.0, theta_s)
    Y = np.maximum(Yz * fY, 0.0) * 1000.0 / 203.0
    x = xz * fx
    y = yz * fy
    # xyY -> XYZ -> linear sRGB
    X = x / np.maximum(y, 1e-5) * Y
    Z = (1.0 - x - y) / np.maximum(y, 1e-5) * Y
    R = 3.2406 * X - 1.5372 * Y - 0.4986 * Z
    G = -0.9689 * X + 1.8758 * Y + 0.0415 * Z
    B = 0.0557 * X - 0.2040 * Y + 1.0570 * Z
    img = np.stack([R, G, B], -1).clip(0.0) * sky_scale
    img[~vis] *= 0.0
    if with_sun and theta_s < np.pi / 2:
        # the sun's disk (~0.5 deg) with a broadband turbidity attenuation
        disk = cg > np.cos(np.deg2rad(0.2665))
        img[disk] += (np.array([1.0, 0.96, 0.88]) * 500.0
                      * np.exp(-0.12 * T) * sun_scale)
    return img.astype(np.float32)
