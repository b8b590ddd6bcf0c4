"""Textures (port of mitsubaer_tpu/models/texture.py).

A BSDF's texture scales its reflectance at the hit (`bsdf_refl_scale`, the
`refl_scale` of models/bsdf.py); a normal or bump map tilts the shading
frame (`shading_normal` in the frame of `uv_tangent_frame`). The
procedural kinds are arithmetic on the texture coordinates, the bitmap a
bilinear lookup of the scene's one shared image with repeat wrapping.
"""
from __future__ import annotations

import torch

from ..core import noise as noise_m
from ..core.math import Frame, coordinate_system, cross, dot
from ..scene.types import (TEX_BITMAP, TEX_BUMPMAP, TEX_CHECKERBOARD,
                           TEX_GRIDTEXTURE, TEX_NOISE, TEX_NORMALMAP,
                           TEX_SCALE, TEX_WIREFRAME, Textures)


def _rows(tex: Textures, tex_idx):
    i = torch.clamp(tex_idx, 0, tex.kind.shape[0] - 1).to(torch.int64)
    return i, torch.where(tex_idx >= 0, tex.kind[i], -1)


def _bilinear(tex: Textures, st):
    """The shared bitmap at st, bilinear with repeat wrapping."""
    Hb, Wb = tex.bitmap.shape[:2]
    img = tex.bitmap.reshape(-1, 3)
    x = (st[..., 0] % 1.0) * Wb - 0.5
    y = (st[..., 1] % 1.0) * Hb - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)
    xi0, xi1 = x0 % Wb, (x0 + 1) % Wb
    yi0, yi1 = y0 % Hb, (y0 + 1) % Hb
    p00 = img[yi0 * Wb + xi0]
    p10 = img[yi0 * Wb + xi1]
    p01 = img[yi1 * Wb + xi0]
    p11 = img[yi1 * Wb + xi1]
    return ((p00 * (1 - fx) + p10 * fx) * (1 - fy)
            + (p01 * (1 - fx) + p11 * fx) * fy)


def eval_texture(tex: Textures, tex_idx, uv, bary=None):
    """RGB value of texture rows tex_idx (N,) at uv (N, 2); -1 gives 1.
    `bary`, the raw barycentrics, feed the wireframe's edge distance."""
    i, kind = _rows(tex, tex_idx)
    c0, c1 = tex.color0[i], tex.color1[i]
    lw = tex.line_width[i]
    st = uv * tex.uv_scale[i] + tex.uv_offset[i]

    # checkerboard: color0 and color1 on alternate integer cells
    cell = torch.floor(st).to(torch.int64)
    check = ((cell[..., 0] + cell[..., 1]) % 2) == 0
    v_check = torch.where(check.unsqueeze(-1), c0, c1)
    # grid: lines of width lw at integer coordinates
    f = st - torch.floor(st)
    on_line = ((torch.minimum(f[..., 0], 1.0 - f[..., 0]) < lw)
               | (torch.minimum(f[..., 1], 1.0 - f[..., 1]) < lw))
    v_grid = torch.where(on_line.unsqueeze(-1), c1, c0)
    # wireframe: barycentric distance to the triangle's edges
    if bary is None:
        bary = uv
    b0, b1 = bary[..., 0], bary[..., 1]
    edge = torch.minimum(torch.minimum(b0, b1),
                         torch.clamp_min(1.0 - b0 - b1, 0.0))
    v_wire = torch.where((edge < lw).unsqueeze(-1), c1, c0)
    # bitmap; the scale kind folds color0 in
    v_bitmap = _bilinear(tex, st)
    v_bitmap = torch.where(
        tex.use_bitmap[i].unsqueeze(-1),
        v_bitmap * torch.where((kind == TEX_SCALE).unsqueeze(-1), c0, 1.0),
        v_bitmap)
    pn = torch.stack([st[..., 0] * 8.0, st[..., 1] * 8.0,
                      torch.zeros_like(st[..., 0])], dim=-1)
    tnoise = (0.5 * (noise_m.fbm(pn, octaves=4) + 1.0)).unsqueeze(-1)
    v_noise = c0 * (1.0 - tnoise) + c1 * tnoise

    out = torch.ones_like(c0)
    for k, val in ((kind == TEX_NOISE, v_noise),
                   (kind == TEX_CHECKERBOARD, v_check),
                   (kind == TEX_GRIDTEXTURE, v_grid),
                   (kind == TEX_WIREFRAME, v_wire),
                   ((kind == TEX_BITMAP) | (kind == TEX_SCALE), v_bitmap)):
        out = torch.where(k.unsqueeze(-1), val, out)
    return out


def _bsdf_tex(scene, table, b_idx):
    nb = scene.bsdfs.kind.shape[0]
    bi = torch.clamp(b_idx, 0, nb - 1).to(torch.int64)
    return torch.where(b_idx >= 0, table[bi], -1)


def shading_normal(scene, b_idx, uv, enabled: bool = True):
    """The tangent-space shading normal of each BSDF's normal_tex row: a
    normal map's n = 2 rgb - 1, a bump map's n from the height field's
    central-difference gradient (strength color0[0]). Unit (N, 3) local
    normals, or None where `enabled` (cfg.has_normal_tex) is False."""
    if not enabled:
        return None
    tex = scene.textures
    t_idx = _bsdf_tex(scene, scene.bsdfs.normal_tex, b_idx)
    i, kind = _rows(tex, t_idx)
    strength = tex.color0[i][..., 0]
    st = uv * tex.uv_scale[i] + tex.uv_offset[i]
    n_nm = _bilinear(tex, st) * 2.0 - 1.0

    Hb, Wb = tex.bitmap.shape[:2]
    zero = torch.zeros(st.shape[:-1], dtype=st.dtype, device=st.device)
    du = torch.stack([torch.full_like(zero, 1.0 / Wb), zero], dim=-1)
    dv = torch.stack([zero, torch.full_like(zero, 1.0 / Hb)], dim=-1)

    def h(s):
        return torch.mean(_bilinear(tex, s), dim=-1)

    dhdu = (h(st + du) - h(st - du)) * (0.5 * Wb)
    dhdv = (h(st + dv) - h(st - dv)) * (0.5 * Hb)
    n_bm = torch.stack([-strength * dhdu, -strength * dhdv,
                        torch.ones_like(dhdu)], dim=-1)
    up = torch.stack([zero, zero, torch.ones_like(zero)], dim=-1)
    n_loc = torch.where((kind == TEX_BUMPMAP).unsqueeze(-1), n_bm,
                        torch.where((kind == TEX_NORMALMAP).unsqueeze(-1),
                                    n_nm, up))
    n_loc = n_loc / torch.clamp_min(
        torch.linalg.vector_norm(n_loc, dim=-1, keepdim=True), 1e-6)
    # keep the tilted normal in the frame's upper hemisphere
    return torch.where((n_loc[..., 2] < 1e-3).unsqueeze(-1), up, n_loc)


def uv_tangent_frame(scene, hit) -> Frame:
    """The uv-aligned shading frame at triangle hits: dp/du from the edge
    and uv-edge system, made orthogonal to the geometric normal; the
    arbitrary Frame.from_normal basis on spheres and degenerate charts."""
    geo = scene.geo
    is_tri = hit.prim < (1 << 30)
    ti = torch.clamp(torch.where(is_tri, hit.prim, 0), 0,
                     geo.v0.shape[0] - 1)
    e1, e2 = geo.e1[ti], geo.e2[ti]
    u1, u2 = geo.uve1[ti], geo.uve2[ti]
    det = u1[..., 0] * u2[..., 1] - u2[..., 0] * u1[..., 1]
    ok = is_tri & (torch.abs(det) > 1e-12)
    inv = 1.0 / torch.where(ok, det, 1.0)
    dpdu = (u2[..., 1:2] * e1 - u1[..., 1:2] * e2) * inv.unsqueeze(-1)
    n = hit.ng
    t = dpdu - dot(dpdu, n, True) * n
    tlen = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    ok = ok & (tlen[..., 0] > 1e-9)
    t = t / torch.clamp_min(tlen, 1e-12)
    s0, t0 = coordinate_system(n)
    okx = ok.unsqueeze(-1)
    return Frame(torch.where(okx, t, s0), torch.where(okx, cross(n, t), t0),
                 n)


def bsdf_refl_scale(scene, b_idx, uv, bary=None, enabled: bool = True):
    """Texture factor on the reflectance of a batch of surface hits, or
    None where `enabled` (cfg.has_textures) is False."""
    if not enabled:
        return None
    return eval_texture(scene.textures,
                        _bsdf_tex(scene, scene.bsdfs.texture, b_idx), uv,
                        bary)
