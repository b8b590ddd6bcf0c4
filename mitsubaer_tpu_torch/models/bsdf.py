"""BSDFs (port of mitsubaer_tpu/models/bsdf.py): every kind of the JAX
package's tagged-union table, with its `eval`, `pdf` and `sample`.

Directions are in the local shading frame (+z = normal), `wi` points toward
the previous vertex, `eval` returns f * |cos(wo)|, `pdf` is a solid-angle
density and `sample` returns weight = f * cos / pdf; delta lobes evaluate
to zero and set `delta`. A negative index is the null surface of a pure
medium boundary. `eta_override` is the per-lane IOR of the h-dielectric
kinds, `refl_scale` a texture's factor on the reflectance.

Each lobe runs for every lane and a lane takes its kind's; `active`, the
scene's static set of kinds (RenderConfig.bsdf_kinds; None = all), skips
the lobes of the kinds that are absent, as the JAX package's `_on` does,
so a diffuse-only scene launches the diffuse lobe alone. The filtered
result equals the full one on every lane whose kind is in `active` (and on
the null surface). Mixture and two-sided rows resolve to their children
(one wrapper level) and the coatings wrap their child after the base lobes,
drawing the same numbers in the same order as the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..core import warp
from ..core.math import (INV_PI, Frame, abs_cos_theta, cos_theta, dot,
                         fresnel_conductor, fresnel_dielectric, normalize,
                         reflect_local, safe_sqrt)
from ..scene.types import (BSDF_COATING, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                           BSDF_DIFFTRANS, BSDF_DIFFUSE, BSDF_HDIELECTRIC,
                           BSDF_HK, BSDF_HROUGHDIELECTRIC, BSDF_MIRROR,
                           BSDF_MIXTURE, BSDF_NULL, BSDF_PHONG, BSDF_PLASTIC,
                           BSDF_ROUGHCOATING, BSDF_ROUGHCONDUCTOR,
                           BSDF_ROUGHDIELECTRIC, BSDF_ROUGHDIFFUSE,
                           BSDF_ROUGHPLASTIC, BSDF_THINDIELECTRIC,
                           BSDF_TWOSIDED, BSDF_WARD, BSDFs)


@dataclass(frozen=True)
class BSDFSample:
    wo: torch.Tensor      # (N, 3) local frame
    weight: torch.Tensor  # (N, 3) f * cos / pdf
    pdf: torch.Tensor     # (N,) solid-angle pdf (discrete prob for delta)
    delta: torch.Tensor   # (N,) bool: the sampled lobe is a Dirac delta
    eta: torch.Tensor     # (N,) relative IOR of the event (1: no refraction)
    null_passthrough: torch.Tensor  # (N,) bool: null transmission event


def _on(active, *ks) -> bool:
    """Whether a lobe of kinds ks runs: `active` is the scene's static set
    of BSDF kinds, or None for all."""
    return active is None or any(k in active for k in ks)


def _w(c, a, b):
    """torch.where with a per-lane condition over (N, 3) values."""
    return torch.where(c.unsqueeze(-1), a, b)


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], dim=-1)


class _Rows:
    """The BSDF table's rows of per-lane indices, fetched on first use
    (JAX's _params / _params_aniso)."""

    def __init__(self, bs: BSDFs, idx, refl_scale=None, eta_override=None):
        self.bs = bs
        self.i = torch.clamp(idx, 0, bs.kind.shape[0] - 1).to(torch.int64)
        self.kind = torch.where(idx >= 0, bs.kind[self.i], BSDF_NULL)
        self._refl_scale, self._eta_override = refl_scale, eta_override
        self._cache = {}

    def __getattr__(self, name):
        cache = self.__dict__["_cache"]
        if name not in cache:
            v = getattr(self.bs, name)[self.i]
            if name == "reflectance" and self._refl_scale is not None:
                v = v * self._refl_scale
            if name == "eta" and self._eta_override is not None:
                v = torch.where((self.kind == BSDF_HDIELECTRIC)
                                | (self.kind == BSDF_HROUGHDIELECTRIC),
                                self._eta_override, v)
            cache[name] = v
        return cache[name]


def _wrapper_resolve(bs: BSDFs, idx, wi, active=None):
    """Two-sided and mixture rows resolved to (idx_a, idx_b, w_a, wi2,
    flip): base rows, child A's weight, and wi mirrored where a two-sided
    row is shaded from its back. Other lanes: idx_b = idx_a = idx, w_a 1."""
    if not _on(active, BSDF_TWOSIDED, BSDF_MIXTURE):
        return idx, idx, torch.ones_like(wi[..., 0]), wi, \
            torch.zeros_like(idx, dtype=torch.bool)
    r = _Rows(bs, idx)
    is_ts = r.kind == BSDF_TWOSIDED
    is_mix = r.kind == BSDF_MIXTURE
    idx_a = torch.where(is_ts | is_mix, r.child0.to(idx.dtype), idx)
    idx_b = torch.where(is_mix, r.child1.to(idx.dtype), idx_a)
    w_a = torch.where(is_mix, r.mix_w, 1.0)
    flip = is_ts & (cos_theta(wi) < 0)
    return idx_a, idx_b, w_a, _w(flip, _flip_z(wi), wi), flip


# ---------------------------------------------------------------------------
# Microfacet, Ward, Oren-Nayar and Hanrahan-Krueger helpers
# ---------------------------------------------------------------------------
def _rough_diel_halfvec(wi, wo, eta_rel):
    """Half vector of the reflection or refraction configuration, on +z."""
    is_refl = cos_theta(wi) * cos_theta(wo) > 0
    m = _w(is_refl, normalize(wi + wo),
           normalize(wi + wo * eta_rel.unsqueeze(-1)))
    return _w(cos_theta(m) < 0, -m, m), is_refl


def _ward_spec(wi, wo, au, av):
    """Ward specular term * cos(wo) (ward.cpp, balanced variant)."""
    ci, co = cos_theta(wi), cos_theta(wo)
    h = wi + wo
    hz2 = h[..., 2] * h[..., 2]
    expo = -(h[..., 0] ** 2 / torch.clamp_min(au * au, 1e-12)
             + h[..., 1] ** 2 / torch.clamp_min(av * av, 1e-12)) \
        / torch.clamp_min(hz2, 1e-12)
    denom = 4.0 * math.pi * au * av * torch.sqrt(torch.clamp_min(ci * co,
                                                                  1e-12))
    return torch.where((ci > 0) & (co > 0),
                       torch.exp(expo) / torch.clamp_min(denom, 1e-12) * co,
                       0.0)


def _ggx_d(m, alpha):
    ct = cos_theta(m)
    a2 = alpha * alpha
    denom = math.pi * (ct * ct * (a2 - 1.0) + 1.0) ** 2
    return torch.where(ct > 0, a2 / torch.clamp_min(denom, 1e-20), 0.0)


def _ggx_g1(v, m, alpha):
    ct = cos_theta(v)
    tan2 = torch.clamp_min(1.0 - ct * ct, 0.0) / torch.clamp_min(ct * ct,
                                                                  1e-12)
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    return torch.where(dot(v, m) * ct > 0, 1.0 / (1.0 + lam), 0.0)


def _ggx_sample(alpha, u):
    ct = 1.0 / torch.sqrt(1.0 + alpha * alpha * u[..., 0]
                          / torch.clamp_min(1.0 - u[..., 0], 1e-9))
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def _ggx_pdf_m(m, alpha):
    return _ggx_d(m, alpha) * torch.clamp_min(cos_theta(m), 0.0)


def _oren_nayar_factor(wi, wo, sigma):
    """A + B max(0, cos(phi_i - phi_o)) sin(alpha) tan(beta)
    (roughdiffuse.cpp:159-174)."""
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    ci, co = torch.abs(cos_theta(wi)), torch.abs(cos_theta(wo))
    si, so = safe_sqrt(1.0 - ci * ci), safe_sqrt(1.0 - co * co)
    cos_dphi = torch.clamp(
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
        / torch.clamp_min(si * so, 1e-7), -1.0, 1.0)
    sin_alpha = torch.where(ci > co, so, si)
    tan_beta = torch.where(ci > co, si / torch.clamp_min(ci, 1e-6),
                           so / torch.clamp_min(co, 1e-6))
    return A + B * torch.clamp_min(cos_dphi, 0.0) * sin_alpha * tan_beta


def _hk_lobes(r: _Rows, wi, wo):
    """Hanrahan-Krueger single-scatter slab lobes (f_reflect, f_transmit,
    q_delta) with sigma_s = specular_r, sigma_a = specular_t, thickness =
    alpha and HG g = mix_w; q_delta, the unscattered straight-through
    probability, is the delta lobe's sampling weight. The lobes omit
    hk.cpp's extra cos(theta_i), as the JAX package does, so they are
    reciprocal."""
    g = r.mix_w
    mu_i = torch.clamp_min(torch.abs(cos_theta(wi)), 1e-5)
    mu_o = torch.clamp_min(torch.abs(cos_theta(wo)), 1e-5)
    st = r.specular_r + r.specular_t
    tau = st * torch.clamp_min(r.alpha, 1e-6).unsqueeze(-1)
    w_alb = r.specular_r / torch.clamp_min(st, 1e-9)
    cg = dot(-wi, wo)
    denom = torch.clamp_min(1.0 + g * g - 2.0 * g * cg, 1e-9)
    p_hg = (INV_PI * 0.25) * (1.0 - g * g) / (denom * torch.sqrt(denom))
    mi, mo = mu_i.unsqueeze(-1), mu_o.unsqueeze(-1)
    f_r = (w_alb * p_hg.unsqueeze(-1) / (mu_i + mu_o).unsqueeze(-1)
           * (1.0 - torch.exp(-tau * (1.0 / mu_i + 1.0 / mu_o).unsqueeze(-1))))
    dmu = mu_i - mu_o
    near = torch.abs(dmu) < 1e-4
    safe = torch.where(near, 1.0, dmu)
    f_t_gen = (torch.exp(-tau / mi) - torch.exp(-tau / mo)) \
        / safe.unsqueeze(-1)
    f_t_lim = tau * torch.exp(-tau / mi) / (mu_i * mu_i).unsqueeze(-1)
    f_t = w_alb * p_hg.unsqueeze(-1) * _w(near, f_t_lim, f_t_gen)
    q_delta = torch.mean(torch.exp(-tau / mi), dim=-1)
    return f_r, f_t, q_delta


def _spec_weight(r: _Rows):
    """Phong's and Ward's probability of the specular lobe."""
    ms = torch.amax(r.specular_r, dim=-1)
    return ms / torch.clamp_min(ms + torch.amax(r.reflectance, dim=-1),
                                1e-12)


# ---------------------------------------------------------------------------
# eval / pdf of the base kinds
# ---------------------------------------------------------------------------
def _eval_base(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
               active=None):
    r = _Rows(bs, idx, refl_scale, eta_override)
    kind = r.kind
    ci, co = cos_theta(wi), cos_theta(wo)
    co_pos = torch.clamp_min(co, 0.0)
    out = torch.zeros_like(wi)
    if _on(active, BSDF_DIFFUSE):
        out = _w(kind == BSDF_DIFFUSE,
                 r.reflectance * (INV_PI * co_pos).unsqueeze(-1), out)
    if _on(active, BSDF_ROUGHDIFFUSE):
        out = _w(kind == BSDF_ROUGHDIFFUSE, r.reflectance * (
            _oren_nayar_factor(wi, wo, r.alpha) * INV_PI
            * co_pos).unsqueeze(-1), out)
    if _on(active, BSDF_PLASTIC, BSDF_ROUGHPLASTIC):
        # the diffuse part attenuated by (1 - Fi)(1 - Fo) ("nonlinear=false")
        Fi, _ = fresnel_dielectric(ci, r.eta)
        Fo, _ = fresnel_dielectric(co, r.eta)
        f_plastic = r.reflectance * ((1.0 - Fi) * (1.0 - Fo) * INV_PI
                                     * co_pos).unsqueeze(-1)
        out = _w(kind == BSDF_PLASTIC, f_plastic, out)
    if _on(active, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC):
        m = normalize(wi + wo)
        m = _w(ci < 0, -m, m)
        D = _ggx_d(m, r.alpha)
        G = _ggx_g1(wi, m, r.alpha) * _ggx_g1(wo, m, r.alpha)
    if _on(active, BSDF_ROUGHCONDUCTOR):
        Fc = fresnel_conductor(dot(wi, m), r.cond_eta, r.cond_k)
        out = _w(kind == BSDF_ROUGHCONDUCTOR, r.specular_r * Fc * (
            D * G / torch.clamp_min(4.0 * torch.abs(ci), 1e-12)
        ).unsqueeze(-1), out)
    if _on(active, BSDF_PHONG):
        cos_r = torch.clamp_min(dot(reflect_local(wi), wo), 0.0)
        expn = r.exponent
        out = _w(kind == BSDF_PHONG,
                 r.reflectance * (INV_PI * co_pos).unsqueeze(-1)
                 + r.specular_r * ((expn + 2.0) / (2.0 * math.pi)
                                   * cos_r ** expn * co_pos).unsqueeze(-1),
                 out)
    if _on(active, BSDF_WARD):
        out = _w(kind == BSDF_WARD,
                 r.reflectance * (INV_PI * co_pos).unsqueeze(-1)
                 + r.specular_r * _ward_spec(wi, wo, r.alpha,
                                             r.alpha_v).unsqueeze(-1), out)
    if _on(active, BSDF_ROUGHPLASTIC):
        Fm = fresnel_dielectric(dot(wi, m), r.eta)[0]
        out = _w(kind == BSDF_ROUGHPLASTIC, r.specular_r * (
            Fm * D * G / torch.clamp_min(4.0 * torch.abs(ci), 1e-12)
        ).unsqueeze(-1) + f_plastic, out)
    out = _w((ci > 0) & (co > 0), out, 0.0)

    # the lobes that transmit (no front-side gate)
    if _on(active, BSDF_DIFFTRANS):
        f_dt = r.reflectance * (INV_PI * torch.abs(co)).unsqueeze(-1)
        out = _w(kind == BSDF_DIFFTRANS, _w(ci * co < 0, f_dt, 0.0), out)
    if _on(active, BSDF_HK):
        f_hk_r, f_hk_t, _ = _hk_lobes(r, wi, wo)
        out = _w(kind == BSDF_HK, _w(ci * co > 0, f_hk_r, f_hk_t)
                 * torch.abs(co).unsqueeze(-1), out)
    if _on(active, BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        # Walter et al. 2007 (roughdielectric.cpp)
        is_rd = (kind == BSDF_ROUGHDIELECTRIC) | (kind == BSDF_HROUGHDIELECTRIC)
        eta = r.eta
        eta_rel = torch.where(ci > 0, eta, 1.0 / eta)
        mh, is_refl = _rough_diel_halfvec(wi, wo, eta_rel)
        Frd = fresnel_dielectric(dot(wi, mh), eta)[0]
        Drd = _ggx_d(mh, r.alpha)
        Grd = _ggx_g1(wi, mh, r.alpha) * _ggx_g1(wo, mh, r.alpha)
        f_refl = Frd * Drd * Grd / torch.clamp_min(4.0 * torch.abs(ci), 1e-12)
        im, om = dot(wi, mh), dot(wo, mh)
        denom_t = im + eta_rel * om
        f_trans = (torch.abs(im * om) / torch.clamp_min(torch.abs(ci), 1e-12)
                   * (eta_rel * eta_rel) * (1.0 - Frd) * Drd * Grd
                   / torch.clamp_min(denom_t * denom_t, 1e-12))
        # radiance transport: transmission scaled by 1 / eta^2
        f_trans = f_trans / torch.clamp_min(eta_rel * eta_rel, 1e-12)
        out = _w(is_rd, _w(is_refl, r.specular_r * f_refl.unsqueeze(-1),
                           r.specular_t * f_trans.unsqueeze(-1)), out)
    # mask.cpp: the non-delta part of a masked material is opacity * f
    return out * r.opacity.unsqueeze(-1)


def _pdf_base(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
              active=None):
    r = _Rows(bs, idx, refl_scale, eta_override)
    kind = r.kind
    ci, co = cos_theta(wi), cos_theta(wo)
    p_cos = warp.square_to_cosine_hemisphere_pdf(wo)
    out = torch.where(kind == BSDF_DIFFUSE, p_cos, 0.0)
    if _on(active, BSDF_ROUGHDIFFUSE):
        out = torch.where(kind == BSDF_ROUGHDIFFUSE, p_cos, out)
    if _on(active, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC):
        m = normalize(wi + wo)
        m = _w(ci < 0, -m, m)
        p_rough = _ggx_pdf_m(m, r.alpha) / torch.clamp_min(
            4.0 * torch.abs(dot(wo, m)), 1e-12)
        out = torch.where(kind == BSDF_ROUGHCONDUCTOR, p_rough, out)
    if _on(active, BSDF_PLASTIC, BSDF_ROUGHPLASTIC):
        Fi, _ = fresnel_dielectric(ci, r.eta)
        out = torch.where(kind == BSDF_PLASTIC, (1.0 - Fi) * p_cos, out)
    if _on(active, BSDF_PHONG):
        cos_r = torch.clamp_min(dot(reflect_local(wi), wo), 0.0)
        expn = r.exponent
        p_spec = (expn + 1.0) / (2.0 * math.pi) * cos_r ** expn
        sw = _spec_weight(r)
        out = torch.where(kind == BSDF_PHONG,
                          sw * p_spec + (1.0 - sw) * p_cos, out)
    if _on(active, BSDF_WARD):
        alpha, av = r.alpha, r.alpha_v
        h = normalize(wi + wo)
        sw = _spec_weight(r)
        hz = torch.clamp_min(cos_theta(h), 1e-6)
        d_ward = torch.exp(-(h[..., 0] ** 2 / torch.clamp_min(alpha * alpha,
                                                               1e-12)
                             + h[..., 1] ** 2 / torch.clamp_min(av * av,
                                                                 1e-12))
                           / torch.clamp_min(hz * hz, 1e-12))
        p_h = d_ward / (math.pi * alpha * av * hz ** 3)
        p_spec = p_h / torch.clamp_min(4.0 * torch.abs(dot(wo, h)), 1e-12)
        out = torch.where(kind == BSDF_WARD,
                          sw * p_spec + (1.0 - sw) * p_cos, out)
    if _on(active, BSDF_ROUGHPLASTIC):
        out = torch.where(kind == BSDF_ROUGHPLASTIC,
                          Fi * p_rough + (1.0 - Fi) * p_cos, out)
    out = torch.where((ci > 0) & (co > 0), out, 0.0)

    if _on(active, BSDF_DIFFTRANS):
        p_dt = warp.square_to_cosine_hemisphere_pdf(torch.abs(wo))
        out = torch.where(kind == BSDF_DIFFTRANS,
                          torch.where(ci * co < 0, p_dt, 0.0), out)
    if _on(active, BSDF_HK):
        # (1 - q_delta) x a half/half cosine lobe on each side
        _, _, q_hk = _hk_lobes(r, wi, wo)
        out = torch.where(kind == BSDF_HK,
                          (1.0 - q_hk) * 0.5 * torch.abs(co) * INV_PI, out)
    if _on(active, BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        is_rd = (kind == BSDF_ROUGHDIELECTRIC) | (kind == BSDF_HROUGHDIELECTRIC)
        eta = r.eta
        eta_rel = torch.where(ci > 0, eta, 1.0 / eta)
        mh, is_refl = _rough_diel_halfvec(wi, wo, eta_rel)
        Frd = fresnel_dielectric(dot(wi, mh), eta)[0]
        pdf_m = _ggx_pdf_m(mh, r.alpha)
        im, om = dot(wi, mh), dot(wo, mh)
        jac_refl = 1.0 / torch.clamp_min(4.0 * torch.abs(om), 1e-12)
        denom_t = im + eta_rel * om
        jac_trans = (eta_rel * eta_rel) * torch.abs(om) / torch.clamp_min(
            denom_t * denom_t, 1e-12)
        out = torch.where(is_rd, torch.where(
            is_refl, Frd * pdf_m * jac_refl,
            (1.0 - Frd) * pdf_m * jac_trans), out)
    # mask.cpp: the continuous lobe is taken with probability opacity
    return out * r.opacity


# ---------------------------------------------------------------------------
# sample of the base kinds
# ---------------------------------------------------------------------------
def _sample_base(bs: BSDFs, idx, wi, u2, u1, eta_override=None,
                 refl_scale=None, active=None, u_op=None) -> BSDFSample:
    """Every lobe's sample, each lane taking its kind's. u2 draws the
    direction, u1 the lobe; u_op, where given, the mask's passthrough test
    (else a bit-mix of u1)."""
    r = _Rows(bs, idx, refl_scale, eta_override)
    kind = r.kind
    ci = cos_theta(wi)
    ones = torch.ones_like(ci)
    wo_d, w_d, p_d = {}, {}, {}
    delta = kind == BSDF_NULL
    eta_out = ones

    if _on(active, BSDF_DIFFUSE, BSDF_PLASTIC, BSDF_PHONG, BSDF_DIFFTRANS,
           BSDF_ROUGHDIFFUSE, BSDF_HK, BSDF_WARD, BSDF_ROUGHPLASTIC):
        wo_diff = warp.square_to_cosine_hemisphere(u2)
        wo_diff = _w(ci < 0, -wo_diff, wo_diff)   # on the side of wi
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(torch.abs(wo_diff))
        wo_d[BSDF_DIFFUSE], w_d[BSDF_DIFFUSE] = wo_diff, r.reflectance
        p_d[BSDF_DIFFUSE] = pdf_diff
    if _on(active, BSDF_DIELECTRIC, BSDF_HDIELECTRIC, BSDF_THINDIELECTRIC,
           BSDF_PLASTIC, BSDF_ROUGHPLASTIC):
        F, cos_t = fresnel_dielectric(ci, r.eta)
    wo_refl = reflect_local(wi)
    if _on(active, BSDF_DIELECTRIC, BSDF_HDIELECTRIC):
        # smooth dielectric (dielectric.cpp)
        reflect_choice = u1 < F
        eta_rel = torch.where(ci > 0, r.eta, 1.0 / r.eta)
        scale_t = 1.0 / eta_rel
        wo_refr = normalize(torch.stack(
            [-wi[..., 0] * scale_t, -wi[..., 1] * scale_t, cos_t], dim=-1))
        # radiance compression on transmission: 1 / eta_rel^2
        w_trans = r.specular_t * (scale_t * scale_t).unsqueeze(-1)
        for k in (BSDF_DIELECTRIC, BSDF_HDIELECTRIC):
            wo_d[k] = _w(reflect_choice, wo_refl, wo_refr)
            w_d[k] = _w(reflect_choice, r.specular_r, w_trans)
            p_d[k] = torch.where(reflect_choice, F, 1.0 - F)
        is_diel = (kind == BSDF_DIELECTRIC) | (kind == BSDF_HDIELECTRIC)
        delta = delta | is_diel
        eta_out = torch.where(is_diel & ~reflect_choice, eta_rel, eta_out)
    if _on(active, BSDF_THINDIELECTRIC):
        # both faces at once; transmission keeps the direction
        R = torch.where(F < 1.0, F * 2.0 / (1.0 + F), 1.0)
        thin_reflect = u1 < R
        wo_d[BSDF_THINDIELECTRIC] = _w(thin_reflect, wo_refl, -wi)
        w_d[BSDF_THINDIELECTRIC] = _w(thin_reflect, r.specular_r,
                                      r.specular_t)
        p_d[BSDF_THINDIELECTRIC] = torch.where(thin_reflect, R, 1.0 - R)
        delta = delta | (kind == BSDF_THINDIELECTRIC)
    if _on(active, BSDF_CONDUCTOR):
        wo_d[BSDF_CONDUCTOR] = wo_refl
        w_d[BSDF_CONDUCTOR] = r.specular_r * fresnel_conductor(
            ci, r.cond_eta, r.cond_k)
        p_d[BSDF_CONDUCTOR] = ones
        delta = delta | (kind == BSDF_CONDUCTOR)
    if _on(active, BSDF_MIRROR):
        wo_d[BSDF_MIRROR], w_d[BSDF_MIRROR] = wo_refl, r.specular_r
        p_d[BSDF_MIRROR] = ones
        delta = delta | (kind == BSDF_MIRROR)
    # the null surface of a medium boundary passes straight through
    wo_d[BSDF_NULL], w_d[BSDF_NULL], p_d[BSDF_NULL] = -wi, torch.ones_like(
        wi), ones
    if _on(active, BSDF_PLASTIC):
        # specular with probability F, else the cosine-weighted diffuse
        spec_choice = u1 < F
        wo_d[BSDF_PLASTIC] = _w(spec_choice, wo_refl, wo_diff)
        w_d[BSDF_PLASTIC] = _w(spec_choice, r.specular_r, r.reflectance * (
            (1.0 - fresnel_dielectric(cos_theta(wo_diff), r.eta)[0])
            / torch.clamp_min(1.0 - F, 1e-6)).unsqueeze(-1))
        p_d[BSDF_PLASTIC] = torch.where(spec_choice, F, (1.0 - F) * pdf_diff)
        delta = delta | ((kind == BSDF_PLASTIC) & spec_choice)

    alpha = r.alpha
    if _on(active, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC,
           BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        # a GGX microfacet on the side of wi, shared by the rough kinds
        m = _ggx_sample(alpha, u2)
        m = _w(ci < 0, -m, m)
        wo_rough = 2.0 * dot(wi, m, True) * m - wi
    if _on(active, BSDF_ROUGHCONDUCTOR):
        pdf_m = _ggx_pdf_m(torch.abs(m), alpha)
        G = _ggx_g1(wi, m, alpha) * _ggx_g1(wo_rough, m, alpha)
        Fcr = fresnel_conductor(dot(wi, m), r.cond_eta, r.cond_k)
        # weight = F G |wi.m| / (|ci| |m.z|) (Walter et al.)
        wo_d[BSDF_ROUGHCONDUCTOR] = wo_rough
        w_d[BSDF_ROUGHCONDUCTOR] = r.specular_r * Fcr * torch.where(
            cos_theta(wo_rough) * ci > 0,
            G * torch.abs(dot(wi, m)) / torch.clamp_min(
                torch.abs(ci) * torch.abs(cos_theta(m)), 1e-12),
            0.0).unsqueeze(-1)
        p_d[BSDF_ROUGHCONDUCTOR] = pdf_m / torch.clamp_min(
            4.0 * torch.abs(dot(wi, m)), 1e-12)

    def f_over_p(wo):
        f = _eval_base(bs, idx, wi, wo, refl_scale=refl_scale, active=active)
        p = _pdf_base(bs, idx, wi, wo, refl_scale=refl_scale, active=active)
        return f / torch.clamp_min(p, 1e-12).unsqueeze(-1), p

    if _on(active, BSDF_PHONG):
        phong_spec = u1 < _spec_weight(r)
        ct_lobe = u2[..., 0] ** (1.0 / (r.exponent + 1.0))
        st_lobe = safe_sqrt(1.0 - ct_lobe * ct_lobe)
        phi = 2.0 * math.pi * u2[..., 1]
        lobe = torch.stack([st_lobe * torch.cos(phi),
                            st_lobe * torch.sin(phi), ct_lobe], dim=-1)
        wo_ph = _w(phong_spec, Frame.from_normal(wo_refl).to_world(lobe),
                   wo_diff)
        wo_d[BSDF_PHONG] = wo_ph
        w_d[BSDF_PHONG], p_d[BSDF_PHONG] = f_over_p(wo_ph)
    if _on(active, BSDF_DIFFTRANS):
        # diffuse transmitter: the cosine lobe on the far side
        wo_d[BSDF_DIFFTRANS] = _flip_z(wo_diff)
        w_d[BSDF_DIFFTRANS], p_d[BSDF_DIFFTRANS] = r.reflectance, pdf_diff
    if _on(active, BSDF_ROUGHDIFFUSE):
        # the cosine proposal; weight = reflectance * Oren-Nayar factor
        wo_d[BSDF_ROUGHDIFFUSE] = wo_diff
        w_d[BSDF_ROUGHDIFFUSE] = r.reflectance * _oren_nayar_factor(
            wi, wo_diff, alpha).unsqueeze(-1)
        p_d[BSDF_ROUGHDIFFUSE] = pdf_diff
    if _on(active, BSDF_HK):
        # the attenuated straight-through delta with probability q_delta,
        # else a half/half cosine proposal on each side (weight f / p)
        _, _, q_hk = _hk_lobes(r, wi, wi)
        hk_delta = u1 < q_hk
        u1_r = torch.clamp((u1 - q_hk) / torch.clamp_min(1.0 - q_hk, 1e-6),
                           0.0, 1.0)
        wo_hk = _w(hk_delta, -wi, _w(u1_r < 0.5, _flip_z(wo_diff), wo_diff))
        w_hk, p_hk = f_over_p(wo_hk)
        tau_hk = (r.specular_r + r.specular_t) * torch.clamp_min(
            alpha, 1e-6).unsqueeze(-1)
        mu_i = torch.clamp_min(torch.abs(ci), 1e-5)
        w_hk_delta = torch.exp(-tau_hk / mu_i.unsqueeze(-1)) \
            / torch.clamp_min(q_hk, 1e-6).unsqueeze(-1)
        wo_d[BSDF_HK] = wo_hk
        w_d[BSDF_HK] = _w(hk_delta, w_hk_delta, w_hk)
        p_d[BSDF_HK] = torch.where(hk_delta, torch.clamp_min(q_hk, 1e-6),
                                   p_hk)
        delta = delta | ((kind == BSDF_HK) & hk_delta)
    if _on(active, BSDF_WARD):
        av = r.alpha_v
        ward_spec = u1 < _spec_weight(r)
        phi_in = 2.0 * math.pi * u2[..., 1]
        # phi_h with tan(phi_h) = (av / au) tan(phi)
        phi_h = torch.atan2(av * torch.sin(phi_in), alpha * torch.cos(phi_in))
        cph, sph = torch.cos(phi_h), torch.sin(phi_h)
        tan2_th = -torch.log(torch.clamp_min(u2[..., 0], 1e-9)) \
            / torch.clamp_min(
                cph * cph / torch.clamp_min(alpha * alpha, 1e-12)
                + sph * sph / torch.clamp_min(av * av, 1e-12), 1e-12)
        ct_h = 1.0 / torch.sqrt(1.0 + tan2_th)
        st_h = safe_sqrt(1.0 - ct_h * ct_h)
        h_w = torch.stack([st_h * cph, st_h * sph, ct_h], dim=-1)
        h_w = _w(ci < 0, -h_w, h_w)
        wo_ward = _w(ward_spec, 2.0 * dot(wi, h_w, True) * h_w - wi, wo_diff)
        wo_d[BSDF_WARD] = wo_ward
        w_d[BSDF_WARD], p_d[BSDF_WARD] = f_over_p(wo_ward)
    if _on(active, BSDF_ROUGHPLASTIC):
        # GGX specular with probability F(ci), else cosine diffuse
        wo_rp = _w(u1 < F, wo_rough, wo_diff)
        wo_d[BSDF_ROUGHPLASTIC] = wo_rp
        w_d[BSDF_ROUGHPLASTIC], p_d[BSDF_ROUGHPLASTIC] = f_over_p(wo_rp)
    if _on(active, BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        # Walter: the GGX microfacet, then a Fresnel choice of branch
        eta = r.eta
        im = dot(wi, m)
        F_rd, cos_t_rd = fresnel_dielectric(im, eta)
        rd_reflect = u1 < F_rd
        eta_rel_rd = torch.where(im > 0, eta, 1.0 / eta)
        inv_eta = 1.0 / eta_rel_rd
        cos_t_abs = safe_sqrt(1.0 - (1.0 - im * im) * inv_eta * inv_eta)
        wo_rd_tr = normalize(
            (inv_eta * torch.abs(im) - cos_t_abs).unsqueeze(-1)
            * (torch.sign(im).unsqueeze(-1) * m)
            - inv_eta.unsqueeze(-1) * wi)
        wo_rd = _w(rd_reflect, 2.0 * im.unsqueeze(-1) * m - wi, wo_rd_tr)
        G_rd = _ggx_g1(wi, m, alpha) * _ggx_g1(wo_rd, m, alpha)
        # |wi.m| G / (|ci| |m.z|); Fresnel cancels in each branch
        w_scalar = torch.abs(im) * G_rd / torch.clamp_min(
            torch.abs(ci) * torch.abs(cos_theta(m)), 1e-12)
        w_rd = _w(rd_reflect, r.specular_r,
                  r.specular_t * (inv_eta * inv_eta).unsqueeze(-1)) \
            * w_scalar.unsqueeze(-1)
        # total internal reflection: no refraction branch
        w_rd = _w(~rd_reflect & (cos_t_rd == 0.0), 0.0, w_rd)
        pdf_m_rd = _ggx_pdf_m(torch.abs(m), alpha)
        om = dot(wo_rd, m)
        denom = im + eta_rel_rd * om
        pdf_rd = torch.where(
            rd_reflect,
            F_rd * pdf_m_rd / torch.clamp_min(4.0 * torch.abs(om), 1e-12),
            (1.0 - F_rd) * pdf_m_rd * (eta_rel_rd * eta_rel_rd)
            * torch.abs(om) / torch.clamp_min(denom * denom, 1e-12))
        for k in (BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
            wo_d[k], w_d[k], p_d[k] = wo_rd, w_rd, pdf_rd
        is_rd = (kind == BSDF_ROUGHDIELECTRIC) | (kind == BSDF_HROUGHDIELECTRIC)
        eta_out = torch.where(is_rd, torch.where(rd_reflect, 1.0, eta_rel_rd),
                              eta_out)

    # each lane takes its kind's lobe; kinds without one here (the
    # coatings, resolved afterwards) take the diffuse lobe as JAX does
    first = BSDF_DIFFUSE if BSDF_DIFFUSE in wo_d else BSDF_NULL
    wo, weight, pdf_out = wo_d[first], w_d[first], p_d[first]
    for k in wo_d:
        if k == first:
            continue
        c = kind == k
        wo, weight = _w(c, wo_d[k], wo), _w(c, w_d[k], weight)
        pdf_out = torch.where(c, p_d[k], pdf_out)
    null_pass = kind == BSDF_NULL

    # mask.cpp: pass through unchanged with probability 1 - opacity
    if u_op is None:
        u_op = torch.abs(u1 * 4096.0) % 1.0
    opacity = r.opacity
    masked = u_op >= opacity
    wo = _w(masked, -wi, wo)
    weight = _w(masked, 1.0, weight)
    pdf_out = torch.where(masked, torch.clamp_min(1.0 - opacity, 1e-6),
                          pdf_out)
    bad = torch.all(weight == 0.0, dim=-1) | (pdf_out <= 0.0)
    return BSDFSample(wo=wo, weight=_w(bad, 0.0, weight), pdf=pdf_out,
                      delta=delta | masked, eta=eta_out,
                      null_passthrough=null_pass | masked)


# ---------------------------------------------------------------------------
# The dielectric coatings (coating.cpp, roughcoating.cpp): a smooth or
# GGX-rough layer of IOR eta over child0, with absorption optical depth
# sigmaA * thickness in specular_t. Directions refract into the coat before
# they meet the child, whose value and pdf pick up the invEta^2 cos(wo) /
# cos(wo') compression.
# ---------------------------------------------------------------------------
def _refract_into(w, eta):
    """A direction continued inside the coat (same side): (w', R, TIR)."""
    cw = cos_theta(w)
    F, cos_t = fresnel_dielectric(torch.abs(cw), eta)
    inv_eta = 1.0 / eta
    wp = torch.stack([inv_eta * w[..., 0], inv_eta * w[..., 1],
                      -torch.sign(cw) * cos_t], dim=-1)
    return wp, F, cos_t == 0.0


def _refract_outof(w, eta):
    """Coat -> exterior (refractOut, coating.cpp:215)."""
    cw = cos_theta(w)
    F, cos_t = fresnel_dielectric(torch.abs(cw), 1.0 / eta)
    wp = torch.stack([eta * w[..., 0], eta * w[..., 1],
                      -torch.sign(cw) * cos_t], dim=-1)
    return wp, F, cos_t == 0.0


class _Coat:
    """The coating rows of per-lane indices (JAX's _coat_rows)."""

    def __init__(self, bs: BSDFs, idx):
        r = _Rows(bs, idx)
        self.is_coat = (r.kind == BSDF_COATING) | (r.kind == BSDF_ROUGHCOATING)
        self.is_rough = r.kind == BSDF_ROUGHCOATING
        self.child = r.child0.to(idx.dtype)
        self.child_idx = torch.where(self.is_coat, self.child, -1)
        self.eta = torch.clamp_min(r.eta, 1.0 + 1e-4)
        self.spec_r, self.sigd, self.alpha = r.specular_r, r.specular_t, \
            r.alpha
        child_refl = bs.reflectance[torch.clamp(
            self.child, 0, bs.kind.shape[0] - 1).to(torch.int64)]
        ms = torch.amax(self.spec_r, dim=-1)
        self.sw = ms / torch.clamp_min(ms + torch.amax(child_refl, dim=-1),
                                       1e-12)

    def prob_spec(self, R12):
        return (R12 * self.sw) / torch.clamp_min(
            R12 * self.sw + (1.0 - R12) * (1.0 - self.sw), 1e-9)

    def conv(self, wo, wop):
        return (1.0 / (self.eta * self.eta)) * torch.abs(cos_theta(wo)) \
            / torch.clamp_min(abs_cos_theta(wop), 1e-6)


def _coat_absorb(sigd, wip, wop):
    return torch.exp(-sigd * (1.0 / torch.clamp_min(abs_cos_theta(wip), 1e-6)
                              + 1.0 / torch.clamp_min(abs_cos_theta(wop),
                                                      1e-6)).unsqueeze(-1))


def _coat_spec_m(wi, wo):
    m = normalize(wi + wo)
    return _w(cos_theta(wi) < 0, -m, m)


def _coating_eval(bs: BSDFs, idx, wi, wo, f_base, active=None):
    c = _Coat(bs, idx)
    wip, R12, t1 = _refract_into(wi, c.eta)
    wop, R21, t2 = _refract_into(wo, c.eta)
    f_n = _eval_base(bs, c.child_idx, wip, wop, active=active)
    f_c = f_n * ((1.0 - R12) * (1.0 - R21) * c.conv(wo, wop)).unsqueeze(-1) \
        * _coat_absorb(c.sigd, wip, wop)
    f_c = _w(t1 | t2, 0.0, f_c)
    if _on(active, BSDF_ROUGHCOATING):
        ci, co = cos_theta(wi), cos_theta(wo)
        m = _coat_spec_m(wi, wo)
        D = _ggx_d(m, c.alpha)
        G = _ggx_g1(wi, m, c.alpha) * _ggx_g1(wo, m, c.alpha)
        Fm = fresnel_dielectric(dot(wi, m), c.eta)[0]
        f_s = c.spec_r * (Fm * D * G / torch.clamp_min(
            4.0 * torch.abs(ci), 1e-12)).unsqueeze(-1)
        f_c = _w(c.is_rough & (ci * co > 0), f_c + f_s, f_c)
    return _w(c.is_coat, f_c, f_base)


def _coating_pdf(bs: BSDFs, idx, wi, wo, p_base, active=None):
    c = _Coat(bs, idx)
    wip, R12, t1 = _refract_into(wi, c.eta)
    wop, R21, t2 = _refract_into(wo, c.eta)
    prob_s = c.prob_spec(R12)
    p_n = _pdf_base(bs, c.child_idx, wip, wop, active=active)
    p_c = torch.where(t1 | t2, 0.0, p_n * c.conv(wo, wop) * (1.0 - prob_s))
    if _on(active, BSDF_ROUGHCOATING):
        m = _coat_spec_m(wi, wo)
        p_spec = _ggx_pdf_m(m, c.alpha) / torch.clamp_min(
            4.0 * torch.abs(dot(wo, m)), 1e-12)
        p_c = torch.where(c.is_rough, p_c + prob_s * p_spec, p_c)
    return torch.where(c.is_coat, p_c, p_base)


def _coating_sample(bs: BSDFs, idx, wi, u2, u1, res: BSDFSample,
                    active=None) -> BSDFSample:
    c = _Coat(bs, idx)
    wip, R12, t1 = _refract_into(wi, c.eta)
    prob_s = c.prob_spec(R12)
    chose_s = u1 < prob_s
    u1r = torch.clamp((u1 - prob_s) / torch.clamp_min(1.0 - prob_s, 1e-9),
                      0.0, 0.9999994)
    # the nested branch: the child samples with the refracted incident
    res_n = _sample_base(bs, c.child_idx, wip, u2, u1r, active=active)
    wo_out, R21, t2 = _refract_outof(res_n.wo, c.eta)
    w_n = res_n.weight * ((1.0 - R12) * (1.0 - R21) / torch.clamp_min(
        1.0 - prob_s, 1e-9)).unsqueeze(-1) * _coat_absorb(c.sigd, wip,
                                                           res_n.wo)
    p_nn = res_n.pdf * (1.0 - prob_s) * c.conv(wo_out, res_n.wo)
    w_n = _w(t1 | t2, 0.0, w_n)
    # the specular branch
    ci = cos_theta(wi)
    if _on(active, BSDF_ROUGHCOATING):
        m_s = _ggx_sample(c.alpha, u2)
    else:
        m_s = torch.zeros_like(wi)
        m_s[..., 2] = 1.0
    m_s = _w(ci < 0, -m_s, m_s)
    wo_s = 2.0 * dot(wi, m_s, True) * m_s - wi
    wo_c = _w(chose_s, wo_s, wo_out)
    smooth_spec = chose_s & ~c.is_rough
    if _on(active, BSDF_ROUGHCOATING):
        # not a delta: weight = f / p at the sampled direction
        f_all = _coating_eval(bs, idx, wi, wo_c, torch.zeros_like(w_n),
                              active=active)
        p_all = _coating_pdf(bs, idx, wi, wo_c, torch.zeros_like(p_nn),
                             active=active)
        w_rough_c = f_all / torch.clamp_min(p_all, 1e-12).unsqueeze(-1)
    else:
        w_rough_c, p_all = w_n, p_nn
    w_spec_smooth = c.spec_r * (R12 / torch.clamp_min(prob_s, 1e-9)
                                ).unsqueeze(-1)
    w_c = _w(smooth_spec, w_spec_smooth, _w(c.is_rough, w_rough_c, w_n))
    p_c = torch.where(smooth_spec, prob_s, torch.where(c.is_rough, p_all,
                                                       p_nn))
    delta_c = smooth_spec | (~c.is_rough & res_n.delta)
    bad = torch.all(w_c == 0.0, dim=-1) | (p_c <= 0.0)
    w_c = _w(bad, 0.0, w_c)
    k = c.is_coat
    return BSDFSample(
        wo=_w(k, wo_c, res.wo), weight=_w(k, w_c, res.weight),
        pdf=torch.where(k, p_c, res.pdf),
        delta=torch.where(k, delta_c, res.delta),
        eta=torch.where(k, 1.0, res.eta),
        null_passthrough=res.null_passthrough & ~k)


# ---------------------------------------------------------------------------
# Public API: the base lobes and one level of wrapper kinds
# ---------------------------------------------------------------------------
def _eval_full(bs, idx, wi, wo, eta_override=None, refl_scale=None,
               active=None):
    f = _eval_base(bs, idx, wi, wo, eta_override, refl_scale, active)
    if _on(active, BSDF_COATING, BSDF_ROUGHCOATING):
        f = _coating_eval(bs, idx, wi, wo, f, active)
    return f


def _pdf_full(bs, idx, wi, wo, eta_override=None, refl_scale=None,
              active=None):
    p = _pdf_base(bs, idx, wi, wo, eta_override, refl_scale, active)
    if _on(active, BSDF_COATING, BSDF_ROUGHCOATING):
        p = _coating_pdf(bs, idx, wi, wo, p, active)
    return p


def eval(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
         active=None):
    """f * |cos(wo)|."""
    idx_a, idx_b, w_a, wi2, flip = _wrapper_resolve(bs, idx, wi, active)
    wo2 = _w(flip, _flip_z(wo), wo) if _on(active, BSDF_TWOSIDED) else wo
    f = _eval_full(bs, idx_a, wi2, wo2, eta_override, refl_scale, active)
    if _on(active, BSDF_MIXTURE):
        f_b = _eval_full(bs, idx_b, wi2, wo2, eta_override, refl_scale,
                         active)
        f = w_a.unsqueeze(-1) * f + (1.0 - w_a).unsqueeze(-1) * f_b
    return f


def pdf(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
        active=None):
    """Solid-angle pdf of sampling wo."""
    idx_a, idx_b, w_a, wi2, flip = _wrapper_resolve(bs, idx, wi, active)
    wo2 = _w(flip, _flip_z(wo), wo) if _on(active, BSDF_TWOSIDED) else wo
    p = _pdf_full(bs, idx_a, wi2, wo2, eta_override, refl_scale, active)
    if _on(active, BSDF_MIXTURE):
        p_b = _pdf_full(bs, idx_b, wi2, wo2, eta_override, refl_scale,
                        active)
        p = w_a * p + (1.0 - w_a) * p_b
    return p


def sample(bs: BSDFs, idx, wi, u2, u1, eta_override=None, refl_scale=None,
           active=None, u_op=None) -> BSDFSample:
    """A direction from the lobes of each lane's BSDF: u2 draws it, u1
    picks the lobe (and, in a mixture, the child first)."""
    idx_a, idx_b, w_a, wi2, flip = _wrapper_resolve(bs, idx, wi, active)
    if _on(active, BSDF_MIXTURE):
        # one-sample MIS over the two children: A with probability w_a, the
        # rescaled u1 then picks the child's own lobe
        pick_a = u1 < w_a
        u1r = torch.where(pick_a, u1 / torch.clamp_min(w_a, 1e-9),
                          (u1 - w_a) / torch.clamp_min(1.0 - w_a, 1e-9))
        is_mix = _Rows(bs, idx).kind == BSDF_MIXTURE
        u1_eff = torch.where(is_mix, torch.clamp_max(u1r, 0.9999994), u1)
        c_idx = torch.where(is_mix, torch.where(pick_a, idx_a, idx_b), idx_a)
        res = _sample_base(bs, c_idx, wi2, u2, u1_eff, eta_override,
                           refl_scale, active, u_op)
        # smooth lobes: the mixture's f / p; delta lobes keep the child's
        # weight with the pdf scaled by the pick probability
        wo_back = _w(flip, _flip_z(res.wo), res.wo)
        f_mix = eval(bs, idx, wi, wo_back, eta_override, refl_scale, active)
        p_mix = pdf(bs, idx, wi, wo_back, eta_override, refl_scale, active)
        pick_p = torch.where(pick_a, w_a, 1.0 - w_a)
        wt = _w(is_mix & ~res.delta,
                f_mix / torch.clamp_min(p_mix, 1e-12).unsqueeze(-1),
                res.weight)
        pp = torch.where(is_mix, torch.where(res.delta, res.pdf * pick_p,
                                             p_mix), res.pdf)
        res = replace(res, weight=wt, pdf=pp)
    else:
        res = _sample_base(bs, idx_a, wi2, u2, u1, eta_override, refl_scale,
                           active, u_op)
    if _on(active, BSDF_COATING, BSDF_ROUGHCOATING):
        res = _coating_sample(bs, idx_a, wi2, u2, u1, res, active)
    if _on(active, BSDF_TWOSIDED):
        res = replace(res, wo=_w(flip, _flip_z(res.wo), res.wo))
    return res
