"""Phase functions (port of mitsubaer_tpu/models/phase.py): isotropic,
Henyey-Greenstein, Rayleigh, von Mises-Fisher, the two-lobe HG mixture,
Kajiya-Kay and microflake.

Both wi and wo are propagation directions; for g > 0 the HG lobe peaks at
wo == wi (forward scattering), matching hg.cpp with wi negated. Kajiya-Kay
and microflake lobes turn about the medium's fiber axis, or about a per-lane
axis from an orientation field (`axis_override`, heterogeneous.cpp:164).

`active` is the scene's set of phase kinds (RenderConfig.phase_kinds, or
None for all): only those kinds' lobes are evaluated, as the JAX package
compiles only them. A lane's value does not depend on it as long as its
kind is in the set.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import special, warp
from ..core.math import INV_FOURPI, Frame, dot, safe_sqrt, take_rows
from ..scene.types import (PH_HG, PH_KKAY, PH_MICROFLAKE, PH_MIXTURE,
                           PH_RAYLEIGH, PH_VMF, PhaseTable)

_EXT = (PH_MIXTURE, PH_VMF, PH_KKAY, PH_MICROFLAKE)


def _on(active, *ks) -> bool:
    return active is None or any(k in active for k in ks)


def hg_pdf(g, cos_theta):
    """hg.cpp:107 for cos_theta = dot(wi toward the source, wo)."""
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / (temp * safe_sqrt(temp))


def _index(ph: PhaseTable, idx):
    return torch.clamp(idx, 0, ph.kind.shape[0] - 1).to(torch.int64)


def _params_ext(ph: PhaseTable, i, axis_override):
    axis = take_rows(ph.axis, i) if axis_override is None else axis_override
    return (take_rows(ph.g2, i), take_rows(ph.mix, i),
            take_rows(ph.kappa, i), axis)


def _mirror(wi, axis):
    """wi reflected about the fiber axis."""
    return 2.0 * dot(wi, axis, keepdim=True) * axis - wi


def _kkay_value(wi, wo, axis, expn: float = 4.0):
    """Kajiya-Kay fiber phase (kkay.cpp): a diffuse sin(theta_o) lobe,
    normalised over the sphere (pi^2), plus a (p+1)/(2 pi) cos^p lobe about
    the fiber-mirrored direction."""
    st_o = safe_sqrt(1.0 - dot(wo, axis) ** 2)
    diffuse = st_o / (math.pi * math.pi)
    spec = (torch.clamp_min(dot(_mirror(wi, axis), wo), 0.0) ** expn
            * (expn + 1.0) / (2.0 * math.pi))
    return 0.7 * diffuse + 0.3 * spec


def _eval_kinds(ph, i, kind, g, wi, wo, active, axis_override):
    cos_forward = dot(wi, wo)
    v_hg = hg_pdf(g, -cos_forward)
    out = torch.where(kind == PH_HG, v_hg,
                      torch.full_like(cos_forward, INV_FOURPI))
    if _on(active, PH_RAYLEIGH):
        v_ray = 3.0 / (16.0 * math.pi) * (1.0 + cos_forward * cos_forward)
        out = torch.where(kind == PH_RAYLEIGH, v_ray, out)
    if _on(active, *_EXT):
        g2, mix, kappa, axis = _params_ext(ph, i, axis_override)
        if _on(active, PH_MIXTURE):
            v_mix = mix * v_hg + (1.0 - mix) * hg_pdf(g2, -cos_forward)
            out = torch.where(kind == PH_MIXTURE, v_mix, out)
        if _on(active, PH_VMF):
            out = torch.where(kind == PH_VMF,
                              special.vmf_pdf(cos_forward, kappa), out)
        if _on(active, PH_KKAY):
            out = torch.where(kind == PH_KKAY, _kkay_value(wi, wo, axis),
                              out)
        if _on(active, PH_MICROFLAKE):
            # vMF flakes about the fiber-mirrored direction, mixed 50/50
            # with isotropic
            v_mf = (0.5 * special.vmf_pdf(dot(_mirror(wi, axis), wo), kappa)
                    + 0.5 * INV_FOURPI)
            out = torch.where(kind == PH_MICROFLAKE, v_mf, out)
    return out


def eval(ph: PhaseTable, idx, wi, wo, active=None, axis_override=None):
    """Phase value (== pdf but for Kajiya-Kay's sampling) of medium `idx`
    for (N, 3) directions; axis_override: (N, 3) per-lane fiber axes from
    the orientation field, in place of the table's."""
    i = _index(ph, idx)
    return _eval_kinds(ph, i, ph.kind[i], take_rows(ph.g, i), wi, wo,
                       active, axis_override)


@dataclass(frozen=True)
class PhaseSample:
    wo: torch.Tensor      # (N, 3) new propagation direction
    pdf: torch.Tensor     # (N,)
    weight: torch.Tensor  # (N,) value / pdf


def sample(ph: PhaseTable, idx, wi, u2, active=None,
           axis_override=None) -> PhaseSample:
    """Sample a propagation direction after scattering from propagation
    direction wi (unit). In the differentiable form of the JAX package
    (phase.py:178-189): wo is detached, the weight p / max(p.detach(),
    1e-12) is 1 in value and keeps the pathwise derivative with respect to
    g, and the pdf stays attached for the integrator's score term.
    Kajiya-Kay samples the uniform sphere: its weight is f / (1 / 4 pi)."""
    i = _index(ph, idx)
    kind, g = ph.kind[i], take_rows(ph.g, i)
    frame = Frame.from_normal(wi)
    wo_iso = warp.square_to_uniform_sphere(u2)
    wo = torch.where((kind == PH_HG).unsqueeze(-1),
                     frame.to_world(warp.square_to_hg(g, u2)), wo_iso)
    if _on(active, PH_RAYLEIGH):
        # inverse cdf of (3/8)(1 + c^2) by Cardano
        z = 2.0 * (2.0 * u2[..., 0] - 1.0)
        A = _cbrt(z + torch.sqrt(z * z + 1.0))
        c_ray = A - 1.0 / A
        s_ray = safe_sqrt(1.0 - c_ray * c_ray)
        phi = 2.0 * math.pi * u2[..., 1]
        wo_ray = frame.to_world(torch.stack(
            [s_ray * torch.cos(phi), s_ray * torch.sin(phi), c_ray], dim=-1))
        wo = torch.where((kind == PH_RAYLEIGH).unsqueeze(-1), wo_ray, wo)
    if _on(active, *_EXT):
        g2, mix, kappa, axis = _params_ext(ph, i, axis_override)
        if _on(active, PH_MIXTURE):
            # pick a lobe by u2[0], rescaled into the picked lobe's range
            pick1 = u2[..., 0] < mix
            u0r = torch.where(pick1, u2[..., 0] / torch.clamp_min(mix, 1e-9),
                              (u2[..., 0] - mix)
                              / torch.clamp_min(1.0 - mix, 1e-9))
            u2m = torch.stack([torch.clamp(u0r, 0.0, 0.9999994),
                               u2[..., 1]], dim=-1)
            wo_mix = frame.to_world(warp.square_to_hg(
                torch.where(pick1, g, g2), u2m))
            wo = torch.where((kind == PH_MIXTURE).unsqueeze(-1), wo_mix, wo)
        if _on(active, PH_VMF):
            wo_vmf = frame.to_world(special.vmf_sample(u2[..., 0],
                                                       u2[..., 1], kappa))
            wo = torch.where((kind == PH_VMF).unsqueeze(-1), wo_vmf, wo)
        if _on(active, PH_MICROFLAKE):
            # 50/50: the vMF lobe about the fiber mirror, or isotropic
            lobe = Frame.from_normal(_mirror(wi, axis)).to_world(
                special.vmf_sample(
                    torch.clamp(torch.fmod(u2[..., 0] * 2.0, 1.0), 0,
                                0.9999994), u2[..., 1], kappa))
            wo_mf = torch.where((u2[..., 0] < 0.5).unsqueeze(-1), lobe,
                                wo_iso)
            wo = torch.where((kind == PH_MICROFLAKE).unsqueeze(-1), wo_mf,
                             wo)
        if _on(active, PH_KKAY):
            wo = torch.where((kind == PH_KKAY).unsqueeze(-1), wo_iso, wo)
    wo = wo.detach()
    p = _eval_kinds(ph, i, kind, g, wi, wo, active, axis_override)
    weight = p / torch.clamp_min(p.detach(), 1e-12)
    is_kk = kind == PH_KKAY
    weight = torch.where(is_kk, p / INV_FOURPI, weight)
    p = torch.where(is_kk, INV_FOURPI, p)
    return PhaseSample(wo=wo, pdf=p, weight=weight)


def _cbrt(x):
    """Real cube root (jnp.cbrt): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
