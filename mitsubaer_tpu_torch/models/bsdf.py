"""BSDFs (port of mitsubaer_tpu/models/bsdf.py for BSDF_DIFFUSE).

Directions are in the local shading frame (+z = normal), `wi` points toward
the previous vertex, `eval` returns f * cos(wo) and `sample` returns
weight = f * cos / pdf, as in the JAX package. A negative index is the null
surface of a pure medium boundary. The other BSDF kinds are not ported
(ROADMAP Queue 1 step 9); the scene builder refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.math import INV_PI
from ..scene.types import BSDF_DIFFUSE, BSDFs


@dataclass(frozen=True)
class BSDFSample:
    wo: torch.Tensor      # (N, 3) local frame
    weight: torch.Tensor  # (N, 3) f * cos / pdf
    pdf: torch.Tensor     # (N,) solid-angle pdf (1 for the null passthrough)
    delta: torch.Tensor   # (N,) bool
    eta: torch.Tensor     # (N,) relative IOR of the event (1: no refraction)


def _diffuse(bs: BSDFs, idx):
    """(is_diffuse, reflectance) per lane; idx < 0 is the null surface."""
    i = torch.clamp(idx, 0, bs.kind.shape[0] - 1).to(torch.int64)
    return (idx >= 0) & (bs.kind[i] == BSDF_DIFFUSE), bs.reflectance[i]


def _front(wi, wo):
    return (wi[..., 2] > 0) & (wo[..., 2] > 0)


def eval(bs: BSDFs, idx, wi, wo):
    """f cos(wo); zero unless wi and wo both lie on the front side."""
    is_diff, refl = _diffuse(bs, idx)
    f = refl * (INV_PI * torch.clamp_min(wo[..., 2], 0.0)).unsqueeze(-1)
    return torch.where((is_diff & _front(wi, wo)).unsqueeze(-1), f, 0.0)


def pdf(bs: BSDFs, idx, wi, wo):
    is_diff, _ = _diffuse(bs, idx)
    return torch.where(is_diff & _front(wi, wo),
                       warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def sample(bs: BSDFs, idx, wi, u2, u1) -> BSDFSample:
    """Cosine-weighted sample on the side of wi; the null surface passes
    straight through (wo = -wi, weight 1, pdf 1, delta)."""
    is_diff, refl = _diffuse(bs, idx)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo_diff = torch.where((wi[..., 2] < 0).unsqueeze(-1), -wo_diff, wo_diff)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(torch.abs(wo_diff))
    wo = torch.where(is_diff.unsqueeze(-1), wo_diff, -wi)
    weight = torch.where(is_diff.unsqueeze(-1), refl, 1.0)
    p = torch.where(is_diff, pdf_diff, 1.0)
    bad = torch.all(weight == 0.0, dim=-1) | (p <= 0.0)
    return BSDFSample(wo=wo, weight=torch.where(bad.unsqueeze(-1), 0.0, weight),
                      pdf=p, delta=~is_diff, eta=torch.ones_like(p))
