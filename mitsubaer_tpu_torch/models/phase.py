"""Phase functions, isotropic and Henyey-Greenstein (port of
mitsubaer_tpu/models/phase.py::eval and sample).

Both wi and wo are propagation directions; for g > 0 the HG lobe peaks at
wo == wi (forward scattering), matching hg.cpp with wi negated.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import warp
from ..core.math import INV_FOURPI, Frame, dot, safe_sqrt, take_rows
from ..scene.types import PH_HG, PhaseTable


def hg_pdf(g, cos_theta):
    """hg.cpp:107 for cos_theta = dot(wi toward the source, wo)."""
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / (temp * safe_sqrt(temp))


def eval(ph: PhaseTable, idx, wi, wo):
    """Phase value (== pdf) of medium `idx` for (N, 3) directions. Only
    isotropic and HG are ported; callers gate on the scene's phase kinds."""
    i = torch.clamp(idx, 0, ph.kind.shape[0] - 1).to(torch.int64)
    kind, g = ph.kind[i], take_rows(ph.g, i)
    cos_forward = dot(wi, wo)
    return torch.where(kind == PH_HG, hg_pdf(g, -cos_forward),
                       torch.full_like(cos_forward, INV_FOURPI))


@dataclass(frozen=True)
class PhaseSample:
    wo: torch.Tensor      # (N, 3) new propagation direction
    pdf: torch.Tensor     # (N,)
    weight: torch.Tensor  # (N,) value / pdf (= 1)


def sample(ph: PhaseTable, idx, wi, u2) -> PhaseSample:
    """Sample a propagation direction after scattering from propagation
    direction wi (unit): HG about +wi, or the uniform sphere. In the
    differentiable form of the JAX package (phase.py:178-189): wo is
    detached, the weight p / max(p.detach(), 1e-12) is 1 in value and keeps
    the pathwise derivative with respect to g, and the pdf stays attached
    for the integrator's score term."""
    i = torch.clamp(idx, 0, ph.kind.shape[0] - 1).to(torch.int64)
    kind, g = ph.kind[i], take_rows(ph.g, i)
    wo_hg = Frame.from_normal(wi).to_world(warp.square_to_hg(g, u2))
    wo = torch.where((kind == PH_HG).unsqueeze(-1), wo_hg,
                     warp.square_to_uniform_sphere(u2))
    wo = wo.detach()
    p = eval(ph, idx, wi, wo)
    return PhaseSample(wo=wo, pdf=p,
                       weight=p / torch.clamp_min(p.detach(), 1e-12))
