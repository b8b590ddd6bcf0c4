"""Phase functions, isotropic and Henyey-Greenstein (port of
mitsubaer_tpu/models/phase.py::eval).

Both wi and wo are propagation directions; for g > 0 the HG lobe peaks at
wo == wi (forward scattering), matching hg.cpp with wi negated.
"""
from __future__ import annotations

import torch

from ..core.math import INV_FOURPI, dot, safe_sqrt
from ..scene.types import PH_HG, PhaseTable


def hg_pdf(g, cos_theta):
    """hg.cpp:107 for cos_theta = dot(wi toward the source, wo)."""
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / (temp * safe_sqrt(temp))


def eval(ph: PhaseTable, idx, wi, wo):
    """Phase value (== pdf) of medium `idx` for (N, 3) directions. Only
    isotropic and HG are ported; callers gate on the scene's phase kinds."""
    i = torch.clamp(idx, 0, ph.kind.shape[0] - 1).to(torch.int64)
    kind, g = ph.kind[i], ph.g[i]
    cos_forward = dot(wi, wo)
    return torch.where(kind == PH_HG, hg_pdf(g, -cos_forward),
                       torch.full_like(cos_forward, INV_FOURPI))
