"""Shared integrator helpers (port of mitsubaer_tpu/integrators/common.py):
the steady-state contribution sink, Russian roulette and the ray epsilon.
Transient, bounce and CW-ToF sinks are not ported (ROADMAP Queue 1 step 10).
"""
from __future__ import annotations

import torch

from ..scene.types import RenderConfig


def new_sink(n: int, device=None) -> torch.Tensor:
    """Steady-state sink: the (N, 3) radiance of each lane."""
    return torch.zeros((n, 3), dtype=torch.float32, device=device)


def add_contribution(sink, value, active):
    """sink + value where active; non-finite values carry no energy (they
    are numerical casualties on degenerate lanes) and are dropped."""
    value = torch.where(torch.isfinite(value), value, 0.0)
    return sink + torch.where(active.unsqueeze(-1), value, 0.0)


def russian_roulette(throughput, eta_scale, u, depth, cfg: RenderConfig):
    """Mitsuba-style RR (path.cpp:200-208): survive with
    q = min(max(throughput) eta^2, 0.95) once depth >= rr_depth."""
    q = torch.clamp_max(torch.amax(throughput, dim=-1) * eta_scale * eta_scale,
                        0.95)
    do_rr = depth >= cfg.rr_depth
    survive = torch.where(do_rr, u < q, True)
    throughput = torch.where(
        do_rr.unsqueeze(-1),
        throughput / torch.clamp_min(q, 1e-6).unsqueeze(-1), throughput)
    return throughput, survive


def scene_epsilon(scene):
    """Relative ray epsilon from the scene extent (ShadowEpsilon analogue)."""
    diag = torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min)
    return 1e-4 * torch.clamp_min(diag, 1e-3)
