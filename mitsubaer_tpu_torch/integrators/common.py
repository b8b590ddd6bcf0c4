"""Shared integrator helpers (port of mitsubaer_tpu/integrators/common.py)."""
from __future__ import annotations

import torch


def scene_epsilon(scene):
    """Relative ray epsilon from the scene extent (ShadowEpsilon analogue)."""
    diag = torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min)
    return 1e-4 * torch.clamp_min(diag, 1e-3)
