"""4x4 transforms (port of mitsubaer_tpu/core/transform.py).

Scene building composes matrices on the host in numpy; tensors only ever see
the composed (4, 4) float32 matrix.
"""
from __future__ import annotations

import numpy as np
import torch


def look_at(origin, target, up):
    """Camera-to-world transform (Mitsuba's Transform::lookAt): +z looks
    from origin toward target, left = normalize(cross(up, dir)),
    new_up = cross(dir, left)."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) matrix to (..., 3) points."""
    return apply_vector(m, p) + m[:3, 3]


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by m[:3, :3], with the sums written out."""
    r = m[:3, :3]
    return torch.stack(
        [v[..., 0] * r[i, 0] + v[..., 1] * r[i, 1] + v[..., 2] * r[i, 2]
         for i in range(3)], dim=-1)
