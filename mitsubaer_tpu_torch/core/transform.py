"""4x4 transforms (port of mitsubaer_tpu/core/transform.py).

Scene building composes matrices on the host in numpy; tensors only ever see
the composed (4, 4) float32 matrix.
"""
from __future__ import annotations

import numpy as np
import torch


def identity():
    return np.eye(4, dtype=np.float32)


def translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale(v):
    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg):
    """Rotation about `axis` by `angle_deg` degrees (transform.cpp:218)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (np.eye(3) + s * K + (1 - c) * (K @ K)).astype(np.float32)
    return m


def compose(*mats):
    out = np.eye(4, dtype=np.float32)
    for m in mats:
        out = out @ np.asarray(m, np.float32)
    return out


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


def apply_normal(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Normals transform by the inverse transpose of m[:3, :3]."""
    return n @ torch.linalg.inv(m[:3, :3])


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by m[:3, :3], with the sums written out."""
    r = m[:3, :3]
    return torch.stack(
        [v[..., 0] * r[i, 0] + v[..., 1] * r[i, 1] + v[..., 2] * r[i, 2]
         for i in range(3)], dim=-1)
