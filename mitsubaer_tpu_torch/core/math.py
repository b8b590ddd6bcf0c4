"""Vector math on (..., 3) float32 tensors (port of mitsubaer_tpu/core/math.py).

Sums over the three components are written out as ((x + y) + z), so the
order of rounding is the same on every device.
"""
from __future__ import annotations

import torch

INV_PI = 0.3183098861837907
INV_TWOPI = 0.15915494309189535
INV_FOURPI = 0.07957747154594767


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdim else r


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return dot(v, v, keepdim)


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdim), 1e-30))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v/|v|; zero vectors give zeros, not NaN."""
    return v * torch.rsqrt(torch.clamp_min(dot(v, v, True), 1e-24))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 1e-12))


def sgn(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0)


def coordinate_system(n: torch.Tensor):
    """Orthonormal (s, t) around unit n with s x t = n (the branchless
    Duff et al. / Frisvad construction of the JAX package)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    s = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    t = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return s, t


class Frame:
    """Shading frame (s, t, n) around a unit normal."""

    def __init__(self, s, t, n):
        self.s, self.t, self.n = s, t, n

    @staticmethod
    def from_normal(n: torch.Tensor) -> "Frame":
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)],
                           dim=-1)

    def to_world(self, v: torch.Tensor) -> torch.Tensor:
        return (v[..., 0:1] * self.s + v[..., 1:2] * self.t
                + v[..., 2:3] * self.n)


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel reflectance for eta = int/ext IOR and a
    signed cos_theta_i (negative = exiting). Returns (F, cos_theta_t), the
    transmitted cosine signed opposite to cos_theta_i (fresnelDielectricExt)."""
    eta_rel = torch.where(cos_theta_i > 0, eta, 1.0 / eta)
    sin_t2 = (1.0 - cos_theta_i * cos_theta_i) / (eta_rel * eta_rel)
    cos_t = safe_sqrt(1.0 - sin_t2)
    tir = sin_t2 > 1.0
    abs_ci = torch.abs(cos_theta_i)
    den_s = abs_ci + eta_rel * cos_t
    den_p = eta_rel * abs_ci + cos_t
    rs = (abs_ci - eta_rel * cos_t) / torch.where(den_s == 0, 1.0, den_s)
    rp = (eta_rel * abs_ci - cos_t) / torch.where(den_p == 0, 1.0, den_p)
    F = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_theta_t = torch.where(cos_theta_i > 0, -cos_t, cos_t)
    return F, torch.where(tir, 0.0, cos_theta_t)


def mis_weight_power(pdf_a, pdf_b):
    """Power heuristic (beta = 2)."""
    a2 = pdf_a * pdf_a
    denom = a2 + pdf_b * pdf_b
    return torch.where(denom > 0, a2 / torch.clamp_min(denom, 1e-30), 0.0)
