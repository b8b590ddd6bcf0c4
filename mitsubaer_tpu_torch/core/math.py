"""Vector math on (..., 3) float32 tensors (port of mitsubaer_tpu/core/math.py).

Sums over the three components are written out as ((x + y) + z), so the
order of rounding is the same on every device.
"""
from __future__ import annotations

import math

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


def cos_theta(v):
    return v[..., 2]


def abs_cos_theta(v):
    return torch.abs(v[..., 2])


def sin_theta(v):
    return torch.sqrt(torch.clamp_min(1.0 - v[..., 2] * v[..., 2], 0.0))


def tan_theta(v):
    z = v[..., 2]
    return sin_theta(v) / torch.where(z == 0, 1e-20, z)


def reflect_local(wi):
    """Mirror reflection in the local frame: (-x, -y, z)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def reflect(wi, n):
    """wi (pointing away from the surface) reflected about n."""
    return 2.0 * dot(wi, n, True) * n - wi


def refract(wi, n, eta):
    """wi (away from the surface) refracted through n with relative IOR eta
    (int/ext when entering). Returns (wt, total internal reflection);
    cos(theta_t) has the opposite sign of cos(theta_i) (util.cpp refract)."""
    cos_i = dot(wi, n, True)
    eta_rel = torch.where(cos_i > 0, eta, 1.0 / eta)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (eta_rel * eta_rel)
    tir = cos_t2 <= 0.0
    cos_t = safe_sqrt(cos_t2)
    cos_t = torch.where(cos_i > 0, -cos_t, cos_t)
    wt = -wi / eta_rel + (cos_i / eta_rel + cos_t) * n
    return normalize(wt), tir[..., 0]


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized conductor Fresnel reflectance for (..., 3) eta and k
    (fresnelConductorApprox)."""
    ci = torch.abs(cos_theta_i).unsqueeze(-1)
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs2 = (t1 - t2) / (t1 + t2)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp2 = rs2 * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp2 + rs2)


def spherical_direction(theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def spherical_coordinates(d):
    theta = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    return theta, torch.where(phi < 0, phi + 2.0 * math.pi, phi)


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


# tables of more rows than this are indexed (smalltab._MAX_UNROLL)
_MAX_UNROLL = 16


def take_rows(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """table[i]: rows of a small per-medium table for per-lane indices i (in
    range), as the JAX package's smalltab.take: a select chain over the
    rows. Its backward, as autograd forms it, sums the lanes of each row;
    the backward of plain indexing (an index_put_ with accumulate)
    serialises on a row that a million lanes share, ~190 ms a call on an
    H100."""
    n = table.shape[0]
    if n > _MAX_UNROLL:
        return table[i]
    expand = i.shape + (1,) * (table.dim() - 1)
    out = table[0].expand(i.shape + table.shape[1:])
    for k in range(1, n):
        out = torch.where((i == k).view(expand), table[k], out)
    return out
