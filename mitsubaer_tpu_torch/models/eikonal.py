"""Eikonal core (port of mitsubaer_tpu/models/eikonal.py): curved rays
through a refractive-index field (RIF) and the boundary value problem of
curved next-event estimation.

Rays obey d/ds(n dx/ds) = grad n; with the scaled velocity v (|v| = n) one
velocity-Verlet step of size h is (er_step, heterogeneousrefractive.cpp:653)

    v += h/2 grad n(p);  p += h v / n(p);  v += h/2 grad n(p);  opt += h n.

Curved NEE solves for the initial velocity that joins a medium vertex to a
target point with a batched Levenberg-Marquardt iteration over the endpoint
error, whose Jacobian comes from dp/dv0 and dv/dv0 carried along the ray
(er_derivativestep, :798-814).

Fields: the analytic RIFs constant / linear / radial-Gaussian / acoustic
(a Bessel beam, acousticrifvolume.cpp), the analytic sphere / box SDFs,
and the cubic B-spline RIF and SDF over a coefficient grid
(core/spline.py).

The two march loops run in kernels D and E (models/ermarch.py) where the
JAX package runs its Pallas kernels (`_er_kernel_ok` and its lax.cond on
the kind): in forward mode, in float32, with an analytic RIF of kind <=
RIF_RADIAL and an analytic SDF. Everything else, the differentiable
marches, every acoustic and spline march and the float64 core, runs the
kernels' plain versions (`ermarch.trace_plain`,
`ermarch.sens_march_plain`), which are the JAX package's XLA loops in
PyTorch. The route follows from the mode, the dtype and the fields alone
(`kernel_route`).

Float64 (the integrator's `er_f64`): every function here follows the
dtype of its points, with the parameters held as float32 values as the
JAX package holds them, so a float64 march promotes them as JAX does
under x64; the analytic RIF is then computed in the JAX package's order
(`_rif_attached`).

`differentiable=True` keeps autograd attached through the marches: to the
RIF's parameter tensor, which `rif_from_media` keeps where it requires
grad, and to the spline coefficients. The analytic RIF is then computed
from that tensor in the JAX package's order; without it, from float32 host
values in the order of the kernels' CUDA source, so that kernel and plain
version round alike. `solve_bvp(differentiable=True)` solves on detached
fields and inputs (kernel E for the radial RIF on the card) and integrates
once, attached, from the solution.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from ..core import spline, warp
from ..core.math import Frame, dot, length, normalize, safe_sqrt, sgn
from ..core.rng import M32, _hash_u32, _u32_to_float
from ..scene.types import Media

RIF_CONST = 0
RIF_LINEAR = 1    # n = p0 + g . p                   params [p0, gx, gy, gz]
RIF_RADIAL = 2    # n = p0 + a exp(-|p-c|^2 / w^2)   params [p0, a, w, cx, cy, cz]
RIF_ACOUSTIC = 3  # n = p0 + nmax J_m(kr r) cos(m phi), the beam along +x;
#                   params [p0, nmax, kr, m] (m 0..4)
RIF_SPLINE = 4    # cubic B-spline over the media's rif_coeff

SDF_NONE = 0      # always outside
SDF_SPHERE = 1    # params [cx, cy, cz, radius]
SDF_BOX = 2       # params [cx, cy, cz, hx, hy, hz]
SDF_SPLINE = 3    # cubic B-spline over the media's sdf_coeff


def _f32(x) -> float:
    return float(np.float32(x))


def _params8(params) -> tuple:
    return tuple(_f32(x) for x in (tuple(params) + (0.0,) * 8)[:8])


def _detached_grid(grid):
    return None if grid is None else grid._replace(coeff=grid.coeff.detach())


@dataclass(frozen=True)
class RifField:
    """A RIF: its kind and 8 parameters as float32 host values (kernels D
    and E take them by value); `tensor`, the (8,) parameters they were read
    from where a gradient is wanted; `grid`, the spline coefficients where
    the media hold a grid (JAX: coeff.size > 1)."""

    kind: int
    params: tuple
    tensor: Optional[torch.Tensor] = field(default=None, compare=False)
    grid: Optional[spline.SplineGrid3D] = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in (RIF_CONST, RIF_LINEAR, RIF_RADIAL,
                             RIF_ACOUSTIC, RIF_SPLINE):
            raise ValueError(f"unknown RIF kind {self.kind}")
        object.__setattr__(self, "params", _params8(self.params))

    def radial_constants(self):
        """(1/w^2, -2/w^2) with w^2 floored at 1e-12, in float32 as the
        kernels form them."""
        w = np.float32(self.params[2])
        w2 = np.maximum(w * w, np.float32(1e-12))
        return float(np.float32(1.0) / w2), float(np.float32(-2.0) / w2)

    def detached(self) -> "RifField":
        return replace(self, tensor=None, grid=_detached_grid(self.grid))


@dataclass(frozen=True)
class SdfField:
    """An SDF (negative inside): kind, 8 float32 parameters and, where the
    media hold one, the spline grid."""

    kind: int
    params: tuple
    grid: Optional[spline.SplineGrid3D] = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in (SDF_NONE, SDF_SPHERE, SDF_BOX, SDF_SPLINE):
            raise ValueError(f"unknown SDF kind {self.kind}")
        object.__setattr__(self, "params", _params8(self.params))

    def detached(self) -> "SdfField":
        return replace(self, grid=_detached_grid(self.grid))


def _grid(coeff, lo, hi):
    return spline.SplineGrid3D(coeff, lo, hi) if coeff.numel() > 1 else None


def rif_from_media(media: Media) -> RifField:
    prm = media.rif_params
    return RifField(int(media.rif_kind), tuple(prm.detach().tolist()),
                    prm if prm.requires_grad else None,
                    _grid(media.rif_coeff, media.rif_min, media.rif_max))


def sdf_from_media(media: Media) -> SdfField:
    return SdfField(int(media.sdf_kind), tuple(media.sdf_params.tolist()),
                    _grid(media.sdf_coeff, media.sdf_min, media.sdf_max))


def kernel_route(rif: RifField, sdf: SdfField, differentiable: bool,
                 dtype=torch.float32) -> bool:
    """Whether the marches run in kernels D and E (the JAX package's
    `_er_kernel_ok` with its lax.cond on kind <= RIF_RADIAL, eikonal.py:
    344-376): forward mode, float32 points, an analytic RIF of kind <=
    RIF_RADIAL and an analytic SDF (no grid in the media). Elsewhere their
    plain versions march."""
    return (not differentiable and dtype == torch.float32
            and rif.grid is None and sdf.grid is None
            and rif.kind <= RIF_RADIAL)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------
def _rif(f: RifField, p, need_hess: bool):
    """(value (N,), gradient (N, 3), Hessian (N, 3, 3) or None)."""
    if f.kind == RIF_SPLINE and f.grid is not None:
        if need_hess:
            return spline.value_gradient_hessian(f.grid, p)
        v, g = spline.value_gradient(f.grid, p)
        return v, g, None
    if f.tensor is not None:
        return _rif_attached(f.kind, f.tensor, p, need_hess, f.params[3])
    if p.dtype != torch.float32:
        return _rif_attached(f.kind, _param_tensor(f.params, p.device), p,
                             need_hess, f.params[3])
    if f.kind == RIF_ACOUSTIC:
        return _acoustic(f.params, p, need_hess, f.params[3])
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    q = f.params
    zeros = torch.zeros_like(x)
    if f.kind == RIF_RADIAL:
        inv_w2, k_r = f.radial_constants()
        d = (x - q[3], y - q[4], z - q[5])
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        e = q[1] * torch.exp(-(r2 * inv_w2))
        val = q[0] + e
        ke = k_r * e
        g = [ke * d[i] for i in range(3)]
        hess = None
        if need_hess:
            hess = torch.stack([
                torch.stack([d[i] * g[j] * k_r + ke if i == j
                             else d[i] * g[j] * k_r for j in range(3)], -1)
                for i in range(3)], -2)
        return val, torch.stack(g, -1), hess
    if f.kind == RIF_LINEAR:
        val = q[0] + x * q[1] + y * q[2] + z * q[3]
        g = torch.stack([zeros + q[1], zeros + q[2], zeros + q[3]], -1)
    else:   # constant, and the spline kind without a grid (as in JAX)
        val = zeros + q[0]
        g = torch.zeros_like(p)
    hess = torch.zeros(p.shape + (3,), dtype=p.dtype,
                       device=p.device) if need_hess else None
    return val, g, hess


@functools.lru_cache(maxsize=16)
def _param_tensor(params: tuple, device):
    """The float32 (8,) tensor of a RIF's parameters on `device`, made once
    (the float64 core promotes it as JAX promotes its float32 params)."""
    return torch.tensor(params, dtype=torch.float32, device=device)


def _rif_attached(kind: int, prm, p, need_hess: bool, mode: float):
    """The analytic RIF from its (8,) parameter tensor, in the JAX
    package's order (_rif_analytic, eikonal.py:153-236); `mode` is the
    acoustic mode as a host value. Float32 parameters promote to the
    points' dtype."""
    if kind == RIF_ACOUSTIC:
        return _acoustic(prm, p, need_hess, mode)
    zero33 = p.new_zeros(p.shape + (3,)) if need_hess else None
    if kind == RIF_RADIAL:
        w2 = torch.clamp_min(prm[2] * prm[2], 1e-12)
        dp = p - prm[3:6]
        e = prm[1] * torch.exp(-dot(dp, dp) / w2)
        g = (-2.0 / w2) * e.unsqueeze(-1) * dp
        hess = None
        if need_hess:
            eye = torch.eye(3, dtype=p.dtype, device=p.device)
            hess = (-2.0 / w2) * (e[..., None, None] * eye
                                  + dp.unsqueeze(-1) * g.unsqueeze(-2))
        return prm[0] + e, g, hess
    if kind == RIF_LINEAR:
        return prm[0] + dot(p, prm[1:4].expand(p.shape)), \
            prm[1:4].to(p.dtype).expand(p.shape), zero33
    return prm[0].to(p.dtype).expand(p.shape[:-1]), torch.zeros_like(p), \
        zero33


# ---------------------------------------------------------------------------
# the acoustic RIF: Bessel J_m (acousticrifvolume.cpp:243-315), series and
# leading asymptotic terms as in the JAX package (eikonal.py:61-133). The
# orders a call needs are evaluated together, stacked on a leading axis, so
# that each elementwise step is one launch for all of them; each element
# sees the JAX package's operations in its order.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _consts(values: tuple, dtype, device):
    """A (len(values), 1) tensor of constants, made once."""
    return torch.tensor(values, dtype=dtype, device=device).unsqueeze(-1)


def _series(xs, orders: tuple, n_terms: int):
    """sum_k (-1)^k (xs/2)^(2k+m) / (k! (k+m)!) over k <= n_terms for each
    order m, (len(orders), N): term_k = term_{k-1} (-xs^2/4) / (k (k+m))."""
    q = -0.25 * xs * xs
    term = torch.stack([(0.5 * xs) ** m / math.factorial(m) if m else
                        torch.ones_like(xs) for m in orders])
    acc = term
    for k in range(1, n_terms + 1):
        term = term * q / _consts(tuple(float(k * (k + m)) for m in orders),
                                  xs.dtype, xs.device)
        acc = acc + term
    return acc


def _asymptotic01(ax):
    """The leading asymptotic J0 and J1 at max(|x|, 8), (2, N)."""
    c = functools.partial(_consts, dtype=ax.dtype, device=ax.device)
    z = torch.clamp_min(ax, 8.0)
    iz2 = 1.0 / (z * z)
    P = 1.0 + c((-0.0703125, 0.1171875)) * iz2 \
        + c((0.1121520996, -0.1441955566)) * iz2 * iz2
    Q = c((-0.125, 0.375)) / z + c((0.0732421875, -0.1025390625)) / (
        z * z * z)
    xx = z - c((0.78539816339, 2.35619449019))
    return torch.sqrt(0.63661977236 / z) * (torch.cos(xx) * P
                                            - torch.sin(xx) * Q)


def _bessel01(x):
    """(J0, J1): the power series for |x| < 8, the leading asymptotic
    expansion beyond."""
    ax = torch.abs(x)
    small = ax < 8.0
    j = torch.where(small, _series(torch.where(small, ax, 0.0), (0, 1), 23),
                    _asymptotic01(ax))
    return j[0], j[1] * torch.sign(x)


def bessel_orders(orders: tuple, x):
    """[J_m(x) for m in orders] (eikonal.py:61-133): J0 and J1 as
    `_bessel01`; an order m >= 2 by its power series for |x| < 4 and the
    upward recurrence J_{m+1} = (2m / x) J_m - J_{m-1} from J0 and J1 at
    max(|x|, 4) beyond (times sign(x) where m is odd)."""
    out = {}
    if any(m < 2 for m in orders):
        out[0], out[1] = _bessel01(x)
    high = tuple(m for m in orders if m >= 2)
    if high:
        ax = torch.abs(x)
        small = ax < 4.0
        ser = _series(torch.where(small, ax, 0.0), high, 17)
        xb = torch.clamp_min(ax, 4.0)
        jm1, jm = _bessel01(xb)
        for mm in range(1, max(high)):
            jm1, jm = jm, (2.0 * mm / xb) * jm - jm1
            if mm + 1 in high:
                val = torch.where(small, ser[high.index(mm + 1)], jm)
                out[mm + 1] = val * torch.sign(x) if (mm + 1) % 2 else val
    return [out[m] for m in orders]


def bessel_j0(x):
    return _bessel01(x)[0]


def bessel_j1(x):
    return _bessel01(x)[1]


def _acoustic(prm, p, need_hess: bool, mode: float):
    """n0 + nmax J_m(kr r) cos(m phi) with r and phi = atan2(y, z) in the
    yz plane, the beam along +x (eikonal.py:181-235); prm is [n0, nmax, kr,
    mode, ...], host floats or a tensor, and `mode` its host value. The
    value and gradient are JAX's
    closed forms. JAX evaluates J_0 ... J_5 and selects the mode's with
    where; the mode is a host value here, so only the two orders it reads
    are evaluated, which selects the same values. JAX's Hessian is the
    forward-mode Jacobian of the closed-form yz gradient, symmetrised;
    here it is that Jacobian in closed form, with J_m'' and J_{m+1}' from
    the Bessel recurrences. A mode outside 0..4 gives n0, as in JAX."""
    m_f = float(mode)
    n0, amp, kr = prm[0], prm[1], prm[2]
    y, z = p[..., 1], p[..., 2]
    zeros = torch.zeros_like(y)
    m = int(m_f)
    if m != m_f or not 0 <= m <= 4:
        val = zeros + n0
        return val, torch.zeros_like(p), (
            p.new_zeros(p.shape + (3,)) if need_hess else None)
    rr = torch.clamp_min(torch.sqrt(y * y + z * z), 1e-6)
    phi = torch.atan2(y, z)
    xx = kr * rr
    J, Jn = bessel_orders((m, m + 1), xx)
    inv_x = m / torch.clamp_min(xx, 1e-9)
    dJ = inv_x * J - Jn
    cm, sm = torch.cos(m * phi), torch.sin(m * phi)
    invr = 1.0 / rr
    gy = amp * (dJ * kr * y * invr * cm - J * m_f * sm * z * invr * invr)
    gz = amp * (dJ * kr * z * invr * cm + J * m_f * sm * y * invr * invr)
    val = n0 + amp * J * cm
    grad = torch.stack([zeros, gy, gz], -1)
    if not need_hess:
        return val, grad, None
    # d/dx of dJ = (m/x) J - J_{m+1}: -(m/x^2) J + (m/x) J' - J_{m+1}',
    # with J' = dJ and J_{m+1}' = J - ((m+1)/x) J_{m+1}
    ix = 1.0 / torch.clamp_min(xx, 1e-9)
    ddJ = -inv_x * ix * J + inv_x * dJ - (J - (m + 1) * ix * Jn)
    cy, cz = y * invr, z * invr                   # d r / dy, d r / dz
    ir2 = invr * invr
    py_, pz_ = z * ir2, -y * ir2                  # d phi / dy, d phi / dz
    # gy / amp = k dJ cy cm - m J sm z / r^2, gz / amp = k dJ cz cm
    # + m J sm y / r^2; each factor's y and z derivatives
    dcy = (z * z * ir2 * invr, -y * z * ir2 * invr)
    dcz = (-y * z * ir2 * invr, y * y * ir2 * invr)
    dcm = (-m * sm * py_, -m * sm * pz_)
    dsm = (m * cm * py_, m * cm * pz_)
    dx = (kr * cy, kr * cz)
    dzr2 = (-2.0 * y * z * ir2 * ir2, ir2 - 2.0 * z * z * ir2 * ir2)
    dyr2 = (ir2 - 2.0 * y * y * ir2 * ir2, -2.0 * y * z * ir2 * ir2)
    zr2, yr2 = z * ir2, y * ir2

    def d_gy(a):        # d gy / d(y, z)[a]
        t1 = kr * (ddJ * dx[a] * cy * cm + dJ * dcy[a] * cm
                   + dJ * cy * dcm[a])
        t2 = m_f * (dJ * dx[a] * sm * zr2 + J * dsm[a] * zr2
                    + J * sm * dzr2[a])
        return amp * (t1 - t2)

    def d_gz(a):        # d gz / d(y, z)[a]
        u1 = kr * (ddJ * dx[a] * cz * cm + dJ * dcz[a] * cm
                   + dJ * cz * dcm[a])
        u2 = m_f * (dJ * dx[a] * sm * yr2 + J * dsm[a] * yr2
                    + J * sm * dyr2[a])
        return amp * (u1 + u2)

    h_yy, h_yz, h_zy, h_zz = d_gy(0), d_gy(1), d_gz(0), d_gz(1)
    h_off = 0.5 * (h_yz + h_zy)
    hess = torch.stack([zeros, zeros, zeros,
                        zeros, h_yy, h_off,
                        zeros, h_off, h_zz], -1).unflatten(-1, (3, 3))
    return val, grad, hess


def rif_value(f: RifField, p):
    return _rif(f, p, False)[0]


def rif_value_grad(f: RifField, p):
    v, g, _ = _rif(f, p, False)
    return v, g


def rif_value_grad_hess(f: RifField, p):
    return _rif(f, p, True)


def sdf_value(f: SdfField, p):
    """Signed distance, negative inside; SDF_NONE (and a spline kind
    without a grid) is 1, outside."""
    q = f.params
    if f.kind == SDF_SPLINE and f.grid is not None:
        return spline.value(f.grid, p)
    if f.kind in (SDF_NONE, SDF_SPLINE):
        return torch.ones_like(p[..., 0])
    d = (p[..., 0] - q[0], p[..., 1] - q[1], p[..., 2] - q[2])
    if f.kind == SDF_SPHERE:
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        return torch.sqrt(torch.clamp_min(r2, 1e-30)) - q[3]
    b = [torch.abs(d[i]) - q[3 + i] for i in range(3)]
    m = [torch.clamp_min(b[i], 0.0) for i in range(3)]
    outside = torch.sqrt(torch.clamp_min(
        m[0] * m[0] + m[1] * m[1] + m[2] * m[2], 1e-30))
    inside = torch.clamp_max(
        torch.maximum(b[0], torch.maximum(b[1], b[2])), 0.0)
    return outside + inside


def sdf_gradient(f: SdfField, p):
    if f.kind == SDF_SPLINE and f.grid is not None:
        return spline.value_gradient(f.grid, p)[1]
    q = f.params
    dp = p - torch.tensor(q[:3], dtype=p.dtype, device=p.device)
    if f.kind == SDF_SPHERE:
        return normalize(dp)
    b = torch.abs(dp) - torch.tensor(q[3:6], dtype=p.dtype, device=p.device)
    g_out = normalize(torch.clamp_min(b, 0.0) * sgn(dp))
    axis = torch.argmax(b, dim=-1, keepdim=True)
    g_in = torch.zeros_like(dp).scatter_(-1, axis, 1.0) * sgn(dp)
    return torch.where(torch.any(b > 0, dim=-1, keepdim=True), g_out, g_in)


def inside_shape(f: SdfField, p):
    return sdf_value(f, p) < 0.0


# ---------------------------------------------------------------------------
# 3x3 helpers, sums written out
# ---------------------------------------------------------------------------
def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def _mm(a, b):
    """Batched 3x3 product, C_ij = (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _vm(x, m):
    """Row vector times matrix, y_j = (x_0 m_0j + x_1 m_1j) + x_2 m_2j."""
    return (x[..., 0:1] * m[..., 0, :] + x[..., 1:2] * m[..., 1, :]
            + x[..., 2:3] * m[..., 2, :])


def _mv(m, x):
    """Matrix times column vector, y_i = (m_i0 x_0 + m_i1 x_1) + m_i2 x_2."""
    return (m[..., :, 0] * x[..., 0:1] + m[..., :, 1] * x[..., 1:2]
            + m[..., :, 2] * x[..., 2:3])


def _lanes(x, n, like):
    """A scalar or (N,) value as an (N,) tensor of like's dtype."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(n)


# ---------------------------------------------------------------------------
# curved-ray marching
# ---------------------------------------------------------------------------
def er_step(f: RifField, p, v, h):
    """One velocity-Verlet step; h is (N,). Returns (p, v, d_optical)."""
    hh = h.unsqueeze(-1)
    n0, g0 = rif_value_grad(f, p)
    v = v + 0.5 * hh * g0
    p = p + hh * v / n0.unsqueeze(-1)
    _, g1 = rif_value_grad(f, p)
    v = v + 0.5 * hh * g1
    return p, v, h * n0


def er_derivative_step(f: RifField, p, v, dpdv0, dvdv0, h):
    """er_derivativestep (:798-814): a step that also carries the 3x3
    sensitivities of (p, v) to the initial velocity; h is (N,)."""
    hh = h.unsqueeze(-1)
    hhm = hh.unsqueeze(-1)
    n0, g0, H0 = rif_value_grad_hess(f, p)
    v = v + 0.5 * hh * g0
    dvdv0 = dvdv0 + 0.5 * hhm * _mm(H0, dpdv0)
    p = p + hh * v / n0.unsqueeze(-1)
    n1, g1, H1 = rif_value_grad_hess(f, p)
    invn = 1.0 / n1
    # d(p step) = h [ -1/n^2 v (g . dpdv0) + 1/n dvdv0 ]
    gdp = _vm(g1, dpdv0)
    c = (-invn * invn).unsqueeze(-1) * v
    dpdv0 = dpdv0 + hhm * (_outer(c, gdp) + invn[..., None, None] * dvdv0)
    v = v + 0.5 * hh * g1
    dvdv0 = dvdv0 + 0.5 * hhm * _mm(H1, dpdv0)
    return p, v, dpdv0, dvdv0


def trace_curved(rif: RifField, sdf: SdfField, p, v, distance, h,
                 max_steps: int, active, differentiable: bool = False):
    """March curved rays `distance` of arc length, stopping at the medium
    boundary (trace(), :671-691): kernel D on the kernel route, else its
    plain PyTorch loop, the JAX package's XLA march (_trace_curved_xla,
    :379-414), attached in differentiable mode. JAX's differentiable form
    is a scan of exactly max_steps self-masking trips; the march draws no
    random numbers, so stopping once no lane runs gives the same values.
    Returns (p, v, optical_len, dist_marched, exited, steps)."""
    from . import ermarch
    if kernel_route(rif, sdf, differentiable, p.dtype):
        return ermarch.trace(rif, sdf, p, v, distance, h, max_steps, active)
    return ermarch.trace_plain(rif, sdf, p, v, distance, h, max_steps,
                               active)


def refine_boundary(rif: RifField, sdf: SdfField, p, v, h, n_bisect: int = 10):
    """Bisection to the boundary from the last inside point. Returns
    (p_boundary, v_boundary, extra_opt, extra_dist)."""
    n = p.shape[0]
    opt = torch.zeros((n,), dtype=p.dtype, device=p.device)
    adv = torch.zeros_like(opt)
    step = _lanes(h, n, p)
    for _ in range(n_bisect):
        step = step * 0.5
        p2, v2, dopt = er_step(rif, p, v, step)
        ok = inside_shape(sdf, p2)
        p = torch.where(ok.unsqueeze(-1), p2, p)
        v = torch.where(ok.unsqueeze(-1), v2, v)
        opt = torch.where(ok, opt + dopt, opt)
        adv = torch.where(ok, adv + step, adv)
    return p, v, opt, adv


def boundary_velocity(v, N, n_in, n_out):
    """Snell refraction of the scaled velocity (boundaryVelocity,
    :1036-1051); mirror reflection on total internal reflection. Returns
    (v', tir)."""
    dotp = dot(v, N)
    r = (n_out / n_in) ** 2 - 1.0
    sq = r * dot(v, v) + dotp * dotp
    tir = sq < 1e-9
    v_refr = v - dotp.unsqueeze(-1) * N + (sgn(dotp) * safe_sqrt(sq)
                                           ).unsqueeze(-1) * N
    v_refl = v - 2.0 * dotp.unsqueeze(-1) * N
    return torch.where(tir.unsqueeze(-1), v_refl, v_refr), tir


def integrate_with_sensitivities(rif: RifField, sdf: SdfField, p1, v0, p2,
                                 h, max_steps: int, active,
                                 differentiable: bool = False,
                                 jacobian: bool = True):
    """computefdfBDPT (:816-939): march from p1 with initial velocity v0
    until the ray passes the plane through p2 or leaves the shape (kernel E
    on the kernel route, else its plain PyTorch loop, the JAX package's
    _march_xla, :506-537, attached in differentiable mode), then the
    endpoint error and its Jacobian w.r.t. v0. Lanes that leave refract
    and run on straight to the point closest to p2. Returns (err, J,
    exited, opt, geo_inside, geo_total, v_end).

    jacobian=False is for callers that drop J (the final measurement of
    solve_bvp): J is None, and off the kernel route the march carries no
    sensitivities (sens_march_plain with dpdv0 None). The other outputs do
    not read them, so they are the same; the JAX package leaves that work
    to XLA's dead-code elimination."""
    n = p1.shape[0]
    on_kernel = kernel_route(rif, sdf, differentiable, p1.dtype)
    # scale v0 to |v| = n(p1), carrying the projection's Jacobian (:846-851)
    r0 = rif_value(rif, p1)
    nv = length(v0)
    nvc = torch.clamp_min(nv, 1e-12)
    v = v0 / nvc.unsqueeze(-1) * r0.unsqueeze(-1)
    dpdv0 = dvdv0 = None
    if jacobian or on_kernel:
        eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(n, 3, 3)
        dvdv0 = (r0 / nvc ** 3)[..., None, None] * (
            (nv ** 2)[..., None, None] * eye - _outer(v0, v0))
        dpdv0 = torch.zeros((n, 3, 3), dtype=p1.dtype, device=p1.device)
    from . import ermarch
    march = ermarch.sens_march if on_kernel else ermarch.sens_march_plain
    p, v, dpdv0, dvdv0, opt, marched, exited, _ = march(
        rif, sdf, p1, v, dpdv0, dvdv0, p2, h, max_steps, active)

    # exited lanes: refract and run on straight to the point closest to p2
    N_b = normalize(sdf_gradient(sdf, p))
    nb = rif_value(rif, p)
    v_refr, tir = boundary_velocity(v, N_b, nb, torch.ones_like(nb))
    extra_t = -dot(v_refr, p - p2) / torch.clamp_min(dot(v_refr, v_refr),
                                                    1e-12)
    p_ext = p + extra_t.unsqueeze(-1) * v_refr
    # interior lanes: the closest point of approach to p2 along the ray
    if jacobian:
        n_end, dvdt_in = rif_value_grad(rif, p)
    else:
        n_end = rif_value(rif, p)
    dpdt_in = v / n_end.unsqueeze(-1)
    ex = exited.unsqueeze(-1)
    v_eff = torch.where(ex, v_refr, v)
    tstar_in = -dot(p - p2, dpdt_in) / torch.clamp_min(
        dot(dpdt_in, dpdt_in), 1e-12)
    p_in = p + tstar_in.unsqueeze(-1) * dpdt_in
    opt = torch.where(exited, opt + extra_t, opt + tstar_in * n_end)
    # the arc inside the medium (absorption) and the whole connection
    # (inverse-square falloff) are kept apart
    geo_inside = torch.where(exited, marched, marched + tstar_in)
    geo_total = torch.where(exited, marched + extra_t, marched + tstar_in)
    err = torch.where(ex, p_ext, p_in) - p2
    if not jacobian:
        return err, None, exited, opt, geo_inside, geo_total, v_eff

    # exited lanes: dt_b/dv0 from the implicit boundary condition (:920-927)
    dpdt_b = v / nb.unsqueeze(-1)
    nd = dot(N_b, dpdt_b)
    denom = torch.where(torch.abs(nd) > 1e-9, nd, 1e9)
    dtbdv0 = -_vm(N_b, dpdv0) / denom.unsqueeze(-1)
    _, g_b = rif_value_grad(rif, p)
    # refraction Jacobian (boundaryVelocityDerivative, :1057-1074)
    dotp = dot(v, N_b)
    r = 1.0 / torch.clamp_min(nb, 1e-9) ** 2 - 1.0
    sq = safe_sqrt(torch.clamp_min(r * dot(v, v) + dotp * dotp, 1e-12))
    NN = _outer(N_b, N_b)
    inner = dvdv0 + _outer(g_b, dtbdv0)
    refr_J = _mm(eye - NN + sgn(dotp)[..., None, None] * _outer(
        N_b, (r.unsqueeze(-1) * v + dotp.unsqueeze(-1) * N_b)
        / sq.unsqueeze(-1)), inner)
    refl_J = _mm(eye - 2.0 * NN, inner)
    dvdv0_b = torch.where(tir[..., None, None], refl_J, refr_J)
    dpdv0_b = (dpdv0 + _outer(dpdt_b - v_refr, dtbdv0)
               + extra_t[..., None, None] * dvdv0_b)
    # the change of variables to the closest point moves the endpoint
    # along dp/dt (:924-938)
    exm = exited[..., None, None]
    dpdt = torch.where(ex, v_refr, dpdt_in)
    dvdt = torch.where(ex, 0.0, dvdt_in)
    dpdv0_eff = torch.where(exm, dpdv0_b, dpdv0)
    dvdv0_eff = torch.where(exm, dvdv0_b, dvdv0)
    num = _vm(v_eff, dpdv0_eff) + _vm(p - p2, dvdv0_eff)
    den = dot(v_eff, dpdt) + dot(p - p2, dvdt)
    dtstar = -num / torch.where(torch.abs(den) > 1e-9, den, 1e9).unsqueeze(-1)
    J = dpdv0_eff + _outer(dpdt, dtstar)
    return err, J, exited, opt, geo_inside, geo_total, v_eff


# ---------------------------------------------------------------------------
# batched BVP solve (replaces Ceres BFGS, :1087-1163)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BVPResult:
    dir_to_target: torch.Tensor  # (N, 3) unit initial direction
    converged: torch.Tensor      # (N,)
    weight: torch.Tensor         # (N,) RR / multiplicity weight
    opt_len: torch.Tensor        # (N,) optical connection length
    geo_inside: torch.Tensor     # (N,) curved arc length inside the medium
    geo_total: torch.Tensor      # (N,) whole connection length (falloff)
    rev_dir: torch.Tensor        # (N, 3) -normalize(v) at arrival


def _solve33(A, b):
    """Batched 3x3 solve by the adjugate (Cramer's rule)."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c02 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c10 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c20 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    c21 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    ok = torch.abs(det) > 1e-30
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
                        (c10 * b0 + c11 * b1 + c12 * b2) * inv_det,
                        (c20 * b0 + c21 * b1 + c22 * b2) * inv_det], dim=-1)


def _levenberg_solve(rif, sdf, p1, p2, v0, h, max_steps: int, active,
                     tol2: float, max_iters: int = 12):
    """Convergence-masked Levenberg-Marquardt over the endpoint error with
    accept/reject: a trial step is kept only where it lowers the cost, and
    the loop ends once no active lane is still improving. Returns (v, cost)
    at the best point found."""
    n = p1.shape[0]
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(n, 3, 3)

    def eval_err(v, act):
        err, J, *_ = integrate_with_sensitivities(rif, sdf, p1, v, p2, h,
                                                  max_steps, act)
        return err, J

    def lm_step(err, J, lam):
        JT = J.transpose(-1, -2)
        A = _mm(JT, J) + (lam + 1e-9)[..., None, None] * eye
        return _solve33(A, -_mv(JT, err))

    v_cur = v0
    err_cur, J_cur = eval_err(v0, active)
    cost_cur = dot(err_cur, err_cur)
    lam = torch.full((n,), 1e-3, dtype=cost_cur.dtype, device=p1.device)
    running = active & (cost_cur >= tol2)
    v_trial = v0 + lm_step(err_cur, J_cur, lam)
    it = 0
    while it < max_iters and bool(running.any()):
        err_t, J_t = eval_err(v_trial, running)
        cost_t = dot(err_t, err_t)
        better = cost_t < cost_cur
        acc = running & better
        v_cur = torch.where(acc.unsqueeze(-1), v_trial, v_cur)
        err_cur = torch.where(acc.unsqueeze(-1), err_t, err_cur)
        J_cur = torch.where(acc[..., None, None], J_t, J_cur)
        cost_cur = torch.where(acc, cost_t, cost_cur)
        lam = torch.where(running, torch.where(better, lam * 0.33, lam * 6.0),
                          lam)
        lam = torch.clamp(lam, 1e-8, 1e3)
        running = running & (cost_cur >= tol2)
        v_trial = torch.where(running.unsqueeze(-1),
                              v_cur + lm_step(err_cur, J_cur, lam), v_trial)
        it += 1
    return v_cur, cost_cur


def _restart_uniform(seed_bits, round_idx: int, dim: int):
    """The restart loop's own uniform for (round, dimension) of each lane."""
    c = (round_idx * 0x85EBCA6B + dim * 0xC2B2AE35) & M32
    return _u32_to_float(_hash_u32((seed_bits + c) & M32))


def solve_bvp(rif: RifField, sdf: SdfField, p1, p2, init_dir, h,
              max_steps: int, active, tol2: float = 1e-6,
              newton_iters: int = 12, differentiable: bool = False,
              rr_weight: float = 1e-2, seed_bits=None,
              max_restarts: int = 0, dir_match_tol2: float = 1e-4,
              memo: Optional[dict] = None):
    """Solve the curved-connection BVP for the initial velocity p1 -> p2.

    With max_restarts == 0 (or no seed_bits): one solve from `init_dir`
    with weight 1. Otherwise the reference's makeDirectConnections loop
    (:1087-1163) as the JAX package runs it: every attempt restarts from a
    uniform hemisphere direction around the chord; a failed solve goes on
    with probability rr_weight and weight /= rr_weight; the first solution
    counts once an independent restart re-finds it; and the weight is
    multiplied by the Booth multiplicity estimate. Rounds 0 and 1 run as one
    batch of 2N lanes, the rounds after that only for the lanes still
    looping.

    differentiable=True (eikonal.py:748-778): the whole solve runs on
    detached fields and inputs, without autograd, and one attached
    integration from p1 at the solved direction gives the transport
    quantities. The solved direction itself is not differentiated: by
    Fermat's principle the optical length is stationary in it. `memo`, a
    dict, keeps the solved connections (the detached solve and the
    converged flags) and reuses them where they are there: a checkpointed
    bounce's recompute need not solve again."""
    if differentiable:
        res = None if memo is None else memo.get("detached")
        if res is None:
            with torch.no_grad():
                res = solve_bvp(
                    rif.detached(), sdf.detached(), p1.detach(), p2.detach(),
                    init_dir.detach(), h, max_steps, active, tol2=tol2,
                    newton_iters=newton_iters, rr_weight=rr_weight,
                    seed_bits=seed_bits, max_restarts=max_restarts,
                    dir_match_tol2=dir_match_tol2)
            if memo is not None:
                memo["detached"] = res
        r0 = rif_value(rif, p1)
        err, _, _, opt, geo_in, geo_tot, v_end = integrate_with_sensitivities(
            rif, sdf, p1, res.dir_to_target * r0.unsqueeze(-1), p2, h,
            max_steps, active, differentiable=True, jacobian=False)
        err = err.detach()
        converged = None if memo is None else memo.get("converged")
        if converged is None:
            converged = active & (dot(err, err) < tol2) & res.converged
            if memo is not None:
                memo["converged"] = converged
        return replace(res, converged=converged, opt_len=opt,
                       geo_inside=geo_in, geo_total=geo_tot,
                       rev_dir=-normalize(v_end))
    n = p1.shape[0]
    r0 = rif_value(rif, p1)
    weight = torch.ones((n,), dtype=p1.dtype, device=p1.device)

    if max_restarts <= 0 or seed_bits is None:
        v_fin, cost = _levenberg_solve(
            rif, sdf, p1, p2, init_dir * r0.unsqueeze(-1), h, max_steps,
            active, tol2, max_iters=newton_iters)
        conv_final = active & (cost < tol2)
        d_final = normalize(v_fin)
    else:
        frame_c = Frame.from_normal(init_dir)
        R = int(max_restarts)
        B = min(2, R)

        def round_dir(r):
            u = torch.stack([_restart_uniform(seed_bits, r, 0),
                             _restart_uniform(seed_bits, r, 1)], dim=-1)
            return frame_c.to_world(warp.square_to_uniform_hemisphere(u))

        def tile(a):
            return torch.cat([a] * B, dim=0)

        d0_all = torch.cat([round_dir(r) for r in range(B)], dim=0)
        v_all, cost_all = _levenberg_solve(
            rif, sdf, tile(p1), tile(p2), d0_all * tile(r0).unsqueeze(-1), h,
            max_steps, tile(active), tol2, max_iters=newton_iters)
        conv_all = (cost_all < tol2).reshape(B, n) & active.unsqueeze(0)
        d_all = normalize(v_all).reshape(B, n, 3)

        looping = active
        iterations = torch.ones((n,), dtype=torch.int32, device=p1.device)
        have_first = torch.zeros((n,), dtype=torch.bool, device=p1.device)
        first_dir = final_dir = init_dir
        conv_final = torch.zeros_like(have_first)

        def bookkeep(conv_raw, d_i, r):
            nonlocal looping, iterations, weight, have_first, first_dir
            nonlocal final_dir, conv_final
            conv_i = looping & conv_raw
            new_first = conv_i & ~have_first
            first_dir = torch.where(new_first.unsqueeze(-1), d_i, first_dir)
            have_first = have_first | new_first
            iterations = iterations + conv_i.to(torch.int32)
            # accept once an independent restart re-finds the first
            # solution; f32 solves of one solution scatter by ~1e-3 in
            # direction, hence the looser direction-match tolerance
            dd = first_dir - d_i
            refind = conv_i & ~new_first & (dot(dd, dd) < dir_match_tol2)
            final_dir = torch.where(refind.unsqueeze(-1), d_i, final_dir)
            conv_final = conv_final | refind
            # a failed solve: russian roulette on going on
            fail = looping & ~conv_i
            keep = _restart_uniform(seed_bits, r, 3) < rr_weight
            weight = torch.where(fail & keep, weight / rr_weight, weight)
            looping = looping & ~refind & ~(fail & ~keep)

        for r in range(B):
            bookkeep(conv_all[r], d_all[r], r)
        r = B
        while r < R and bool(looping.any()):
            v_fin, cost = _levenberg_solve(
                rif, sdf, p1, p2, round_dir(r) * r0.unsqueeze(-1), h,
                max_steps, looping, tol2, max_iters=newton_iters)
            bookkeep(cost < tol2, normalize(v_fin), r)
            r += 1
        d_final = final_dir
        # Booth multiplicity: iterations - 2 converged re-tries before the
        # re-find estimate 1 / P(a converged solve lands on this solution)
        weight = weight * torch.clamp_min(iterations - 2, 1).to(torch.float32)

    # the final measurement at the accepted direction (:941-1030)
    err, _, _, opt, geo_in, geo_tot, v_end = integrate_with_sensitivities(
        rif, sdf, p1, d_final * r0.unsqueeze(-1), p2, h, max_steps, active,
        jacobian=False)
    converged = conv_final & (dot(err, err) < tol2)
    return BVPResult(dir_to_target=d_final, converged=converged,
                     weight=weight, opt_len=opt, geo_inside=geo_in,
                     geo_total=geo_tot, rev_dir=-normalize(v_end))
