"""Special math (port of mitsubaer_tpu/core/special.py): fixed-depth
Gauss-Lobatto and Simpson quadrature (quad.cpp), a vectorised Brent root
find (brent.cpp), the von Mises-Fisher distribution of the vMF and
microflake phase functions (vmf.cpp), real spherical harmonics
(shvector.cpp) and a chi-square goodness-of-fit harness (chisquare.h).

The reference's adaptive quadrature recurses until a tolerance is met; as
in the JAX package each call here evaluates the integrand on a fixed set
of nodes (batched over the leading dims of its bounds), and Brent's method
runs a fixed number of masked steps.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

# 7-point Gauss-Lobatto nodes and weights on [-1, 1] (degree-9 exactness),
# the kernel rule of the reference's adaptive GaussLobattoIntegrator;
# float64 here, rounded to float32 where used
_GL7_X = np.array([
    -1.0, -np.sqrt(5.0 / 11.0 + 2.0 / 11.0 * np.sqrt(5.0 / 3.0)),
    -np.sqrt(5.0 / 11.0 - 2.0 / 11.0 * np.sqrt(5.0 / 3.0)), 0.0,
    np.sqrt(5.0 / 11.0 - 2.0 / 11.0 * np.sqrt(5.0 / 3.0)),
    np.sqrt(5.0 / 11.0 + 2.0 / 11.0 * np.sqrt(5.0 / 3.0)), 1.0])
_GL7_W = np.array([
    1.0 / 21.0, (124.0 - 7.0 * np.sqrt(15.0)) / 350.0,
    (124.0 + 7.0 * np.sqrt(15.0)) / 350.0, 256.0 / 525.0,
    (124.0 + 7.0 * np.sqrt(15.0)) / 350.0,
    (124.0 - 7.0 * np.sqrt(15.0)) / 350.0, 1.0 / 21.0])


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def gauss_lobatto(f: Callable, a, b, n_intervals: int = 16):
    """Composite 7-point Gauss-Lobatto integral of f over [a, b] on
    n_intervals equal intervals (error ~ h^10 for smooth integrands).
    f maps a tensor of nodes (..., n_intervals, 7) to integrand values;
    a and b broadcast over leading dims."""
    a = _f32(a)
    b = _f32(b, a.device)
    h = (b - a) / _f32(float(n_intervals), a.device)
    edges = a[..., None] + h[..., None] * torch.arange(
        n_intervals, dtype=torch.float32, device=a.device)
    x01 = (_f32(_GL7_X, a.device) + 1.0) * 0.5       # (7,) in [0, 1]
    nodes = edges[..., :, None] + h[..., None, None] * x01
    w = _f32(_GL7_W, a.device) * 0.5
    return torch.sum(f(nodes) * w, dim=(-1, -2)) * h


def simpson(f: Callable, a, b, n_intervals: int = 32):
    """Composite Simpson over 2 n_intervals sub-intervals (the reference's
    integrateDensity rule, heterogeneous.cpp:301)."""
    a = _f32(a)
    b = _f32(b, a.device)
    n = 2 * n_intervals
    h = (b - a) / _f32(float(n), a.device)
    i = torch.arange(n + 1, dtype=torch.float32, device=a.device)
    x = a[..., None] + h[..., None] * i
    w = torch.where(torch.remainder(i, 2.0) == 1.0, 4.0, 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    return torch.sum(f(x) * w, dim=-1) * h / _f32(3.0, a.device)


def brent(f: Callable, lo, hi, iters: int = 64, tol: float = 1e-7):
    """Vectorised Brent root find on [lo, hi] (f(lo) and f(hi) must
    bracket): the bisection, secant and inverse-quadratic hybrid of
    brent.cpp BrentSolver::solve, `iters` steps on every lane, a lane's
    state frozen once |f(b)| < tol. Returns (root, converged)."""
    a = _f32(lo)
    b = _f32(hi, a.device)
    a, b = torch.broadcast_tensors(a, b)
    fa, fb = f(a), f(b)
    # |f(b)| <= |f(a)|: b is the best guess
    swap = torch.abs(fa) < torch.abs(fb)
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    fa, fb = torch.where(swap, fb, fa), torch.where(swap, fa, fb)
    state = (a, b, a, a, fa, fb, fa, torch.ones_like(a, dtype=torch.bool))
    one = _f32(1.0, a.device)
    for _ in range(iters):
        a, b, c, d, fa, fb, fc, mflag = state
        done = torch.abs(fb) < tol
        # inverse quadratic interpolation, else the secant
        use_iqi = (fa != fc) & (fb != fc)
        s_iqi = (a * fb * fc / torch.where(use_iqi, (fa - fb) * (fa - fc), one)
                 + b * fa * fc / torch.where(use_iqi, (fb - fa) * (fb - fc),
                                             one)
                 + c * fa * fb / torch.where(use_iqi, (fc - fa) * (fc - fb),
                                             one))
        s_sec = b - fb * (b - a) / torch.where(fb != fa, fb - fa, one)
        s = torch.where(use_iqi, s_iqi, s_sec)
        lo_b = (3.0 * a + b) / 4.0
        cond_bisect = (
            ((s < torch.minimum(lo_b, b)) | (s > torch.maximum(lo_b, b)))
            | (mflag & (torch.abs(s - b) >= torch.abs(b - c) / 2.0))
            | (~mflag & (torch.abs(s - b) >= torch.abs(c - d) / 2.0))
            | (mflag & (torch.abs(b - c) < tol))
            | (~mflag & (torch.abs(c - d) < tol)))
        s = torch.where(cond_bisect, (a + b) / 2.0, s)
        fs = f(s)
        neg = fa * fs < 0
        a2 = torch.where(neg, a, s)
        fa2 = torch.where(neg, fa, fs)
        b2 = torch.where(neg, s, b)
        fb2 = torch.where(neg, fs, fb)
        swap2 = torch.abs(fa2) < torch.abs(fb2)
        new = (torch.where(swap2, b2, a2), torch.where(swap2, a2, b2), b, c,
               torch.where(swap2, fb2, fa2), torch.where(swap2, fa2, fb2), fb,
               cond_bisect)
        state = tuple(torch.where(done, o, n) for o, n in zip(state, new))
    a, b, fb = state[0], state[1], state[5]
    return b, ((torch.abs(fb) < tol * 10.0)
               | (torch.abs(b - a) < tol * 4.0 * (1.0 + torch.abs(b))))


def vmf_pdf(cos_theta, kappa):
    """pdf over the sphere w.r.t. solid angle (vmf.cpp
    VonMisesFisherDistr::eval); the stable form above kappa 30."""
    small = kappa < 1e-4
    k = torch.where(small, 1.0, kappa)
    val = k / (4.0 * math.pi * torch.sinh(k)) * torch.exp(k * cos_theta)
    stable = (k * torch.exp(k * (cos_theta - 1.0))
              / (2.0 * math.pi * (1.0 - torch.exp(-2.0 * k))))
    return torch.where(small, 1.0 / (4.0 * math.pi),
                       torch.where(kappa > 30.0, stable, val))


def vmf_sample(u1, u2, kappa):
    """A direction about +z (vmf.cpp::sample), (N, 3)."""
    kappa = torch.clamp_min(kappa, 1e-9)
    w = 1.0 + torch.log(u1 + (1.0 - u1) * torch.exp(-2.0 * kappa)) / kappa
    st = torch.sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), w], dim=-1)


def vmf_kappa_for_mean_cosine(r):
    """Banerjee's approximation kappa(r) (vmf.cpp::forMeanCosine)."""
    r = torch.as_tensor(r, dtype=torch.float32)
    return r * (3.0 - r * r) / torch.clamp_min(1.0 - r * r, 1e-9)


def sh_eval(d, order: int = 3):
    """Real SH basis values at unit directions d (..., 3), bands 0 to
    order - 1 (order <= 4: up to 16 coefficients), without the
    Condon-Shortley phase, as shvector.cpp."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full(x.shape, 0.28209479177387814, dtype=d.dtype,
                      device=d.device)]
    if order > 1:
        out += [0.4886025119029199 * y,
                0.4886025119029199 * z,
                0.4886025119029199 * x]
    if order > 2:
        out += [1.0925484305920792 * x * y,
                1.0925484305920792 * y * z,
                0.31539156525252005 * (3.0 * z * z - 1.0),
                1.0925484305920792 * x * z,
                0.5462742152960396 * (x * x - y * y)]
    if order > 3:
        out += [
            0.5900435899266435 * y * (3 * x * x - y * y),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * z * z - 1.0),
            0.3731763325901154 * z * (5 * z * z - 3.0),
            0.4570457994644658 * x * (5 * z * z - 1.0),
            1.445305721320277 * z * (x * x - y * y),
            0.5900435899266435 * x * (x * x - 3 * y * y),
        ]
    return torch.stack(out, dim=-1)


def sh_project(fn: Callable, order: int = 3, res: int = 64, device=None):
    """Project fn(dirs (N, 3)) -> (N,) onto the SH basis by lat-long
    quadrature over res x 2 res cell centres (shvector.cpp
    SHVector::project)."""
    theta = ((torch.arange(res, dtype=torch.float32, device=device) + 0.5)
             / _f32(float(res), device) * math.pi)
    phi = ((torch.arange(2 * res, dtype=torch.float32, device=device) + 0.5)
           / _f32(float(2 * res), device) * 2.0 * math.pi)
    T, P = torch.meshgrid(theta, phi, indexing="ij")
    st = torch.sin(T)
    d = torch.stack([st * torch.cos(P), st * torch.sin(P), torch.cos(T)],
                    dim=-1)
    vals = fn(d.reshape(-1, 3)).reshape(res, 2 * res)
    basis = sh_eval(d.reshape(-1, 3), order).reshape(res, 2 * res, -1)
    dA = (math.pi / res) * (math.pi / res) * st    # sin(theta) dtheta dphi
    return torch.sum(vals[..., None] * basis * dA[..., None], dim=(0, 1))


def chi2_test(counts, expected, n_samples, min_exp_frequency: float = 5.0):
    """Pearson's chi-square statistic with the reference's pooling
    (ChiSquare::runTest): cells whose expected count is below
    min_exp_frequency are pooled into one. Returns (chi2, dof), in float64
    on the host."""
    counts = np.asarray(counts, np.float64).ravel()
    expected = np.asarray(expected, np.float64).ravel() * n_samples
    keep = expected >= min_exp_frequency
    pooled_c = counts[~keep].sum()
    pooled_e = expected[~keep].sum()
    c = counts[keep]
    e = expected[keep]
    chi2 = float((((c - e) ** 2) / np.maximum(e, 1e-9)).sum())
    dof = int(keep.sum()) - 1
    if pooled_e > min_exp_frequency:
        chi2 += float((pooled_c - pooled_e) ** 2 / pooled_e)
        dof += 1
    return chi2, max(dof, 1)


def chi2_threshold(dof: int, significance: float = 0.0025) -> float:
    """The upper critical value by the Wilson-Hilferty approximation, with
    Acklam's rational approximation of the normal quantile (no scipy;
    ~1% for dof >= 3)."""
    p = 1.0 - significance
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow = 0.02425
    if p < plow:
        q = math.sqrt(-2 * np.log(p))
        z = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
             + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    elif p <= 1 - plow:
        q = p - 0.5
        r = q * q
        z = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
              + a[5]) * q
             / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r
                + 1))
    else:
        q = math.sqrt(-2 * np.log(1 - p))
        z = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
              + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    k = float(dof)
    return k * (1.0 - 2.0 / (9.0 * k) + z * math.sqrt(2.0 / (9.0 * k))) ** 3
