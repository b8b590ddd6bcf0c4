"""Specular manifold walks (port of mitsubaer_tpu/core/manifold.py; the
reference's libbidir SpecularManifold, manifold.cpp:35).

Newton iteration on the specular constraint between two fixed endpoints:
for a vertex x(u) on an analytic surface (a sphere or a plane) with
tangent frame (t1, t2), the generalized half-vector constraint (Walter et
al.)

    C(u) = [h . t1, h . t2],   h = normalize(wa + eta * wb),

with wa, wb the unit vectors from x(u) to the endpoints, is zero iff
Snell's law (or the mirror law, eta = 1) holds. `solve_specular_vertex`
walks one vertex, `solve_specular_chain` a chain of V vertices on the
stacked (2V)-dim constraint with Levenberg damping and a backtracking line
search. The Jacobians come from forward-mode AD, torch.func.vmap of
torch.func.jacfwd, as the JAX package takes them from jax.jacfwd; the
fixed iteration counts are Python loops.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .math import cross, dot, normalize

SURF_SPHERE = 0
SURF_PLANE = 1


@dataclass(frozen=True)
class ManifoldResult:
    x: torch.Tensor          # (N, 3) solved specular vertex
    n: torch.Tensor          # (N, 3) surface normal at x
    converged: torch.Tensor  # (N,)
    resid: torch.Tensor      # (N,) final |C|


@dataclass(frozen=True)
class ChainResult:
    x: torch.Tensor          # (N, V, 3) solved specular vertices
    n: torch.Tensor          # (N, V, 3) surface normals
    converged: torch.Tensor  # (N,)
    resid: torch.Tensor      # (N,) final |C|


def _surface_point(kind: int, params, u):
    """x(u), the normal and the tangent frame of the surface.
    sphere: params (cx, cy, cz, R), u = (theta, phi);
    plane: params (px, py, pz, nx, ny, nz), u = offsets along the
    tangents."""
    if kind == SURF_SPHERE:
        c, R = params[..., :3], params[..., 3]
        st, ct = torch.sin(u[..., 0]), torch.cos(u[..., 0])
        sp, cp = torch.sin(u[..., 1]), torch.cos(u[..., 1])
        n = torch.stack([st * cp, st * sp, ct], dim=-1)
        x = c + R.unsqueeze(-1) * n
        t1 = torch.stack([ct * cp, ct * sp, -st], dim=-1)
        t2 = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
        return x, n, t1, t2
    p0 = params[..., :3]
    n = normalize(params[..., 3:6])
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    a = torch.where(torch.abs(n[..., :1]) < 0.9, ex, ey)
    t1 = normalize(cross(n, a.expand(n.shape)))
    t2 = cross(n, t1)
    x = p0 + u[..., :1] * t1 + u[..., 1:2] * t2
    return x, n, t1, t2


def _half_rows(x, t1, t2, prev, nxt, eta):
    """[h . t1, h . t2] of the generalized half vector at x."""
    h = normalize(prev - x) + eta.unsqueeze(-1) * normalize(nxt - x)
    h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=-1,
                                                     keepdim=True), 1e-12)
    return torch.stack([dot(h, t1), dot(h, t2)], dim=-1)


def _constraint(kind: int, params, u, a, b, eta):
    """C(u) of one vertex for (N, .) batches; eta is the IOR ratio across
    the boundary as seen from the `a` side (1 = mirror reflection)."""
    x, _, t1, t2 = _surface_point(kind, params, u)
    return _half_rows(x, t1, t2, a, b, eta)


def _jacobian(fn, *args):
    """The per-lane Jacobian of fn(u, *rest) with respect to u, for (N, .)
    batched arguments (vmap of forward-mode AD)."""
    return torch.func.vmap(torch.func.jacfwd(fn))(*args)


def solve_specular_vertex(kind: int, params, a, b, eta, u0,
                          iters: int = 16, tol: float = 1e-6,
                          damping: float = 1.0) -> ManifoldResult:
    """Batched Newton walk for one specular vertex between endpoints a, b:
    params (N, 4 | 6), eta a scalar or (N,) relative IOR, u0 (N, 2) the
    initial surface parameters."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    params = torch.as_tensor(params, dtype=torch.float32, device=a.device)
    eta = torch.as_tensor(eta, dtype=torch.float32,
                          device=a.device).expand(a.shape[:-1])

    def c_single(u, prm, aa, bb, ee):
        return _constraint(kind, prm, u, aa, bb, ee)

    u = torch.as_tensor(u0, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        c = _constraint(kind, params, u, a, b, eta)
        J = _jacobian(c_single, u, params, a, b, eta)      # (N, 2, 2)
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        ok = torch.abs(det) > 1e-14
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        du0 = (J[..., 1, 1] * c[..., 0] - J[..., 0, 1] * c[..., 1]) * inv_det
        du1 = (-J[..., 1, 0] * c[..., 0] + J[..., 0, 0] * c[..., 1]) * inv_det
        u = u - damping * torch.stack([du0, du1], dim=-1)
    resid = torch.linalg.vector_norm(_constraint(kind, params, u, a, b, eta),
                                     dim=-1)
    x, n, _, _ = _surface_point(kind, params, u)
    return ManifoldResult(x=x, n=n, converged=resid < tol, resid=resid)


def _chain_constraint(kinds, params, u, a, b, etas):
    """The stacked (2V,) constraint of one V-vertex chain: rows 2i, 2i + 1
    are vertex i's half-vector tangentials with neighbours x_{i-1} and
    x_{i+1} (x_{-1} = a, x_V = b). params (V, P), u (V, 2), etas (V,)."""
    pts = [_surface_point(k, params[i], u[i]) for i, k in enumerate(kinds)]
    V = len(kinds)
    rows = []
    for i in range(V):
        x, _, t1, t2 = pts[i]
        prev = a if i == 0 else pts[i - 1][0]
        nxt = b if i == V - 1 else pts[i + 1][0]
        rows.append(_half_rows(x, t1, t2, prev, nxt, etas[i]))
    return torch.cat(rows)


def solve_specular_chain(kinds, params, a, b, etas, u0,
                         iters: int = 24, tol: float = 1e-6,
                         damping: float = 1.0) -> ChainResult:
    """Batched Newton walk for a chain of V specular vertices between fixed
    endpoints a, b (SpecularManifold::move, manifold.cpp:35): kinds a
    tuple of SURF_* per vertex, params (N, V, P), etas (N, V) IOR ratios
    (1 = mirror), u0 (N, V, 2). Each step solves (J^T J + 1e-9 I) s = J^T c
    and takes the largest scale of s in {1, 1/2, 1/4, 1/10, 0.03, 0.01}
    that lowers |C|^2, else stays."""
    V = len(kinds)
    a = torch.as_tensor(a, dtype=torch.float32)
    dev = a.device
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    params = torch.as_tensor(params, dtype=torch.float32, device=dev)
    etas = torch.as_tensor(etas, dtype=torch.float32, device=dev)
    N = a.shape[0]

    def c_flat(uf, prm, aa, bb, ee):
        return _chain_constraint(kinds, prm, uf.reshape(V, 2), aa, bb, ee)

    c_all = torch.func.vmap(c_flat)

    def cost(uf):
        c = c_all(uf, params, a, b, etas)
        return torch.sum(c * c, dim=-1)

    eye = 1e-9 * torch.eye(2 * V, dtype=torch.float32, device=dev)
    uf = torch.as_tensor(u0, dtype=torch.float32, device=dev).reshape(N,
                                                                      2 * V)
    for _ in range(iters):
        c = c_all(uf, params, a, b, etas)                  # (N, 2V)
        J = _jacobian(c_flat, uf, params, a, b, etas)      # (N, 2V, 2V)
        JT = J.transpose(-1, -2)
        g = torch.einsum("...ij,...j->...i", JT, c)
        step = torch.linalg.solve(JT @ J + eye, g.unsqueeze(-1))[..., 0]
        best_u, best_c = uf, torch.sum(c * c, dim=-1)
        for sc in (1.0, 0.5, 0.25, 0.1, 0.03, 0.01):
            u_t = uf - (damping * sc) * step
            c_t = cost(u_t)
            take = c_t < best_c
            best_u = torch.where(take.unsqueeze(-1), u_t, best_u)
            best_c = torch.where(take, c_t, best_c)
        uf = best_u
    resid = torch.linalg.vector_norm(c_all(uf, params, a, b, etas), dim=-1)
    u = uf.reshape(N, V, 2)
    xs, ns = zip(*[_surface_point(k, params[:, i], u[:, i])[:2]
                   for i, k in enumerate(kinds)])
    return ChainResult(x=torch.stack(xs, dim=1), n=torch.stack(ns, dim=1),
                       converged=resid < tol, resid=resid)


def sphere_init(params, a, b):
    """A robust u0 on a sphere: the chord midpoint's direction from the
    centre, as (theta, phi)."""
    m = normalize(0.5 * (a + b) - params[..., :3])
    theta = torch.arccos(torch.clamp(m[..., 2], -1.0, 1.0))
    phi = torch.atan2(m[..., 1], m[..., 0])
    return torch.stack([theta, phi], dim=-1)
