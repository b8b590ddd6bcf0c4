"""Accurate single scattering through a refractive boundary (port of
mitsubaer_tpu/integrators/singlescatter.py; the reference's
src/subsurface/singlescatter.cpp, Holzschuch 2015).

For a shape holding a homogeneous medium behind a smooth dielectric
boundary, the camera ray refracts at its entry point, a distance is drawn
along the refracted chord, and the scatter point x connects to a point
light through the boundary point B at which light -> B refracts exactly to
x, weighed by the refraction-aware geometry factor.

- A sphere boundary (`render_singlescatter`): B lies in the plane through
  the centre, x and the light, so it is one angle phi, found by 24 steps
  of bisection on Snell's residual (`_solve_phi`).
- A triangle-mesh boundary (`render_singlescatter_mesh`): every
  triangle's planar refraction point is found for every lane (T, n) by
  bisection along the projected chord (`_solve_planar`), masked by the
  barycentric inside test, and every valid solution adds. The lanes are
  processed in chunks of at most MESH_CHUNK_ELEMS / T, each lane's sum
  over the triangles the same set of terms in any chunking.

The geometry factor |d omega_x / dA_light| comes from solving again for
two light positions displaced by delta (3e-3 R on the sphere, 3e-3 on the
mesh) along the plane perpendicular to B -> light. Fresnel transmittance
applies at both crossings. No kernel runs: each bisection step is a few
elementwise launches on the host's loop.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.math import cross, dot, fresnel_dielectric, normalize, refract
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..scene import intersect as isect
from ..scene.types import RenderConfig, Scene
from . import common
from .photonmap import camera_rays, lap

# the (T, chunk) elements of one chunk of the mesh variant's connections:
# each (T, chunk, 3) float32 temporary is 12 bytes an element, ~50 MB here
MESH_CHUNK_ELEMS = 1 << 22


def _norm(v):
    return torch.sqrt(dot(v, v))


def _axis_pick(v):
    """(1, 0, 0) where |v_x| < 0.9, else (0, 1, 0): an axis not along v."""
    ex = torch.tensor([1.0, 0.0, 0.0], device=v.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=v.device)
    return torch.where(torch.abs(v[..., :1]) < 0.9, ex, ey)


def _material(scene: Scene, sid: int, med_id: int, default_eta: float):
    """(eta as a Python float, sigma_a (3,), sigma_s (3,)) of the target
    shape's boundary BSDF and interior medium."""
    b_idx = int(scene.shapes.bsdf[sid])
    eta = float(scene.bsdfs.eta[b_idx]) if b_idx >= 0 else default_eta
    dev = scene.aabb_min.device
    _, sa, ss, _ = medium_m.params(
        scene.media, torch.full((1,), med_id, dtype=torch.int32, device=dev))
    return eta, sa[0], ss[0]


def point_light(scene: Scene):
    """(position, radiance) of the first emitter of any kind, used as a
    point light whatever its kind, as in the JAX package
    (argmax(kind >= 0))."""
    em = scene.emitters
    i = int(torch.argmax((em.kind >= 0).to(torch.int32)))
    return em.position[i], em.radiance[i]


def _find_target(scene: Scene):
    """The first sphere with a shape whose interior is a medium:
    (sphere index, shape id, medium id)."""
    sph_shape = scene.geo.sph_shape_id.tolist()
    interior = scene.shapes.interior.tolist()
    for i, sid in enumerate(sph_shape):
        if sid >= 0 and interior[sid] >= 0:
            return i, sid, interior[sid]
    raise ValueError("singlescatter: no sphere shape with interior medium")


def _solve_phi(c, R, eta, x, l, iters: int = 24):
    """The boundary point of the refracted connection in the (c, x, l)
    plane: x inside the sphere, l outside. Returns (B, ok). Bracket: at
    phi = 0 (B radially above x) g = -sin_o <= 0; at phi the azimuth of l
    g >= 0."""
    u = x - c
    u = u / torch.clamp_min(_norm(u)[..., None], 1e-9)
    lc = l - c
    w = lc - dot(lc, u, True) * u
    nw = _norm(w)[..., None]
    # colinear x, c, l: any perpendicular plane serves; a true
    # perpendicular from the axis u is least aligned with
    alt = cross(u, _axis_pick(u).expand(u.shape))
    v = torch.where(nw > 1e-6, w / torch.clamp_min(nw, 1e-9), normalize(alt))
    phi_l = torch.acos(torch.clamp(dot(normalize(lc), u), -1.0, 1.0))

    def point(phi):
        return c + R * (u * torch.cos(phi)[..., None]
                        + v * torch.sin(phi)[..., None])

    def g(phi):
        B = point(phi)
        n = (B - c) / R
        wi = normalize(B - x)          # interior, x -> B
        wo = normalize(l - B)          # exterior, B -> l
        return eta * _norm(cross(wi, n)) - _norm(cross(wo, n))

    lo = torch.zeros_like(phi_l)
    hi = torch.clamp_min(phi_l, 1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = g(mid) > 0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    phi = 0.5 * (lo + hi)
    return point(phi), torch.abs(g(phi)) < 1e-3


def _displaced(lb, B):
    """Two unit vectors perpendicular to B -> lb (the light's two
    displacement directions)."""
    dlb = normalize(lb - B)
    uu = normalize(cross(dlb, _axis_pick(dlb).expand(dlb.shape)))
    return uu, cross(dlb, uu)


def _distance(smp, sigma_t, t_exit):
    """An exponential distance on [0, t_exit) at the channels' mean
    sigma_t: (t, its pdf, the sampler)."""
    u_t, smp = rng.next_1d(smp)
    st_m = torch.sum(sigma_t) * (1.0 / 3.0)     # jnp.mean: the sum times 1/n
    denom = 1.0 - torch.exp(-st_m * t_exit)
    t = -torch.log1p(-u_t * denom) / st_m
    pdf_t = st_m * torch.exp(-st_m * t) / torch.clamp_min(denom, 1e-12)
    return t, pdf_t, smp


def _finish(img, cfg: RenderConfig):
    return (img / torch.tensor(float(cfg.spp), device=img.device)).reshape(
        cfg.height, cfg.width, 3)


def render_singlescatter(scene: Scene, cfg: RenderConfig, seed: int = 0,
                         n_dist: int = 4, stats: dict | None = None):
    """Single-scatter-only image of the target refractive sphere, (H, W,
    3); n_dist interior distances a camera sample, cfg.spp samples a
    pixel from stream seed ^ 0x55C. If `stats` is a dict it gets the wall
    as "singlescatter_s"."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    t0 = lap(stats, None, dev, None)
    eps = common.scene_epsilon(scene)
    si, sid, med_id = _find_target(scene)
    c = scene.geo.sph_center[si]
    R = scene.geo.sph_radius[si]
    eta, sigma_a, sigma_s = _material(scene, sid, med_id, 1.5)
    sigma_t = sigma_a + sigma_s
    l_pos, I = point_light(scene)
    med = torch.full((npix,), med_id, dtype=torch.int32, device=dev)
    delta = 3e-3 * R
    img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        rays, smp = camera_rays(scene, cfg, seed ^ 0x55C, s)
        # the entry point on the sphere
        oc = rays.o - c
        b = dot(oc, rays.d)
        disc = b * b - (dot(oc, oc) - R * R)
        t_e = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        hit_sph = (disc > 0) & (t_e > eps)
        E = rays.o + t_e[..., None] * rays.d
        nE = (E - c) / R
        F_E, _ = fresnel_dielectric(dot(-rays.d, nE), eta)
        d_in, tir_in = refract(-rays.d, nE, eta)
        ok0 = hit_sph & ~tir_in
        t_exit = torch.clamp_min(-2.0 * dot(E - c, d_in), 1e-6)   # the chord
        Lsum = torch.zeros_like(img)
        for _ in range(n_dist):
            t, pdf_t, smp = _distance(smp, sigma_t, t_exit)
            x = E + t[..., None] * d_in
            tr_in = torch.exp(-sigma_t * t[..., None])
            lb = l_pos.expand(x.shape)
            B, okc = _solve_phi(c, R, eta, x, lb)
            uu, vv = _displaced(lb, B)
            B_u, _ = _solve_phi(c, R, eta, x, lb + delta * uu)
            B_v, _ = _solve_phi(c, R, eta, x, lb + delta * vv)
            w0 = normalize(B - x)
            G = _norm(cross((normalize(B_u - x) - w0) / delta,
                            (normalize(B_v - x) - w0) / delta))
            F_B, _ = fresnel_dielectric(dot(normalize(lb - B), (B - c) / R),
                                        eta)
            tr_conn = torch.exp(-sigma_t * _norm(B - x)[..., None])
            rho = phase_m.eval(scene.media.phase, med, d_in, w0)
            val = (tr_in * tr_conn * sigma_s * I
                   * ((1.0 - F_E) * (1.0 - F_B) * rho * G
                      / torch.clamp_min(pdf_t, 1e-12))[..., None])
            ok = ok0 & okc & torch.isfinite(val).all(-1) & (G > 0)
            Lsum = Lsum + torch.where(ok[..., None], val, 0.0)
        img = img + Lsum / torch.tensor(float(n_dist), device=dev)
    lap(stats, "singlescatter_s", dev, t0)
    return _finish(img, cfg)


def _solve_planar(p0, n, eta, x, l, iters: int = 24):
    """The refraction point B on the plane (p0, n) at which l -> B
    refracts to x (x and l on opposite sides): bisection along the
    segment between the plane projections of l and x, which holds the
    plane of incidence (singlescatter.cpp:117 solves it by Newton).
    Returns (B, ok); shapes broadcast, (T, n, 3) batches too."""
    hx = dot(x - p0, n, True)
    hl = dot(l - p0, n, True)
    x_p = x - hx * n
    l_p = l - hl * n
    ok_side = (hx * hl)[..., 0] < 0

    def point(s):
        return l_p + s[..., None] * (x_p - l_p)

    def g(s):
        B = point(s)
        wi = normalize(x - B)          # interior, B -> x
        wo = normalize(l - B)          # exterior, B -> l
        return eta * _norm(cross(wi, n)) - _norm(cross(wo, n))

    # at s = 0 (under l) sin_o = 0, g >= 0; at s = 1 sin_i = 0, g <= 0
    shape = torch.broadcast_shapes(x.shape, l.shape, p0.shape, n.shape)[:-1]
    lo = torch.zeros(shape, dtype=torch.float32, device=x.device)
    hi = torch.ones_like(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = g(mid) < 0
        lo, hi = torch.where(neg, lo, mid), torch.where(neg, mid, hi)
    s = 0.5 * (lo + hi)
    return point(s), ok_side & (torch.abs(g(s)) < 1e-3)


def _find_mesh_target(scene: Scene):
    """The mesh shape of lowest id whose interior is a medium: (shape id,
    medium id)."""
    interior = scene.shapes.interior.tolist()
    for sid in torch.unique(scene.geo.shape_id).tolist():
        if interior[sid] >= 0:
            return sid, interior[sid]
    raise ValueError("singlescatter_mesh: no mesh shape with interior medium")


def _mesh_triangles(scene: Scene, sid: int):
    """(v0, e1, e2, ng) of the target shape's triangles, (T, 3) each."""
    geo = scene.geo
    tri = torch.nonzero(geo.shape_id == sid).squeeze(-1)
    return geo.v0[tri], geo.e1[tri], geo.e2[tri], geo.ng[tri]


def _connect(scene: Scene, tris, eta, sigma_t, med_id: int, x, lb, d_in):
    """The refracted connections of the (n, 3) scatter points x through
    every triangle of `tris` (T of them): (n, 3), each lane's sum over the
    triangles whose planar solution lies inside the triangle (barycentric
    test) of transmittance, Fresnel, geometry factor and phase."""
    v0, e1, e2, ng = tris
    T, n = v0.shape[0], x.shape[0]
    p0, nrm = v0[:, None], ng[:, None]
    e1b, e2b = e1[:, None], e2[:, None]
    xb, lbb = x[None], lb[None]
    B, okp = _solve_planar(p0, nrm, eta, xb, lbb)
    d = B - p0
    d00, d01, d11 = dot(e1b, e1b), dot(e1b, e2b), dot(e2b, e2b)
    d20, d21 = dot(d, e1b), dot(d, e2b)
    den = torch.clamp_min(d00 * d11 - d01 * d01, 1e-12)
    bu = (d11 * d20 - d01 * d21) / den
    bv = (d00 * d21 - d01 * d20) / den
    inside = (bu >= -1e-4) & (bv >= -1e-4) & (bu + bv <= 1 + 1e-4)
    lbb = lbb.expand(B.shape)
    uu, vv = _displaced(lbb, B)
    delta = 3e-3
    B_u, _ = _solve_planar(p0, nrm, eta, xb, lbb + delta * uu)
    B_v, _ = _solve_planar(p0, nrm, eta, xb, lbb + delta * vv)
    w0 = normalize(B - xb)
    G = _norm(cross((normalize(B_u - xb) - w0) / delta,
                    (normalize(B_v - xb) - w0) / delta))
    F_B, _ = fresnel_dielectric(torch.abs(dot(normalize(lbb - B), nrm)), eta)
    tr_conn = torch.exp(-sigma_t * _norm(B - xb)[..., None])
    rho = phase_m.eval(
        scene.media.phase,
        torch.full((T * n,), med_id, dtype=torch.int32, device=x.device),
        d_in.expand(T, n, 3).reshape(-1, 3), w0.reshape(-1, 3)).reshape(T, n)
    val = tr_conn * ((1.0 - F_B) * G * rho)[..., None]
    return torch.sum(torch.where((okp & inside & (G > 0))[..., None], val,
                                 0.0), dim=0)


def render_singlescatter_mesh(scene: Scene, cfg: RenderConfig, seed: int = 0,
                              n_dist: int = 4, stats: dict | None = None):
    """Single scatter through a triangle-mesh refractive boundary (the
    reference's per-triangle Newton, singlescatter.cpp:117, as bisection):
    every boundary triangle's planar refraction point for every lane, all
    valid solutions adding. Returns (H, W, 3); stream seed ^ 0x55D. The
    connections run only on the lanes whose camera ray enters the target,
    in chunks of MESH_CHUNK_ELEMS / T lanes. If `stats` is a dict it gets
    the wall as "singlescatter_mesh_s" and the connections' share as
    "singlescatter_mesh_connect_s"."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    t0 = lap(stats, None, dev, None)
    eps = common.scene_epsilon(scene)
    sid, med_id = _find_mesh_target(scene)
    tris = _mesh_triangles(scene, sid)
    chunk = max(MESH_CHUNK_ELEMS // tris[0].shape[0], 1)
    eta, sigma_a, sigma_s = _material(scene, sid, med_id, 1.5)
    sigma_t = sigma_a + sigma_s
    l_pos, I = point_light(scene)
    img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    connect_s = 0.0
    for s in range(cfg.spp):
        rays, smp = camera_rays(scene, cfg, seed ^ 0x55D, s)
        hit = isect.intersect(scene.geo, rays.o, rays.d, eps.expand(npix),
                              isect.INF)
        on_tgt = hit.valid & (hit.shape_id == sid)
        F_E, _ = fresnel_dielectric(dot(-rays.d, hit.ng), eta)
        d_in, tir_in = refract(-rays.d, hit.ng, eta)
        ok0 = on_tgt & ~tir_in
        E = hit.p
        # the exit chord: intersect again from just inside
        hit2 = isect.intersect(scene.geo, E + d_in * (2 * eps), d_in,
                               eps.expand(npix), isect.INF)
        t_exit = torch.where(hit2.valid & (hit2.shape_id == sid), hit2.t,
                             1e-3)
        t_exit = torch.clamp_min(t_exit, 1e-6)
        lanes = torch.nonzero(ok0).squeeze(-1)
        Lsum = torch.zeros_like(img)
        for _ in range(n_dist):
            t, pdf_t, smp = _distance(smp, sigma_t, t_exit)
            x = E + t[..., None] * d_in
            tr_in = torch.exp(-sigma_t * t[..., None])
            # the connections of the lanes that enter the target (the
            # others' values are dropped by ok0)
            tc = lap(stats, None, dev, None)
            conn = torch.zeros_like(x)
            for k in range(0, lanes.shape[0], chunk):
                sel = lanes[k:k + chunk]
                conn[sel] = _connect(scene, tris, eta, sigma_t, med_id,
                                     x[sel], l_pos.expand(sel.shape[0], 3),
                                     d_in[sel])
            if tc is not None:
                connect_s += lap(stats, None, dev, None) - tc
            val = (tr_in * conn * sigma_s * I
                   * ((1.0 - F_E) / torch.clamp_min(pdf_t, 1e-12))[..., None])
            ok = ok0 & torch.isfinite(val).all(-1)
            Lsum = Lsum + torch.where(ok[..., None], val, 0.0)
        img = img + Lsum / torch.tensor(float(n_dist), device=dev)
    if stats is not None:
        stats["singlescatter_mesh_connect_s"] = connect_s
    lap(stats, "singlescatter_mesh_s", dev, t0)
    return _finish(img, cfg)
