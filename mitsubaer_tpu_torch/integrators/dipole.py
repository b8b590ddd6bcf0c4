"""The classical dipole BSSRDF (port of mitsubaer_tpu/integrators/dipole.py;
the reference's src/subsurface/dipole.cpp, Jensen et al. 2001).

The reference gathers R_d-weighted irradiance from an octree over surface
samples. As in the JAX package the cache is a dense array of M
area-weighted surface samples and the gather a pairwise (n, M) R_d sum in
chunks of `chunk` samples:
- cache: M points x_i on the target mesh with area A_i and the
  point light's irradiance E_i through the boundary's Fresnel
  transmittance, shadowed (dipole.cpp preprocess);
- diffusion: R_d(r) of the classical dipole, with Groenhuis's internal
  reflection parameter A = (1 + F_dr) / (1 - F_dr);
- shading: Lo(x, wo) = Ft(eta, wo) / pi sum_i R_d(|x - x_i|) E_i A_i.
The JAX gather slices its chunks with lax.dynamic_slice_in_dim, which
clamps the start: where M % chunk != 0 the last chunk is the last `chunk`
samples and overlaps the one before it, whose samples then count twice.
The port does the same (start min(c0, M - chunk)). The pixel lanes whose
camera ray meets the target are gathered in blocks of at most
GATHER_ELEMS / chunk lanes; a lane's sum is the same in any blocking.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.math import dot, fresnel_dielectric
from ..scene import intersect as isect
from ..scene.types import RenderConfig, Scene
from . import common
from .photonmap import camera_rays, lap
from .singlescatter import (_find_mesh_target, _finish, _material,
                            point_light)

# the (lanes, samples) elements of one block of the pairwise gather: each
# (lanes, chunk, 3) float32 temporary is 12 bytes an element, ~100 MB here
GATHER_ELEMS = 1 << 23


def rd_dipole(r, sigma_a, sigma_s_p, eta: float):
    """The classical dipole's diffuse reflectance R_d(r) (dipole.cpp,
    Jensen 2001 eq. 4); r, sigma_a and the reduced sigma_s' broadcast,
    channels on the last axis; eta a Python float."""
    sigma_t_p = sigma_a + sigma_s_p
    alpha_p = sigma_s_p / torch.clamp_min(sigma_t_p, 1e-9)
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_t_p)
    F_dr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    # A and the virtual source's depth factor in float32, as the JAX
    # package's weakly typed scalars round them
    A = np.float32(1.0 + F_dr) / np.float32(max(1.0 - F_dr, 1e-6))
    z_fac = float(np.float32(1.0) + np.float32(4.0 / 3.0) * A)
    z_r = 1.0 / torch.clamp_min(sigma_t_p, 1e-9)
    z_v = z_r * z_fac
    r2 = r * r
    d_r = torch.sqrt(r2 + z_r * z_r)
    d_v = torch.sqrt(r2 + z_v * z_v)
    c1 = (z_r * (sigma_tr * d_r + 1.0) * torch.exp(-sigma_tr * d_r)
          / torch.clamp_min(d_r * d_r * d_r, 1e-12))
    c2 = (z_v * (sigma_tr * d_v + 1.0) * torch.exp(-sigma_tr * d_v)
          / torch.clamp_min(d_v * d_v * d_v, 1e-12))
    return alpha_p / (4.0 * math.pi) * (c1 + c2)


def _surface_samples(scene: Scene, sid: int, m: int, seed: int):
    """m area-weighted points of shape `sid` (a triangle mesh), drawn on
    the host with numpy's generator of `seed` exactly as the JAX package
    draws them: (points (m, 3), normals (m, 3), areas (m,)) on the scene's
    device, each point's area total / m."""
    geo = scene.geo
    tri_shape = geo.shape_id.cpu().numpy()
    tri_ids = np.argwhere(tri_shape == sid).ravel()
    v0, e1, e2, ng = (t.cpu().numpy()[tri_ids]
                      for t in (geo.v0, geo.e1, geo.e2, geo.ng))
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    rs = np.random.default_rng(seed)
    which = rs.choice(len(tri_ids), size=m, p=areas / total)
    u = rs.random((m, 2)).astype(np.float32)
    su = np.sqrt(u[:, 0])
    b1 = 1.0 - su
    b2 = u[:, 1] * su
    pts = v0[which] + b1[:, None] * e1[which] + b2[:, None] * e2[which]
    dev = scene.aabb_min.device
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(ng[which]).to(dev),
            torch.full((m,), float(np.float32(total / m)),
                       dtype=torch.float32, device=dev))


def _cache_irradiance(scene: Scene, eps, l_pos, I, eta: float, xi, ni):
    """Each sample's irradiance from the point light through the
    boundary's Fresnel transmittance, 0 where the light is blocked."""
    to_l = l_pos - xi
    d2 = torch.clamp_min(dot(to_l, to_l), 1e-9)
    dist = torch.sqrt(d2)
    wl = to_l / dist[..., None]
    cos_i = torch.clamp_min(dot(wl, ni), 0.0)
    blocked = isect.occluded(scene.geo, xi + wl * (2 * eps), wl,
                             eps.expand(xi.shape[0]), dist - 4 * eps)
    F_i, _ = fresnel_dielectric(cos_i, eta)
    E = I * ((1.0 - F_i) * cos_i / d2)[..., None]
    return torch.where(blocked[..., None], 0.0, E)


def _gather(x, xi, Ei, Ai, sigma_a, sigma_s_p, eta: float, chunk: int):
    """sum_i R_d(|x - x_i|) E_i A_i at the (n, 3) points x, over the
    samples in chunks of `chunk` with JAX's clamped starts (the last chunk
    overlapping where M % chunk != 0)."""
    M = xi.shape[0]
    acc = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=x.device)
    for c0 in range(0, M, chunk):
        s0 = max(min(c0, M - chunk), 0)
        xc, Ec, Ac = xi[s0:s0 + chunk], Ei[s0:s0 + chunk], Ai[s0:s0 + chunk]
        d = x[:, None, :] - xc[None, :, :]
        r = torch.sqrt(torch.clamp_min(
            d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            + d[..., 2] * d[..., 2], 1e-12))
        rd = rd_dipole(r[..., None], sigma_a, sigma_s_p, eta)
        acc = acc + torch.sum(rd * Ec[None] * Ac[None, :, None], dim=1)
    return acc


def render_dipole(scene: Scene, cfg: RenderConfig, seed: int = 0,
                  n_cache: int = 4096, chunk: int = 1024,
                  stats: dict | None = None):
    """Dipole-subsurface image of the target mesh shape, (H, W, 3): a
    cache of n_cache samples (numpy's generator of `seed`), then cfg.spp
    camera samples a pixel from stream seed ^ 0xD1B, gathered in chunks
    of `chunk` samples. The light is the first emitter, used as a point
    light whatever its kind. If `stats` is a dict it gets the wall as
    "dipole_s" and the stages' seconds as "dipole_stage_s" ("cache",
    "camera", "gather")."""
    npix = cfg.height * cfg.width
    dev = scene.aabb_min.device
    stages = None if stats is None else stats.setdefault("dipole_stage_s",
                                                         {})
    t0 = lap(stats, None, dev, None)
    eps = common.scene_epsilon(scene)
    sid, med_id = _find_mesh_target(scene)
    eta, sigma_a, sigma_s = _material(scene, sid, med_id, 1.3)
    # the JAX package reads the reduced coefficient's g from media.g, a
    # field its Media does not have: g is 0 and sigma_s' = sigma_s
    sigma_s_p = sigma_s
    l_pos, I = point_light(scene)

    ts = lap(stages, None, dev, None)
    xi, ni, Ai = _surface_samples(scene, sid, n_cache, seed)
    Ei = _cache_irradiance(scene, eps, l_pos, I, eta, xi, ni)
    ts = lap(stages, "cache", dev, ts)
    block = max(GATHER_ELEMS // min(chunk, n_cache), 1)
    img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        rays, _ = camera_rays(scene, cfg, seed ^ 0xD1B, s)
        hit = isect.intersect(scene.geo, rays.o, rays.d, eps.expand(npix),
                              isect.INF)
        on_tgt = hit.valid & (hit.shape_id == sid)
        F_o, _ = fresnel_dielectric(dot(-rays.d, hit.ng), eta)
        lanes = torch.nonzero(on_tgt).squeeze(-1)
        ts = lap(stages, "camera", dev, ts)
        Mo = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        for k in range(0, lanes.shape[0], block):
            sel = lanes[k:k + block]
            Mo[sel] = _gather(hit.p[sel], xi, Ei, Ai, sigma_a, sigma_s_p,
                              eta, chunk)
        Lo = Mo * ((1.0 - F_o) / math.pi)[..., None]
        img = img + torch.where(on_tgt[..., None], Lo, 0.0)
        ts = lap(stages, "gather", dev, ts)
    lap(stats, "dipole_s", dev, t0)
    return _finish(img, cfg)
