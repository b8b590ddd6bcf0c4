"""Deterministic validation reference (port of
mitsubaer_tpu/utils/validate.py::single_scatter_quadrature).

The single-scatter image of a point-lit heterogeneous medium bounded by the
scene AABB, by midpoint quadrature: the absolute anchor that the wavefront
engine's tracking estimators converge to. Its density lookups go through
`DensityGrid.lookup` (kernel A on the card). The beam double-scatter anchor
is not ported yet (ROADMAP Queue 1 step 4).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect


def single_scatter_quadrature(scene, cfg, *, medium: int = 0,
                              emitter: int = 0, sub: int = 4, nt: int = 128,
                              nl: int = 64) -> np.ndarray:
    """(H, W, 3) float64 truth for max_depth=2:

      L(pix) = avg_subpix INT T_cam(t) sigma_s dens rho_HG T_light I/d^2 dt

    with `sub`^2 subpixel rays, `nt` camera steps and `nl` light-segment
    steps, on the scene's device."""
    dev = scene.aabb_min.device
    grid = medium_m.DensityGrid(scene.media)
    ss = scene.media.sigma_s[medium]
    st = scene.media.sigma_a[medium] + ss
    scale = scene.media.scale[medium]
    light_p = scene.emitters.position[emitter]
    light_I = scene.emitters.radiance[emitter]
    W, H = cfg.width, cfg.height
    lo, hi = scene.aabb_min, scene.aabb_max
    k = torch.arange(nt, dtype=torch.float32, device=dev) + 0.5
    kk = torch.arange(nl, dtype=torch.float32, device=dev) + 0.5
    med = torch.full((W * H * nt,), medium, dtype=torch.int64, device=dev)

    def block(px, py):
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
        o, d = rays.o, rays.d
        t0, t1 = isect.ray_aabb(o, d, lo, hi)
        t0 = torch.clamp_min(t0, 0.0)
        dt = torch.clamp_min(t1 - t0, 0.0) / nt
        tmid = t0[:, None] + k[None, :] * dt[:, None]
        pmid = o[:, None, :] + tmid[..., None] * d[:, None, :]
        dmid = (grid.lookup(pmid.reshape(-1, 3)) * scale).reshape(
            pmid.shape[:2])
        dtau = dmid[..., None] * st * dt[:, None, None]
        T_cam = torch.exp(-(torch.cumsum(dtau, dim=1) - 0.5 * dtau))

        to_l = light_p - pmid
        dist_l = torch.linalg.vector_norm(to_l, dim=-1)
        wl = to_l / dist_l[..., None]
        pf, wf = pmid.reshape(-1, 3), wl.reshape(-1, 3)
        _, tl_exit = isect.ray_aabb(pf, wf, lo, hi)
        tl_exit = torch.minimum(torch.clamp_min(tl_exit, 0.0),
                                dist_l.reshape(-1))
        dl = tl_exit / nl
        pl = pf[:, None, :] + (kk[None, :] * dl[:, None])[..., None] \
            * wf[:, None, :]
        dml = (grid.lookup(pl.reshape(-1, 3)) * scale).reshape(pl.shape[:2])
        tau_l = torch.sum(dml, dim=1) * dl
        T_light = torch.exp(-tau_l[:, None] * st).reshape(pmid.shape[0], nt,
                                                          3)
        rho = phase_m.eval(scene.media.phase, med,
                           torch.repeat_interleave(d, nt, dim=0),
                           wf).reshape(pmid.shape[:2])
        emit = light_I / (dist_l ** 2)[..., None]
        integrand = (T_cam * (dmid[..., None] * ss) * rho[..., None]
                     * T_light * emit)
        return torch.sum(integrand * dt[:, None, None], dim=1)

    offs = (np.arange(sub) + 0.5) / sub
    img = np.zeros((H, W, 3), np.float64)
    pix = np.arange(W * H)
    for oy in offs:
        for ox in offs:
            px = torch.from_numpy((pix % W + ox).astype(np.float32)).to(dev)
            py = torch.from_numpy((pix // W + oy).astype(np.float32)).to(dev)
            img += block(px, py).cpu().numpy().reshape(H, W, 3)
    return img / (sub * sub)
