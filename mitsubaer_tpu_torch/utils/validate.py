"""Deterministic validation references (port of
mitsubaer_tpu/utils/validate.py::single_scatter_quadrature and
beam_double_scatter_quadrature).

By midpoint quadrature: the single-scatter image of a point-lit
heterogeneous medium bounded by the scene AABB, and the double-scatter
image of the collimated-beam scene. They are the absolute anchors that the
wavefront, boxwalk and loop engines' estimators converge to. Their density
lookups go through `DensityGrid.lookup` (kernel A on the card).
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


def beam_double_scatter_quadrature(scene, cfg, *, medium: int = 0,
                                   sub: int = 2, nt: int = 96,
                                   ns: int = 192) -> np.ndarray:
    """(H, W, 3) float64 truth for the collimated-beam scene at
    max_depth=2, whose shortest light path is camera -> x (scatter) <- y
    (scatter on the beam) <- beam:

      L_c(pix) = avg_sub INT_t T_cam,c sigma_s_c(x)
                 INT_s rho(d_cam, d_xy) e^{-tau_c(x, y)} / d^2
                        sigma_s_c(y) rho(b_d, d_yx) T_beam,c(s) P_c ds dt

    with `sub`^2 subpixel rays, `nt` camera steps, `ns` beam steps and 64
    steps along each chord x-y for its optical depth, on the scene's
    device, four camera rays at a time (nt * ns * 64 lookups each)."""
    from ..integrators.volpath import get_beam

    dev = scene.aabb_min.device
    grid = medium_m.DensityGrid(scene.media)
    ss = scene.media.sigma_s[medium]
    st = scene.media.sigma_a[medium] + ss
    scale = scene.media.scale[medium]
    phase = scene.media.phase
    beam = get_beam(scene)
    W, H = cfg.width, cfg.height
    lo, hi = scene.aabb_min, scene.aabb_max
    nsh = 64                        # shadow-chord quadrature steps
    k = torch.arange(nt, dtype=torch.float32, device=dev) + 0.5
    kk = (torch.arange(nsh, dtype=torch.float32, device=dev) + 0.5) / nsh

    # beam samples y_j, shared by every pixel
    ds_ = (beam.s1 - beam.s0) / ns
    sj = beam.s0 + (torch.arange(ns, dtype=torch.float32, device=dev)
                    + 0.5) * ds_
    y = beam.o[None, :] + sj[:, None] * beam.d[None, :]          # (ns, 3)
    dy = grid.lookup(y) * scale
    tau_beam = (torch.cumsum(dy, dim=0) - 0.5 * dy) * ds_
    T_beam = torch.exp(-tau_beam[:, None] * st[None, :])         # (ns, 3)

    def inner(x, di):
        """(P, nt, 3) beam integral at camera points x (P, nt, 3) of rays
        with directions di (P, 3)."""
        P = x.shape[0]
        to_x = x[:, :, None, :] - y[None, None]              # (P, nt, ns, 3)
        dist = torch.clamp_min(torch.linalg.vector_norm(to_x, dim=-1), 1e-6)
        w = to_x / dist[..., None]
        pssh = y[None, None, :, None, :] \
            + (kk[None, None, None, :, None] * dist[..., None, None]) \
            * w[..., None, :]
        dsh = (grid.lookup(pssh.reshape(-1, 3)) * scale).reshape(
            P, nt, ns, nsh)
        tau_sh = torch.sum(dsh, dim=-1) * (dist / nsh)
        T_sh = torch.exp(-tau_sh[..., None] * st)
        midx = torch.full((P * nt * ns,), medium, dtype=torch.int64,
                          device=dev)
        rho_x = phase_m.eval(phase, midx, di[:, None, None, :].expand(
            w.shape).reshape(-1, 3), (-w).reshape(-1, 3)).reshape(P, nt, ns)
        rho_y = phase_m.eval(phase, midx, beam.d.expand(w.shape).reshape(
            -1, 3), w.reshape(-1, 3)).reshape(P, nt, ns)
        val = (rho_x[..., None] * T_sh / (dist ** 2)[..., None]
               * (dy[:, None] * ss) * rho_y[..., None] * T_beam
               * beam.power) * ds_
        return torch.sum(val, dim=2)

    def block(px, py):
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
        o, d = rays.o, rays.d
        t0, t1 = isect.ray_aabb(o, d, lo, hi)
        t0 = torch.clamp_min(t0, 0.0)
        dt = torch.clamp_min(t1 - t0, 0.0) / nt
        tmid = t0[:, None] + k[None, :] * dt[:, None]
        x = o[:, None, :] + tmid[..., None] * d[:, None, :]      # (N, nt, 3)
        dx = (grid.lookup(x.reshape(-1, 3)) * scale).reshape(x.shape[:2])
        dtau = dx[..., None] * st * dt[:, None, None]
        T_cam = torch.exp(-(torch.cumsum(dtau, dim=1) - 0.5 * dtau))
        inner_all = torch.cat([inner(x[i:i + 4], d[i:i + 4])
                               for i in range(0, x.shape[0], 4)])
        integrand = T_cam * (dx[..., None] * ss) * inner_all
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
