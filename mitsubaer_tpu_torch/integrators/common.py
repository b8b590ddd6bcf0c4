"""Shared integrator helpers (port of mitsubaer_tpu/integrators/common.py):
the render device, the steady-state contribution sink, Russian roulette,
the ray epsilon, and the camera prologue of a render pass.
Transient, bounce and CW-ToF sinks are not ported (ROADMAP Queue 1 step 10).
"""
from __future__ import annotations

import torch

from ..core import rng
from ..models import sensor as sensor_m
from ..scene.types import RenderConfig


def render_device(device) -> torch.device:
    """The device to render on: the CUDA card unless `device` names
    another. Never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return device


def new_sink(n: int, device=None) -> torch.Tensor:
    """Steady-state sink: the (N, 3) radiance of each lane."""
    return torch.zeros((n, 3), dtype=torch.float32, device=device)


def add_contribution(sink, value, active, log_p=None):
    """sink + value where active; non-finite values carry no energy (they
    are numerical casualties on degenerate lanes) and are dropped, before
    the mask, so that NaN primals never reach the backward pass.

    log_p: the attached log-density of the parameter-dependent sampling
    decisions behind the contribution (common.py:33-56). Where given, the
    zero-valued surrogate value.detach() * (log_p - log_p.detach()) is
    added, whose derivative is the score term value * dlog_p."""
    value = torch.where(torch.isfinite(value), value, 0.0)
    value = torch.where(active.unsqueeze(-1), value, 0.0)
    if log_p is not None:
        value = value + value.detach() * (log_p - log_p.detach()).unsqueeze(-1)
    return sink + value


def russian_roulette(throughput, eta_scale, u, depth, cfg: RenderConfig):
    """Mitsuba-style RR (path.cpp:200-208): survive with
    q = min(max(throughput) eta^2, 0.95) once depth >= rr_depth."""
    q = torch.clamp_max(torch.amax(throughput, dim=-1) * eta_scale * eta_scale,
                        0.95)
    do_rr = depth >= cfg.rr_depth
    survive = torch.where(do_rr, u < q, True)
    throughput = torch.where(
        do_rr.unsqueeze(-1),
        throughput / torch.clamp_min(q, 1e-6).unsqueeze(-1), throughput)
    return throughput, survive


def scene_epsilon(scene):
    """Relative ray epsilon from the scene extent (ShadowEpsilon analogue)."""
    diag = torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min)
    return 1e-4 * torch.clamp_min(diag, 1e-3)


def camera_samples(scene, cfg: RenderConfig, sppc: int, seed: int,
                   pass_idx: int, mode: int = rng.INDEPENDENT):
    """The camera prologue of one spp chunk (render.py:109-124): lane
    s * npix + pixel is sample pass_idx * sppc + s of its pixel; it draws
    its jitter inside the pixel, then the thin-lens aperture sample, from a
    sampler in `mode` (the loop road's cfg.sampler; the eikonal road keeps
    the independent one, as in the JAX package). Returns (rays, (N, 2)
    jitter, the sampler after both draws)."""
    H, W = cfg.height, cfg.width
    npix = H * W
    dev = scene.aabb_min.device
    pixel = torch.arange(npix, dtype=torch.int64, device=dev).repeat(sppc)
    sample_index = torch.repeat_interleave(
        pass_idx * sppc + torch.arange(sppc, dtype=torch.int64, device=dev),
        npix)
    smp = rng.make_sampler(seed, pixel, sample_index, mode=mode,
                           n_samples=cfg.spp)
    jitter, smp = rng.next_2d(smp)
    u_lens, smp = rng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jitter[:, 0]
    py = (pixel // W).to(torch.float32) + jitter[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H, u_lens=u_lens,
                                kind_hint=cfg.sensor_kind)
    return rays, jitter, smp
