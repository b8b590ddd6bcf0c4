"""Shared integrator helpers (port of mitsubaer_tpu/integrators/common.py):
the render device, the contribution sink (steady state, transient, bounce
and CW-ToF), Russian roulette, the ray epsilon, and the camera prologue of
a render pass.

The sink generalises the reference's ImageBlock putSample with the film's
decomposition (bdpt_wr.cpp, bdpt_proc.cpp:452-476): every contribution
carries its optical path length and depth, and lands in the steady image,
in a time bin, in a bounce bin, or weighted by the CW-ToF correlation.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core import rng
from ..models import film as film_m
from ..models import sensor as sensor_m
from ..models import tof
from ..scene.types import RenderConfig


def render_device(device) -> torch.device:
    """The device to render on: the CUDA card unless `device` names
    another. Never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return device


@dataclass(frozen=True)
class Sink:
    """What a lane's contributions add to: `steady` (N, 3), and where the
    film has frames (cfg.n_frames > 1) `frames` (H W, F, 3) of the pass,
    addressed through `pixel`, the (N,) pixel of each lane."""
    steady: torch.Tensor
    frames: torch.Tensor | None = None
    pixel: torch.Tensor | None = None


def sync(device) -> None:
    """Wait for the card's queued work (a timer's edge); nothing on the
    CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def new_sink(cfg: RenderConfig, n: int, pixel=None, device=None) -> Sink:
    """An empty sink of n lanes; frames where cfg.n_frames > 1, which need
    the lanes' pixels."""
    frames = None
    if cfg.n_frames > 1:
        if pixel is None:
            raise ValueError("a sink with frames needs the lanes' pixels")
        frames = torch.zeros((cfg.height * cfg.width, cfg.n_frames, 3),
                             dtype=torch.float32, device=device)
    return Sink(steady=torch.zeros((n, 3), dtype=torch.float32,
                                   device=device),
                frames=frames, pixel=pixel)


def add_contribution(sink: Sink, cfg: RenderConfig, value, plen, depth,
                     active, log_p=None) -> Sink:
    """The sink plus value (N, 3) of the lanes `active`, a contribution of
    optical path length plen and depth `depth` (common.py:33-69), in JAX's
    order: non-finite values carry no energy (they are numerical casualties
    on degenerate lanes) and are dropped before the mask, so that NaN
    primals never reach the backward pass; then the mask; then, where
    log_p (the attached log-density of the parameter-dependent sampling
    decisions behind the contribution) is given, the zero-valued surrogate
    value.detach() * (log_p - log_p.detach()), whose derivative is the
    score term value * dlog_p. Under CW-ToF the value is weighted by the
    correlation at plen and added to `steady`; with one frame it is added
    to `steady`; in transient (bounce) mode it lands in the floor bin of
    plen (depth), and nowhere where that lies outside [min_bound,
    max_bound). The frames add through index_put_ with accumulate, in a
    varying order on CUDA; where the value carries gradients (or log_p is
    given) the frames are added out of place, so that a checkpointed
    bounce that runs again does not add twice."""
    value = torch.where(torch.isfinite(value), value, 0.0)
    value = torch.where(active.unsqueeze(-1), value, 0.0)
    if log_p is not None:
        value = value + value.detach() * (log_p - log_p.detach()).unsqueeze(-1)
    if cfg.modulation != "none":
        w = tof.correlation_function(cfg, plen)
        return replace(sink, steady=sink.steady + value * w.unsqueeze(-1))
    if cfg.n_frames == 1:
        return replace(sink, steady=sink.steady + value)
    key = depth.to(torch.float32) if cfg.decomposition == "bounce" else plen
    b, inside = film_m.bin_index(cfg, key)
    value = torch.where((inside & active).unsqueeze(-1), value, 0.0)
    index = (sink.pixel.to(torch.int64), b)
    if value.requires_grad or log_p is not None:
        frames = sink.frames.index_put(index, value, accumulate=True)
    else:
        frames = sink.frames.index_put_(index, value, accumulate=True)
    return replace(sink, frames=frames)


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


def lane_pixels(cfg: RenderConfig, sppc: int, device=None) -> torch.Tensor:
    """The pixel of each lane of an spp chunk: lane s * npix + p is
    pixel p."""
    npix = cfg.height * cfg.width
    return torch.arange(npix, dtype=torch.int64, device=device).repeat(sppc)


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
    pixel = lane_pixels(cfg, sppc, dev)
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
