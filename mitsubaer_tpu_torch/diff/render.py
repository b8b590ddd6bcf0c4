"""Differentiable rendering: gradients of the rendered image with respect
to the medium parameters (port of mitsubaer_tpu/diff/render.py).

The estimator is the JAX package's ("differential path sampling"): every
sampling decision (distances, collision tests, directions) is detached, the
contribution weights keep the parameters attached (the pathwise d(f/p)
term), and every contribution adds the zero-valued surrogate
value.detach() * (log_p - log_p.detach()), whose derivative is the score
term. The bounce loop is `volpath.li(differentiable=True)`: each bounce
under a checkpoint, the tracking loops capped at 64 tests.

Gradients reach sigma_a, sigma_s (per medium), the heterogeneous density
grid (through kernel A's backward, kernel A') and the HG g. The JAX
package's `rif` (the B-spline refractive-index grid of the eikonal road)
waits for ROADMAP Queue 1 step 8b, after the spline RIF (step 7).

`render_diff`, `loss_and_grad` and `image_grad` run on the CUDA card unless
the caller passes device="cpu"; without a card they raise.
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from .. import not_ported
from ..core import rng
from ..integrators import volpath as volpath_m
from ..integrators.render import _device
from ..models import sensor as sensor_m
from ..scene.types import RenderConfig, Scene


class MediumParams(NamedTuple):
    """The differentiable parameter bundle. The JAX bundle's fifth field,
    `rif`, waits for step 8b."""

    sigma_a: torch.Tensor   # (NM, 3)
    sigma_s: torch.Tensor   # (NM, 3)
    density: torch.Tensor   # (nz, ny, nx) heterogeneous density grid
    g: torch.Tensor         # (NM,) HG asymmetry


def get_params(scene: Scene) -> MediumParams:
    media = scene.media
    return MediumParams(sigma_a=media.sigma_a, sigma_s=media.sigma_s,
                        density=media.density.data, g=media.phase.g)


def put_params(scene: Scene, p: MediumParams) -> Scene:
    """The scene with the parameters p; the tracking majorant becomes
    max(density) * max(scale), detached (render.py:56-70)."""
    media = scene.media
    majorant = (torch.amax(p.density) * torch.amax(media.scale)).detach()
    media = replace(media, sigma_a=p.sigma_a, sigma_s=p.sigma_s,
                    density=replace(media.density, data=p.density),
                    phase=replace(media.phase, g=p.g), majorant=majorant)
    return replace(scene, media=media)


def params_from_numpy(arrays: dict, device=None) -> MediumParams:
    """MediumParams from a dict of numpy arrays named as the JAX bundle's
    fields (its `rif` is ignored), as float32 tensors on `device`."""
    return MediumParams(*(
        torch.as_tensor(np.asarray(arrays[f], dtype=np.float32),
                        device=device) for f in MediumParams._fields))


def render_diff(scene: Scene, params: MediumParams, cfg: RenderConfig,
                sppc: int, seed: int, pass_idx: int, device=None):
    """Differentiable forward render of one spp chunk: the (H, W, 3) mean
    radiance over its sppc samples a pixel (box filter), with the
    pixel and sample-index layout of render.py:73-94 (one jitter draw, no
    aperture draw). `params` may live on another device: they are moved,
    and gradients flow back to them."""
    integ = (cfg.integrator if cfg.integrator.startswith("volpath")
             else "volpath")
    if integ == "volpath_er":
        raise not_ported("gradients of the eikonal road (volpath_er)", 8)
    dev = _device(device)
    scene = put_params(scene.to(dev),
                       MediumParams(*(t.to(dev) for t in params)))
    H, W = cfg.height, cfg.width
    npix = H * W
    pixel = torch.arange(npix, dtype=torch.int64, device=dev).repeat(sppc)
    sample_index = torch.repeat_interleave(
        pass_idx * sppc + torch.arange(sppc, dtype=torch.int64, device=dev),
        npix)
    smp = rng.make_sampler(seed, pixel, sample_index)
    jitter, smp = rng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jitter[:, 0]
    py = (pixel // W).to(torch.float32) + jitter[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
    sink, _, _ = volpath_m.li(scene, replace(cfg, integrator=integ), rays.o,
                              rays.d, smp, simple=integ == "volpath_simple",
                              differentiable=True)
    return sink.reshape(sppc, H, W, 3).mean(dim=0)


def loss_fn(scene, params, cfg, sppc, seed, pass_idx, target, device=None):
    img = render_diff(scene, params, cfg, sppc, seed, pass_idx, device)
    target = torch.as_tensor(target, dtype=torch.float32, device=img.device)
    return torch.mean((img - target) ** 2)


def _grads(scalar, params: MediumParams):
    """(scalar(leaves).detach(), MediumParams of its gradients) at fresh
    leaves made from params; a field the render never read (the density
    grid of a homogeneous scene) gets zeros, as in JAX."""
    leaves = MediumParams(*(t.detach().requires_grad_() for t in params))
    value = scalar(leaves)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), MediumParams(*(
        torch.zeros_like(t) if g is None else g
        for t, g in zip(leaves, grads)))


def loss_and_grad(scene: Scene, params: MediumParams, cfg: RenderConfig,
                  sppc: int, seed: int, pass_idx: int, target, device=None):
    """(loss, dloss/dparams as MediumParams) for one spp chunk against a
    target image; the gradients lie on the params' devices."""
    return _grads(lambda p: loss_fn(scene, p, cfg, sppc, seed, pass_idx,
                                    target, device), params)


def image_grad(scene: Scene, cfg: RenderConfig, sppc: int, seed: int = 0,
               weight_image=None, device=None) -> MediumParams:
    """d(sum(image * weight_image))/dparams at the scene's own parameters,
    pass 0 (weight_image defaults to all ones)."""
    def scalar(p):
        img = render_diff(scene, p, cfg, sppc, seed, 0, device)
        if weight_image is None:
            return img.sum()
        w = torch.as_tensor(weight_image, dtype=torch.float32,
                            device=img.device)
        return torch.sum(img * w)

    return _grads(scalar, get_params(scene))[1]
