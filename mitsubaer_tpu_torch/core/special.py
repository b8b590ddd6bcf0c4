"""Special functions (port of mitsubaer_tpu/core/special.py): the von
Mises-Fisher distribution of the vMF and microflake phase functions
(vmf.cpp). The quadrature, root-finding, spherical-harmonic and chi^2
helpers wait for their callers (ROADMAP Queue 1 steps 12-13)."""
from __future__ import annotations

import math

import torch


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
