"""CW time-of-flight correlation functions and path-length importance
sampling (port of mitsubaer_tpu/models/tof.py; the reference's
PathLengthSampler, pathlengthsampler.cpp).

`correlation_function(cfg, t)` weighs a contribution by the demodulation
profile at its optical path length t: sine, square, hamiltonian,
m-sequence or depth-selective codes (pathlengthsampler.cpp:67-120), and 1
with no modulation. `sample_path_length` draws a target length with
density proportional to |R(t)| on [min_bound, max_bound] from a tabulated
inverse CDF (the reference's rejection sampler made branchless).
"""
from __future__ import annotations

import math

import torch

from ..scene.types import RenderConfig


def _mseq(cfg: RenderConfig, t, phase: float):
    """m-sequence correlation (pathlengthsampler.h mSeq): period lambda_,
    a triangular peak one chip (lambda_ / P) wide at the phase offset,
    the floor -1/P elsewhere."""
    P = cfg.P
    x = torch.remainder(t / cfg.lambda_ + phase / (2 * math.pi), 1.0) * P
    r = torch.round(x)
    tri = torch.clamp_min(1.0 - torch.abs(x - r) * 2.0, 0.0)
    near0 = torch.remainder(r, P) == 0
    return torch.where(near0, tri * (1.0 + 1.0 / P) - 1.0 / P, -1.0 / P)


def correlation_function(cfg: RenderConfig, t):
    """The weight of a contribution of optical path length t
    (pathlengthsampler.cpp:67)."""
    lam = cfg.lambda_
    phase = cfg.phase * math.pi / 180.0
    if cfg.modulation == "sine":
        tt = t + phase * lam / (2 * math.pi)
        return torch.cos(tt * 2 * math.pi / lam)
    if cfg.modulation == "square":
        tt = t + phase * lam / (2 * math.pi)
        return 4.0 / lam * (torch.abs(torch.remainder(tt, lam) - lam / 2)
                            - lam / 4)
    if cfg.modulation == "hamiltonian":
        tt = torch.remainder(t + phase * lam / (2 * math.pi), lam)
        return torch.where(
            tt < lam / 6, 6 * tt / lam,
            torch.where(tt < lam / 2, 1.0,
                        torch.where(tt < 2 * lam / 3,
                                    1 - (tt - lam / 2) * 6 / lam, 0.0)))
    if cfg.modulation == "mseq":
        return _mseq(cfg, t, phase)
    if cfg.modulation == "depthselective":
        v = torch.zeros_like(t)
        for i in range(cfg.neighbors):
            v = v + _mseq(cfg, t, phase - i * (2 * math.pi) / cfg.P)
        return v - (cfg.neighbors - 1) / cfg.P
    return torch.ones_like(t)


def area_under_correlation(cfg: RenderConfig, n_bins: int = 1024,
                           device=None):
    """The integral of |R(t)| over [min_bound, max_bound] by the midpoint
    rule (pathlengthsampler.cpp areaUnderCorrelationGraph)."""
    edges = torch.linspace(cfg.min_bound, cfg.max_bound, n_bins + 1,
                           dtype=torch.float32, device=device)
    mids = 0.5 * (edges[:-1] + edges[1:])
    w = torch.abs(correlation_function(cfg, mids))
    return torch.sum(w) * (cfg.max_bound - cfg.min_bound) / n_bins


def sample_path_length(cfg: RenderConfig, u, n_bins: int = 256):
    """A target optical path length with density proportional to |R(t)|
    on [min_bound, max_bound] (pathlengthsampler.cpp
    sampleRestrictedPathLength): the bin by binary search of the
    tabulated CDF, the position inside it by its linear CDF. Returns
    (t, pdf); uniform with no modulation."""
    dev = u.device
    lo = torch.tensor(cfg.min_bound, dtype=torch.float32, device=dev)
    hi = torch.tensor(max(cfg.max_bound, cfg.min_bound + 1e-6),
                      dtype=torch.float32, device=dev)
    edges = torch.linspace(float(lo), float(hi), n_bins + 1,
                           dtype=torch.float32, device=dev)
    mids = 0.5 * (edges[:-1] + edges[1:])
    w = torch.abs(correlation_function(cfg, mids)) + 1e-8
    cdf = torch.cumsum(w, dim=0)
    total = cdf[-1]
    target = u * total
    idx = torch.clamp(torch.searchsorted(cdf, target), 0, n_bins - 1)
    prev = torch.where(idx > 0, cdf[torch.clamp_min(idx - 1, 0)], 0.0)
    wi = w[idx]
    frac = torch.clamp((target - prev) / torch.clamp_min(wi, 1e-12), 0.0,
                       1.0)
    bin_w = (hi - lo) / n_bins
    t = lo + (idx.to(torch.float32) + frac) * bin_w
    pdf = wi / torch.clamp_min(total * bin_w, 1e-12)
    return t, pdf
