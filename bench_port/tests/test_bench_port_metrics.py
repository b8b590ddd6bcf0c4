"""The benchmark's arithmetic on synthetic input: the busy share as a
union of device intervals, the idle gaps, s_to_1pct_rmse on images of a
known variance and the comparison's numbers."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench_port import check, run, trace
from bench_port.traffic import render_loop


@pytest.mark.parametrize("rows, busy", [
    ([], 0.0),
    ([[0, 10]], 10.0),
    ([[0, 10], [5, 15]], 15.0),            # overlap on two streams
    ([[0, 10], [2, 3], [20, 25]], 15.0),   # nested, then apart
    ([[20, 25], [0, 10], [10, 12]], 17.0),  # unsorted, touching
])
def test_busy_union(rows, busy):
    iv = np.asarray(rows, dtype=np.float64).reshape(-1, 2)
    assert trace.busy_union(iv) == busy


def test_idle_gaps_name_the_innermost_span():
    iv = np.array([[0, 10], [5, 20], [30, 40], [41, 50]], np.float64) * 1e9
    tr = trace.DeviceTrace(["a", "b", "c", "d"], iv, (0, 60e9), 0)
    assert tr.busy_s == 39.0 and tr.window_s == 60.0 and tr.launches == 4
    spans = [("render", 0, 60e9, 0), ("body", 22e9, 28e9, 1)]
    assert sorted(tr.idle_gaps(spans)) == [["body", 10.0], ["render", 1.0],
                                           ["render", 10.0]]
    assert trace.gaps(iv, 0, 60e9).tolist() == [[20e9, 30e9], [40e9, 41e9],
                                                [50e9, 60e9]]


def test_s_to_1pct_rmse_on_known_variance():
    """Images of mean 2 and per-pixel variance 0.04: a relative MSE of 0.01
    an image, so at 2 s an image 1% RMSE takes 2 * 0.01 / 1e-4 s."""
    g = torch.Generator().manual_seed(0)
    n, h = 400, 64
    imgs = 2.0 + 0.2 * torch.randn(n, h, h, 3, generator=g, dtype=torch.float64)
    drv = render_loop.Driver.__new__(render_loop.Driver)
    drv.walls, drv.splatted = [2.0] * n, n * h * h * 4
    drv.sum, drv.sumsq = imgs.sum(0), (imgs * imgs).sum(0)
    e2e = drv.end_to_end(window_s=2.0 * n)
    assert e2e["s_to_1pct_rmse"] == pytest.approx(200.0, rel=0.02)
    assert e2e["msamples_per_s"] == pytest.approx(h * h * 4 / 2.0 / 1e6)


def _synthetic(bias: float, n: int = 6, m: int = 16, scale: float = 1.0,
               seed: int = 0):
    """Images of 16 x 16 pixels whose truth is known: the reference's m
    replicas of 8 samples a pixel, the program's n images of 8, each
    sample of standard deviation 0.4 (times scale for the program's)."""
    g = torch.Generator().manual_seed(seed)
    truth = 1.0 + torch.rand(16, 16, 3, generator=g, dtype=torch.float64)

    def images(k, sd):
        return truth + sd / math.sqrt(8) * torch.randn(
            k, 16, 16, 3, generator=g, dtype=torch.float64)

    reps, prog = images(m, 0.4), images(n, 0.4 * scale) * (1 + bias)
    zero = torch.zeros(64, 3, dtype=torch.float64)
    ref = {"blocks": torch.stack([check.image_blocks(r) for r in reps]),
           "var": torch.full((16, 16, 3), 0.16, dtype=torch.float64),
           "spp": 8, "ss_mean": zero, "ss_se": zero, "image": reps.mean(0),
           "image_var": torch.full((16, 16, 3), 0.02 / m, dtype=torch.float64)}
    return check.numbers(torch.stack([check.image_blocks(p) for p in prog]),
                         prog.mean(0), prog.var(0), prog.var(0), 8, ref, 0)


def test_numbers_see_bias_and_noise():
    sound = [_synthetic(0.0, seed=s) for s in range(8)]
    assert all(0.3 < v["bias_chi2"] < 2.5 for v in sound)
    assert all(-0.3 < v["pixel_excess"] < 0.4 for v in sound)
    assert all(0.5 < v["noise_ratio"] < 2.0 for v in sound)
    assert _synthetic(0.05)["bias_chi2"] > 5
    assert _synthetic(0.05)["pixel_excess"] > 0.5
    assert _synthetic(0.05)["image_chi2"] > 20
    assert _synthetic(0.0, scale=math.sqrt(2))["noise_ratio"] > 1.6
    limits = {"bias_chi2": 3.0, "image_chi2": 9.0, "pixel_excess": 0.5,
              "noise_ratio": 2.5, "bad_values": 0}
    assert run.verdict(sound[0], limits)
    assert not run.verdict(dict(sound[0], bad_values=1), limits)
    assert not run.verdict(dict(sound[0], bias_chi2=math.nan), limits)
    assert run.verdict(dict(sound[0], noise_ratio=9.0),
                         dict(limits, noise_ratio=None))


def test_image_blocks():
    img = torch.arange(16 * 16 * 3, dtype=torch.float32).reshape(16, 16, 3)
    b = check.image_blocks(img, 8)
    assert b.shape == (64, 3)
    assert b[0].tolist() == img[:2, :2].double().mean((0, 1)).tolist()
    assert b[63].tolist() == img[14:, 14:].double().mean((0, 1)).tolist()


def test_roofline_bound():
    from bench_port import roofline
    assert roofline.bound_s(67e12, 0) == 1.0
    assert roofline.bound_s(0, 3.35e12) == 1.0
    assert roofline.bound_s(67e9, 3.35e12) == 1.0     # bytes bind
    assert roofline.share_pct(67e9, 0, 0.002) == pytest.approx(50.0)
    assert roofline.share_pct(1, 1, 0.0) is None
