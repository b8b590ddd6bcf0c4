"""The port's particle tracer (integrators/ptracer.py: trace_particles,
render_ptracer) against the JAX package's, pixel by pixel on the same
seeds: the cbox and the homogeneous point-lit box at 8^2, spp 2 (128
particles). JAX's reference runs eagerly (jax.disable_jit), ~4 s a render
here against ~15 s to compile its while loop.

Tolerance: a pixel agrees within 1e-4 relative plus 1e-6 of the image's
largest value, on every pixel; the means within 1e-5."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import ptracer as jptracer
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import ptracer as tptracer
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)


def _cases(name):
    if name == "cbox":
        kw = dict(res=8, spp=2, max_depth=6, boxes=False, filter="box")
        return jpresets.cornell_box(**kw), tpresets.cornell_box(**kw)
    kw = dict(res=8, spp=2, max_depth=4, heterogeneous=False,
              sigma_s=(0.6, 0.6, 0.6), sigma_a=(0.05, 0.05, 0.05),
              emitter_kind="point", filter="box")
    return jpresets.volumetric_box(**kw), tpresets.volumetric_box(**kw)


@pytest.mark.parametrize("name", ["cbox", "point_box"])
def test_render_ptracer_matches_jax(name):
    (js, jc), (ts, tc) = _cases(name)
    with jax.disable_jit():
        want = np.asarray(jptracer.render_ptracer(js, jc, seed=3))
    got = tptracer.render_ptracer(ts, tc, seed=3).numpy()
    assert got.shape == want.shape == (8, 8, 3)
    assert np.isfinite(got).all() and (want > 0).mean() > 0.1
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale)
    assert abs(float(got.mean()) / float(want.mean()) - 1) <= 1e-5
    # render() routes "ptracer" to render_ptracer
    img = trender.render(ts, dataclasses.replace(tc, integrator="ptracer"),
                         seed=3, device="cpu")
    torch.testing.assert_close(img, torch.from_numpy(got), rtol=0, atol=0)
