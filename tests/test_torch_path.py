"""The surface path of the port against the JAX package: `path.li` lane by
lane on the same rays and sampler, render() of "path", "direct" and the
Cornell box filled with a homogeneous HG medium ("volpath", BASELINE
config 2's medium) at 16^2, and the box-filtered cbox on the wavefront
road against JAX's loop image. (The area-lit refractive sphere is in
tests/test_torch_surface.py.)

The cbox here has no boxes (14 triangles, not 36): the JAX package
unrolls its intersection over the triangles, and the boxes double each
compile (27 s against 12 s here); tests/test_torch_surface.py holds the
whole box's build field by field, and chip_smoke.py renders it.

Tolerances: a lane or pixel agrees within 1e-4 relative plus 1e-6 of the
image's largest value; li and the loop-road renders need 99% of lanes
and pixels to agree and the means within 1e-5 (measured: every lane and
pixel, largest difference ~7e-7); the wavefront road (another estimator
at other seeds) needs its mean within 5% of JAX's loop image (as
tests/test_wavefront.py holds JAX's two engines)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import path as jpath
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import common as tcommon
from mitsubaer_tpu_torch.integrators import path as tpath
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

CBOX_MEDIUM = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)


def _agree(got, want, frac):
    s = max(float(np.abs(want).max()), 1e-6)
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6 * s).all(-1)
    assert ok.mean() >= frac, ok.mean()
    assert abs(float(got.mean()) / float(want.mean()) - 1) <= 1e-5


def test_li_matches_jax_lane_by_lane():
    """cbox at 8^2, spp 2, depth 4: the camera rays of the port's render
    prologue, each package's sampler after the two camera draws."""
    res, spp, seed = 8, 2, 5
    js, jc = jpresets.cornell_box(res=res, spp=spp, max_depth=4, boxes=False)
    ts, tc = tpresets.cornell_box(res=res, spp=spp, max_depth=4, boxes=False)
    rays, _, smp = tcommon.camera_samples(ts, tc, spp, seed, 0)
    got, _, (bounces,) = tpath.li(ts, tc, rays.o, rays.d, smp)
    npix = res * res
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (spp,))
    index = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), npix)
    jsmp = jrng.make_sampler(seed, pixel, index, n_samples=spp)
    _, jsmp = jrng.next_2d(jsmp)
    _, jsmp = jrng.next_2d(jsmp)
    sink, _ = jax.jit(lambda s, o, d, m: jpath.li(s, jc, o, d, m))(
        js, rays.o.numpy(), rays.d.numpy(), jsmp)
    want = np.asarray(sink.steady)
    assert 2 <= bounces <= 4 and (want.sum(-1) > 0).mean() > 0.5
    _agree(got.steady.numpy(), want, 0.99)


@pytest.mark.parametrize("kw", [
    dict(integrator="path"), dict(integrator="direct"),
    dict(integrator="volpath", medium=CBOX_MEDIUM)],
    ids=["path", "direct", "medium"])
def test_render_matches_jax(kw):
    """The loop road at 16^2, spp 4, depth 40 (the BASELINE depth): the
    gaussian-filtered film, pixel by pixel; direct is below path."""
    js, jc = jpresets.cornell_box(res=16, spp=4, boxes=False, **kw)
    want = np.asarray(jrender.render(js, jc, seed=3))
    ts, tc = tpresets.cornell_box(res=16, spp=4, boxes=False, **kw)
    stats = {}
    got = trender.render(ts, tc, seed=3, device="cpu", stats=stats).numpy()
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    assert len(stats["passes"]) == 1 and stats["loop_s"] > 0
    _agree(got, want, 0.99)
    if kw["integrator"] == "direct":
        path = trender.render(ts, dataclasses.replace(tc, integrator="path"),
                              seed=3, device="cpu")
        assert float(got.mean()) < float(path.mean())


def test_wavefront_cbox_matches_jax_loop():
    """The box-filtered cbox takes the wavefront road in both packages
    (render.py:78-91); it estimates the same integral as the loop road:
    the means within 5% at spp 256 (tests/test_wavefront.py:25-30)."""
    js, jc = jpresets.cornell_box(res=12, spp=256, max_depth=3, boxes=False,
                                  filter="box")
    want = np.asarray(jrender.render(js, jc._replace(engine="loop"), seed=2))
    ts, tc = tpresets.cornell_box(res=12, spp=256, max_depth=3, boxes=False,
                                  filter="box")
    stats = {}
    got = trender.render(ts, tc, seed=1, device="cpu", stats=stats).numpy()
    assert "wavefront_s" in stats and np.isfinite(got).all()
    assert abs(got.mean() / want.mean() - 1) < 0.05
