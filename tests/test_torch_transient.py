"""Transient, bounce and CW-ToF films through the port's roads against the
JAX package's, on the same rays, samplers and seeds (CPU): `volpath.li`
on the heterogeneous box (12^2, spp 2, depth 4) with transient and bounce
frames and the sine and m-sequence weights; `path.li` on the cbox (12^2,
transient); `volpath_er.li` on the refractive sphere (10^2, single BVP
solve, transient); render() of the beam-lit box with transient frames
(the beam splat binned at s + d); and render_diff on a transient config,
whose steady image is 0 as JAX's. Port-only: the frames of a box-filtered
loop render sum to its steady image, and engine="wavefront" with frames
or a modulation raises ValueError (the JAX package renders a steady image
there, Queue 3).

JAX's loop references run eagerly (jax.disable_jit: ~6 s a call after
the first here, against 15-30 s to compile each configuration); the
eikonal one is jitted with JAX's acoustic Bessel functions stubbed
(tests/test_torch_er_grad.py::_acoustic_stub; the linear RIF never reads
them): eagerly its BVP solve takes minutes.

Tolerances: sinks and frames lane by lane (pixel by pixel for renders)
within 1e-4 relative plus 1e-6 of the largest value, on every lane (99%
for the eikonal road, whose BVP convergence flags may flip with ulps);
frame bins hold energy exactly where JAX's do; the frame-sum identity
within 1e-5 of the steady image's largest pixel (the order of adds)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.diff import render as jdiff
from mitsubaer_tpu.integrators import path as jpath
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.integrators import volpath as jvp
from mitsubaer_tpu.integrators import volpath_er as jer
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.diff import render as tdiff
from mitsubaer_tpu_torch.integrators import common as tcommon
from mitsubaer_tpu_torch.integrators import path as tpath
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.integrators import volpath_er as ter
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

SEED = 5
# every eager JAX reference runs 288 lanes (12^2 at spp 2), so that JAX's
# one-op compiles of the first serve the others
RES, LANES = 12, 288
FILMS = {
    "transient": dict(decomposition="transient", min_bound=0.0,
                      max_bound=16.0, bin_width=0.25),
    "bounce": dict(decomposition="bounce", min_bound=0.0, max_bound=10.0,
                   bin_width=1.0),
    "sine": dict(modulation="sine", lambda_=3.0, phase=45.0),
    "mseq": dict(modulation="mseq", lambda_=6.0, P=8),
}


def _agree(got, want, frac=1.0):
    """Within 1e-4 relative plus 1e-6 of the largest value on frac of the
    lanes (every value of a lane), and energy in the same places."""
    scale = max(float(np.abs(want).max()), 1e-12)
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6 * scale)
    lanes = ok.reshape(ok.shape[0], -1).all(-1)
    assert lanes.mean() >= frac, lanes.mean()
    if frac == 1.0:
        np.testing.assert_array_equal(got != 0, want != 0)


def _jax_sampler(smp, dim):
    """JAX's sampler on the port's lanes and sample indices at `dim`."""
    s = jrng.make_sampler(jnp.uint32(int(smp.seed)),
                          jnp.asarray(smp.lane.numpy().astype(np.uint32)),
                          jnp.asarray(smp.index.numpy().astype(np.uint32)))
    return s._replace(dim=s.dim + jnp.uint32(dim))


def _compare_sinks(got, want, frac=1.0):
    _agree(got.steady.numpy(), np.asarray(want.steady), frac)
    if want.frames is None:
        assert got.frames is None
        return
    g, w = got.frames.numpy(), np.asarray(want.frames)
    assert g.shape == w.shape and (w != 0).any()
    _agree(g, w, frac)


@pytest.mark.parametrize("film", list(FILMS))
def test_volpath_li_matches_jax(film):
    kw = dict(res=RES, spp=2, heterogeneous=True, density_res=8,
              max_depth=4, **FILMS[film])
    js, jc = jpresets.volumetric_box(**kw)
    ts, tc = tpresets.volumetric_box(**kw)
    rays, _, smp = tcommon.camera_samples(ts, tc, 2, SEED, 0)
    pixel = tcommon.lane_pixels(tc, 2)
    got, smp_t, _ = tvp.li(ts, tc, rays.o, rays.d, smp, pixel)
    with jax.disable_jit():
        want, smp_j = jvp.li(js, jc, jnp.asarray(rays.o.numpy()),
                             jnp.asarray(rays.d.numpy()),
                             _jax_sampler(smp, 4),
                             pixel=jnp.asarray(pixel.numpy()))
    np.testing.assert_array_equal(smp_t.dim.numpy(), np.asarray(smp_j.dim))
    _compare_sinks(got, want)
    if tc.n_frames > 1:
        assert not got.steady.any()


def test_path_li_transient_matches_jax():
    """The cbox's lengths are hundreds of units: frames of 150 from 500."""
    kw = dict(res=RES, spp=2, max_depth=4, boxes=False,
              decomposition="transient", min_bound=500.0, max_bound=3500.0,
              bin_width=150.0)
    js, jc = jpresets.cornell_box(**kw)
    ts, tc = tpresets.cornell_box(**kw)
    rays, _, smp = tcommon.camera_samples(ts, tc, 2, SEED, 0)
    pixel = tcommon.lane_pixels(tc, 2)
    got, _, _ = tpath.li(ts, tc, rays.o, rays.d, smp, pixel)
    with jax.disable_jit():
        want, _ = jpath.li(js, jc, jnp.asarray(rays.o.numpy()),
                           jnp.asarray(rays.d.numpy()), _jax_sampler(smp, 4),
                           pixel=jnp.asarray(pixel.numpy()))
    _compare_sinks(got, want)


@pytest.fixture
def _acoustic_stub():
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


def test_volpath_er_li_transient_matches_jax(_acoustic_stub):
    kw = dict(res=10, spp=1, max_depth=4, rif_kind=1,
              rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=2e-2,
              filter="box")
    ex = dict(er_maxsteps=96, er_bvp_hscale=4.0, decomposition="transient",
              min_bound=2.0, max_bound=14.0, bin_width=0.1875)
    js, jc = jpresets.refractive_sphere(**kw)
    ts, tc = tpresets.refractive_sphere(**kw)
    jc, tc = jc._replace(**ex), dataclasses.replace(tc, **ex)
    rays, _, smp = tcommon.camera_samples(ts, tc, 1, SEED, 0)
    pixel = tcommon.lane_pixels(tc, 1)
    got, _, _ = ter.li(ts, tc, rays.o, rays.d, smp, pixel)
    want, _ = jax.jit(lambda s, o, d, m, p: jer.li(s, jc, o, d, m, pixel=p))(
        js, rays.o.numpy(), rays.d.numpy(), _jax_sampler(smp, 4),
        pixel.numpy().astype(np.uint32))
    _compare_sinks(got, want, frac=0.99)


def test_render_transient_beam_splat_matches_jax():
    """render() of the beam-lit box, box filter, loop engine, transient:
    the camera passes' frames and the beam splat's, binned at s + d."""
    kw = dict(res=RES, spp=2, heterogeneous=False, max_depth=3,
              filter="box", engine="loop", decomposition="transient",
              min_bound=0.0, max_bound=12.0, bin_width=0.5)
    js, jc = jpresets.volumetric_box(**kw)
    ts, tc = tpresets.volumetric_box(**kw)
    with jax.disable_jit():
        want = np.asarray(jrender.render(js, jc, seed=SEED))
    got = trender.render(ts, tc, seed=SEED, device="cpu").numpy()
    npix = RES * RES
    assert got.shape == want.shape == (RES, RES, 3 * 24)
    _agree(got.reshape(npix, -1), want.reshape(npix, -1))
    # the beam splat alone, frame by frame
    splat = torch.zeros((RES, RES, 3 * 24))
    trender.beam_splat_pass(ts, splat, tc, LANES, SEED, 1)
    with jax.disable_jit():
        want_s = np.asarray(jrender.beam_splat_pass(
            js, jnp.zeros((RES, RES, 3 * 24)), jc, LANES, jnp.uint32(SEED),
            jnp.uint32(1)))
    assert (want_s != 0).any()
    _agree(splat.numpy().reshape(npix, -1), want_s.reshape(npix, -1))


@pytest.mark.parametrize("film", ["transient", "bounce"])
def test_frames_sum_to_the_steady_image(film):
    """With a box filter every sample weighs 1 in its own pixel, so the
    frames of a render whose bins hold every contribution sum to the
    steady render at the same seed (beam splat included)."""
    kw = dict(res=10, spp=4, heterogeneous=True, density_res=8, max_depth=5,
              filter="box", engine="loop")
    ts, tc = tpresets.volumetric_box(**kw)
    steady = trender.render(ts, tc, seed=2, device="cpu")
    fc = dataclasses.replace(tc, **(
        dict(decomposition="transient", min_bound=0.0, max_bound=40.0,
             bin_width=0.5) if film == "transient" else
        dict(decomposition="bounce", min_bound=0.0, max_bound=12.0,
             bin_width=1.0)))
    frames = trender.render(ts, fc, seed=2, device="cpu")
    assert frames.shape == (10, 10, 3 * fc.n_frames)
    fsum = frames.view(10, 10, fc.n_frames, 3).sum(2)
    assert float(steady.max()) > 0
    assert (fsum - steady).abs().max() <= 1e-5 * steady.abs().max()
    assert (frames.view(10, 10, fc.n_frames, 3).sum((0, 1, 3)) > 0).sum() > 2


@pytest.mark.parametrize("kw", [
    dict(decomposition="transient", max_bound=8.0),
    dict(modulation="sine"),
], ids=["frames", "cwtof"])
def test_wavefront_engine_with_frames_raises(kw):
    """The fast engines keep a steady film: engine="wavefront" with frames
    or a modulation raises (the JAX package returns a steady image there,
    and fails to add a beam's frames to it); "auto" takes the loop road."""
    ts, tc = tpresets.volumetric_box(res=4, spp=1, heterogeneous=True,
                                     density_res=8, max_depth=2,
                                     filter="box", **kw)
    with pytest.raises(ValueError, match="engine='wavefront'"):
        trender.render(ts, dataclasses.replace(tc, engine="wavefront"),
                       device="cpu")
    stats = {}
    img = trender.render(ts, tc, device="cpu", stats=stats)
    assert "loop_s" in stats and bool(torch.isfinite(img).all())


def test_render_diff_reads_zero_steady_in_transient_mode():
    """render_diff returns the steady sink, as JAX's does: zero in
    transient mode (the frames take every contribution)."""
    kw = dict(res=4, spp=1, heterogeneous=True, density_res=8, max_depth=2,
              decomposition="transient", min_bound=0.0, max_bound=20.0,
              bin_width=1.0)
    js, jc = jpresets.volumetric_box(**kw)
    ts, tc = tpresets.volumetric_box(**kw)
    want = np.asarray(jdiff.render_diff(js, jdiff.get_params(js), jc, 1,
                                        jnp.uint32(3), jnp.uint32(0)))
    got = tdiff.render_diff(ts, tdiff.get_params(ts), tc, 1, 3, 0,
                            device="cpu")
    assert got.shape == want.shape == (4, 4, 3)
    assert not want.any() and not got.detach().any()
    steady = tdiff.render_diff(ts, tdiff.get_params(ts), dataclasses.replace(
        tc, decomposition="steadystate"), 1, 3, 0, device="cpu")
    assert steady.detach().sum() > 0
