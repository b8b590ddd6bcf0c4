"""The port's CW-ToF weights, frame film and frame sinks against the JAX
package's, on the same seeded inputs (numpy), eagerly on the CPU:
models/tof.py (every correlation mode on 4,096 lengths, in and outside
[min_bound, max_bound); area_under_correlation; sample_path_length),
models/film.py's frames (splat_frames, bin_index and develop at F = 1, 3
and 16) and integrators/common.py's add_contribution under transient,
bounce and CW-ToF films.

Tolerances: the correlations within 2e-7 absolute (|R| <= 1 + 1/P; the
sine is the one transcendental); the areas, the sampled lengths and their
pdfs within 1e-6 relative (torch's and XLA's linspace and cumsum may
differ by an ulp), the sampled lengths within 1e-5 absolute on [1, 9]
(XLA's cumsum adds in a tree: the CDF moves by ulps of its total, and the
position in a bin divides that by the bin's weight); films, sinks and
developed frames within 1e-6 relative, plus 1e-6 absolute for the film
(whose sums run in another order) and 1e-6 of the largest steady value
for the sinks (CW-ToF weights of both signs cancel); bins exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import common as jcommon
from mitsubaer_tpu.models import film as jfilm
from mitsubaer_tpu.models import tof as jtof
from mitsubaer_tpu.scene.types import RenderConfig as JConfig
from mitsubaer_tpu_torch.integrators import common as tcommon
from mitsubaer_tpu_torch.models import film as tfilm
from mitsubaer_tpu_torch.models import tof as ttof
from mitsubaer_tpu_torch.scene.types import RenderConfig as TConfig

torch.set_num_threads(1)

MODES = ["sine", "square", "hamiltonian", "mseq", "depthselective", "none"]


def _cfgs(**kw):
    return JConfig(**kw), TConfig(**kw)


def _lengths(n=4096, seed=0):
    # lengths below, inside and beyond [2, 14), and the bounds themselves
    t = np.random.default_rng(seed).uniform(-3.0, 20.0, n).astype(np.float32)
    t[:4] = (2.0, 14.0, 0.0, 13.999999)
    return t


@pytest.mark.parametrize("mode", MODES)
def test_correlation_matches(mode):
    for lam, phase, P, nb in ((3.0, 0.0, 32, 3), (1.7, 40.0, 7, 2)):
        jc, tc = _cfgs(modulation=mode, lambda_=lam, phase=phase, P=P,
                       neighbors=nb, min_bound=2.0, max_bound=14.0)
        t = _lengths()
        want = np.asarray(jtof.correlation_function(jc, jnp.asarray(t)))
        got = ttof.correlation_function(tc, torch.from_numpy(t)).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


@pytest.mark.parametrize("mode", MODES)
def test_area_and_path_length_sampling_match(mode):
    jc, tc = _cfgs(modulation=mode, lambda_=2.5, phase=15.0, min_bound=1.0,
                   max_bound=9.0)
    want = float(jtof.area_under_correlation(jc))
    got = float(ttof.area_under_correlation(tc))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    u = np.random.default_rng(1).uniform(0, 1, 4096).astype(np.float32)
    u[:3] = (0.0, 0.5, 0.99999994)
    t_j, pdf_j = jtof.sample_path_length(jc, jnp.asarray(u))
    t_t, pdf_t = ttof.sample_path_length(tc, torch.from_numpy(u))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-6)
    assert (t_t.numpy() >= 1.0).all() and (t_t.numpy() <= 9.0).all()


@pytest.mark.parametrize("F", [1, 3, 16])
def test_frame_film_matches(F):
    """splat_frames with the gaussian filter into an accumulator of
    (H, W, 3F + 1), develop, and bin_index on lengths in and out of the
    frames."""
    jc, tc = _cfgs(decomposition="transient", min_bound=0.5,
                   max_bound=0.5 + 0.75 * F, bin_width=0.75)
    assert jc.n_frames == tc.n_frames == F
    r = np.random.default_rng(F)
    S, H, W = 2, 5, 7
    values = r.exponential(1.0, (S, H, W, F, 3)).astype(np.float32)
    jitter = r.uniform(0, 1, (S, H, W, 2)).astype(np.float32)
    accum = r.uniform(0, 1, (H, W, 3 * F + 1)).astype(np.float32)
    assert tuple(tfilm.new_accumulator(tc).shape) == tuple(
        jfilm.new_accumulator(jc).shape) == (tc.height, tc.width, 3 * F + 1)
    want = np.asarray(jfilm.splat_frames(jnp.asarray(accum),
                                         jnp.asarray(values),
                                         jnp.asarray(jitter), "gaussian"))
    got = tfilm.splat_frames(torch.from_numpy(accum),
                             torch.from_numpy(values),
                             torch.from_numpy(jitter), "gaussian").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dev_j = np.asarray(jfilm.develop(jnp.asarray(want)))
    dev_t = tfilm.develop(torch.from_numpy(want)).numpy()
    assert dev_t.shape == (H, W, 3 * F)
    np.testing.assert_allclose(dev_t, dev_j, rtol=1e-6)
    # the steady splat fills frame 0 and the weights, the rest unchanged
    got0 = tfilm.splat(torch.from_numpy(accum),
                       torch.from_numpy(values[..., 0, :]),
                       torch.from_numpy(jitter), "gaussian").numpy()
    want0 = np.asarray(jfilm.splat(jnp.asarray(accum),
                                   jnp.asarray(values[..., 0, :]),
                                   jnp.asarray(jitter), "gaussian"))
    np.testing.assert_allclose(got0, want0, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got0[..., 3:-1], accum[..., 3:-1])
    t = _lengths(seed=F)
    b_j, in_j = jfilm.bin_index(jc, jnp.asarray(t))
    b_t, in_t = tfilm.bin_index(tc, torch.from_numpy(t))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    assert in_t.any() and not in_t.all()


def _sink_case(n=4096, npix=64, seed=7):
    r = np.random.default_rng(seed)
    value = r.exponential(1.0, (n, 3)).astype(np.float32)
    value[5] = (np.nan, 1.0, 0.0)             # non-finite: dropped
    value[6] = (np.inf, 2.0, 3.0)
    plen = r.uniform(-1.0, 18.0, n).astype(np.float32)
    depth = r.integers(0, 16, n).astype(np.int32)
    active = r.uniform(0, 1, n) < 0.8
    pixel = r.integers(0, npix, n).astype(np.uint32)
    return value, plen, depth, active, pixel


@pytest.mark.parametrize("kw", [
    dict(decomposition="transient", min_bound=1.0, max_bound=13.0,
         bin_width=0.5),
    dict(decomposition="bounce", min_bound=1.0, max_bound=9.0,
         bin_width=1.0),
    dict(modulation="sine", lambda_=4.0, phase=20.0),
], ids=["transient", "bounce", "cwtof"])
def test_add_contribution_matches(kw):
    """Two contributions into a fresh sink of 64 pixels: the steady part
    and the frames equal JAX's; every bin gets what JAX's gets (the same
    lanes, the same bins: a bin is empty in one exactly where it is in the
    other)."""
    jc, tc = _cfgs(width=8, height=8, **kw)
    value, plen, depth, active, pixel = _sink_case()
    js = jcommon.new_sink(jc, value.shape[0], jnp.asarray(pixel))
    ts = tcommon.new_sink(tc, value.shape[0],
                          torch.from_numpy(pixel.astype(np.int64)))
    for k in range(2):
        js = jcommon.add_contribution(
            js, jc, jnp.asarray(value), jnp.asarray(plen + k),
            jnp.asarray(depth + k), jnp.asarray(active))
        ts = tcommon.add_contribution(
            ts, tc, torch.from_numpy(value), torch.from_numpy(plen + k),
            torch.from_numpy(depth + k), torch.from_numpy(active))
    want_steady = np.asarray(js.steady)
    np.testing.assert_allclose(ts.steady.numpy(), want_steady, rtol=1e-6,
                               atol=1e-6 * np.abs(want_steady).max())
    assert np.isfinite(ts.steady.numpy()).all()
    if tc.n_frames == 1:
        assert ts.frames is None and js.frames is None
        return
    want = np.asarray(js.frames)
    got = ts.frames.numpy()
    assert got.shape == want.shape == (64, tc.n_frames, 3)
    assert (want > 0).any() and not (ts.steady.numpy() != 0).any()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
