"""The port's sampler modes (lds, stratified, halton, hammersley, sobol)
against the JAX package's: the Sobol' table equal, each mode's next_1d /
next_2d stream over 4,096 lanes and 16 dimensions bit-exact (halton and
hammersley: within 1 ulp is allowed, as XLA on the CPU may contract their
float32 r + f d sums to FMAs; every lane measured so far is bit-exact), and
the modes threaded through exactly the two roads that JAX threads them
through: the loop road and the wavefront road render the ldsampler as JAX
does; the eikonal road, the training path, the beam splat and the light
image draw independent streams whatever cfg.sampler says."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

N = 4096
MODES = ["lds", "stratified", "halton", "hammersley", "sobol"]
ULPS = {"halton": 1, "hammersley": 1}


def test_sobol_table_equals_jax():
    assert trng._SOBOL_TABLE.shape == (64, 32)
    np.testing.assert_array_equal(trng._SOBOL_TABLE, jrng._SOBOL_TABLE)


def _lanes(seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
            r.integers(0, 64, N, dtype=np.uint64).astype(np.uint32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", MODES)
@pytest.mark.parametrize("n_samples", [16, 12])
def test_mode_stream_matches_jax(name, n_samples):
    """16 dimensions drawn as 2D, 1D, 2D, ... from the same (seed, lane,
    index): each value equal to JAX's (halton / hammersley within 1 ulp;
    n_samples 12 is not a square, so stratified's 2D grid leaves samples
    unstratified)."""
    mode = trng.MODES[name]
    assert mode == jrng.MODES[name]
    lanes, idx = _lanes(mode)
    js = jrng.make_sampler(jnp.uint32(7), jnp.asarray(lanes),
                           jnp.asarray(idx), mode=mode, n_samples=n_samples)
    ts = trng.make_sampler(7, torch.from_numpy(lanes.astype(np.int64)),
                           torch.from_numpy(idx.astype(np.int64)), mode=mode,
                           n_samples=n_samples)
    dims = 0
    while dims < 16:
        draw = "next_2d" if dims % 3 == 0 else "next_1d"
        jv, js = getattr(jrng, draw)(js)
        tv, ts = getattr(trng, draw)(ts)
        jv, tv = np.asarray(jv), tv.numpy()
        assert tv.dtype == np.float32 and tv.shape == jv.shape
        assert _ulps(tv, jv).max() <= ULPS.get(name, 0), (name, dims)
        assert ((tv >= 0) & (tv < 1)).all()
        dims += 2 if draw == "next_2d" else 1
    np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim))


def test_helpers_bit_exact():
    """_reverse_bits, _owen_scramble, _sobol_2nd_dim, radical_inverse and
    _kensler_permute on 4,096 random words."""
    r = np.random.default_rng(3)
    x = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    k = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    tx, tk = (torch.from_numpy(v.astype(np.int64)) for v in (x, k))
    u32 = lambda t: t.numpy().astype(np.uint32)   # noqa: E731
    np.testing.assert_array_equal(u32(trng._reverse_bits(tx)),
                                  np.asarray(jrng._reverse_bits(x)))
    np.testing.assert_array_equal(u32(trng._owen_scramble(tx, tk)),
                                  np.asarray(jrng._owen_scramble(x, k)))
    np.testing.assert_array_equal(u32(trng._sobol_2nd_dim(tx)),
                                  np.asarray(jrng._sobol_2nd_dim(x)))
    for n in (1, 7, 16, 64):
        np.testing.assert_array_equal(
            u32(trng._kensler_permute(tx % n, n, tk)),
            np.asarray(jrng._kensler_permute(jnp.asarray(x % n), n, k)))
    base = np.asarray(jrng._PRIMES)[x % 20]
    want = np.asarray(jrng.radical_inverse(x, base, scramble_key=k))
    got = trng.radical_inverse(tx, torch.from_numpy(base.astype(np.int64)),
                               tk).numpy()
    assert _ulps(got, want).max() <= 1


def _box(P, **kw):
    return P.volumetric_box(res=8, spp=4, heterogeneous=True, density_res=8,
                            max_depth=3, emitter_kind="point",
                            sampler="ldsampler", **kw)


@pytest.mark.parametrize("engine,filt", [("loop", "gaussian"),
                                         ("wavefront", "box")])
def test_ldsampler_renders_as_jax(engine, filt):
    """The point-lit heterogeneous box with the ldsampler on the loop and
    wavefront roads: the port's image against JAX's (same streams, float
    tolerance; the loop road's f32 density and the wavefront road's bf16
    taps agree with JAX within 1e-3 on at least 95% of the pixels; JAX's
    wavefront road tracks through kernel C, as the port's does), and
    unlike the independent sampler's image."""
    js, jc = _box(jpresets, filter=filt, engine=engine)
    ts, tc = _box(tpresets, filter=filt, engine=engine)
    if engine == "wavefront":
        # JAX tracks through kernel C (interpret mode) as the port does
        jc = jc._replace(wf_track_mega=1)
    want = np.asarray(jrender.render(js, jc, seed=3))
    got = trender.render(ts, tc, seed=3, device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.95, close.mean()
    indep = trender.render(ts, dataclasses.replace(tc, sampler="independent"),
                           seed=3, device="cpu").numpy()
    assert not np.allclose(indep, got)


def test_other_roads_stay_independent():
    """The eikonal road, the training path, the beam splat and the light
    image ignore cfg.sampler, as in the JAX package: the same image under
    "sobol" as under "independent"."""
    from mitsubaer_tpu_torch.diff import render as tdr
    from mitsubaer_tpu_torch.integrators import volpath_er as ter
    scene, cfg = tpresets.refractive_sphere(
        res=6, spp=1, max_depth=3, rif_kind=1, rif_params=(1.3, 0.15),
        er_stepsize=0.05, emitter="point", filter="box")
    cfg = dataclasses.replace(cfg, er_maxsteps=32, bvp_restarts=0)
    sob = dataclasses.replace(cfg, sampler="sobol")
    torch.testing.assert_close(
        trender.render(scene, sob, seed=1, device="cpu"),
        trender.render(scene, cfg, seed=1, device="cpu"), rtol=0, atol=0)
    torch.testing.assert_close(
        ter.render_er_light_image(scene, sob, seed=1, n_passes=1,
                                  device="cpu"),
        ter.render_er_light_image(scene, cfg, seed=1, n_passes=1,
                                  device="cpu"), rtol=0, atol=0)
    # the beam splat (a box-filtered beam box takes boxwalk) and the
    # training path's camera
    bs, bc = tpresets.volumetric_box(res=6, spp=2, heterogeneous=True,
                                     density_res=8, max_depth=2,
                                     filter="box")
    bsob = dataclasses.replace(bc, sampler="sobol")
    torch.testing.assert_close(
        trender.render(bs, bsob, seed=2, device="cpu"),
        trender.render(bs, bc, seed=2, device="cpu"), rtol=0, atol=0)
    p = tdr.get_params(bs)
    with torch.no_grad():
        a = tdr.render_diff(bs, p, dataclasses.replace(bsob, filter="gaussian"),
                            2, 5, 0, device="cpu")
        b = tdr.render_diff(bs, p, dataclasses.replace(bc, filter="gaussian"),
                            2, 5, 0, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
