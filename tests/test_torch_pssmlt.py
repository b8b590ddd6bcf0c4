"""The port's primary-sample-space MLT (integrators/pssmlt.py and the VECTOR
sampler of core/rng.py) against the JAX package's on the CPU.

One JAX reference, made once: render_pssmlt on the Cornell box without its
boxes at 8^2, spp 4, depth 3 (128 chains, 2 mutation rounds, 128 bootstrap
samples, D 32), run op by op but for its _trace, which is jitted once
(~8 s here, against ~26 s for the jitted bootstrap and run): its
bootstrap's (b, u0), its film and every round's proposals and traced
paths; and the volume's _trace ("pssmlt_volpath", volpath.li) on the
point-lit heterogeneous box at 8^2, depth 3, at 1,024 hashed states of D
32 (one jitted compile, ~10 s here).

Tolerances, stated per case:
- VECTOR draws: bit-exact, past the table's D columns too (the hash);
- _mutate_small: within 1 ulp of the larger of the state and the result
  plus the largest step 1/64 (the float32 log of the step ratio may round
  apart, and a wrap keeps the rounding of the sum before it), negative
  wraps included;
- _trace (path and volpath): the pixel equal and the rgb within 1e-4
  relative plus 1e-6 of the largest value, on at least 99% of lanes (the
  rest a path whose branch an ulp decided apart);
- bootstrap: b within 1e-6 relative, the resampled rows equal but for at
  most 1% (the cumulative sums round otherwise: the port's prefix sums
  add in a fixed tree order, the same bits on the card on every run,
  XLA's one at a time);
- the film from JAX's (b, u0): at most 2% of the chains apart at each
  round (the proposal beyond _mutate_small's ulp, its pixel, or its rgb
  beyond the _trace tolerance: a chain whose acceptance flipped, or a
  path that an ulp of its proposal sent elsewhere), and the film's pixels
  within the _trace tolerance on at least 98% of pixels with the film's
  sum within 2%;
- render_pssmlt's mean within 5% of JAX's (chains that start apart where
  the resampled rows differ); render() hands "pssmlt", "mlt" and
  "pssmlt_volpath" to it, "pssmlt" and "mlt" the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import pssmlt as jps
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.integrators import pssmlt as tps
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

SEED, N_CHAINS, N_BOOT = 5, 128, 128
CBOX = dict(res=8, spp=4, max_depth=3, boxes=False, integrator="pssmlt")


def _close(got, want, frac, what):
    """Lanes (rows) whose values agree within 1e-4 relative plus 1e-6 of
    the largest; at least `frac` of them."""
    s = max(float(np.abs(want).max()), 1e-6)
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6 * s).reshape(
        len(want), -1).all(-1)
    print(f"{what}: {ok.mean():.4f} of {len(ok)} rows agree")
    assert ok.mean() >= frac, (what, ok.mean())
    return ok


@pytest.fixture(scope="module")
def cbox():
    """JAX's render_pssmlt run op by op (jax.disable_jit) but for its
    _trace, jitted once at the chains' shape (the bootstrap's N_BOOT =
    N_CHAINS lanes share the compile): its bootstrap's (b, u0), its film,
    and every _trace call's states and results in order (the bootstrap's,
    the chains' start, then each round's proposals)."""
    js, jc = jpresets.cornell_box(**CBOX)
    ts, tc = tpresets.cornell_box(**CBOX)
    seen, traced = {}, []
    trace, run = jps._trace, jps._pssmlt_run
    fast = jax.jit(lambda u: trace(js, jc, u))

    def jitted_trace(scene, cfg, u):
        with jax.disable_jit(False):
            out = fast(u)
        traced.append(tuple(np.array(a) for a in (u, *out)))
        return out

    def capture(*args):
        seen["b"], seen["u0"] = np.array(args[6]), np.array(args[7])
        seen["n_mut"] = args[3]
        film = run(*args)
        seen["film"] = np.array(film)
        return film

    jps._trace, jps._pssmlt_run = jitted_trace, capture
    try:
        with jax.disable_jit():
            img = np.array(jps.render_pssmlt(js, jc, seed=SEED,
                                             n_chains=N_CHAINS,
                                             n_bootstrap=N_BOOT))
    finally:
        jps._trace, jps._pssmlt_run = trace, run
    return dict(ts=ts, tc=tc, img=img, traced=traced, **seen)


def test_vector_draws_match_jax():
    """next_1d / next_2d of the VECTOR mode from a (64, 10) table, each lane
    at its own dim (some past D), bit for bit."""
    r = np.random.default_rng(0)
    n, D = 64, 10
    table = r.uniform(0, 1, (n, D)).astype(np.float32)
    dim = r.integers(0, 14, n).astype(np.uint32)
    lane = np.arange(n, dtype=np.uint32) * 7 + 3
    js = jrng.Sampler(lane=jnp.asarray(lane), index=jnp.full(n, 2, jnp.uint32),
                      dim=jnp.asarray(dim), seed=jnp.uint32(0x4D4C54),
                      mode=jrng.VECTOR, table=jnp.asarray(table))
    ts = dataclasses.replace(
        trng.make_sampler(0x4D4C54, torch.from_numpy(lane.astype(np.int64)),
                          2, mode=trng.VECTOR,
                          table=torch.from_numpy(table)),
        dim=torch.from_numpy(dim.astype(np.int64)))
    past = 0
    for step in range(6):
        draw_j, draw_t = ((jrng.next_1d, trng.next_1d) if step % 2 == 0
                          else (jrng.next_2d, trng.next_2d))
        past += int((np.asarray(js.dim) >= D).sum())
        vj, js = draw_j(js)
        vt, ts = draw_t(ts)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim))
    assert past > n      # lanes drew past the table's columns


def test_mutate_small_matches_jax():
    """Kelemen's small step on (256, 32) states, within 1 ulp, the states
    near 0 and 1 included so that both wraps of the floor modulo run."""
    r = np.random.default_rng(1)
    u = r.uniform(0, 1, (256, 32)).astype(np.float32)
    u[:64] = r.uniform(0, 1e-3, (64, 32))
    u[64:128] = 1 - r.uniform(1e-7, 1e-3, (64, 32)).astype(np.float32)
    bits = r.integers(0, 2 ** 32, (256, 32), dtype=np.uint64)
    want = np.asarray(jps._mutate_small(jnp.asarray(u),
                                        jnp.asarray(bits, jnp.uint32)))
    got = tps._mutate_small(torch.from_numpy(u),
                            torch.from_numpy(bits.astype(np.int64))).numpy()
    assert ((got >= 0) & (got < 1)).all()
    ulp = np.spacing(np.maximum(u, want) + np.float32(1 / 64))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    assert (want > u + 0.5).any() and (want < u - 0.5).any()   # both wraps


def test_trace_matches_jax_lane_by_lane(cbox):
    """path.li through the VECTOR sampler at JAX's chain states u0."""
    u, pix_j, rgb_j = cbox["traced"][1]
    np.testing.assert_array_equal(u, cbox["u0"])
    pix_t, rgb_t = tps._trace(cbox["ts"], cbox["tc"], torch.from_numpy(u))
    np.testing.assert_array_equal(pix_t.numpy(), pix_j)
    assert (rgb_j.sum(-1) > 0).mean() > 0.3
    _close(rgb_t.numpy(), rgb_j, 0.99, "_trace (path)")


def test_prefix_sum_matches_cumsum():
    """The bootstrap's fixed-order prefix sums: within 1e-6 relative of a
    float64 cumulative sum, at lengths around powers of two."""
    r = np.random.default_rng(4)
    for n in (1, 2, 3, 1000, 1024, 1025):
        x = r.exponential(1.0, n).astype(np.float32)
        got = tps.prefix_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64)),
                                   rtol=1e-6)


def test_bootstrap_matches_jax(cbox):
    b, u0 = tps.bootstrap(cbox["ts"], cbox["tc"], N_BOOT, 32, N_CHAINS,
                          SEED, "cpu")
    assert abs(float(b) / float(cbox["b"]) - 1) <= 1e-6
    same = (u0.numpy() == cbox["u0"]).all(-1)
    assert same.mean() >= 0.99, same.mean()


def test_film_matches_jax(cbox):
    """_pssmlt_run from JAX's (b, u0): each round's proposals and their
    traced pixels and rgb chain by chain (a chain is apart from the round
    whose acceptance flipped on), then the film."""
    rounds = []
    film = tps._pssmlt_run(cbox["ts"], cbox["tc"], N_CHAINS, cbox["n_mut"],
                           32, SEED, torch.tensor(cbox["b"]),
                           torch.from_numpy(cbox["u0"]), rounds=rounds)
    assert len(rounds) == cbox["n_mut"] == 2
    for i, ((u_prop, pix, rgb, _), (u_j, pix_j, rgb_j)) in enumerate(
            zip(rounds, cbox["traced"][2:])):
        s = max(float(np.abs(rgb_j).max()), 1e-6)
        apart = ((np.abs(u_prop.numpy() - u_j) > 2 ** -23).any(-1)
                 | (pix.numpy() != pix_j)
                 | ~np.isclose(rgb.numpy(), rgb_j, rtol=1e-4,
                               atol=1e-6 * s).all(-1))
        print(f"round {i}: {int(apart.sum())} of {N_CHAINS} chains apart")
        assert apart.mean() <= 0.02
    want = cbox["film"]
    _close(film.numpy(), want, 0.98, "film pixels")
    assert abs(float(film.sum()) / float(want.sum()) - 1) <= 0.02


def test_render_routes_pssmlt(cbox, monkeypatch):
    """render_pssmlt against JAX's; render() hands "pssmlt", "mlt" and
    "pssmlt_volpath" to it on the scene's device with its stats (the entry
    run here at this file's chain and bootstrap counts)."""
    ts, tc = cbox["ts"], cbox["tc"]
    render_pssmlt = tps.render_pssmlt
    img = render_pssmlt(ts, tc, seed=SEED, n_chains=N_CHAINS,
                        n_bootstrap=N_BOOT)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) / float(cbox["img"].mean()) - 1) <= 0.05
    calls = []

    def entry(scene, cfg, seed=0, stats=None):
        calls.append((scene.aabb_min.device, cfg.integrator))
        if cfg.integrator == "pssmlt_volpath":
            return None
        return render_pssmlt(scene, cfg, seed=seed, n_chains=N_CHAINS,
                             n_bootstrap=N_BOOT, stats=stats)

    monkeypatch.setattr(tps, "render_pssmlt", entry)
    for name in ("pssmlt", "mlt", "pssmlt_volpath"):
        stats = {}
        out = trender.render(ts, dataclasses.replace(tc, integrator=name),
                             seed=SEED, device="cpu", stats=stats)
        if name != "pssmlt_volpath":
            assert stats["pssmlt_s"] > 0 and stats["rounds"] == 2
            torch.testing.assert_close(out, img, rtol=0, atol=0)
    assert calls == [(torch.device("cpu"), name)
                     for name in ("pssmlt", "mlt", "pssmlt_volpath")]


def test_volpath_trace_matches_jax_lane_by_lane():
    """pssmlt._trace with volpath.li ("pssmlt_volpath") through the VECTOR
    sampler on the point-lit heterogeneous box (NEE through Woodcock and
    ratio tracking) at 1,024 hashed states of D 32 (a state's film and
    lens samples are uniform: about one lane in twelve meets light)."""
    kw = dict(res=8, spp=1, heterogeneous=True, density_res=8, max_depth=3,
              emitter_kind="point", integrator="pssmlt_volpath")
    js, jc = jpresets.volumetric_box(**kw)
    ts, tc = tpresets.volumetric_box(**kw)
    u = np.random.default_rng(2).uniform(0, 1, (1024, 32)).astype(
        np.float32)
    pix_j, rgb_j = (np.asarray(a) for a in jax.jit(
        lambda v: jps._trace(js, jc, v))(jnp.asarray(u)))
    pix_t, rgb_t = tps._trace(ts, tc, torch.from_numpy(u))
    np.testing.assert_array_equal(pix_t.numpy(), pix_j)
    assert (rgb_j.sum(-1) > 0).sum() >= 50
    _close(rgb_t.numpy(), rgb_j, 0.99, "_trace (volpath)")
