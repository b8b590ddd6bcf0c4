"""The port's counter-based RNG against the JAX package's: bit-exact uint32
streams and float32 uniforms on 10^5 (seed, lane, sample) triples."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import boxwalk as jbw
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.integrators import boxwalk as tbw

torch.set_num_threads(1)

N = 100_000


def _triples(seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
            r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
            r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_hash_u32_bit_exact():
    x, _, _ = _triples(0)
    want = np.asarray(jrng._hash_u32(jnp.asarray(x)))
    got = _u32(trng._hash_u32(trng.u32(torch.from_numpy(x.astype(np.int64)))))
    np.testing.assert_array_equal(got, want)


def test_hash_combine_bit_exact():
    a, b, c = _triples(1)
    want = np.asarray(jrng.hash_combine(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(c)))
    got = _u32(trng.hash_combine(*(torch.from_numpy(v.astype(np.int64))
                                   for v in (a, b, c))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scalar_seed", [0, 0xBEA11 ^ 7, 2 ** 32 - 1])
def test_independent_sampler_bit_exact(scalar_seed):
    """make_sampler + next_1d + next_2d + next_1d, scalar and per-lane seeds."""
    seeds, lanes, idx = _triples(2)
    for seed in (scalar_seed, seeds):
        js = jrng.make_sampler(jnp.asarray(seed, jnp.uint32), jnp.asarray(lanes),
                               jnp.asarray(idx))
        ts = trng.make_sampler(
            torch.from_numpy(np.asarray(seed, np.int64)),
            torch.from_numpy(lanes.astype(np.int64)),
            torch.from_numpy(idx.astype(np.int64)))
        for draw in ("next_1d", "next_2d", "next_1d"):
            jv, js = getattr(jrng, draw)(js)
            tv, ts = getattr(trng, draw)(ts)
            jv = np.asarray(jv)
            assert tv.dtype == torch.float32
            np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                          jv.view(np.uint32))
        np.testing.assert_array_equal(_u32(ts.dim), np.asarray(js.dim))


def test_boxwalk_hash_chain_bit_exact():
    """The walk's per-trip chain: b = (lane ^ C) + ctr * K + seed, then nine
    lowbias32 steps, each read as a 24-bit uniform through int32."""
    seeds, lanes, ctr = _triples(3)
    ctr = ctr % (1 << 24)
    b = (jnp.asarray(lanes) ^ jnp.uint32(0x9E3779B9)) \
        + jnp.asarray(ctr) * jnp.uint32(0x85EBCA6B) + jnp.asarray(seeds)
    lt = torch.from_numpy(lanes.astype(np.int64))
    bt = ((lt ^ 0x9E3779B9) + trng.mul32(torch.from_numpy(ctr.astype(np.int64)),
                                         0x85EBCA6B)
          + torch.from_numpy(seeds.astype(np.int64))) & trng.M32
    np.testing.assert_array_equal(_u32(bt), np.asarray(b))
    for k in range(9):
        c = (0x68E31DA4 + 0x3504F333 * k) & 0xFFFFFFFF
        b = jbw._hash(b + jnp.uint32(c))
        bt = trng._hash_u32((bt + c) & trng.M32)
        np.testing.assert_array_equal(_u32(bt), np.asarray(b))
        np.testing.assert_array_equal(tbw._unif(bt).numpy(),
                                      np.asarray(jbw._unif(b)))


def test_pass_seed_matches_render_boxwalk_mix():
    for seed, pidx in [(0, 0), (5, 3), (2 ** 32 - 1, 7)]:
        want = int(jnp.asarray(seed, jnp.uint32)
                   ^ (jnp.asarray(pidx, jnp.uint32) * jnp.uint32(0x9E3779B9)
                      + jnp.uint32(0x7F4A7C15)))
        assert tbw.pass_seed(seed, pidx) == want


def test_other_sampler_modes_raise():
    """The lds mode, which used to raise, draws its stream now
    (tests/test_torch_sampler.py holds every mode against JAX)."""
    s = trng.make_sampler(0, torch.arange(4), 0, mode=1)
    v, s = trng.next_2d(s)
    assert s.mode == trng.LDS and bool(((v >= 0) & (v < 1)).all())
