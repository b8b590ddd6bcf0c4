"""Kernel C's plain version (megatrack.run_plain) against the JAX package's
megatrack.run in Pallas interpret mode, lane by lane, and the statistical
checks of tests/test_megatrack.py on the plain version.

Both draw the same lowbias32 bits, so a lane takes the same branches in both
unless a float differs by an ulp right at a decision: XLA on the CPU fuses
o + t * d into a multiply-add and has its own log, the port rounds every
product. So the counter and the tap count must agree on >= 99.5% of lanes,
and t and fac within rtol 1e-5 on the lanes whose flags agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import megatrack as jmt
from mitsubaer_tpu_torch.integrators import megatrack as tmt

torch.set_num_threads(1)


def _mkrows(n, o, d, t, tlim, maj, stm, stc, w_real, is_sh, valid):
    z = np.zeros((n,), np.float32)
    return np.stack([
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        t, tlim, maj, stm, stc[:, 0], stc[:, 1], stc[:, 2],
        w_real[:, 0], w_real[:, 1], w_real[:, 2],
        is_sh.astype(np.float32), valid.astype(np.float32),
        z, z, z, z, z, z,
    ], axis=0).astype(np.float32)


def _run_plain(rows, ctr, d, seed=7, max_trips=64):
    nz, ny, nx = d.shape
    tab, nb = tmt.build_table(torch.from_numpy(d))
    out, ctr_out = tmt.run_plain(torch.from_numpy(rows),
                                 torch.from_numpy(ctr), tab, seed, max_trips,
                                 (nx, ny, nz), nb)
    return out.numpy(), ctr_out.numpy()


def _run_jax(rows, ctr, d, seed=7, max_trips=64, B=256):
    nz, ny, nx = d.shape
    tab, nb = jmt.build_table(jnp.asarray(d))
    out, ctr_out = jmt.run(jnp.asarray(rows), jnp.asarray(ctr), tab,
                           jnp.asarray(seed, jnp.uint32), B=B,
                           max_trips=max_trips, res=(nx, ny, nz), nb=nb,
                           interpret=True)
    return np.asarray(out), np.asarray(ctr_out)


def _zero_density(n=512):
    rng = np.random.default_rng(0)
    d = np.zeros((8, 8, 8), np.float32)
    o = rng.random((n, 3)).astype(np.float32) * 7
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tlim = (rng.random(n) * 2 + 0.5).astype(np.float32)
    rows = _mkrows(n, o, dirs, np.zeros(n, np.float32), tlim,
                   np.full(n, 4.0, np.float32), np.full(n, 1.0, np.float32),
                   np.ones((n, 3), np.float32), np.ones((n, 3), np.float32),
                   np.zeros(n, bool), np.ones(n, bool))
    return rows, np.zeros((1, n), np.int32), d, tlim


def _constant_density(n=4096, sig=2.0):
    d = np.full((8, 8, 8), 0.5, np.float32)
    o = np.tile(np.array([[0.5, 3.5, 3.5]], np.float32), (n, 1))
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    rows = _mkrows(n, o, dirs, np.zeros(n, np.float32),
                   np.full(n, 4.0, np.float32),
                   np.full(n, 0.5 * sig, np.float32),
                   np.full(n, sig, np.float32),
                   np.full((n, 3), sig, np.float32),
                   np.full((n, 3), 0.9, np.float32),
                   np.zeros(n, bool), np.ones(n, bool))
    return rows, np.zeros((1, n), np.int32), d


def _ramp(n=8192, sig=1.5):
    d = np.zeros((8, 8, 16), np.float32)
    d[:] = np.linspace(0.0, 1.0, 16)[None, None, :]
    o = np.tile(np.array([[0.0, 3.5, 3.5]], np.float32), (n, 1))
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    rows = _mkrows(n, o, dirs, np.zeros(n, np.float32),
                   np.full(n, 15.0, np.float32),
                   np.full(n, 1.0 * sig, np.float32),
                   np.full(n, sig, np.float32),
                   np.full((n, 3), sig, np.float32),
                   np.ones((n, 3), np.float32), np.ones(n, bool),
                   np.ones(n, bool))
    return rows, np.zeros((1, n), np.int32), d


def _mixed(n=1000, seed=5):
    """Shadow and extension lanes, ~10% invalid, through a random
    12x10x9 grid (padded to bricks), with counters spread over the whole
    uint32 range (int32 bits: negatives included)."""
    r = np.random.default_rng(seed)
    d = r.random((12, 10, 9)).astype(np.float32) ** 2
    res = np.array([9, 10, 12], np.float32)
    o = (r.random((n, 3)) * (res + 2) - 1).astype(np.float32)
    dirs = r.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    stc = r.uniform(0.2, 1.5, (n, 3)).astype(np.float32)
    stm = stc.mean(-1)
    maj = stc.max(-1) * float(d.max())
    w_real = r.uniform(0.3, 1.0, (n, 3)).astype(np.float32)
    t0 = r.uniform(0.0, 2.0, n).astype(np.float32)
    tlim = t0 + r.uniform(0.5, 20.0, n).astype(np.float32)
    rows = _mkrows(n, o, dirs, t0, tlim, maj, stm, stc, w_real,
                   r.random(n) < 0.4, r.random(n) < 0.9)
    ctr = r.integers(-2 ** 31, 2 ** 31, (1, n), dtype=np.int64)
    return rows, ctr.astype(np.int32), d


def _compare(plain, jax_):
    (out_p, ctr_p), (out_j, ctr_j) = plain, jax_
    agree = (ctr_p[0] == ctr_j[0]) & (out_p[6] == out_j[6])
    assert agree.mean() >= 0.995, agree.mean()
    same = agree & (out_p[4] == out_j[4]) & (out_p[5] == out_j[5])
    assert same.mean() >= 0.995, same.mean()
    np.testing.assert_allclose(out_p[0:4, same], out_j[0:4, same], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(out_p[7], 0.0)


@pytest.mark.parametrize("case", ["zero", "constant", "ramp"])
def test_plain_matches_jax_interpret(case):
    """The three cases of tests/test_megatrack.py, lane by lane."""
    if case == "zero":
        rows, ctr, d, _ = _zero_density()
        kw = {}
    elif case == "constant":
        rows, ctr, d = _constant_density()
        kw = {}
    else:
        rows, ctr, d = _ramp()
        kw = dict(max_trips=128)
    _compare(_run_plain(rows, ctr, d, **kw),
             _run_jax(rows, ctr, d, B=1024 if case == "ramp" else 256, **kw))


@pytest.mark.parametrize("max_trips", [6, 64])
def test_plain_matches_jax_interpret_mixed(max_trips):
    """Shadow, extension and invalid lanes, n = 1000 (not a multiple of the
    JAX block), with the engine's trip cap and a large one."""
    rows, ctr, d = _mixed()
    plain = _run_plain(rows, ctr, d, seed=0xDEADBEEF, max_trips=max_trips)
    _compare(plain, _run_jax(rows, ctr, d, seed=0xDEADBEEF,
                             max_trips=max_trips))
    out = plain[0]
    valid = rows[17] > 0.5
    assert not (out[5][~valid] > 0.5).any() and (out[6][~valid] == 0).all()
    assert (out[6] <= max_trips).all()
    if max_trips == 6:
        assert (out[5][valid] < 0.5).any()           # some lanes left over
    assert (out[4] > 0.5).any() and (out[5] > 0.5).any()


def test_zero_density_escapes_with_unit_weight():
    rows, ctr, d, tlim = _zero_density()
    out, ctr_out = _run_plain(rows, ctr, d)
    assert (out[5] > 0.5).all()
    assert not (out[4] > 0.5).any()
    np.testing.assert_allclose(out[0], tlim, rtol=1e-5)
    np.testing.assert_allclose(out[1:4], 1.0, rtol=1e-6)
    assert (ctr_out[0] == 5 * out[6].astype(np.int64)).all()


def test_constant_density_collision_rate():
    """P(scatter before tlim) = 1 - exp(-sigma tlim); grey medium, so the
    null weight is 1 and the real weight w_real."""
    sig = 2.0
    rows, ctr, d = _constant_density(sig=sig)
    out, _ = _run_plain(rows, ctr, d)
    assert (out[5] > 0.5).all()
    scat = out[4] > 0.5
    p_true = 1 - np.exp(-0.5 * sig * 4.0)
    assert abs(scat.mean() - p_true) < 0.03, (scat.mean(), p_true)
    np.testing.assert_allclose(out[1][~scat], 1.0, rtol=1e-5)
    np.testing.assert_allclose(out[1][scat], 0.9, rtol=1e-5)
    lam = 0.5 * sig
    m_true = 1 / lam - 4.0 * np.exp(-lam * 4.0) / (1 - np.exp(-lam * 4.0))
    assert abs(out[0][scat].mean() - m_true) < 0.08


def test_shadow_ratio_tracking_transmittance():
    """Ratio tracking through a linear ramp: E[fac] = exp(-tau)."""
    rows, ctr, d = _ramp()
    out, _ = _run_plain(rows, ctr, d, max_trips=128)
    assert (out[5] > 0.5).all()
    tr_true = np.exp(-1.5 * 7.5)
    se = out[1].std() / np.sqrt(out.shape[1])
    assert abs(out[1].mean() - tr_true) < max(4 * se, 0.05 * tr_true)
