"""The port's core/special.py numerics (quadrature, Brent, spherical
harmonics, the chi-square harness) against the JAX package's on the CPU,
on tests/test_special.py's inputs, and held to that file's own bars.

Tolerances, stated per case:
- gauss_lobatto, simpson: within 2 ulp of float32 (rtol 2.4e-7) of JAX's
  value (the same float32 nodes from the same float64 constants; XLA may
  sum the 7 x n terms in another order);
- brent: the converged flags equal and the roots within the stop test's
  bracket, 8 tol (1 + |root|) (both stop within 4 tol (1 + |b|) of the
  root; XLA's and torch's exp differ by an ulp, which moves a lane's last
  steps: 1 of 2,048 lanes 2.6e-6 apart at a root of 3.8 here);
- sh_eval: within 1e-6 absolute; sh_project: within 1e-5 of JAX's
  largest coefficient (2,048-8,192 float32 terms summed in another
  order: 4.8e-6 of it measured on the constant);
- chi2_test, chi2_threshold: equal (the same float64 numpy code).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import special as jsp
from mitsubaer_tpu_torch.core import special as tsp

F32_RTOL = 2.4e-7


@pytest.mark.parametrize("case", ["poly9", "sin", "batched"])
def test_gauss_lobatto_matches_jax(case):
    if case == "poly9":
        args = (lambda x: 10 * x ** 9, 0.0, 1.0, 1)
        want_exact = 1.0
    elif case == "sin":
        args = ("sin", 0.0, np.pi, 8)
        want_exact = 2.0
    else:
        args = (lambda x: x * x, np.zeros(3), np.array([1.0, 2.0, 3.0]), 16)
        want_exact = np.array([1.0, 8.0, 9.0]) / np.array([3.0, 3.0, 1.0])
    f, a, b, n = args
    jf = jnp.sin if f == "sin" else f
    tf = torch.sin if f == "sin" else f
    want = np.asarray(jsp.gauss_lobatto(jf, jnp.asarray(a, jnp.float32),
                                        jnp.asarray(b, jnp.float32),
                                        n_intervals=n))
    got = tsp.gauss_lobatto(tf, torch.tensor(a, dtype=torch.float32),
                            torch.tensor(b, dtype=torch.float32),
                            n_intervals=n).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)
    np.testing.assert_allclose(got, want_exact, rtol=1e-5)


def test_simpson_matches_jax():
    want = float(jsp.simpson(jnp.exp, jnp.float32(0.0), jnp.float32(1.0),
                             n_intervals=16))
    got = float(tsp.simpson(torch.exp, 0.0, 1.0, n_intervals=16))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)
    np.testing.assert_allclose(got, np.e - 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["cubic", "vector", "lanes"])
def test_brent_matches_jax(case):
    if case == "cubic":
        targets = None
        lo, hi = np.float32(2.0), np.float32(3.0)
    elif case == "vector":
        targets = np.array([0.25, 0.5, 0.9], np.float32)
        lo, hi = np.zeros(3, np.float32), np.full(3, 10.0, np.float32)
    else:
        targets = np.random.default_rng(0).uniform(
            0.01, 0.99, 2048).astype(np.float32)
        lo, hi = np.zeros_like(targets), np.full_like(targets, 10.0)

    def f_of(xp, t):
        if t is None:
            return lambda x: x * x * x - 2.0 * x - 5.0
        return lambda x: 1.0 - xp.exp(-x) - t

    want_root, want_ok = jsp.brent(f_of(jnp, None if targets is None
                                        else jnp.asarray(targets)),
                                   jnp.asarray(lo), jnp.asarray(hi))
    got_root, got_ok = tsp.brent(f_of(torch, None if targets is None
                                      else torch.from_numpy(targets)),
                                 torch.from_numpy(np.asarray(lo)),
                                 torch.from_numpy(np.asarray(hi)))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    want_root = np.asarray(want_root)
    np.testing.assert_array_less(np.abs(got_root.numpy() - want_root),
                                 8e-7 * (1.0 + np.abs(want_root)))
    assert bool(got_ok.all())
    exact = (2.0945515 if targets is None
             else -np.log1p(-targets.astype(np.float64)))
    np.testing.assert_allclose(got_root.numpy(), exact, atol=1e-5)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_sh_eval_matches_jax(order):
    d = np.random.default_rng(order).normal(size=(4096, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jsp.sh_eval(jnp.asarray(d), order))
    got = tsp.sh_eval(torch.from_numpy(d), order).numpy()
    assert got.shape == want.shape == (4096, order * order)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("idx", [0, 4, 8])
def test_sh_project_orthonormal_as_jax(idx):
    """A basis function projected onto the basis: the identity's row, as
    tests/test_special.py::TestSH (a 2e-3 bar), and JAX's coefficients."""
    want = np.asarray(jsp.sh_project(
        lambda d: jsp.sh_eval(d, 3)[..., idx], order=3, res=64))
    got = tsp.sh_project(lambda d: tsp.sh_eval(d, 3)[..., idx], order=3,
                         res=64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.eye(9)[idx], atol=2e-3)


def test_sh_project_constant_as_jax():
    want = np.asarray(jsp.sh_project(lambda d: jnp.ones(d.shape[:-1]),
                                     order=2, res=32))
    got = tsp.sh_project(lambda d: torch.ones(d.shape[:-1]), order=2,
                         res=32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got[0], np.sqrt(4 * np.pi), rtol=1e-3)
    np.testing.assert_allclose(got[1:], 0.0, atol=1e-3)


@pytest.mark.parametrize("case", ["uniform", "biased", "sparse"])
def test_chi2_test_equals_jax(case):
    n = 100000
    if case == "uniform":
        counts = np.bincount(np.random.default_rng(1).integers(0, 64, n),
                             minlength=64)
        expected = np.full(64, 1 / 64)
    elif case == "biased":
        r = np.random.default_rng(2)
        counts = np.bincount((r.random(n) ** 1.3 * 64).astype(int)
                             .clip(0, 63), minlength=64)
        expected = np.full(64, 1 / 64)
    else:
        # cells below the pooling threshold
        expected = np.geomspace(1.0, 1e-7, 48)
        expected /= expected.sum()
        counts = np.random.default_rng(3).multinomial(2000, expected)
        n = 2000
    want = jsp.chi2_test(counts, expected, n)
    got = tsp.chi2_test(counts, expected, n)
    assert got == want
    passes = got[0] < tsp.chi2_threshold(got[1])
    assert passes == (case != "biased")


@pytest.mark.parametrize("dof,sig", [(1, 0.0025), (5, 0.01), (50, 0.0025),
                                     (200, 0.5), (10, 0.99)])
def test_chi2_threshold_equals_jax(dof, sig):
    assert tsp.chi2_threshold(dof, sig) == jsp.chi2_threshold(dof, sig)
    if dof == 50:
        assert abs(tsp.chi2_threshold(50) - 83.66) < 1.5
