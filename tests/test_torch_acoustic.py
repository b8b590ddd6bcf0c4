"""The acoustic RIF (RIF_ACOUSTIC: n = n0 + nmax J_m(kr r) cos(m phi), the
beam along +x, acousticrifvolume.cpp) in the port against the JAX package
on the CPU: the Bessel series, the field's value, gradient and Hessian for
modes 0-4 against JAX's `_rif_analytic`, the checks of
tests/test_eikonal.py (autodiff, finite differences, the azimuthal
symmetry) on the port, the gradient with respect to the parameters
against jax.grad, the two plain marches lane by lane, and
tests/test_volpath_er.py's acoustic render against JAX's.

JAX's Hessian is the forward-mode Jacobian of its closed-form yz
gradient; the port's is that Jacobian in closed form (Bessel
recurrences). Tolerances, float32 on both sides: the value within 1e-6,
the gradient within 1e-4 and the Hessian within 2e-4 of their largest
JAX magnitude (measured: 1.2e-5 and 2.1e-5); the parameter gradient
within rtol 1e-4; the marches within 1e-4 of their largest magnitude on
all but MAX_FLIPPED lanes (a step's inside test or plane test decided an
ulp apart ends a lane a step early); the render as
tests/test_torch_volpath_er.py holds the linear one (mean within 1%,
rtol 1e-3 on >= 95% of lit pixels, box filter).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

MAX_FLIPPED = 2         # of the march cases' 64 lanes
KR = (6.0, 30.0)        # the render's kr; test_eikonal's mode-2 kr (its
#                         arguments reach the asymptotic branch, |x| >= 8)


def _jax_rif(prm):
    return jek.RifField(kind=jnp.asarray(jek.RIF_ACOUSTIC, jnp.int32),
                        params=jnp.asarray(prm, jnp.float32),
                        coeff=jnp.ones((1, 1, 1), jnp.float32),
                        aabb_min=jnp.zeros(3), aabb_max=jnp.ones(3))


def _prm(mode, kr, n0=1.3333, amp=0.05):
    return np.array([n0, amp, kr, mode, 0, 0, 0, 0], np.float32)


def _points(n, seed, lo=-1.2, hi=1.2):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def test_bessel_matches_jax_and_scipy():
    """J_0 ... J_5 against JAX's series on both sides of each branch, and
    J0, J1 against scipy at tests/test_eikonal.py's tolerance."""
    from scipy.special import j0, j1
    x = np.linspace(-25.0, 25.0, 401).astype(np.float32)
    xt = torch.from_numpy(x)
    for m in range(6):
        got = tek.bessel_orders((m,), xt)[0].numpy()
        want = np.asarray(jek.bessel_jm(m, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                   err_msg=f"J_{m}")
    np.testing.assert_allclose(tek.bessel_j0(xt).numpy(), j0(x), atol=3e-4)
    np.testing.assert_allclose(tek.bessel_j1(xt).numpy(), j1(x), atol=3e-4)


@pytest.mark.parametrize("kr", KR)
@pytest.mark.parametrize("mode", range(5))
def test_field_matches_jax(mode, kr):
    p = _points(256, mode)
    prm = _prm(mode, kr)
    v, g, H = (np.asarray(a) for a in jek._rif_analytic(
        jnp.int32(jek.RIF_ACOUSTIC), jnp.asarray(prm), jnp.asarray(p),
        True))
    tv, tg, tH = tek.rif_value_grad_hess(
        tek.RifField(tek.RIF_ACOUSTIC, tuple(prm.tolist())),
        torch.from_numpy(p))
    np.testing.assert_allclose(tv.numpy(), v, rtol=0, atol=1e-6)
    for got, want, tol, what in ((tg.numpy(), g, 1e-4, "gradient"),
                                 (tH.numpy(), H, 2e-4, "Hessian")):
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        print(f"mode {mode} kr {kr} {what}: max |diff| / max |JAX| "
              f"{err / scale:.2e}")
        assert scale > 0 and err <= tol * scale, (what, err, scale)
    # the x row and column are zero, the Hessian symmetric
    assert not tg[:, 0].any() and not tH[:, 0].any() and not tH[:, :, 0].any()
    torch.testing.assert_close(tH, tH.transpose(-1, -2), rtol=0, atol=0)


def test_gradient_matches_autodiff():
    """tests/test_eikonal.py::test_acoustic_gradient_matches_autodiff on
    the port: the closed-form gradient against autograd of the value."""
    rif = tek.RifField(tek.RIF_ACOUSTIC, (1.3333, 0.04, 8.0))
    p = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (20, 3)).astype(np.float32)).requires_grad_()
    _, g = tek.rif_value_grad(rif, p)
    (g_ad,) = torch.autograd.grad(tek.rif_value(rif, p).sum(), p)
    np.testing.assert_allclose(g.detach().numpy(), g_ad.numpy(), atol=1e-3)


def test_mode2_gradient_hessian_fd():
    """tests/test_eikonal.py::TestAcousticModes::
    test_mode2_gradient_hessian_fd on the port."""
    rng = np.random.RandomState(3)
    rif = tek.RifField(tek.RIF_ACOUSTIC, (1.333, 0.05, 30.0, 2.0))
    p = torch.from_numpy(rng.uniform(-0.3, 0.3, (48, 3)).astype(np.float32))
    _, g, H = tek.rif_value_grad_hess(rif, p)
    h = 1e-3
    for a in range(3):
        dp = torch.zeros(3)
        dp[a] = h
        fd = (tek.rif_value(rif, p + dp) - tek.rif_value(rif, p - dp)) / (
            2 * h)
        assert (g[:, a] - fd).abs().max() < 2e-3 * (fd.abs().max() + 1), a
        _, gp = tek.rif_value_grad(rif, p + dp)
        _, gm = tek.rif_value_grad(rif, p - dp)
        fd = (gp - gm) / (2 * h)
        assert (H[:, :, a] - fd).abs().max() < 5e-3 * (fd.abs().max() + 1), a


def test_mode_azimuthal_symmetry():
    """tests/test_eikonal.py::TestAcousticModes::
    test_mode_azimuthal_symmetry on the port: mode 4 has 4-fold symmetry."""
    phi = torch.linspace(0, 2 * np.pi, 65)[:-1]
    p = torch.stack([torch.zeros_like(phi), 0.25 * torch.sin(phi),
                     0.25 * torch.cos(phi)], -1)
    v4 = tek.rif_value(tek.RifField(tek.RIF_ACOUSTIC, (1.3, 0.1, 12.0, 4.0)),
                       p)
    assert torch.allclose(v4, torch.roll(v4, -16), atol=2e-5)


@pytest.mark.parametrize("mode", [0, 2, 3])
def test_parameter_gradient_matches_jax(mode):
    """jax.grad of sum(rif_value) with respect to the parameters against
    autograd through the attached parameter tensor (the differentiable
    marches' route); the mode gets no gradient."""
    prm = _prm(mode, 6.0)
    p = _points(128, 10 + mode)

    def f(q):
        return jnp.sum(jek.rif_value(_jax_rif(q), jnp.asarray(p)))

    want = np.asarray(jax.grad(f)(jnp.asarray(prm)))
    leaf = torch.from_numpy(prm).requires_grad_()
    rif = tek.RifField(tek.RIF_ACOUSTIC, tuple(prm.tolist()), leaf)
    (got,) = torch.autograd.grad(tek.rif_value(rif, torch.from_numpy(p))
                                 .sum(), leaf)
    np.testing.assert_allclose(got.numpy()[:3], want[:3], rtol=1e-4,
                               atol=1e-4)
    assert got.numpy()[3] == 0 and not got.numpy()[4:].any()
    assert np.abs(want[:3]).min() > 0


def _sphere():
    return (jek.SdfField(kind=jnp.asarray(jek.SDF_SPHERE, jnp.int32),
                         params=jnp.asarray([0, 0, 0, 1.0, 0, 0, 0, 0],
                                            jnp.float32),
                         coeff=jnp.ones((1, 1, 1), jnp.float32),
                         aabb_min=jnp.zeros(3), aabb_max=jnp.ones(3)),
            tek.SdfField(tek.SDF_SPHERE, (0.0, 0.0, 0.0, 1.0)))


def _assert_lanes_close(got, want, tol, what):
    """Every output within tol of its largest magnitude on all but
    MAX_FLIPPED lanes."""
    bad = np.zeros(want[0].shape[0], bool)
    for a, b in zip(got, want):
        a = np.asarray(a, np.float64).reshape(len(bad), -1)
        b = np.asarray(b, np.float64).reshape(len(bad), -1)
        scale = max(np.abs(b).max(), 1e-30)
        bad |= (np.abs(a - b) > tol * scale).any(-1)
    print(f"{what}: {int(bad.sum())} of {len(bad)} lanes differ")
    assert bad.sum() <= MAX_FLIPPED, (what, np.nonzero(bad))


@pytest.mark.parametrize("mode", [0, 2])
def test_plain_marches_match_jax_per_lane(mode):
    """trace_plain (kernel D's plain version, the acoustic route's march)
    through trace_curved, and sens_march_plain through
    integrate_with_sensitivities, against the JAX package's XLA loops."""
    prm = _prm(mode, 6.0, amp=0.08)
    jsdf, tsdf = _sphere()
    jrif = _jax_rif(prm)
    trif = tek.RifField(tek.RIF_ACOUSTIC, tuple(prm.tolist()))
    r = np.random.default_rng(20 + mode)
    n = 64
    p = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    v = d * np.asarray(jek.rif_value(jrif, jnp.asarray(p)))[:, None]
    dist = r.uniform(0.2, 3.0, n).astype(np.float32)
    act = r.uniform(size=n) < 0.9
    want = jek.trace_curved(jrif, jsdf, jnp.asarray(p), jnp.asarray(v),
                            jnp.asarray(dist), 0.02, 256, jnp.asarray(act))
    t = [torch.from_numpy(a) for a in (p, v, dist, act)]
    got = tek.trace_curved(trif, tsdf, *t[:3], 0.02, 256, t[3])
    assert got[4].any() and (~got[4]).any()          # exits and stops
    _assert_lanes_close([x.numpy() for x in got[:5]],
                        [np.asarray(x) for x in want[:5]], 1e-4,
                        f"trace mode {mode}")

    p2 = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    p2[: n // 2] = (2.0, 2.0, -2.0)
    v0 = (p2 - p).astype(np.float32)
    want = jek.integrate_with_sensitivities(
        jrif, jsdf, jnp.asarray(p), jnp.asarray(v0), jnp.asarray(p2), 0.04,
        64, jnp.asarray(act))
    got = tek.integrate_with_sensitivities(
        trif, tsdf, t[0], torch.from_numpy(v0), torch.from_numpy(p2), 0.04,
        64, t[3])
    _assert_lanes_close([x.numpy() for x in got],
                        [np.asarray(x) for x in want], 1e-4,
                        f"sensitivity march mode {mode}")


def test_render_matches_jax():
    """tests/test_volpath_er.py::TestCurvedRendering::
    test_acoustic_rif_renders (mode 0, depth 5) on the port against the
    JAX render's host-stepped ER loop at the same seed, at 12^2 spp 2 (the
    JAX test's 16^2 spp 4 costs the port's plain loops ~4x the lanes and
    JAX the same compile), with a box filter so that a lane whose path
    took another branch moves only its own pixel (measured at 12^2 spp 2:
    0 of 128 lit pixels apart, mean within 6e-8; at 16^2 spp 4, 4 of 224
    apart, the others within 1e-5)."""
    kw = dict(res=12, spp=2, max_depth=5, rif_kind=jek.RIF_ACOUSTIC,
              rif_params=(1.3333, 0.03, 6.0, 0.0), er_stepsize=0.02,
              filter="box")
    js, jc = jpresets.refractive_sphere(**kw)
    want = np.asarray(jrender.render(js, jc._replace(er_host_stepped=True),
                                     seed=0))
    ts, tc = tpresets.refractive_sphere(**kw)
    got = trender.render(ts, tc, seed=0, device="cpu").numpy()
    assert got.shape == want.shape == (12, 12, 3)
    assert np.isfinite(got).all() and got.mean() > 0.001
    assert abs(got.mean() / want.mean() - 1) <= 0.01
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=0).all(-1)
    print(f"acoustic render: mean {got.mean():.6f} (JAX {want.mean():.6f}), "
          f"{int((~close[lit]).sum())} of {int(lit.sum())} lit pixels apart")
    assert close[lit].mean() >= 0.95


def test_acoustic_route_is_plain():
    """The acoustic RIF takes the plain loops, as JAX's lax.cond sends it
    to XLA: kernels D and E have no acoustic field."""
    rif = tek.RifField(tek.RIF_ACOUSTIC, (1.3, 0.03, 6.0, 2.0))
    assert not tek.kernel_route(rif, _sphere()[1], differentiable=False)
