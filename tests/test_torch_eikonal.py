"""The eikonal core of the port against the JAX package on the same seeded
inputs: the analytic RIF and SDF fields, the plain versions of the march
kernels D and E (against the Pallas kernels in interpret mode and the XLA
loops), the post-march Jacobian algebra and the batched BVP solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.models import ermarch as jem
from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.models import ermarch as tem

torch.set_num_threads(1)

LINEAR = (tek.RIF_LINEAR, (1.3, 0.15, 0.05, -0.1, 0, 0, 0, 0))
RADIAL = (tek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0, 0, 0))
CONST = (tek.RIF_CONST, (1.4, 0, 0, 0, 0, 0, 0, 0))
SPHERE = (tek.SDF_SPHERE, (0, 0, 0, 1, 0, 0, 0, 0))
BOX = (tek.SDF_BOX, (0.1, 0, 0, 0.5, 0.7, 0.9, 0, 0))


def _fields(rif=LINEAR, sdf=SPHERE):
    """(JAX RifField, JAX SdfField, port RifField, port SdfField)."""
    none = dict(coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                aabb_max=jnp.ones(3))
    return (jek.RifField(kind=jnp.int32(rif[0]),
                         params=jnp.asarray(rif[1], jnp.float32), **none),
            jek.SdfField(kind=jnp.int32(sdf[0]),
                         params=jnp.asarray(sdf[1], jnp.float32), **none),
            tek.RifField(*rif), tek.SdfField(*sdf))


def _t(a):
    return torch.from_numpy(np.array(a))


_JITS = {}


def _jit(fn, *static):
    """jax.jit of fn, one per (fn, static positions) for the module: the
    fields are traced arguments, so the RIF kinds share one compile."""
    key = (fn, static)
    if key not in _JITS:
        _JITS[key] = jax.jit(fn, static_argnums=static)
    return _JITS[key]


def _close(got, want, rel):
    """Equal within rel of the largest magnitude of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rif", [CONST, LINEAR, RADIAL],
                         ids=["const", "linear", "radial"])
def test_rif_value_gradient_hessian_match(rif):
    jr, _, tr, _ = _fields(rif)
    p = np.random.default_rng(0).uniform(-1, 1, (512, 3)).astype(np.float32)
    want = _jit(jek.rif_value_grad_hess)(jr, jnp.asarray(p))
    got = tek.rif_value_grad_hess(tr, _t(p))
    for w, g in zip(want, got):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("sdf", [SPHERE, BOX], ids=["sphere", "box"])
def test_sdf_value_gradient_match(sdf):
    _, js, _, ts = _fields(sdf=sdf)
    p = np.random.default_rng(1).uniform(-1.2, 1.2, (512, 3)).astype(np.float32)
    _close(tek.sdf_value(ts, _t(p)), jek.sdf_value(js, jnp.asarray(p)), 1e-6)
    _close(tek.sdf_gradient(ts, _t(p)), jek.sdf_gradient(js, jnp.asarray(p)),
           1e-6)
    np.testing.assert_array_equal(tek.inside_shape(ts, _t(p)).numpy(),
                                  np.asarray(jek.inside_shape(js,
                                                              jnp.asarray(p))))


def _march_inputs(jr, n, seed):
    r = np.random.default_rng(seed)
    p = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    v = r.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = v * np.asarray(jek.rif_value(jr, jnp.asarray(p)))[:, None]
    dist = r.uniform(0.3, 1.5, (n,)).astype(np.float32)
    return p, v, dist


@pytest.mark.parametrize("rif", [LINEAR, RADIAL, CONST],
                         ids=["linear", "radial", "const"])
def test_trace_plain_matches_jax_kernel_and_xla_loop(rif):
    """The cases and tolerances of tests/test_ermarch.py."""
    jr, js, tr, ts = _fields(rif)
    n = 128
    p, v, dist = _march_inputs(jr, n, 0)
    act = np.ones(n, bool)
    args = (jnp.asarray(p), jnp.asarray(v), jnp.asarray(dist), 0.01, 300,
            jnp.asarray(act))
    xla = _jit(jek._trace_curved_xla, 5)(jr, js, *args)
    kern = jem.trace(jr, js, *args, B=128, interpret=True)
    before = tem.trace.launches
    got = tem.trace(tr, ts, _t(p), _t(v), _t(dist), 0.01, 300, _t(act))
    assert tem.trace.launches == before     # the CPU runs the plain version
    for want in (xla, kern):
        for i in range(4):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                       atol=3e-6, rtol=1e-5)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(got[5]) == int(xla[5])


@pytest.mark.parametrize("rif", [LINEAR, RADIAL], ids=["linear", "radial"])
def test_sens_march_plain_matches_jax_kernel(rif):
    """The cases and tolerances of tests/test_ermarch.py."""
    jr, js, tr, ts = _fields(rif)
    r = np.random.default_rng(1)
    n, h = 128, 0.01
    p1 = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    v0 = r.standard_normal((n, 3)).astype(np.float32)
    p2 = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    r0 = np.asarray(jek.rif_value(jr, jnp.asarray(p1)))
    nv = np.linalg.norm(v0, axis=-1)
    dvdv0 = ((r0 / nv ** 3)[:, None, None]
             * ((nv ** 2)[:, None, None] * np.eye(3)
                - v0[:, :, None] * v0[:, None, :])).astype(np.float32)
    v = (v0 / nv[:, None] * r0[:, None]).astype(np.float32)
    dpdv0 = np.zeros((n, 3, 3), np.float32)
    act = np.ones(n, bool)
    want = jem.sens_march(jr, js, *map(jnp.asarray, (p1, v, dpdv0, dvdv0, p2)),
                          h, 300, jnp.asarray(act), B=128, interpret=True)
    before = tem.sens_march.launches
    got = tem.sens_march(tr, ts, *map(_t, (p1, v, dpdv0, dvdv0, p2)), h, 300,
                         _t(act))
    assert tem.sens_march.launches == before
    for i in range(6):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=3e-6, rtol=1e-4)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    assert 0 < int(got[7]) < 300


def _bvp_inputs(n, seed, outside=0):
    """Vertices and targets in the unit-sphere medium; the first `outside`
    targets are moved out of it."""
    r = np.random.default_rng(seed)
    p1 = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    p2 = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    p2[:outside] = 2.5 * p2[:outside] / np.linalg.norm(
        p2[:outside], axis=-1, keepdims=True)
    chord = p2 - p1
    chord /= np.linalg.norm(chord, axis=-1, keepdims=True)
    return p1, p2, chord


@pytest.mark.parametrize("rif", [LINEAR, RADIAL], ids=["linear", "radial"])
def test_integrate_with_sensitivities_matches(rif):
    jr, js, tr, ts = _fields(rif)
    n = 128
    p1, p2, chord = _bvp_inputs(n, 2, outside=n // 4)
    v0 = chord * np.float32(1.3)
    act = np.ones(n, bool)
    want = jax.jit(lambda: jek.integrate_with_sensitivities(
        jr, js, jnp.asarray(p1), jnp.asarray(v0), jnp.asarray(p2), 0.04, 64,
        jnp.asarray(act)))()
    got = tek.integrate_with_sensitivities(tr, ts, _t(p1), _t(v0), _t(p2),
                                           0.04, 64, _t(act))
    ex = np.asarray(want[2])
    assert 0.1 < ex.mean() < 0.9          # both exiting and interior lanes
    np.testing.assert_array_equal(got[2].numpy(), ex)
    for i in (0, 1, 3, 4, 5, 6):          # err, J, opt, geo_in, geo_tot, v
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("max_restarts", [0, 2])
def test_solve_bvp_matches(max_restarts):
    """Connections inside the medium, at the render's BVP step 0.04, solved
    to tol2 = 1e-8. (At the default 1e-6 a converged solve pins the
    direction only to about 1e-3, so two solvers that accept different
    iterates of one solution differ by that much. Where the target lies
    outside, the Levenberg iteration often stalls near tol2, and one-ulp
    differences decide the converged flag: XLA on the CPU contracts the
    Jacobian's multiply-adds into FMAs, and the normal equations are
    singular along v0, which amplifies them.)"""
    jr, js, tr, ts = _fields(LINEAR)
    n = 512
    p1, p2, chord = _bvp_inputs(n, 5)
    seed_bits = np.asarray(jrng._hash_u32(
        jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
        + jnp.uint32(13)))
    act = np.ones(n, bool)
    act[::7] = False
    kw = dict(tol2=1e-8, max_restarts=max_restarts)
    want = jax.jit(lambda: jek.solve_bvp(
        jr, js, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(chord), 0.04,
        64, jnp.asarray(act), seed_bits=jnp.asarray(seed_bits), **kw))()
    got = tek.solve_bvp(tr, ts, _t(p1), _t(p2), _t(chord), 0.04, 64, _t(act),
                        seed_bits=_t(seed_bits.astype(np.int64)), **kw)
    cj, ct = np.asarray(want.converged), got.converged.numpy()
    assert cj.mean() > 0.5
    assert (cj == ct).mean() >= 0.99
    both = cj & ct
    np.testing.assert_allclose(got.dir_to_target.numpy()[both],
                               np.asarray(want.dir_to_target)[both], atol=1e-3)
    np.testing.assert_allclose(got.weight.numpy()[both],
                               np.asarray(want.weight)[both], rtol=1e-6)


def test_fields_not_ported_raise():
    """The acoustic RIF, the spline SDF and the differentiable march,
    ported since, run (their values are held against JAX in
    tests/test_torch_acoustic.py, tests/test_torch_spline.py and
    tests/test_torch_er_grad.py); an unknown kind raises."""
    acoustic = tek.RifField(tek.RIF_ACOUSTIC, (1.33, 0.03, 6.0, 0.0))
    n = tek.rif_value(acoustic, torch.tensor([[0.0, 0.1, 0.2]]))
    assert bool(torch.isfinite(n).all()) and abs(float(n) - 1.33) < 0.03
    with pytest.raises(ValueError, match="unknown RIF kind"):
        tek.RifField(7, (1.0,))
    zs = torch.linspace(-1.5, 1.5, 6)
    Z, Y, X = torch.meshgrid(zs, zs, zs, indexing="ij")
    from mitsubaer_tpu_torch.core import spline as tspline
    ball = tspline.SplineGrid3D(
        torch.from_numpy(tspline.prefilter(
            (torch.sqrt(X * X + Y * Y + Z * Z) - 1.0).numpy())),
        torch.full((3,), -1.5), torch.full((3,), 1.5))
    sdf = tek.SdfField(tek.SDF_SPLINE, (), grid=ball)
    p = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 1.4]])
    assert tek.inside_shape(sdf, p).tolist() == [True, False]
    _, _, tr, ts = _fields()
    p = torch.zeros((4, 3))
    prm = torch.tensor(tr.params).requires_grad_()
    attached = tek.RifField(tr.kind, tr.params, tensor=prm)
    out = tek.trace_curved(attached, ts, p, p + 1, 1.0, 0.01, 8,
                           torch.ones(4, dtype=torch.bool),
                           differentiable=True)
    (g,) = torch.autograd.grad(out[2].sum(), prm)
    assert bool(torch.isfinite(g).all()) and g[0] > 0


def test_march_wrappers_reject_other_devices():
    _, _, tr, ts = _fields()
    p = torch.zeros((4, 3), device="meta")
    act = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tem.trace(tr, ts, p, p, 1.0, 0.01, 8, act)
    with pytest.raises(ValueError, match="unsupported device"):
        tem.sens_march(tr, ts, p, p, p, p, p, 0.01, 8, act)
