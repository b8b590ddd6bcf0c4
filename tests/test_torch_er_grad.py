"""The differentiable pieces of the port's eikonal core against the JAX
package on the CPU, for the radial RIF's parameters and for the spline
RIF's coefficients: trace_curved, integrate_with_sensitivities and
solve_bvp (with restarts), each with differentiable=True. The outputs and
the gradient of a seeded weighted sum of them, with respect to the (8,)
RIF parameters and the coefficient grid, are compared.

Each JAX reference is one jitted value_and_grad with the outputs as aux,
the parameters and coefficients traced, the RIF kind static (one compile
a piece and kind). JAX's `_rif_analytic` computes every analytic kind and
selects one with jnp.where, so its acoustic branch, Bessel series under a
forward-mode Hessian, is compiled for every kind; `_acoustic_stub` (see
there) replaces those Bessel functions by zeros for this file, which
leaves the radial and spline RIFs' values and gradients as they are. The
solve's reference runs twice: once to read which lanes converge, then
with the weighted sum restricted to the lanes that converge in both
packages.

Tolerances: outputs within rtol 1e-4 (atol 1e-5, and 1e-4 for the 3x3
Jacobian); each gradient field within 1e-3 of its largest JAX magnitude;
the solve's converged flags equal on at least 99% of the lanes. Measured
on the CPU, gradients within: trace_curved 1.0e-7 (radial) and 1.9e-7
(spline), integrate_with_sensitivities 8.8e-8 and 9.2e-7, solve_bvp
1.7e-5 and 2.2e-6 of their largest JAX magnitude; no flag differed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu_torch.core import spline as tspline
from mitsubaer_tpu_torch.models import eikonal as tek

torch.set_num_threads(1)
_ACOUSTIC_BESSEL = jek.bessel_jm

LO, HI = -1.2, 1.2
SPHERE = np.array([0, 0, 0, 1, 0, 0, 0, 0], np.float32)
RTOL_GRAD = 1e-3
H, STEPS = 0.05, 48


def _bessel_zero(m, x):
    return jnp.zeros_like(x)


@pytest.fixture(scope="module", autouse=True)
def _acoustic_stub():
    """JAX's acoustic-RIF Bessel functions as zeros while this file runs.
    The acoustic branch of `_rif_analytic` is selected away for the radial
    and spline kinds (test_jax_acoustic_branch_is_dead holds JAX's fields
    and their gradients equal with and without it), and it is the larger
    part of every program here: on a CPU the whole eikonal road's
    gradient lowers to 40.6 MB of HLO with it (compile stopped after 11
    minutes at 15 GiB) and to 7.0 MB without it (36 s to lower, 31 s to
    compile, 1.6 GiB)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", _bessel_zero)
    yield
    mp.undo()


def _rif_samples(n=8):
    """A smooth index bump over [-1.2, 1.2]^3 with seeded ripples."""
    zs = np.linspace(LO, HI, n)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    ripple = np.random.default_rng(0).normal(size=(n, n, n))
    return (1.33 + 0.15 * np.exp(-(X**2 + Y**2 + Z**2) / 0.36)
            + 0.01 * ripple).astype(np.float32)


COEFF = tspline.prefilter(_rif_samples())
# kind, parameters
FAMILIES = {
    "radial": (tek.RIF_RADIAL, np.array([1.33, 0.1, 0.5, 0.05, -0.05, 0.0,
                                         0, 0], np.float32)),
    "spline": (tek.RIF_SPLINE, np.array([1.33, 0, 0, 0, 0, 0, 0, 0],
                                        np.float32)),
}


def _jfields(kind, prm, coeff):
    lo, hi = jnp.full(3, LO, jnp.float32), jnp.full(3, HI, jnp.float32)
    return (jek.RifField(kind=jnp.int32(kind), params=prm, coeff=coeff,
                         aabb_min=lo, aabb_max=hi),
            jek.SdfField(kind=jnp.int32(jek.SDF_SPHERE),
                         params=jnp.asarray(SPHERE), coeff=jnp.zeros(()),
                         aabb_min=lo, aabb_max=hi))


def _tfields(kind, prm, coeff):
    box = torch.full((3,), LO), torch.full((3,), HI)
    return (tek.RifField(kind, tuple(prm.detach().tolist()), tensor=prm,
                         grid=tspline.SplineGrid3D(coeff, *box)),
            tek.SdfField(tek.SDF_SPHERE, tuple(SPHERE)))


def _weighted(outs, weights):
    return sum(jnp.sum(o * w) for o, w in zip(outs, weights))


def _weights(outs, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=np.shape(o)).astype(np.float32) for o in outs]


def _unit(r, n):
    d = r.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(name, n=64):
    """Seeded lanes in the unit-sphere medium, the same for both
    families."""
    r = np.random.default_rng({"trace": 1, "sens": 2, "bvp": 3}[name])
    p1 = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    act = r.uniform(size=n) < 0.9
    if name == "trace":
        v = _unit(r, n) * np.float32(1.4)
        dist = np.where(r.uniform(size=n) < 0.25, 1e6,
                        r.uniform(0.2, 1.5, n)).astype(np.float32)
        return p1, v, dist, act
    p2 = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    if name == "sens":
        p2[: n // 3] = 2.5 * p2[: n // 3] / np.linalg.norm(
            p2[: n // 3], axis=-1, keepdims=True)
    chord = p2 - p1
    chord /= np.linalg.norm(chord, axis=-1, keepdims=True)
    if name == "sens":
        return p1, chord * np.float32(1.3), p2, act
    return p1, p2, chord, act


# ---------------------------------------------------------------------------
# the JAX references: one compile each a kind, the kind static
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=0)
def _jax_trace(kind, prm, coeff, p, v, dist, act, w):
    def f(pc):
        rif, sdf = _jfields(kind, *pc)
        out = jek.trace_curved(rif, sdf, p, v, dist, H, STEPS, act,
                               differentiable=True)
        return _weighted(out[:4], w), out[:5]
    return jax.value_and_grad(f, has_aux=True)((prm, coeff))


@functools.partial(jax.jit, static_argnums=0)
def _jax_sens(kind, prm, coeff, p1, v0, p2, act, w):
    def f(pc):
        rif, sdf = _jfields(kind, *pc)
        out = jek.integrate_with_sensitivities(
            rif, sdf, p1, v0, p2, H, STEPS, act, differentiable=True)
        return _weighted(out[:2] + out[3:], w), out
    return jax.value_and_grad(f, has_aux=True)((prm, coeff))


BVP_KW = dict(tol2=1e-8, max_restarts=2)


@functools.partial(jax.jit, static_argnums=0)
def _jax_bvp(kind, prm, coeff, p1, p2, chord, act, seed_bits, mask, w):
    def f(pc):
        rif, sdf = _jfields(kind, *pc)
        res = jek.solve_bvp(rif, sdf, p1, p2, chord, H, STEPS, act,
                            differentiable=True, seed_bits=seed_bits,
                            **BVP_KW)
        outs = (res.opt_len, res.geo_inside, res.geo_total, res.rev_dir)
        masked = [jnp.where(mask.reshape(mask.shape + (1,) * (o.ndim - 1)),
                            o, 0.0) for o in outs]
        return _weighted(masked, w), res
    return jax.value_and_grad(f, has_aux=True)((prm, coeff))


def _leaves(family):
    kind, prm = FAMILIES[family]
    return (kind, torch.from_numpy(prm.copy()).requires_grad_(),
            torch.from_numpy(COEFF.copy()).requires_grad_())


def _torch_grads(value, prm, coeff):
    g = torch.autograd.grad(value, (prm, coeff), allow_unused=True)
    return [np.zeros(t.shape, np.float32) if x is None else x.numpy()
            for x, t in zip(g, (prm, coeff))]


def _twsum(outs, weights):
    return sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))


@functools.cache
def _run(name, family):
    """(JAX outputs, JAX grads, port outputs, port grads) of a piece."""
    kind, prm, coeff = _leaves(family)
    jargs = (kind, jnp.asarray(FAMILIES[family][1]), jnp.asarray(COEFF))
    rif, sdf = _tfields(kind, prm, coeff)
    ins = _inputs(name)
    tin = [torch.from_numpy(x) for x in ins]
    if name == "trace":
        got = tek.trace_curved(rif, sdf, *tin[:3], H, STEPS, tin[3],
                               differentiable=True)
        w = _weights(got[:4], 10)
        (_, want), gj = _jax_trace(*jargs, *map(jnp.asarray, ins), w)
        gt = _torch_grads(_twsum(got[:4], w), prm, coeff)
        return want, gj, got[:5], gt
    if name == "sens":
        got = tek.integrate_with_sensitivities(
            rif, sdf, *tin[:3], H, STEPS, tin[3], differentiable=True)
        w = _weights(got[:2] + got[3:], 11)
        (_, want), gj = _jax_sens(*jargs, *map(jnp.asarray, ins), w)
        gt = _torch_grads(_twsum(got[:2] + got[3:], w), prm, coeff)
        return want, gj, got, gt
    n = ins[0].shape[0]
    seed_bits = np.asarray(jrng._hash_u32(
        jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
        + jnp.uint32(13)))
    res = tek.solve_bvp(rif, sdf, *tin[:3], H, STEPS, tin[3],
                        differentiable=True,
                        seed_bits=torch.from_numpy(seed_bits.astype(np.int64)),
                        **BVP_KW)
    outs = (res.opt_len, res.geo_inside, res.geo_total, res.rev_dir)
    w = _weights(outs, 12)
    jin = list(map(jnp.asarray, ins)) + [jnp.asarray(seed_bits)]
    (_, first), _ = _jax_bvp(*jargs, *jin, jnp.ones(n, bool), w)
    both = np.asarray(first.converged) & res.converged.numpy()
    (_, want), gj = _jax_bvp(*jargs, *jin, jnp.asarray(both), w)
    mask = torch.from_numpy(both)
    gt = _torch_grads(_twsum([torch.where(
        mask.reshape(mask.shape + (1,) * (o.dim() - 1)), o, 0.0)
        for o in outs], w), prm, coeff)
    return want, gj, res, gt


def _assert_grads(gj, gt, family, what):
    kind = FAMILIES[family][0]
    for i, field in enumerate(("params", "coeff")):
        want = np.asarray(gj[i])
        scale = np.abs(want).max()
        err = np.abs(gt[i] - want).max()
        print(f"{what} {family} d / d {field}: max |JAX| {scale:.4e}, "
              f"max |diff| / max |JAX| {err / scale if scale else err:.2e}")
        # the field the family reads carries a gradient, the other none
        reads = (field == "params") == (kind == tek.RIF_RADIAL)
        assert (scale > 0) == reads, (field, scale)
        if field == "params" and reads:
            assert (np.abs(want[:3]) > 0).all()    # p0, a and w
        assert err <= RTOL_GRAD * scale, (field, err, scale)


def _assert_outputs(got, want, atol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trace_curved_differentiable_matches_jax(family):
    want, gj, got, gt = _run("trace", family)
    ex = np.asarray(want[4])
    assert 0 < ex.mean() < 1            # lanes that leave and lanes that stop
    np.testing.assert_array_equal(got[4].numpy(), ex)
    for i in range(4):                  # p, v, opt, marched
        _assert_outputs(got[i], want[i], what=f"output {i}")
    _assert_grads(gj, gt, family, "trace_curved")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_integrate_with_sensitivities_differentiable_matches_jax(family):
    want, gj, got, gt = _run("sens", family)
    ex = np.asarray(want[2])
    assert 0 < ex.mean() < 1            # exiting and interior lanes
    np.testing.assert_array_equal(got[2].numpy(), ex)
    for i in (0, 1, 3, 4, 5, 6):        # err, J, opt, geo_in, geo_tot, v
        _assert_outputs(got[i], want[i], 1e-4 if i == 1 else 1e-5,
                        f"output {i}")
    _assert_grads(gj, gt, family, "integrate_with_sensitivities")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_solve_bvp_differentiable_matches_jax(family):
    want, gj, got, gt = _run("bvp", family)
    cj, ct = np.asarray(want.converged), got.converged.numpy()
    assert cj.mean() > 0.5
    assert (cj == ct).mean() >= 0.99
    both = cj & ct
    for f in ("dir_to_target", "weight", "opt_len", "geo_inside",
              "geo_total", "rev_dir"):
        _assert_outputs(getattr(got, f)[torch.from_numpy(both)],
                        np.asarray(getattr(want, f))[both], 1e-5, f)
    _assert_grads(gj, gt, family, "solve_bvp")


def test_the_kernel_route_follows_mode_and_fields(monkeypatch):
    """Kernels D and E (here their plain versions, on CPU tensors) run only
    in forward mode with an analytic RIF of kind <= RIF_RADIAL and an
    analytic SDF, the JAX package's _er_kernel_ok and its lax.cond; every
    other (mode, field) pair marches in the kernels' plain versions,
    called directly. The route is decided before any launch, never from a
    failed one."""
    from mitsubaer_tpu_torch.models import ermarch as tem

    calls = []
    for name in ("trace", "sens_march", "trace_plain", "sens_march_plain"):
        real = getattr(tem, name)
        monkeypatch.setattr(tem, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    p1, v, dist, act = map(torch.from_numpy, _inputs("trace", 8))
    p2 = torch.zeros_like(p1)
    grid = tspline.SplineGrid3D(torch.from_numpy(COEFF), torch.full((3,), LO),
                                torch.full((3,), HI))
    sphere = tek.SdfField(tek.SDF_SPHERE, tuple(SPHERE))
    cases = [
        (tek.RifField(tek.RIF_CONST, (1.3,)), sphere),
        (tek.RifField(tek.RIF_LINEAR, (1.3, 0.1)), sphere),
        (tek.RifField(tek.RIF_RADIAL, FAMILIES["radial"][1]), sphere),
        (tek.RifField(tek.RIF_RADIAL, FAMILIES["radial"][1], grid=grid),
         sphere),
        (tek.RifField(tek.RIF_SPLINE, (1.33,), grid=grid), sphere),
        (tek.RifField(tek.RIF_LINEAR, (1.3, 0.1)),
         tek.SdfField(tek.SDF_SPLINE, (), grid=grid._replace(
             coeff=grid.coeff - 1.4))),
    ]
    for i, (rif, sdf) in enumerate(cases):
        for differentiable in (False, True):
            calls.clear()
            tek.trace_curved(rif, sdf, p1, v, dist, H, 8, act,
                             differentiable=differentiable)
            tek.integrate_with_sensitivities(rif, sdf, p1, v, p2, H, 8, act,
                                             differentiable=differentiable)
            kernels = not differentiable and i < 3
            assert tek.kernel_route(rif, sdf, differentiable) == kernels
            want = (["trace", "trace_plain", "sens_march",
                     "sens_march_plain"] if kernels
                    else ["trace_plain", "sens_march_plain"])
            assert calls == want, (i, differentiable, calls)


def test_jax_acoustic_branch_is_dead():
    """JAX's RIF fields and their gradients with respect to the parameters
    and the coefficients, at the radial and spline kinds, are the same with
    the acoustic Bessel functions and with _acoustic_stub's zeros (eager
    JAX, 32 points)."""
    p = jnp.asarray(_inputs("trace", 32)[0])

    def fields(kind, prm, coeff):
        rif, _ = _jfields(kind, prm, coeff)
        v, g, hess = jek.rif_value_grad_hess(rif, p)
        return v.sum() + (g * g).sum() + (hess * hess).sum(), (v, g, hess)

    for kind, prm in FAMILIES.values():
        args = (kind, jnp.asarray(prm), jnp.asarray(COEFF))
        stub = jax.value_and_grad(fields, argnums=(1, 2), has_aux=True)(*args)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jek, "bessel_jm", _ACOUSTIC_BESSEL)
            real = jax.value_and_grad(fields, argnums=(1, 2),
                                      has_aux=True)(*args)
        for a, b in zip(jax.tree.leaves(stub), jax.tree.leaves(real)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
