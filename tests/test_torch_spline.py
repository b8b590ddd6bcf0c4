"""The B-spline field of the port (mitsubaer_tpu_torch/core/spline.py) and
the spline RIF and SDF of its eikonal core against the JAX package on
numpy-seeded inputs: the prefilter exactly; value, gradient and Hessian at
random points inside, outside and on the faces of a random grid, within
1e-6 of each output's largest magnitude; the coefficient gradient of a
scalar of value and of value_gradient by torch.autograd against jax.grad
within 1e-5 of its largest magnitude; the spline fields through
eikonal.rif_value_grad_hess and sdf_value, and the builder's prefiltered
grids against the JAX builder's. Measured on the CPU: outputs within
3.1e-7, coefficient gradients within 1.6e-7, of their largest
magnitudes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import spline as jspline
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import spline as tspline
from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

LO = np.array([-1.0, -0.5, -1.2], np.float32)
HI = np.array([1.0, 0.7, 1.1], np.float32)
SHAPES = [(5, 6, 7), (4, 4, 4), (1, 5, 3)]


def _samples(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _points(n, seed):
    """Points in and around the box, a fifth of them on its faces and
    edges (where the cell clamp puts t at 0 or 1)."""
    r = np.random.default_rng(seed)
    p = r.uniform(LO - 0.3, HI + 0.3, (n, 3)).astype(np.float32)
    k = n // 5
    axis = r.integers(0, 3, k)
    p[np.arange(k), axis] = np.where(r.uniform(size=k) < 0.5, LO[axis],
                                     HI[axis])
    return p


def _grids(coeff):
    return (jspline.SplineGrid3D(jnp.asarray(coeff), jnp.asarray(LO),
                                 jnp.asarray(HI)),
            tspline.SplineGrid3D(torch.from_numpy(coeff),
                                 torch.from_numpy(LO), torch.from_numpy(HI)))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_prefilter_matches_exactly(shape):
    data = _samples(shape, 0)
    np.testing.assert_array_equal(tspline.prefilter(data),
                                  jspline.prefilter(data))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_value_gradient_hessian_match(shape):
    coeff = jspline.prefilter(_samples(shape, 1))
    jg, tg = _grids(coeff)
    p = _points(600, 2)
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    _close(tspline.value(tg, pt), jspline.value(jg, pj), 1e-6, "value")
    for name, jf, tf in (
            ("value_gradient", jspline.value_gradient,
             tspline.value_gradient),
            ("value_gradient_hessian", jspline.value_gradient_hessian,
             tspline.value_gradient_hessian)):
        for i, (w, g) in enumerate(zip(jf(jg, pj), tf(tg, pt))):
            _close(g, w, 1e-6, f"{name}[{i}]")


def test_coefficient_gradients_match_jax():
    """d/dcoeff of sum(a value) + sum(b gradient) at seeded weights a, b:
    the port's gather backward (a scatter-add) against jax.grad."""
    coeff = jspline.prefilter(_samples((6, 5, 7), 3))
    p = _points(500, 4)
    r = np.random.default_rng(5)
    a = r.normal(size=500).astype(np.float32)
    b = r.normal(size=(500, 3)).astype(np.float32)

    def jf(c):
        g = jspline.SplineGrid3D(c, jnp.asarray(LO), jnp.asarray(HI))
        v, grad = jspline.value_gradient(g, jnp.asarray(p))
        return (jnp.sum(jspline.value(g, jnp.asarray(p)) * a)
                + jnp.sum(grad * b) + jnp.sum(v * a))

    want = jax.grad(jf)(jnp.asarray(coeff))
    c = torch.from_numpy(coeff).requires_grad_()
    g = tspline.SplineGrid3D(c, torch.from_numpy(LO), torch.from_numpy(HI))
    pt = torch.from_numpy(p)
    v, grad = tspline.value_gradient(g, pt)
    out = ((tspline.value(g, pt) * torch.from_numpy(a)).sum()
           + (grad * torch.from_numpy(b)).sum()
           + (v * torch.from_numpy(a)).sum())
    (got,) = torch.autograd.grad(out, c)
    assert np.abs(np.asarray(want)).max() > 0
    _close(got, want, 1e-5, "d / d coeff")


def _spline_fields(rif_coeff, sdf_coeff):
    """(JAX RifField, JAX SdfField, port RifField, port SdfField) of a
    spline RIF and a spline SDF over the same box."""
    lo, hi = jnp.asarray(LO), jnp.asarray(HI)
    prm = np.array([1.4, 0, 0, 0, 0, 0, 0, 0], np.float32)
    jr = jek.RifField(kind=jnp.int32(jek.RIF_SPLINE), params=jnp.asarray(prm),
                      coeff=jnp.asarray(rif_coeff), aabb_min=lo, aabb_max=hi)
    js = jek.SdfField(kind=jnp.int32(jek.SDF_SPLINE),
                      params=jnp.zeros(8, jnp.float32),
                      coeff=jnp.asarray(sdf_coeff), aabb_min=lo, aabb_max=hi)
    tr = tek.RifField(tek.RIF_SPLINE, tuple(prm),
                      grid=_grids(rif_coeff)[1])
    ts = tek.SdfField(tek.SDF_SPLINE, (), grid=_grids(sdf_coeff)[1])
    return jr, js, tr, ts


def test_spline_rif_and_sdf_fields_match():
    rif_coeff = jspline.prefilter(1.3 + 0.1 * _samples((6, 7, 5), 6))
    sdf_coeff = jspline.prefilter(_samples((5, 6, 6), 7))
    jr, js, tr, ts = _spline_fields(rif_coeff, sdf_coeff)
    p = _points(512, 8)
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    for i, (w, g) in enumerate(zip(jek.rif_value_grad_hess(jr, pj),
                                   tek.rif_value_grad_hess(tr, pt))):
        _close(g, w, 1e-6, f"rif_value_grad_hess[{i}]")
    _close(tek.rif_value(tr, pt), jek.rif_value(jr, pj), 1e-6, "rif_value")
    _close(tek.sdf_value(ts, pt), jek.sdf_value(js, pj), 1e-6, "sdf_value")
    _close(tek.sdf_gradient(ts, pt), jek.sdf_gradient(js, pj), 1e-6,
           "sdf_gradient")


def _refractive_scene(B, types, rif, sdf):
    b = B.SceneBuilder()
    b.add_medium(kind=types.MED_REFRACTIVE, sigma_s=(0.4,) * 3,
                 rif_kind=4, rif=rif, rif_aabb=(tuple(LO), tuple(HI)),
                 sdf_kind=3, sdf=sdf, sdf_aabb=((-1.5,) * 3, (1.5,) * 3))
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 40)
    return b.build()


def test_builder_prefilters_the_grids_as_jax():
    """SceneBuilder.add_medium(rif=, rif_aabb=, sdf=, sdf_aabb=) in both
    packages from the same samples; the media's grids, boxes and the
    fields read from them agree, and an analytic medium keeps JAX's
    (1, 1, 1) ones."""
    rif, sdf = _samples((6, 5, 4), 9) * 0.1 + 1.3, _samples((4, 4, 5), 10)
    jm = _refractive_scene(jbuild, JT, rif, sdf).media
    tm = _refractive_scene(tbuild, T, rif, sdf).media
    for f in ("rif_coeff", "rif_min", "rif_max", "sdf_coeff", "sdf_min",
              "sdf_max"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    r, s = tek.rif_from_media(tm), tek.sdf_from_media(tm)
    assert r.grid is not None and s.grid is not None
    assert not tek.kernel_route(r, s, differentiable=False)
    b = tbuild.SceneBuilder()
    b.add_medium(kind=T.MED_REFRACTIVE, rif_kind=2, rif_params=(1.3, 0.1))
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 40)
    media = b.build().media
    assert media.rif_coeff.shape == media.sdf_coeff.shape == (1, 1, 1)
    assert bool((media.rif_coeff == 1).all())
    assert tek.rif_from_media(media).grid is None
