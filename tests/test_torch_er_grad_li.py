"""The port's eikonal gradient, `volpath_er.li(differentiable=True)`, against
the JAX package's on the CPU, for both RIF families, as bench.py's
bench_er_grad and tests/test_inverse.py::render_er_diff build the loss
(the mean of the sink over res^2 x sppc lanes).

The scene is tests/test_inverse.py::spline_rif_sphere (a Gaussian index
bump on a 12^3 grid over [-1.2, 1.2]^3, a unit-sphere SDF, a point light,
h 0.05, er_maxsteps 96) at res 4, sppc 2, max_depth 3 (the first depth at
which a path reaches a curved NEE connection, so that the gradients are
not zero) and 2 BVP restarts, built by each package's SceneBuilder from
the same samples. The radial family replaces the kind by RIF_RADIAL and
the parameters by (1.33, 0.1, 0.5, 0.05, -0.05, 0).

The JAX reference of each family is one jitted value_and_grad with
respect to the field it reads (rif_params or rif_coeff), the image and
the final sampler's dimension its aux output. The scene, the config and
the RIF kind are closed over, as test_inverse.py's jit closes over its
scene, and JAX's acoustic-RIF Bessel functions are zeros while the file
runs (tests/test_torch_er_grad.py::_acoustic_stub, which also holds the
fields equal with and without them). A traced kind compiles every RIF
kind's branch for each family, and each branch's backward: on a CPU
one such compile for both families had not finished after 18 minutes, at
~28 GiB; with the kind closed over and the Bessel functions in, the
spline family lowered to 40.6 MB of HLO and had not compiled after 11
minutes (15 GiB); without them, 7.0 MB, 36 s to lower and 31 s to
compile. The field a family does not read gets no JAX gradient; the
port's is held at zero.

Tolerances: lane by lane, at most MAX_FLIPPED lanes whose sinks differ
by more than 1e-4 of the largest; over the others, the loss within rtol
1e-4 and the image within 1e-4 of its largest pixel; each gradient field
within 1e-3 of its largest JAX magnitude. Measured on the CPU: radial, no
lane flipped, the loss within 1.6e-6, the sinks within 8.2e-6, the
gradient within 7.8e-5; spline, one lane flipped (the loss 4.81e-2
against 3.90e-2), the other sinks within 4.7e-7, the gradient within
6.5e-5.

The flipped lane is JAX's programs disagreeing with each other, not the
port's restart loop (scripts/er_flip_witness.py, which records every
restart round of each run). Lane 26 tries one connection, at bounce 1,
whose inputs differ by at most 2.1e-7 between the runs. The port's two
rounds end at Levenberg costs 9.84e-7 and 3.9e-8 (bvp_tol2 1e-6), the
re-find distance at 0.0015 of its tolerance: accepted. JAX's forward,
jitted alone, ends them at 7.9e-7 and 7.4e-9: accepted, and its sink
there equals the port's (0.29143; its loss 4.808028e-2 against the
port's 4.808025e-2, no lane apart). Only the value_and_grad program this
file compiles ends round 1 at 3.5e-6 and drops the connection.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.integrators import volpath_er as jer
from mitsubaer_tpu.models import sensor as jsensor
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.core import transform as ttf
from mitsubaer_tpu_torch.integrators import volpath_er as ter
from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.models import sensor as tsensor
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

RES, SPPC, SEED = 4, 2, 0
RTOL_LOSS, RTOL_IMG, RTOL_GRAD = 1e-4, 1e-4, 1e-3
MAX_FLIPPED = 1         # lanes of the 32 whose sinks may differ (above)
FAMILIES = {
    "radial": (tek.RIF_RADIAL, np.array([1.33, 0.1, 0.5, 0.05, -0.05, 0.0,
                                         0, 0], np.float32)),
    "spline": (tek.RIF_SPLINE, np.array([1.33, 0, 0, 0, 0, 0, 0, 0],
                                        np.float32)),
}


def _rif_samples(n=12, amp=0.15):
    zs = np.linspace(-1.2, 1.2, n)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    return (1.33 + amp * np.exp(-(X**2 + Y**2 + Z**2) / 0.36)).astype(
        np.float32)


def _spline_rif_sphere(B, types, tf):
    """tests/test_inverse.py::spline_rif_sphere at this file's size, in
    either package."""
    b = B.SceneBuilder()
    med = b.add_medium(
        kind=types.MED_REFRACTIVE, sigma_a=(0.02,) * 3, sigma_s=(0.4,) * 3,
        rif_kind=tek.RIF_SPLINE, rif=_rif_samples(),
        rif_aabb=((-1.2,) * 3, (1.2,) * 3), sdf_kind=tek.SDF_SPHERE,
        sdf_params=(0.0, 0.0, 0.0, 1.0))
    b.add_sphere([0, 0, 0], 1.0, bsdf=-1, interior=med)
    b.add_emitter(types.EM_POINT, radiance=(40.0,) * 3,
                  position=(2.0, 2.0, -2.0))
    b.set_perspective_sensor(tf.look_at([0, 0, -3.5], [0, 0, 0], [0, 1, 0]),
                             40)
    kw = dict(width=RES, height=RES, spp=1, max_depth=3,
              integrator="volpath_er", er_stepsize=0.05, er_maxsteps=96,
              bvp_restarts=2)
    b.config = (b.config._replace(**kw) if hasattr(b.config, "_replace")
                else dataclasses.replace(b.config, **kw))
    # the JAX builder adds the scene's BSDF, phase and sensor kinds to the
    # config at build(): jit compiles only those
    return b.build(), b.config


@functools.cache
def _jax_value_and_grad(family):
    """The jitted value_and_grad of render_er_diff's mean with respect to
    the field the family reads; aux: the image and the final sampler's
    dim."""
    (scene, cfg), _ = _scenes()
    kind, prm = FAMILIES[family]
    coeff = scene.media.rif_coeff
    H, W = cfg.height, cfg.width
    npix = H * W

    def loss(x):
        pc = (x, coeff) if kind == tek.RIF_RADIAL else (jnp.asarray(prm), x)
        media = scene.media._replace(rif_kind=jnp.int32(kind),
                                     rif_params=pc[0], rif_coeff=pc[1])
        sc = scene._replace(media=media)
        pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (SPPC,))
        sidx = jnp.repeat(jnp.arange(SPPC, dtype=jnp.uint32), npix)
        smp = jrng.make_sampler(jnp.uint32(SEED), pixel, sidx)
        jitter, smp = jrng.next_2d(smp)
        px = (pixel % W).astype(jnp.float32) + jitter[:, 0]
        py = (pixel // W).astype(jnp.float32) + jitter[:, 1]
        rays = jsensor.sample_rays(sc.sensor, px, py, W, H)
        sink, smp = jer.li(sc, cfg, rays.o, rays.d, smp, pixel=pixel,
                           differentiable=True)
        img = sink.steady.reshape(SPPC, H, W, 3).mean(axis=0)
        return jnp.mean(sink.steady), (img, smp.dim, sink.steady)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port(scene, cfg, kind, prm, coeff):
    """(loss, image, final sampler dims, d loss / d rif_params,
    d loss / d rif_coeff) of the port at fresh leaves."""
    prm = torch.from_numpy(prm.copy()).requires_grad_()
    coeff = torch.from_numpy(coeff.copy()).requires_grad_()
    media = dataclasses.replace(
        scene.media, rif_kind=torch.tensor(kind, dtype=torch.int32),
        rif_params=prm, rif_coeff=coeff)
    sc = dataclasses.replace(scene, media=media)
    H, W = cfg.height, cfg.width
    npix = H * W
    pixel = torch.arange(npix).repeat(SPPC)
    smp = trng.make_sampler(SEED, pixel,
                            torch.repeat_interleave(torch.arange(SPPC), npix))
    jitter, smp = trng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jitter[:, 0]
    py = (pixel // W).to(torch.float32) + jitter[:, 1]
    rays = tsensor.sample_rays(sc.sensor, px, py, W, H)
    sink, smp, _ = ter.li(sc, cfg, rays.o, rays.d, smp, differentiable=True)
    sink = sink.steady
    loss = sink.mean()
    grads = torch.autograd.grad(loss, (prm, coeff), allow_unused=True)
    return (loss.item(), sink.detach().reshape(SPPC, H, W, 3).mean(0).numpy(),
            smp.dim.numpy(), *[np.zeros(t.shape, np.float32) if g is None
                               else g.numpy()
                               for g, t in zip(grads, (prm, coeff))],
            sink.detach().numpy())


@functools.cache
def _scenes():
    return (_spline_rif_sphere(jbuild, JT, jtf),
            _spline_rif_sphere(tbuild, T, ttf))


@functools.cache
def _run(family):
    _, (ts, tc) = _scenes()
    kind, prm = FAMILIES[family]
    coeff = ts.media.rif_coeff.numpy()
    radial = kind == tek.RIF_RADIAL
    (loss_j, (img_j, dim_j, sink_j)), grad_j = _jax_value_and_grad(family)(
        jnp.asarray(prm if radial else coeff))
    grad_j = np.asarray(grad_j)
    want = (float(loss_j), np.asarray(img_j), np.asarray(dim_j),
            grad_j if radial else None, None if radial else grad_j,
            np.asarray(sink_j))
    return want, _port(ts, tc, kind, prm, coeff)


@pytest.fixture(scope="module")
def run():
    return _run


@pytest.fixture(scope="module", autouse=True)
def _acoustic_stub():
    """JAX's acoustic-RIF Bessel functions as zeros while this file runs
    (see tests/test_torch_er_grad.py::_acoustic_stub)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


def test_scene_equals_jax_build():
    """The port's builder gives the JAX builder's scene, the spline
    coefficients (each package prefilters the same samples) among them."""
    (js, _), (ts, _) = _scenes()
    for f in ("rif_kind", "rif_params", "rif_coeff", "rif_min", "rif_max",
              "sdf_kind", "sdf_params", "sigma_a", "sigma_s"):
        np.testing.assert_array_equal(getattr(ts.media, f).numpy(),
                                      np.asarray(getattr(js.media, f)),
                                      err_msg=f)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_image_match_jax(run, family):
    """Lane by lane: at most MAX_FLIPPED lanes differ (a connection that one
    program's restart loop accepts and another's does not: the Levenberg
    iterates differ in their last bits, and the stopping test decides on
    them; see the module docstring); the other lanes, their loss and the
    pixels they alone cover agree within RTOL_IMG and RTOL_LOSS."""
    want, got = run(family)
    sink_j, sink_t = want[5], got[5]
    scale = np.abs(sink_j).max()
    flipped = np.abs(sink_t - sink_j).max(-1) > RTOL_IMG * scale
    same = ~flipped
    H, W = want[1].shape[:2]
    clean = ~flipped.reshape(SPPC, H, W).any(0)
    print(f"{family} loss: JAX {want[0]:.8e}, port {got[0]:.8e}; lanes "
          f"flipped {int(flipped.sum())} of {flipped.size}; over the others "
          f"max |diff| / max |JAX| "
          f"{np.abs(sink_t - sink_j)[same].max() / scale:.2e}")
    assert np.isfinite(got[0]) and got[0] > 0
    assert flipped.sum() <= MAX_FLIPPED
    np.testing.assert_allclose(sink_t[same].mean(), sink_j[same].mean(),
                               rtol=RTOL_LOSS)
    np.testing.assert_allclose(got[1][clean], want[1][clean], rtol=0,
                               atol=RTOL_IMG * np.abs(want[1]).max())
    if not flipped.any():
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL_LOSS)
    # the sampler after JAX's fixed-trip scan: the trips the port did not
    # run are skipped by their draws
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("field", ["rif_params", "rif_coeff"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_gradient_matches_jax(run, family, field):
    want, got = run(family)
    i = 3 if field == "rif_params" else 4
    w, g = want[i], got[i]
    assert np.isfinite(g).all()
    if w is None:
        # the family does not read this field: no gradient in either
        assert not g.any()
        return
    scale = np.abs(w).max()
    err = np.abs(g - w).max()
    print(f"{family} d loss / d {field}: max |JAX| {scale:.4e}, max |diff| "
          f"/ max |JAX| {err / scale:.2e}")
    assert scale > 0
    if field == "rif_params":
        assert (np.abs(w[:3]) > 0).all()        # p0, a and w
    assert err <= RTOL_GRAD * scale, (err, scale)


def test_checkpointed_li_gives_the_uncheckpointed_gradients(monkeypatch):
    """li(differentiable=True) with each bounce under a checkpoint against
    the same loop with none, on the radial family: equal loss and
    gradients. The recomputed bounce sees the forward's `iters` and
    sampler, so it seeds the same BVP restarts."""
    (_, _), (ts, tc) = _scenes()
    kind, prm = FAMILIES["radial"]
    coeff = ts.media.rif_coeff.numpy()
    bodies = []
    body = ter.body

    def counting_body(scene, cfg, s, *a, **k):
        bodies.append(s.iters)
        return body(scene, cfg, s, *a, **k)

    monkeypatch.setattr(ter, "body", counting_body)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        ck = _port(ts, tc, kind, prm, coeff)
    # every bounce ran twice, in the forward and in the recompute
    assert len(bodies) == 2 * len(set(bodies)) >= 4
    monkeypatch.setattr(ter, "_checkpointed", lambda step, s: step(s))
    plain = _port(ts, tc, kind, prm, coeff)
    assert ck[0] == plain[0]
    for a, b in zip(ck[1:], plain[1:]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(ck[3]).max() > 0
