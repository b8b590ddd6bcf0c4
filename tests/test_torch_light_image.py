"""The eikonal light image (volpath_er.render_er_light_image and
trace_er_particles: light particles through the refractive body, each
scatter vertex joined to the camera by the sensor-side BVP,
heterogeneousrefractive.cpp:960-992) and its emission sampler
(ptracer.sample_emitter_ray, the point and collimated branches; the
others are in tests/test_torch_misc.py) in the
port against the JAX package on the CPU.

The scene is tests/test_volpath_er.py::TestSensorSideConnections's: the
refractive sphere at 24^2 with a point light and a radial RIF (n0 1.33,
w 0.5), er_maxsteps 256, 4 BVP restarts, max_depth 4. JAX's light image is
one jit with the scene as an argument, so both lens strengths share its
compile; JAX's acoustic Bessel functions are zeros while this file runs
(the radial kind selects that branch away; see
tests/test_torch_er_grad.py::_acoustic_stub).

Tolerances: the emission rays' positions and weights equal, directions
within 2e-7 (sin and cos an ulp apart), every sampler dimension equal.
The films pass by pass (a pass splats 0-3 connections, each on its own
pixel): every pixel both packages lit within rtol 1e-3 (measured 1.4e-4),
and at most MAX_FLIPPED pixels lit by one package only. Those are
connections that the Levenberg stop test decided differently: through the
strong lens (a = 0.5) the three measured are JAX-accepted rounds that end
within ~1e-6 of tol2 after the 12 iterations, where the port ends a round
at 1.1e-4 from the same start, its marches and Jacobians equal to JAX's
within 3e-6 along the way (FMA contraction, ROADMAP "Known behaviour").
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import ptracer as jpt
from mitsubaer_tpu.integrators import volpath_er as jer
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.core import transform as ttf
from mitsubaer_tpu_torch.integrators import ptracer as tpt
from mitsubaer_tpu_torch.integrators import volpath_er as ter
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

# connections (pixels of a pass) that one package splats and the other
# does not, over PASSES passes, by lens strength (measured: 0 of 12 and 3
# of 11 JAX-lit; 12 and 8 pixels lit by both)
MAX_FLIPPED = {0.0: 1, 0.5: 4}
PASSES = 6


@pytest.fixture(scope="module", autouse=True)
def _acoustic_stub():
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


def _emitters(B, types, tf):
    b = B.SceneBuilder()
    b.add_emitter(types.EM_POINT, radiance=(40.0, 30.0, 20.0),
                  position=(2.0, 2.0, -2.0))
    b.add_emitter(types.EM_COLLIMATED, radiance=(5.0, 6.0, 7.0),
                  position=(-1.0, 0.5, 0.2), direction=(1.0, -0.2, 0.1))
    b.add_sphere([0, 0, 0], 1.0)
    b.set_perspective_sensor(tf.look_at([0, 0, -3.5], [0, 0, 0], [0, 1, 0]),
                             45.0)
    return b.build()


def test_emission_rays_match_jax():
    """sample_emitter_ray's point and collimated branches against JAX's
    _sample_emitter_ray on the same sampler: the emitter picked, the ray
    and its weight, and the three draws on every lane (the sampler's
    dimension after them)."""
    js, ts = _emitters(jbuild, JT, ttf), _emitters(tbuild, T, ttf)
    n = 4096
    lane = np.arange(n, dtype=np.uint32)
    smp_j = jrng.make_sampler(jnp.uint32(7) ^ jnp.uint32(0xE51),
                              jnp.asarray(lane), jnp.uint32(1))
    o, d, w, med, _, _, smp_j, e_j, _ = jpt._sample_emitter_ray(js, smp_j)
    smp_t = trng.make_sampler(7 ^ 0xE51, torch.from_numpy(lane.astype(
        np.int64)), 1)
    o_t, d_t, w_t, med_t, smp_t, e_t, kind_t = tpt.sample_emitter_ray(
        ts, smp_t)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert 0.4 < float((kind_t == T.EM_POINT).float().mean()) < 0.6
    np.testing.assert_array_equal(smp_t.dim.numpy(), np.asarray(smp_j.dim))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w))
    np.testing.assert_array_equal(med_t.numpy(), np.asarray(med))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d), rtol=0,
                               atol=2e-7)


def test_other_emitters_raise():
    """The constant emitter's branch, which used to raise, samples its
    rays now (tests/test_torch_misc.py holds every branch against JAX):
    from the bounding sphere's disk, finite, with weight L 4 pi^2 R^2."""
    b = tbuild.SceneBuilder()
    b.add_emitter(T.EM_CONSTANT, radiance=(1.0, 1.0, 1.0))
    b.add_sphere([0, 0, 0], 1.0)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    o, d, w, _, _, _, kind = tpt.sample_emitter_ray(
        b.build(), trng.make_sampler(0, torch.arange(4), 0))
    assert bool((kind == T.EM_CONSTANT).all())
    assert bool(torch.isfinite(o).all() & torch.isfinite(d).all())
    R = 0.5 * np.sqrt(12.0) * 1.01
    np.testing.assert_allclose(w.numpy(), 4 * np.pi ** 2 * R * R,
                               rtol=1e-5)


def _scenes(P, a):
    scene, cfg = P.refractive_sphere(
        res=24, spp=1, max_depth=4, rif_kind=jek.RIF_RADIAL,
        rif_params=(1.33, a, 0.5, 0.0, 0.0, 0.0), er_stepsize=0.02,
        emitter="point", filter="box")
    kw = dict(er_maxsteps=256, bvp_restarts=4)
    return scene, (cfg._replace(**kw) if hasattr(cfg, "_replace")
                   else dataclasses.replace(cfg, **kw))


@functools.cache
def _port_passes(a):
    """The port's per-pass films, (PASSES, H * W, 3)."""
    scene, cfg = _scenes(tpresets, a)
    return np.stack([ter.trace_er_particles(scene, cfg, 576, 0, i).numpy()
                     for i in range(PASSES)])


_jax_trace = jax.jit(jer.trace_er_particles,
                     static_argnames=("cfg", "n_particles"))


@pytest.mark.parametrize("a", [0.0, 0.5])
def test_light_image_matches_jax(a):
    """Each pass's film (576 particles) against JAX's trace_er_particles
    at the same seed and pass; render_er_light_image is their mean over
    the particles."""
    js, jc = _scenes(jpresets, a)
    want = np.stack([np.asarray(_jax_trace(js, jc, n_particles=576,
                                           seed=jnp.uint32(0),
                                           pass_idx=jnp.uint32(i)))
                     for i in range(PASSES)])
    got = _port_passes(a)
    assert np.isfinite(got).all()
    lit_j, lit_t = want.sum(-1) > 0, got.sum(-1) > 0
    both = lit_j & lit_t
    close = np.isclose(got, want, rtol=1e-3, atol=0).all(-1)
    apart = int((lit_j ^ lit_t).sum())
    print(f"light image a={a}: {int(lit_j.sum())} JAX connections, "
          f"{int(lit_t.sum())} the port's, {apart} in one only")
    assert both.sum() >= 6
    assert close[both].all()
    assert apart <= MAX_FLIPPED[a]
    img = ter.render_er_light_image(*_scenes(tpresets, a), seed=0,
                                    n_passes=2, device="cpu").numpy()
    np.testing.assert_allclose(img.reshape(-1, 3),
                               got[:2].sum(0) / (2 * 576), rtol=1e-6)


def test_light_image_renders_and_responds_to_rif():
    """tests/test_volpath_er.py::TestSensorSideConnections::
    test_light_image_renders_and_responds_to_rif on the port (3 passes): a
    strong lens (a = 0.5) redistributes the splats of the constant-index
    sphere (a = 0) by more than 0.05 in normalised L1."""
    img, img2 = (_port_passes(a)[:3].sum(0) / (3 * 576) for a in (0.0, 0.5))
    for x in (img, img2):
        assert np.isfinite(x).all() and x.sum() > 0
    a, b = img.sum(-1), img2.sum(-1)
    a, b = a / max(a.sum(), 1e-9), b / max(b.sum(), 1e-9)
    assert np.abs(a - b).sum() > 0.05, np.abs(a - b).sum()


def test_light_image_runs_on_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ter.render_er_light_image(*_scenes(tpresets, 0.0), n_passes=1)
