"""The port's loop engine (integrators/volpath.py::li) and its Woodcock
tracking (models/medium.py::sample_distance_woodcock) against the JAX
package's on the CPU, per lane, at equal inputs and sampler streams; and the
two config repairs that came with it: `has_beam` (beam NEE follows the
config flag, not the scene) and `sampler` (carried, and refused by the
engines that would read it).

The JAX functions run jitted on the CPU, where DensityBricks.lookup takes
its f32 XLA branch; the port runs kernel A's plain version. The tracking
loops run until no lane runs and every lane draws at every step, so a lane
that decided a collision test differently by an ulp could shift every
lane's later dimensions: each test therefore first asserts that the
sampler dimensions (and with them the trip counts) equal JAX's. At these
sizes no lane of any case flipped a branch (measured: 0 of 400 lanes per
case, 0 of 4,096 Woodcock lanes); the tolerances below allow rung 2 of the
ROADMAP's parity ladder all the same.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.integrators import volpath as jvp
from mitsubaer_tpu.models import medium as jmedium
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.core import transform as tf
from mitsubaer_tpu_torch.integrators import common as tcommon
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

RES, SPPC, SEED = 10, 4, 7


def _env_box(B, types, integrator):
    """The heterogeneous box of volumetric_box lit by a constant
    environment and a point light, built by either package's SceneBuilder:
    escaped paths and environment NEE carry MIS weights, which
    volpath_simple drops."""
    b = B.SceneBuilder()
    zs = np.linspace(-1, 1, 16)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    med = b.add_medium(kind=types.MED_HETEROGENEOUS, sigma_a=(0.05,) * 3,
                       sigma_s=(0.5, 1.5, 3.0), phase_kind=types.PH_HG, g=0.5,
                       density=np.exp(-2.0 * (X * X + Y * Y + Z * Z)
                                      ).astype(np.float32),
                       density_aabb=((-1, -1, -1), (1, 1, 1)))
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    b.add_emitter(types.EM_CONSTANT, radiance=(0.4, 0.5, 0.6))
    b.add_emitter(types.EM_POINT, radiance=(30.0, 30.0, 30.0),
                  position=(-1.5, 0.8, 0.0))
    b.set_perspective_sensor(
        to_world=tf.look_at([-3, 0, 0], [-2, 0, 0], [0, 1, 0]),
        fov_deg=95.8402, fov_axis="x")
    kw = dict(width=RES, height=RES, spp=SPPC, max_depth=6,
              integrator=integrator)
    cfg = (b.config._replace(**kw) if hasattr(b.config, "_replace")
           else dataclasses.replace(b.config, **kw))
    return b.build(), cfg


def _box(kw):
    kw = dict(res=RES, spp=SPPC, max_depth=6, density_res=16, **kw)
    return jpresets.volumetric_box(**kw), tpresets.volumetric_box(**kw)


CASES = {
    "beam_heterogeneous": lambda: _box(dict(heterogeneous=True)),
    "beam_homogeneous": lambda: _box(dict(heterogeneous=False)),
    "point_heterogeneous": lambda: _box(dict(heterogeneous=True,
                                             emitter_kind="point")),
    "volpath_simple": lambda: (
        _env_box(jbuild, JT, "volpath_simple"),
        _env_box(tbuild, T, "volpath_simple")),
}


@functools.cache
def _li(name):
    """(JAX sink, JAX dims, port sink, port dims, port counts) of li on the
    first pass's camera rays."""
    (js, jc), (ts, tc) = CASES[name]()
    simple = tc.integrator == "volpath_simple"
    rays, _, smp = tcommon.camera_samples(ts, tc, SPPC, SEED, 0)
    got, smp_t, counts = tvp.li(ts, tc, rays.o, rays.d, smp, simple=simple)

    @jax.jit
    def run(o, d, lane, index):
        s = jrng.make_sampler(jnp.uint32(SEED), lane, index)
        s = s._replace(dim=s.dim + jnp.uint32(4))       # the camera draws
        sink, s = jvp.li(js, jc, o, d, s, simple=simple)
        return sink.steady, s.dim

    want, dim = run(rays.o.numpy(), rays.d.numpy(),
                    smp.lane.numpy().astype(np.uint32),
                    smp.index.numpy().astype(np.uint32))
    return (np.asarray(want), np.asarray(dim), got.numpy(),
            smp_t.dim.numpy(), counts)


@pytest.mark.parametrize("name", list(CASES))
def test_li_sinks_match_jax_per_lane(name):
    """Sinks within rtol 1e-4, atol 1e-6 on >= 98% of lanes, after the
    sampler dimensions agree on every lane."""
    want, dim_j, got, dim_t, counts = _li(name)
    np.testing.assert_array_equal(dim_t, dim_j)
    assert got.shape == want.shape == (RES * RES * SPPC, 3)
    assert np.isfinite(got).all() and (want.sum(-1) > 0).mean() > 0.03
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"li {name}: {int((~close).sum())} of {close.size} lanes differ")
    assert close.mean() >= 0.98, close.mean()
    bounces, wood = counts
    assert 2 <= bounces <= 2 * 6 + 8
    assert (wood > 0) == (name != "beam_homogeneous")


def test_volpath_simple_differs_from_volpath():
    """The MIS weights matter on the environment-lit box: volpath_simple's
    sinks differ from volpath's on the same streams."""
    _, (ts, tc) = CASES["volpath_simple"]()
    rays, _, smp = tcommon.camera_samples(ts, tc, SPPC, SEED, 0)
    a = tvp.li(ts, tc, rays.o, rays.d, smp, simple=True)[0]
    b = tvp.li(ts, tc, rays.o, rays.d, smp, simple=False)[0]
    assert not torch.allclose(a, b, rtol=1e-3)


def test_woodcock_matches_jax():
    """Trip counts (the sampler's dimensions) equal, hit equal on >= 99% of
    lanes, dist and weight within rtol 1e-5 on the agreeing lanes."""
    (js, _), (ts, _) = _box(dict(heterogeneous=True))
    n = 4096
    r = np.random.default_rng(5)
    o = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = r.uniform(0.0, 2.5, n).astype(np.float32)
    active = r.uniform(size=n) < 0.9
    idx = np.zeros(n, np.int32)
    lanes = np.arange(n, dtype=np.uint32)

    _, sa, ss, _, scale = jmedium.params(js.media, jnp.asarray(idx))
    hit_j, dist_j, w_j, _, smp_j, _ = jax.jit(
        lambda o, d, t, a: jmedium.sample_distance_woodcock(
            js.media, sa, ss, scale, o, d, t,
            jrng.make_sampler(jnp.uint32(9), lanes, 3), a,
            bricks=jmedium.DensityBricks(js.media)))(o, d, t_max, active)
    _, tsa, tss, tscale = tmedium.params(ts.media, torch.from_numpy(idx))
    out = tmedium.sample_distance_woodcock(
        ts.media, tsa, tss, tscale, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_max),
        trng.make_sampler(9, torch.from_numpy(lanes.astype(np.int64)), 3),
        torch.from_numpy(active))
    hit_t, dist_t, w_t, p_t, smp_t, iters, _ = out
    dim_j = np.asarray(smp_j.dim)
    np.testing.assert_array_equal(smp_t.dim.numpy(), dim_j)
    assert iters == int(dim_j[0]) // 8 > 1      # 4 steps of 2 draws each
    hit_j = np.asarray(hit_j)
    agree = hit_t.numpy() == hit_j
    print(f"Woodcock: {iters} iterations, hit differs on "
          f"{int((~agree).sum())} of {n} lanes")
    assert agree.mean() >= 0.99 and 0.2 < hit_j.mean() < 0.8
    np.testing.assert_allclose(dist_t.numpy()[agree], np.asarray(dist_j)[agree],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_t.numpy()[agree], np.asarray(w_j)[agree],
                               rtol=1e-5, atol=1e-6)
    assert not hit_t[~torch.from_numpy(active)].any()
    # p is the last tested point: the collision point on a hit lane
    h = hit_t.numpy()
    np.testing.assert_allclose(p_t.numpy()[h],
                               (o + dist_t.numpy()[:, None] * d)[h],
                               rtol=1e-6, atol=1e-6)


def _builder_beam_scene(B, types):
    """A beam-lit heterogeneous box made with a SceneBuilder (no preset),
    so its config keeps has_beam False."""
    b = B.SceneBuilder()
    zs = np.linspace(-1, 1, 16)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    med = b.add_medium(kind=types.MED_HETEROGENEOUS, sigma_a=(0.05,) * 3,
                       sigma_s=(0.5, 3.5, 7.5), phase_kind=types.PH_HG, g=0.7,
                       density=np.exp(-2.0 * (X * X + Y * Y + Z * Z)
                                      ).astype(np.float32),
                       density_aabb=((-1, -1, -1), (1, 1, 1)))
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    origin = np.array([-1.1, -1.1, -1.1])
    d = np.array([1.1, 1.1, 1.1]) - origin
    b.add_emitter(types.EM_COLLIMATED, radiance=(1e2,) * 3,
                  position=tuple(origin), direction=tuple(d / np.linalg.norm(d)))
    b.set_perspective_sensor(
        to_world=tf.look_at([-3, 0, 0], [-2, 0, 0], [0, 1, 0]),
        fov_deg=95.8402, fov_axis="x")
    kw = dict(width=8, height=8, spp=4, max_depth=4, integrator="volpath",
              filter="box")
    cfg = (b.config._replace(engine="wavefront", wf_track_mega=1, **kw)
           if hasattr(b.config, "_replace")
           else dataclasses.replace(b.config, **kw))
    return b.build(), cfg


def test_builder_beam_scene_has_no_beam_nee_in_either_package():
    """The has_beam repair: a SceneBuilder beam scene leaves has_beam
    False, and the wavefront engine then runs no beam NEE in either
    package; the radiance sums agree within rtol 1e-3 on >= 99% of pixels
    (the wavefront parity tests' tolerance)."""
    js, jc = _builder_beam_scene(jbuild, JT)
    ts, tc = _builder_beam_scene(tbuild, T)
    want, _ = jrender.render_pass_wavefront(
        js, jnp.zeros((64, 3), jnp.float32), jc, 4, jnp.uint32(3),
        jnp.uint32(1), has_direct=False, any_het=True)
    got, _ = trender.render_pass_wavefront(
        ts, torch.zeros((64, 3)), tc, 4, 3, 1, has_direct=False,
        any_het=True)
    want, got = np.asarray(want), got.numpy()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert jc.has_beam is False and tc.has_beam is False
    # with the flag set, the port adds the beam term
    beam, _ = trender.render_pass_wavefront(
        ts, torch.zeros((64, 3)), dataclasses.replace(tc, has_beam=True), 4,
        3, 1, has_direct=False, any_het=True)
    assert beam.sum() > 1.5 * got.sum()


def test_presets_set_has_beam_as_the_jax_presets():
    for kind in ("collimated", "point"):
        _, jc = jpresets.volumetric_box(res=4, emitter_kind=kind)
        _, tc = tpresets.volumetric_box(res=4, emitter_kind=kind)
        assert tc.has_beam == jc.has_beam == (kind == "collimated")
    jc = jpresets.volumetric_box(res=4, sampler="ldsampler")[1]
    assert T.config_from_dict(jc._asdict()).sampler == "ldsampler"


@pytest.mark.parametrize("engine,filt", [("loop", "gaussian"),
                                         ("wavefront", "box")])
@pytest.mark.parametrize("sampler", ["ldsampler", "sobol"])
def test_other_sampler_modes_raise_on_the_engines(engine, filt, sampler):
    """The sampler repair: the engines that read cfg.sampler refuse the
    modes the port lacks, naming ROADMAP step 1."""
    scene, cfg = tpresets.volumetric_box(
        res=4, spp=1, heterogeneous=True, density_res=8, max_depth=2,
        filter=filt, engine=engine, emitter_kind="point", sampler=sampler)
    with pytest.raises(NotImplementedError, match="step 1"):
        trender.render(scene, cfg, device="cpu")


def test_unknown_sampler_name_is_independent():
    """As rng.MODES.get(name, INDEPENDENT) in the JAX package."""
    scene, cfg = tpresets.volumetric_box(res=6, spp=2, heterogeneous=True,
                                         density_res=8, max_depth=3)
    a = trender.render(scene, cfg, seed=2, device="cpu")
    b = trender.render(scene, dataclasses.replace(cfg, sampler="custom"),
                       seed=2, device="cpu")
    assert torch.equal(a, b)
