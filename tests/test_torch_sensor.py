"""The port's sensors against the JAX package's: every kind's rays lane by
lane at 4,096 lanes (with and without the lens sample, with and without
the kind hint; within 1e-5), the builder's sensor fields equal, and each
kind rendered on the cbox's loop road (and the thin lens on the wavefront
and eikonal roads) against JAX's image. The training path's thin lens
puts every ray at the lens centre, as JAX's (diff/render.py:88)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import sensor as jsensor
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import sensor as tsensor
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

N = 4096
KINDS = list(range(9))
LENS = dict(aperture=0.3, focus=4.0)


def _sensor(P, kind, w=24, h=16):
    b = P.SceneBuilder()
    b.set_sensor(kind, jtf.look_at([0.5, 1.0, -4.0], [0, 0, 0], [0, 1, 0]),
                 fov_deg=50.0, width=w, height=h, **LENS)
    b.add_sphere([0, 0, 0], 1.0)
    return b.build(), b.config


def _kc(scene, P):
    """Radial distortion coefficients (the builders leave them 0)."""
    kc = np.array([0.1, -0.05], np.float32)
    if P is jbuild:
        return scene._replace(sensor=scene.sensor._replace(
            kc=jnp.asarray(kc)))
    return dataclasses.replace(scene, sensor=dataclasses.replace(
        scene.sensor, kc=torch.from_numpy(kc)))


@pytest.mark.parametrize("lens", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_sample_rays_match_jax(kind, lens):
    (js, jc), (ts, tc) = _sensor(jbuild, kind), _sensor(tbuild, kind)
    js, ts = _kc(js, jbuild), _kc(ts, tbuild)
    assert tc.sensor_kind == jc.sensor_kind == kind
    for f in ("kind", "to_world", "tan_x", "tan_y", "near", "far",
              "aperture", "focus"):
        np.testing.assert_array_equal(getattr(ts.sensor, f).numpy(),
                                      np.asarray(getattr(js.sensor, f)))
    r = np.random.default_rng(kind)
    px = r.uniform(0, 24, N).astype(np.float32)
    py = r.uniform(0, 16, N).astype(np.float32)
    u = r.random((N, 2), dtype=np.float32) if lens else None
    want = jsensor.sample_rays(js.sensor, jnp.asarray(px), jnp.asarray(py),
                               24, 16, u_lens=None if u is None
                               else jnp.asarray(u))
    for hint in (-1, kind):
        got = tsensor.sample_rays(ts.sensor, torch.from_numpy(px),
                                  torch.from_numpy(py), 24, 16,
                                  u_lens=None if u is None
                                  else torch.from_numpy(u), kind_hint=hint)
        np.testing.assert_allclose(got.o.numpy(), np.asarray(want.o),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.d.numpy(), np.asarray(want.d),
                                   rtol=1e-5, atol=1e-5)


def _cbox_kind(P, kind, **kw):
    scene, cfg = P.cornell_box(res=10, spp=2, max_depth=3, **kw)
    sensor = scene.sensor
    if P is jpresets:
        sensor = sensor._replace(kind=jnp.asarray(kind, jnp.int32),
                                 aperture=jnp.asarray(0.05, jnp.float32),
                                 focus=jnp.asarray(3.0, jnp.float32))
        # sensor_kind -1: JAX compiles all nine models once for every kind
        return scene._replace(sensor=sensor), cfg._replace(sensor_kind=-1)
    sensor = dataclasses.replace(
        sensor, kind=torch.tensor(kind, dtype=torch.int32),
        aperture=torch.tensor(0.05), focus=torch.tensor(3.0))
    return (dataclasses.replace(scene, sensor=sensor),
            dataclasses.replace(cfg, sensor_kind=kind))


@pytest.mark.parametrize("kind", KINDS)
def test_loop_road_renders_each_kind_as_jax(kind):
    """The 10x10 cbox path render, depth 3, with each sensor kind (thin lens
    aperture 0.05 focused at 3; the port's config names the kind, JAX's
    compiles every model): within 1e-3 of JAX's image on >= 95% of the
    pixels."""
    js, jc = _cbox_kind(jpresets, kind)
    ts, tc = _cbox_kind(tpresets, kind)
    want = np.asarray(jrender.render(js, jc, seed=1))
    got = trender.render(ts, tc, seed=1, device="cpu").numpy()
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.95, close.mean()


def test_thin_lens_on_the_wavefront_road_matches_jax():
    js, jc = _cbox_kind(jpresets, T.SENSOR_THINLENS, filter="box")
    ts, tc = _cbox_kind(tpresets, T.SENSOR_THINLENS, filter="box")
    want = np.asarray(jrender.render(js, jc, seed=1))
    got = trender.render(ts, tc, seed=1, device="cpu").numpy()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.95, close.mean()
    assert got.mean() > 0


def test_training_thin_lens_is_the_lens_centre():
    """The training path draws no lens sample (diff/render.py:88): its thin
    lens renders as the pinhole through the lens centre, the same image as
    the perspective sensor's with the same focus-scaled direction."""
    from mitsubaer_tpu_torch.diff import render as tdr
    scene, cfg = tpresets.volumetric_box(res=6, spp=2, heterogeneous=True,
                                         density_res=8, max_depth=2)
    thin = dataclasses.replace(scene, sensor=dataclasses.replace(
        scene.sensor, kind=torch.tensor(T.SENSOR_THINLENS, dtype=torch.int32),
        aperture=torch.tensor(0.5), focus=torch.tensor(2.0)))
    p = tdr.get_params(scene)
    with torch.no_grad():
        a = tdr.render_diff(thin, p, cfg, 2, 5, 0, device="cpu")
        b = tdr.render_diff(scene, p, cfg, 2, 5, 0, device="cpu")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # the loop road's thin lens draws u_lens: a different image
    c = trender.render(thin, dataclasses.replace(
        cfg, sensor_kind=T.SENSOR_THINLENS), seed=5, device="cpu")
    d = trender.render(scene, cfg, seed=5, device="cpu")
    assert not torch.allclose(c, d)
