"""The port's environment map against the JAX package's: the builder's
sampling tables and the Preetham sky equal, the map's lookup, sampling
and pdf lane by lane at 4,096 lanes (within 1e-5 relative; a sample whose
u falls within an ulp of a texel edge may land in the neighbouring texel
in one package, so at most 0.5% of the lanes may differ), direct sampling
of an environment-map emitter, tests/test_texture_bsdf.py::TestEnvmap
ported, and the sky-lit floor and boxes on the loop and wavefront roads
against JAX's images."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import emitter as jemitter
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import emitter as temitter
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

N = 4096
SUN = (0.4, 0.3, 0.7)
# env frame (z-up) to the cbox's y-up world: env z -> world y
Z_TO_Y = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
                  np.float32)
ENV_TABLES = ("env_map", "env_cdf_rows", "env_cdf_cond", "env_to_world",
              "env_scale")


def sky_scene(P, B, res=8, spp=2, max_depth=3, sky_res=16, **cfg_kw):
    """The sky-lit scene: the cbox's floor (widened) and two boxes under
    make_sky_envmap, on the cbox's camera. P is a presets module, B its
    builder module."""
    b = B.SceneBuilder()
    white = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=P.CBOX_WHITE)
    floor = [[2500, 0, -1500], [-2000, 0, -1500], [-2000, 0, 3000],
             [2500, 0, 3000]]
    b.add_mesh(*P._quad(floor), bsdf=white)
    b.add_mesh(*P._box(P._SHORT_BOX), bsdf=white)
    b.add_mesh(*P._box(P._TALL_BOX_TOP), bsdf=white)
    sky = (jemitter if B is jbuild else temitter).make_sky_envmap(
        SUN, turbidity=3.0, res=sky_res)
    b.add_emitter(T.EM_ENVMAP, envmap=sky, to_world=Z_TO_Y, scale=0.05)
    b.set_perspective_sensor(
        to_world=jtf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
        fov_deg=39.3077, fov_axis="x", near=10.0)
    kw = dict(width=res, height=res, spp=spp, max_depth=max_depth,
              integrator="path", **cfg_kw)
    if B is jbuild:
        b.config = b.config._replace(**kw)
    else:
        b.config = dataclasses.replace(b.config, **kw)
    return b.build(), b.config


def _scenes(**kw):
    return sky_scene(jpresets, jbuild, **kw), sky_scene(tpresets, tbuild,
                                                         **kw)


def test_sky_and_tables_equal_jax():
    np.testing.assert_array_equal(
        temitter.make_sky_envmap(SUN, turbidity=2.5, res=32),
        jemitter.make_sky_envmap(SUN, turbidity=2.5, res=32))
    (js, jc), (ts, tc) = _scenes()
    for f in ENV_TABLES:
        np.testing.assert_array_equal(getattr(ts.emitters, f).numpy(),
                                      np.asarray(getattr(js.emitters, f)))
    assert tc == T.config_from_dict(jc._asdict())


def _dirs(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _frac_close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(-1).mean()


def test_lookup_sampling_pdf_match_jax():
    (js, _), (ts, _) = _scenes()
    r = np.random.default_rng(0)
    d = _dirs(r, N)
    u2 = r.random((N, 2), dtype=np.float32)
    for jf, tf in [(jemitter._env_lookup, temitter._env_lookup),
                   (jemitter.env_pdf_direction, temitter.env_pdf_direction),
                   (jemitter.env_radiance, temitter.env_radiance),
                   (jemitter.pdf_direct_env, temitter.pdf_direct_env)]:
        assert _frac_close(tf(ts, torch.from_numpy(d)),
                           jf(js, jnp.asarray(d))) >= 0.995, jf.__name__
    jd, jp, jv = jemitter.sample_env_direction(js, jnp.asarray(u2))
    td, tp, tv = temitter.sample_env_direction(ts, torch.from_numpy(u2))
    for got, want in [(td, jd), (tp, jp), (tv, jv)]:
        assert _frac_close(got, want, atol=1e-5) >= 0.995
    # u past a row's last cdf takes the row's last column, as JAX's clip
    edge = np.array([[0.5, 0.99999994], [0.0, 0.0], [0.99999994, 0.5]],
                    np.float32)
    np.testing.assert_allclose(
        temitter.sample_env_direction(ts, torch.from_numpy(edge))[1].numpy(),
        np.asarray(jemitter.sample_env_direction(js, jnp.asarray(edge))[1]),
        rtol=1e-5)


def test_direct_sampling_of_the_envmap_matches_jax():
    (js, _), (ts, _) = _scenes()
    r = np.random.default_rng(1)
    p = r.uniform(0, 500, (N, 3)).astype(np.float32)
    u2 = r.random((N, 2), dtype=np.float32)
    u1 = r.random(N, dtype=np.float32)
    want = jemitter.sample_direct(js, jnp.asarray(p), jnp.asarray(u2),
                                  jnp.asarray(u1))
    got = temitter.sample_direct(ts, torch.from_numpy(p),
                                 torch.from_numpy(u2), torch.from_numpy(u1))
    for f in ("d", "dist", "pdf", "value", "n"):
        assert _frac_close(getattr(got, f), getattr(want, f),
                           atol=1e-5) >= 0.995, f
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))


def _env_only(img, to_world=None):
    b = tbuild.SceneBuilder()
    b.add_emitter(T.EM_ENVMAP, envmap=img, to_world=to_world)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    return b.build()


def test_importance_sampling_integral():
    """TestEnvmap: E[lum / pdf] over 50,000 samples is the map's
    solid-angle luminance integral within 5%."""
    rng = np.random.default_rng(0)
    img = (rng.random((16, 32, 3)) ** 2).astype(np.float32) * 3.0
    scene = _env_only(img)
    u2 = torch.from_numpy(rng.random((50000, 2)).astype(np.float32))
    _, pdf, val = temitter.sample_env_direction(scene, u2)
    lum = val.numpy() @ np.array([0.2126, 0.7152, 0.0722])
    est = (lum / np.maximum(pdf.numpy(), 1e-9)).mean()
    H, W = img.shape[:2]
    th = (np.arange(H) + 0.5) / H * np.pi
    w = np.sin(th)[:, None] * (np.pi / H) * (2 * np.pi / W)
    ref = (img @ np.array([0.2126, 0.7152, 0.0722]) * w).sum()
    np.testing.assert_allclose(est, ref, rtol=0.05)


@pytest.mark.parametrize("to_world", [None, Z_TO_Y])
def test_pdf_matches_sampling(to_world):
    """TestEnvmap: env_pdf_direction of a sampled direction is the
    sampler's pdf (within 1e-3 on > 99.5% of the samples: a texel-edge
    sample round-trips into the neighbouring texel)."""
    rng = np.random.default_rng(1)
    img = rng.random((8, 16, 3)).astype(np.float32)
    scene = _env_only(img, to_world)
    u2 = torch.from_numpy(rng.random((20000, 2)).astype(np.float32))
    d, pdf, _ = temitter.sample_env_direction(scene, u2)
    a, b = pdf.numpy(), temitter.env_pdf_direction(scene, d).numpy()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-5)
    assert (rel < 1e-3).mean() > 0.995


def test_sky_is_blueish():
    img = temitter.make_sky_envmap([0.4, 0.0, 0.7], turbidity=2.5, res=32,
                                   with_sun=False)
    upper = img[:14]
    mask = upper.sum(-1) > 1e-3
    assert (upper[..., 2][mask] >= upper[..., 0][mask] * 0.8).mean() > 0.7


@pytest.mark.parametrize("filt", ["gaussian", "box"])
def test_sky_scene_renders_as_jax(filt):
    """The sky-lit floor and boxes (8x8, spp 2, depth 3) on the loop road
    (gaussian) and the wavefront road (box): within 1e-3 of JAX's image on
    >= 95% of the pixels."""
    (js, jc), (ts, tc) = _scenes(filter=filt)
    want = np.asarray(jrender.render(js, jc, seed=4))
    got = trender.render(ts, tc, seed=4, device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.95, close.mean()
