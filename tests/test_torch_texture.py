"""The port's textures and noise against the JAX package's: Perlin, fBm
and turbulence (the uint32 corner hash bit for bit), every TEX_* kind of
eval_texture over one table that shares a bitmap, the shading normal of a
normal map and a bump map, the uv tangent frame at triangle and sphere
hits, and bsdf_refl_scale through a textured BSDF table.

Tolerance: 1e-5 absolute on noise, texture values, unit normals and frame
axes (measured: noise and texture values equal, the hash bit for bit,
shading normals within 4.3e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import noise as jnoise
from mitsubaer_tpu.models import texture as jtex
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import intersect as jisect
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import noise as tnoise
from mitsubaer_tpu_torch.models import texture as ttex
from mitsubaer_tpu_torch.scene import intersect as tisect
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

N = 4096
TEX_KINDS = [JT.TEX_CHECKERBOARD, JT.TEX_GRIDTEXTURE, JT.TEX_BITMAP,
             JT.TEX_WIREFRAME, JT.TEX_SCALE, JT.TEX_NORMALMAP,
             JT.TEX_BUMPMAP, JT.TEX_NOISE]


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


@pytest.fixture(scope="module")
def scenes():
    """A JAX scene with one texture row of each kind (row k is kind
    TEX_KINDS[k]; the bitmap row carries the shared image), a BSDF per
    row (textured, and normal-mapped for the normal and bump rows), a
    uv-mapped quad and a sphere; and the port's carried copy."""
    r = np.random.default_rng(3)
    bitmap = r.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    b = jbuild.SceneBuilder()
    for k in TEX_KINDS:
        b.add_texture(k, color0=(0.9, 0.3, 0.2), color1=(0.1, 0.7, 0.4),
                      uv_scale=(3.0, 2.0), uv_offset=(0.1, -0.2),
                      line_width=0.08,
                      bitmap=bitmap if k == JT.TEX_BITMAP else None)
    for i, k in enumerate(TEX_KINDS):
        nt = i if k in (JT.TEX_NORMALMAP, JT.TEX_BUMPMAP) else -1
        b.add_bsdf(JT.BSDF_DIFFUSE, reflectance=(0.8, 0.6, 0.4), texture=i,
                   normal_tex=nt)
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    uv = np.array([[0, 0], [2, 0], [2, 1.5], [0, 1.5]], np.float32)
    b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32), bsdf=0, uv=uv)
    b.add_sphere([0, 0, 3], 1.0, bsdf=1)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    js = b.build()
    return js, T.scene_from_numpy(_tree(js)), b.config


def _points(seed, n=N, scale=6.0):
    return np.random.default_rng(seed).uniform(-scale, scale,
                                               (n, 3)).astype(np.float32)


@pytest.mark.parametrize("fn", ["perlin", "fbm", "turbulence"])
def test_noise_matches_jax(fn):
    p = _points(1)
    want = np.asarray(getattr(jnoise, fn)(jnp.asarray(p)))
    got = getattr(tnoise, fn)(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_noise_hash_is_bit_exact():
    """The corner hash's uint32 arithmetic, in int64 masked to 32 bits,
    equals JAX's uint32 bits, negative lattice coordinates included."""
    r = np.random.default_rng(2)
    xyz = r.integers(-2 ** 20, 2 ** 20, (3, N)).astype(np.int32)
    want = np.asarray(jnoise._hash3(*map(jnp.asarray, xyz)))
    got = tnoise._hash3(*(torch.from_numpy(a).to(torch.int64)
                          for a in xyz)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("row", range(len(TEX_KINDS)))
def test_eval_texture_matches_jax(scenes, row):
    js, ts, _ = scenes
    r = np.random.default_rng(10 + row)
    uv = r.uniform(-2, 3, (N, 2)).astype(np.float32)
    bary = r.uniform(0, 0.6, (N, 2)).astype(np.float32)
    idx = np.full((N,), row, np.int32)
    idx[::7] = -1                                # untextured lanes
    want = np.asarray(jtex.eval_texture(js.textures, jnp.asarray(idx),
                                        jnp.asarray(uv), jnp.asarray(bary)))
    got = ttex.eval_texture(ts.textures, torch.from_numpy(idx).long(),
                            torch.from_numpy(uv), torch.from_numpy(bary))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.all(got.numpy()[::7] == 1.0)


def test_shading_normal_matches_jax(scenes):
    """Normal and bump maps (BSDF rows 5 and 6) and the unperturbed rows."""
    js, ts, cfg = scenes
    r = np.random.default_rng(4)
    uv = r.uniform(-1, 2, (N, 2)).astype(np.float32)
    b_idx = (np.arange(N) % (len(TEX_KINDS) + 1) - 1).astype(np.int32)
    want = np.asarray(jtex.shading_normal(js, jnp.asarray(b_idx),
                                          jnp.asarray(uv)))
    got = ttex.shading_normal(ts, torch.from_numpy(b_idx).long(),
                              torch.from_numpy(uv),
                              enabled=cfg.has_normal_tex).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert cfg.has_normal_tex and cfg.has_textures
    tilted = np.isin(b_idx, [5, 6])
    assert (want[tilted, 2] < 0.999).mean() > 0.5
    assert ttex.shading_normal(ts, None, None, enabled=False) is None


def test_uv_tangent_frame_and_refl_scale_match_jax(scenes):
    """Hits on the uv-mapped quad and on the sphere: the uv frame, the
    interpolated texture coordinates and the BSDF's texture factor."""
    js, ts, _ = scenes
    r = np.random.default_rng(5)
    rad = 0.95 * np.sqrt(r.uniform(0, 1, N // 2))
    phi = r.uniform(0, 2 * np.pi, N // 2)
    o = np.concatenate([
        np.stack([r.uniform(-1, 1, N // 2), r.uniform(-1, 1, N // 2),
                  np.full(N // 2, -2.0)], -1),
        np.stack([rad * np.cos(phi), rad * np.sin(phi),
                  np.full(N // 2, 1.5)], -1)]).astype(np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (N, 1))
    jh = jisect.intersect(js.geo, jnp.asarray(o), jnp.asarray(d), 1e-4,
                          jisect.INF, need_uv=True)
    th = tisect.intersect(ts.geo, torch.from_numpy(o), torch.from_numpy(d),
                          1e-4, tisect.INF, need_uv=True)
    assert bool(th.valid.all())
    np.testing.assert_allclose(th.tex_uv.numpy(), np.asarray(jh.tex_uv),
                               rtol=0, atol=1e-5)
    jf = jtex.uv_tangent_frame(js, jh)
    tf_ = ttex.uv_tangent_frame(ts, th)
    for a in ("s", "t", "n"):
        np.testing.assert_allclose(getattr(tf_, a).numpy(),
                                   np.asarray(getattr(jf, a)), rtol=0,
                                   atol=1e-5, err_msg=a)
    b_idx = np.where(np.asarray(jh.shape_id) == 0, 0, 1).astype(np.int32)
    want = np.asarray(jtex.bsdf_refl_scale(js, jnp.asarray(b_idx),
                                           jh.tex_uv, jh.uv))
    got = ttex.bsdf_refl_scale(ts, torch.from_numpy(b_idx).long(),
                               th.tex_uv, th.uv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert len(np.unique(got.round(4), axis=0)) >= 2
