"""Scene description, intersection, camera projection, phase functions and
the beam of the port against the JAX package, on the same scenes and inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import volpath as jvp
from mitsubaer_tpu.models import phase as jphase
from mitsubaer_tpu.models import sensor as jsensor
from mitsubaer_tpu.scene import intersect as jisect
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.models import phase as tphase
from mitsubaer_tpu_torch.models import sensor as tsensor
from mitsubaer_tpu_torch.scene import intersect as tisect
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)


def _tree(x):
    """A JAX NamedTuple pytree as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _pair(**kw):
    js, jc = jpresets.volumetric_box(**kw)
    ts, tc = tpresets.volumetric_box(**kw)
    return js, jc, ts, tc


def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


@pytest.mark.parametrize("heterogeneous", [False, True])
def test_volumetric_box_equals_jax_build(heterogeneous):
    kw = dict(res=16, spp=4, heterogeneous=heterogeneous, density_res=16,
              max_depth=3, filter="box")
    js, jc, ts, tc = _pair(**kw)
    carried = T.scene_from_numpy(_tree(js))
    for (name, a), (_, b) in zip(_fields(carried), _fields(ts)):
        assert a.shape == b.shape, name
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)
    assert T.config_from_dict(jc._asdict()) == tc


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def test_ray_aabb_matches():
    o, d = _rays(4096, 0)
    d[:64, 0] = 0.0                                  # axis-parallel rays
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    jn, jf = jisect.ray_aabb(jnp.asarray(o), jnp.asarray(d), lo, hi)
    tn, tf = tisect.ray_aabb(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)


@pytest.mark.parametrize("t_min", [0.0, 0.5])
def test_intersect_cube_matches(t_min):
    js, _, ts, _ = _pair(res=8, heterogeneous=True, density_res=8)
    o, d = _rays(4096, 1)
    aim = np.random.default_rng(6).uniform(-1, 1, (2048, 3)) - o[:2048]
    d[:2048] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    jh = jisect.intersect(js.geo, jnp.asarray(o), jnp.asarray(d), t_min, 50.0)
    th = tisect.intersect(ts.geo, torch.from_numpy(o), torch.from_numpy(d),
                          t_min, 50.0)
    valid = np.asarray(jh.valid)
    assert 0.4 < valid.mean() < 0.9
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    np.testing.assert_array_equal(th.shape_id.numpy(), np.asarray(jh.shape_id))
    np.testing.assert_array_equal(th.prim.numpy()[valid],
                                  np.asarray(jh.prim)[valid])
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid],
                               rtol=1e-5)
    np.testing.assert_allclose(th.p.numpy(), np.asarray(jh.p), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.ng.numpy()[valid], np.asarray(jh.ng)[valid],
                               rtol=1e-5)


def test_project_matches():
    js, jc, ts, tc = _pair(res=24, heterogeneous=False)
    r = np.random.default_rng(2)
    p = r.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    p[:16, 0] = -3.5                                 # behind the camera
    jf = jsensor.project(js.sensor, jnp.asarray(p), jc.width, jc.height)
    tf = tsensor.project(ts.sensor, torch.from_numpy(p), tc.width, tc.height)
    valid = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    for name in ("px", "py", "inv_pixel_omega"):
        np.testing.assert_allclose(getattr(tf, name).numpy()[valid],
                                   np.asarray(getattr(jf, name))[valid],
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(tf.d.numpy(), np.asarray(jf.d), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("g", [0.0, 0.7, -0.4])
def test_phase_eval_matches(g):
    js, _, ts, _ = _pair(res=8, g=g)
    kind = np.int32([1 if g else 0])                 # PH_HG or PH_ISOTROPIC
    jph = js.media.phase._replace(kind=jnp.asarray(kind))
    tph = dataclasses.replace(ts.media.phase, kind=torch.from_numpy(kind))
    _, wi = _rays(4096, 3)
    _, wo = _rays(4096, 4)
    idx = np.zeros(4096, np.int32)
    want = np.asarray(jphase.eval(jph, jnp.asarray(idx), jnp.asarray(wi),
                                  jnp.asarray(wo)))
    got = tphase.eval(tph, torch.from_numpy(idx), torch.from_numpy(wi),
                      torch.from_numpy(wo)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_get_beam_and_sample_beam_point_match():
    js, _, ts, _ = _pair(res=8, heterogeneous=True, density_res=8)
    jb, tb = jvp.get_beam(js), tvp.get_beam(ts)
    for name in ("exists", "medium"):
        assert int(getattr(tb, name)) == int(getattr(jb, name)), name
    for name in ("o", "d", "power", "s0", "s1"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)), rtol=1e-5,
                                   err_msg=name)
    r = np.random.default_rng(5)
    p = r.uniform(-1, 1, (4096, 3)).astype(np.float32)
    u = r.uniform(0, 1, 4096).astype(np.float32)
    want = jvp.sample_beam_point(jb, jnp.asarray(p), jnp.asarray(u))
    got = tvp.sample_beam_point(tb, torch.from_numpy(p), torch.from_numpy(u))
    for w, g_ in zip(want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
