"""The eikonal slice of the port against the JAX package: the models the
volpath_er bounce reads (camera rays, warps, Fresnel, the diffuse BSDF,
phase sampling, homogeneous distance sampling, point-emitter sampling), the
refractive_sphere scene, and the whole render() on the CPU against the JAX
render with the host-stepped ER loop at the same seed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import math as jmath
from mitsubaer_tpu.core import warp as jwarp
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import bsdf as jbsdf
from mitsubaer_tpu.models import emitter as jemitter
from mitsubaer_tpu.models import medium as jmedium
from mitsubaer_tpu.models import phase as jphase
from mitsubaer_tpu.models import sensor as jsensor
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.core import math as tmath
from mitsubaer_tpu_torch.core import warp as twarp
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import bsdf as tbsdf
from mitsubaer_tpu_torch.models import emitter as temitter
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.models import phase as tphase
from mitsubaer_tpu_torch.models import sensor as tsensor
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

# bench_er_forward's scene (bench.py:88-102) cut to a tiny size: linear RIF,
# point light, grey backdrop, box filter, h = 0.01 and the BVP at 4x h; the
# legacy single-solve BVP of the preset (bvp_restarts=0), whose converged
# flags the two packages decide alike (the restart rounds are held against
# the JAX solver in tests/test_torch_eikonal.py)
SCENE = dict(res=16, spp=2, max_depth=3, rif_kind=1,
             rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=1e-2, filter="box")
CFG = dict(er_maxsteps=64, er_bvp_hscale=4.0)


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _u(n, k, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, k)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_render():
    """The JAX scene, config and image (compiled once for the module)."""
    scene, cfg = jpresets.refractive_sphere(**SCENE)
    cfg = cfg._replace(er_host_stepped=True, **CFG)
    return scene, cfg, np.asarray(jrender.render(scene, cfg, seed=0))


def _port_scene():
    scene, cfg = tpresets.refractive_sphere(**SCENE)
    return scene, dataclasses.replace(cfg, **CFG)


def test_render_matches_jax(jax_render):
    _, _, want = jax_render
    scene, cfg = _port_scene()
    stats = {}
    got = trender.render(scene, cfg, seed=0, device="cpu", stats=stats).numpy()
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert len(stats["passes"]) == 1 and 1 <= stats["passes"][0][0] <= 14
    assert abs(got.mean() / want.mean() - 1) <= 0.01
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=0).all(-1)
    assert close[lit].mean() >= 0.95


def test_gaussian_render_matches_jax():
    """The eikonal road with the gaussian film filter against the JAX
    render's host-stepped ER branch, which splats with cfg.filter too
    (render.py:323-345), at test_render_matches_jax's size and tolerance."""
    scene, cfg = jpresets.refractive_sphere(**{**SCENE, "filter": "gaussian"})
    cfg = cfg._replace(er_host_stepped=True, **CFG)
    want = np.asarray(jrender.render(scene, cfg, seed=0))
    scene, cfg = _port_scene()
    got = trender.render(scene, dataclasses.replace(cfg, filter="gaussian"),
                         seed=0, device="cpu").numpy()
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert abs(got.mean() / want.mean() - 1) <= 0.01
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=0).all(-1)
    assert close[lit].mean() >= 0.95


def test_refractive_sphere_equals_jax_build(jax_render):
    js, jc, _ = jax_render
    carried = T.scene_from_numpy(_tree(js))
    ts, tc = _port_scene()
    for f in ("geo", "shapes", "bsdfs", "emitters", "sensor", "media"):
        a, b = getattr(carried, f), getattr(ts, f)
        for g in dataclasses.fields(a):
            x, y = getattr(a, g.name), getattr(b, g.name)
            if dataclasses.is_dataclass(x):
                continue
            assert x.shape == y.shape, (f, g.name)
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0,
                                       atol=1e-7, err_msg=f"{f}.{g.name}")
    for f in ("aabb_min", "aabb_max", "camera_medium"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      getattr(carried, f).numpy())
    assert T.config_from_dict(jc._asdict()) == tc


def test_carried_jax_scene_renders_as_the_preset(jax_render):
    """scene_from_numpy(JAX scene) renders the very image of the preset."""
    js, jc, _ = jax_render
    small = dict(width=6, height=6, spp=1, max_depth=2, er_maxsteps=32)
    carried = T.scene_from_numpy(_tree(js))
    cfg = dataclasses.replace(T.config_from_dict(jc._asdict()), **small)
    ts, tc = _port_scene()
    a = trender.render(carried, cfg, seed=1, device="cpu")
    b = trender.render(ts, dataclasses.replace(tc, **small), seed=1,
                       device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw,step", [
    # step 10's CW-ToF and transient films, ported since: they render
    # (tests/test_torch_transient.py)
    pytest.param(dict(modulation="sine"), None, id="kw0-step 10"),
    # step 7's er_f64 and medium_strategies, ported since: they render
    # (tests/test_torch_er_f64.py, tests/test_torch_strategies.py)
    pytest.param(dict(er_f64=True), None, id="kw1-step 7"),
    pytest.param(dict(medium_strategies=True), None, id="kw2-step 7"),
    # (frames up to 16: every camera path here is longer than 4)
    pytest.param(dict(decomposition="transient", max_bound=16.0), None,
                 id="kw3-step 10"),
])
def test_er_road_parts_not_ported_raise(kw, step):
    scene, cfg = _port_scene()
    cfg = dataclasses.replace(cfg, **kw)
    if step is None:
        small = dict(width=4, height=4, max_depth=2)
        img = trender.render(scene, dataclasses.replace(cfg, **small),
                             device="cpu")
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
        return
    with pytest.raises(NotImplementedError, match=step):
        trender.render(scene, cfg, device="cpu")


def test_er_scene_parts_not_ported_raise():
    """The environment-map emitter, which used to raise on the eikonal
    road (step 9), the area emitter of refractive_sphere(emitter=
    "area_behind") and the acoustic RIF, ported since, render
    (tests/test_torch_envmap.py, tests/test_torch_surface.py,
    tests/test_torch_acoustic.py)."""
    scene, cfg = tpresets.refractive_sphere(
        res=8, spp=1, max_depth=3, rif_kind=1, rif_params=(1.3, 0.15),
        er_stepsize=0.05, emitter="area_behind", filter="box")
    cfg = dataclasses.replace(cfg, er_maxsteps=32)
    img = trender.render(scene, cfg, device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    kind = scene.emitters.kind.clone()
    kind[0] = T.EM_ENVMAP
    envmap = dataclasses.replace(scene, emitters=dataclasses.replace(
        scene.emitters, kind=kind))
    out = trender.render(envmap, cfg, device="cpu")
    assert bool(torch.isfinite(out).all())
    assert not torch.allclose(out, img)
    scene, cfg = tpresets.refractive_sphere(res=4, spp=1, rif_kind=3,
                                            rif_params=(1.33, 0.03, 6.0, 0.0),
                                            filter="box", max_depth=2)
    img = trender.render(scene, cfg, device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


def test_sample_rays_match(jax_render):
    js, jc, _ = jax_render
    ts, _ = _port_scene()
    u = _u(4096, 2, 0) * 16
    want = jsensor.sample_rays(js.sensor, jnp.asarray(u[:, 0]),
                               jnp.asarray(u[:, 1]), 16, 16)
    got = tsensor.sample_rays(ts.sensor, _t(u[:, 0]), _t(u[:, 1]), 16, 16)
    np.testing.assert_allclose(got.o.numpy(), np.asarray(want.o), atol=1e-6)
    np.testing.assert_allclose(got.d.numpy(), np.asarray(want.d), atol=1e-6)


@pytest.mark.parametrize("name", ["square_to_uniform_sphere",
                                  "square_to_uniform_hemisphere",
                                  "square_to_cosine_hemisphere"])
def test_warps_match(name):
    u = _u(4096, 2, 1)
    u[:8] = 0.5                                 # the concentric map's centre
    want = getattr(jwarp, name)(jnp.asarray(u))
    got = getattr(twarp, name)(_t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("g", [0.0, 0.7, -0.4, 5e-5])
def test_square_to_hg_matches(g):
    u = _u(4096, 2, 2)
    want = jwarp.square_to_hg(jnp.float32(g), jnp.asarray(u))
    got = twarp.square_to_hg(torch.tensor(g), _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_frame_fresnel_and_mis_match():
    n = _dirs(4096, 3)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    v = _dirs(4096, 4)
    jf, tf = jmath.Frame.from_normal(jnp.asarray(n)), tmath.Frame.from_normal(
        _t(n))
    for a, b in ((jf.s, tf.s), (jf.t, tf.t), (jf.to_local(jnp.asarray(v)),
                                              tf.to_local(_t(v)))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6)
    cos = np.linspace(-1, 1, 4096).astype(np.float32)
    eta = np.float32(1.33) + 0.2 * _u(4096, 1, 5)[:, 0]
    for a, b in zip(jmath.fresnel_dielectric(jnp.asarray(cos),
                                             jnp.asarray(eta)),
                    tmath.fresnel_dielectric(_t(cos), _t(eta))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6)
    pa, pb = _u(4096, 2, 6).T * [[3.0], [0.1]]
    pa[:4] = 0
    pb[:2] = 0
    np.testing.assert_allclose(
        tmath.mis_weight_power(_t(pa), _t(pb)).numpy(),
        np.asarray(jmath.mis_weight_power(jnp.asarray(pa), jnp.asarray(pb))),
        rtol=1e-6)


def test_diffuse_bsdf_matches(jax_render):
    js, _, _ = jax_render
    ts, _ = _port_scene()
    wi, wo = _dirs(4096, 7), _dirs(4096, 8)
    idx = np.where(np.arange(4096) % 5 == 0, -1, 0).astype(np.int32)
    u2, u1 = _u(4096, 2, 9), _u(4096, 1, 10)[:, 0]
    j = [jnp.asarray(x) for x in (idx, wi, wo)]
    t = [_t(x) for x in (idx, wi, wo)]
    np.testing.assert_allclose(tbsdf.eval(ts.bsdfs, *t).numpy(),
                               np.asarray(jbsdf.eval(js.bsdfs, *j)), atol=1e-7)
    np.testing.assert_allclose(tbsdf.pdf(ts.bsdfs, *t).numpy(),
                               np.asarray(jbsdf.pdf(js.bsdfs, *j)), atol=1e-7)
    want = jbsdf.sample(js.bsdfs, j[0], j[1], jnp.asarray(u2), jnp.asarray(u1))
    got = tbsdf.sample(ts.bsdfs, t[0], t[1], _t(u2), _t(u1))
    for f in ("wo", "weight", "pdf"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=2e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))


@pytest.mark.parametrize("g", [0.0, 0.6])
def test_phase_sample_matches(g):
    kind = np.int32([1 if g else 0])
    js, _ = jpresets.refractive_sphere(res=4, g=g)
    ts, _ = tpresets.refractive_sphere(res=4, g=g)
    np.testing.assert_array_equal(ts.media.phase.kind.numpy(), kind)
    wi, u2 = _dirs(4096, 11), _u(4096, 2, 12)
    idx = np.zeros(4096, np.int32)
    want = jphase.sample(js.media.phase, jnp.asarray(idx), jnp.asarray(wi),
                         jnp.asarray(u2))
    got = tphase.sample(ts.media.phase, _t(idx), _t(wi), _t(u2))
    np.testing.assert_allclose(got.wo.numpy(), np.asarray(want.wo), atol=2e-6)
    np.testing.assert_allclose(got.pdf.numpy(), np.asarray(want.pdf),
                               rtol=1e-5)
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-6)


def test_homogeneous_distance_sampling_matches():
    n = 4096
    sa = np.float32([0.02, 0.05, 0.1])
    ss = np.float32([0.4, 0.3, 0.8])
    w = np.float32(0.8)
    u, uc = _u(n, 1, 13)[:, 0], _u(n, 1, 14)[:, 0]
    t_max = np.where(np.arange(n) % 3 == 0, 1e7, 2.0).astype(np.float32)
    args_j = (jnp.broadcast_to(sa, (n, 3)), jnp.broadcast_to(ss, (n, 3)),
              jnp.full((n,), w), jnp.asarray(t_max), jnp.asarray(u),
              jnp.asarray(uc))
    args_t = (_t(sa).expand(n, 3), _t(ss).expand(n, 3),
              torch.full((n,), float(w)), _t(t_max), _t(u), _t(uc))
    want = jmedium.sample_distance_homogeneous(*args_j)
    got = tmedium.sample_distance_homogeneous(*args_t)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for i in (1, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=2e-6)
    st = np.broadcast_to(sa + ss, (n, 3))
    for a, b in zip(jmedium.homog_strategy_pdfs(jnp.asarray(st),
                                                jnp.asarray(want[1])),
                    tmedium.homog_strategy_pdfs(_t(st), got[1])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6)


def test_point_emitter_sampling_matches(jax_render):
    js, _, _ = jax_render
    ts, _ = _port_scene()
    p = np.random.default_rng(15).uniform(-1, 1, (4096, 3)).astype(np.float32)
    u2, u1 = _u(4096, 2, 16), _u(4096, 1, 17)[:, 0]
    want = jemitter.sample_direct(js, jnp.asarray(p), jnp.asarray(u2),
                                  jnp.asarray(u1))
    got = temitter.sample_direct(ts, _t(p), _t(u2), _t(u1))
    for f in ("d", "dist", "pdf", "value", "p", "n"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))
    d = _dirs(4096, 18)
    np.testing.assert_array_equal(
        temitter.env_radiance(ts, _t(d)).numpy(),
        np.asarray(jemitter.env_radiance(js, jnp.asarray(d))))
    np.testing.assert_array_equal(
        temitter.pdf_direct_env(ts, _t(d)).numpy(),
        np.asarray(jemitter.pdf_direct_env(js, jnp.asarray(d))))
