"""The loop road of the port's render() (render_pass: camera samples,
volpath.li and the filtered film, then the beam splat) on the CPU: against
the JAX render() at equal seed, against the double-scatter beam
quadrature, and against Beer-Lambert's closed form; the routing of
render() to it; and its default device."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.utils import validate as jvalidate
from mitsubaer_tpu_torch.core import transform as tf
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T
from mitsubaer_tpu_torch.utils import validate as tvalidate

torch.set_num_threads(1)

SCENE = dict(res=10, spp=4, heterogeneous=True, density_res=16, max_depth=4)


@pytest.mark.parametrize("kw", [{}, dict(filter="box", engine="loop")],
                         ids=["gaussian", "box_loop"])
def test_render_matches_jax(kw):
    """The whole image, splat included, at the JAX render()'s seed: median
    pixel ratio in [0.999, 1.001] and >= 99% of pixels within rtol 1e-3."""
    js, jc = jpresets.volumetric_box(**SCENE, **kw)
    want = np.asarray(jrender.render(js, jc, seed=3))
    ts, tc = tpresets.volumetric_box(**SCENE, **kw)
    stats = {}
    got = trender.render(ts, tc, seed=3, device="cpu", stats=stats).numpy()
    assert got.shape == want.shape == (10, 10, 3) and np.isfinite(got).all()
    assert set(stats) == {"passes", "loop_s"} and len(stats["passes"]) == 1
    bounces, wood = stats["passes"][0]
    assert 2 <= bounces <= 2 * 4 + 8 and wood > 0
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.1             # the box covers ~20% of the film
    ratio = np.median(got.mean(-1)[lit] / want.mean(-1)[lit])
    assert 0.999 <= ratio <= 1.001, ratio
    close = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_quadrature_matches_jax():
    """beam_double_scatter_quadrature equals the JAX package's within rtol
    1e-4 (at a small size: the chord integrals make it costly on the CPU)."""
    kw = dict(res=4, spp=1, heterogeneous=True, density_res=16, max_depth=2)
    js, jc = jpresets.volumetric_box(**kw)
    q = dict(sub=1, nt=24, ns=48)
    want = jvalidate.beam_double_scatter_quadrature(js, jc, **q)
    got = tvalidate.beam_double_scatter_quadrature(
        *tpresets.volumetric_box(**kw), **q)
    assert got.shape == (4, 4, 3) and (want > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())


@functools.cache
def _anchor():
    """tests/test_boxwalk.py's configuration: res 12, density 16^3, depth 2
    (the beam's double scatter), 4 passes of 64 spp, no splat."""
    return tpresets.volumetric_box(res=12, spp=64, heterogeneous=True,
                                   density_res=16, max_depth=2, filter="box",
                                   engine="loop")


def test_loop_engine_matches_beam_quadrature_median():
    """The loop passes against the double-scatter quadrature: pixel-by-
    pixel median ratio in test_boxwalk.py's band (0.85, 1.2) over the
    pixels above the truth's 30th percentile (JAX's boxwalk gives 1.029,
    its wavefront engine 1.021, ROADMAP). The quadrature keeps its 2x2
    subpixels and takes 24 camera and 64 beam steps, for CPU time."""
    scene, cfg = _anchor()
    truth = tvalidate.beam_double_scatter_quadrature(
        scene, cfg, nt=24, ns=64).mean(-1).ravel()
    acc = np.zeros(144)
    for p in range(4):
        accum, counts = trender.render_pass(
            scene, torch.zeros((12, 12, 4)), cfg, 64, p + 1, p)
        acc += (accum[..., :3] / accum[..., 3:]).mean(-1).numpy().ravel()
        assert counts[0] <= 2 * 2 + 8
    acc /= 4
    sel = truth > np.percentile(truth, 30)
    ratio = np.median(acc[sel] / truth[sel])
    print(f"loop engine / beam quadrature: median pixel ratio {ratio:.6f}")
    assert 0.85 < ratio < 1.2, ratio


def _slab(filt):
    """test_golden.py's absorbing slab, seen by a narrow camera, with a
    constant environment of radiance L0 as the backdrop in place of the
    emissive quad (direct sampling of area emitters is ROADMAP step 9)."""
    b = tbuild.SceneBuilder()
    med = b.add_medium(kind=T.MED_HOMOGENEOUS, sigma_a=(0.3, 0.7, 1.1),
                       sigma_s=(0.0, 0.0, 0.0))
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    b.add_emitter(T.EM_CONSTANT, radiance=(2.0, 2.0, 2.0))
    b.set_perspective_sensor(
        to_world=tf.look_at([0, 0, -4.0], [0, 0, 0], [0, 1, 0]), fov_deg=4.0)
    b.config = dataclasses.replace(b.config, width=8, height=8, spp=16,
                                   max_depth=4, integrator="volpath",
                                   filter=filt)
    return b.build(), b.config


@pytest.mark.parametrize("filt", ["box", "gaussian"])
def test_beer_lambert_slab_closed_form(filt):
    """Centre pixels equal L0 exp(-2 sigma_a) within rtol 0.02: the chord
    through the box is 2 / cos(theta) with |theta| < 0.25 deg."""
    scene, cfg = _slab(filt)
    cfg = dataclasses.replace(cfg, engine="loop")
    img = trender.render(scene, cfg, seed=0, device="cpu").numpy()
    center = img[3:5, 3:5].mean(axis=(0, 1))
    expect = 2.0 * np.exp(-2.0 * np.array([0.3, 0.7, 1.1]))
    assert np.allclose(center, expect, rtol=0.02), (center, expect)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(filter="tent", emitter_kind="point"),
    dict(filter="box", integrator="volpath_simple"),
    dict(filter="box", engine="loop"),
])
def test_render_routing(kw):
    """As the JAX render()'s _use_wavefront: engine "loop", a filter other
    than box or volpath_simple take the loop engine (the box-filter roads'
    routing: tests/test_torch_wavefront.py). On the CPU kernel A's wrapper
    counts no launch."""
    scene, cfg = tpresets.volumetric_box(res=6, spp=2, heterogeneous=True,
                                         density_res=8, max_depth=2, **kw)
    launches = tmedium.trilinear_lookup.launches
    stats = {}
    img = trender.render(scene, cfg, seed=0, device="cpu", stats=stats)
    assert set(stats) == {"passes", "loop_s"}
    assert tmedium.trilinear_lookup.launches == launches
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0


def test_gaussian_render_defaults_to_cuda():
    """No device: the card, or an error where there is none."""
    scene, cfg = tpresets.volumetric_box(res=4, spp=1, heterogeneous=True,
                                         density_res=8, max_depth=2)
    assert cfg.filter == "gaussian"
    if torch.cuda.is_available():
        assert trender._device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.render(scene, cfg)


@pytest.mark.parametrize("kw,step", [
    # step 10's transient and CW-ToF films, ported since: they render
    # (tests/test_torch_transient.py)
    pytest.param(dict(decomposition="transient", max_bound=4.0), None,
                 id="kw0-step 10"),
    pytest.param(dict(modulation="sine"), None, id="kw1-step 10"),
    # step 7's medium_strategies, ported since: it renders
    pytest.param(dict(emitter_kind="point", medium_strategies=True), None,
                 id="kw2-step 7"),
])
def test_loop_parts_not_ported_raise(kw, step):
    scene, cfg = tpresets.volumetric_box(res=4, spp=1, heterogeneous=True,
                                         density_res=8, max_depth=2, **kw)
    if step is None:
        img = trender.render(scene, cfg, device="cpu")
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
        return
    with pytest.raises(NotImplementedError, match=step):
        trender.render(scene, cfg, device="cpu")
