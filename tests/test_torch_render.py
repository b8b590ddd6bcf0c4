"""The whole slice: the port's render() on the CPU against the JAX package's
render() composite on the boxwalk road (render.py:346-389 with use_bw taken:
the render_boxwalk passes in interpret mode plus four beam_splat_passes at
the same seeds), the device rule, and the port's import hygiene."""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import boxwalk as jbw
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _jax_composite(scene, cfg, seed):
    """The JAX render() body for the boxwalk road, with use_bw forced."""
    npix = cfg.width * cfg.height
    spp_per_pass = max(1, min(cfg.spp, (1 << 21) // npix))
    L = np.zeros((npix, 3), np.float32)
    done = pass_idx = 0
    while done < cfg.spp:
        sppc = min(spp_per_pass, cfg.spp - done)
        Lb, _ = jbw.render_boxwalk(scene, cfg, sppc, jnp.uint32(seed),
                                   jnp.uint32(pass_idx), interpret=True)
        L = L + np.asarray(Lb)
        done += sppc
        pass_idx += 1
    img = (L / np.float32(cfg.spp)).reshape(cfg.height, cfg.width, 3)
    n_splat = 4 * npix
    splat = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    for i in range(4):
        splat = jrender.beam_splat_pass(scene, splat, cfg, n_splat,
                                        jnp.uint32(seed), jnp.uint32(i))
    return img + np.asarray(splat) / (n_splat * 4)


@pytest.mark.parametrize("seed", [0, 3])
def test_render_matches_jax_composite(seed):
    res, spp = 12, 4
    js, jc = jpresets.volumetric_box(res=res, spp=spp, heterogeneous=True,
                                     density_res=16, max_depth=3)
    jc = jc._replace(filter="box")
    want = _jax_composite(js, jc, seed)
    ts, tc = tpresets.volumetric_box(res=res, spp=spp, heterogeneous=True,
                                     density_res=16, max_depth=3,
                                     filter="box")
    stats = {}
    got = trender.render(ts, tc, seed=seed, device="cpu", stats=stats).numpy()
    assert got.shape == (res, res, 3) and np.isfinite(got).all()
    assert len(stats["passes"]) == 1 and stats["passes"][0][3] == 0
    assert abs(got.mean() / want.mean() - 1) <= 0.01
    lum_t, lum_j = got.mean(-1), want.mean(-1)
    sel = lum_j > 0
    assert sel.mean() > 0.1             # the box covers ~20% of the film
    assert 0.99 <= np.median(lum_t[sel] / lum_j[sel]) <= 1.01


def test_render_of_carried_jax_scene_matches_preset():
    """scene_from_numpy(JAX scene) renders the same image as the preset."""
    kw = dict(res=8, spp=2, heterogeneous=True, density_res=8, max_depth=2)
    js, jc = jpresets.volumetric_box(**kw)
    carried = T.scene_from_numpy(_tree(js))
    cfg = T.config_from_dict(jc._asdict())
    ts, tc = tpresets.volumetric_box(filter="box", **kw)
    a = trender.render(carried, dataclasses.replace(cfg, filter="box"), seed=1,
                       device="cpu")
    b = trender.render(ts, tc, seed=1, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def test_spp_per_pass_follows_render_budget():
    """min(spp, 2^21 // npix) samples a pass, as the JAX render() sets it."""
    scene, cfg = tpresets.volumetric_box(res=8, spp=3, heterogeneous=True,
                                         density_res=8, max_depth=2,
                                         filter="box")
    stats = {}
    trender.render(scene, cfg, seed=0, device="cpu", stats=stats)
    assert len(stats["passes"]) == 1
    assert all(p[3] == 0 for p in stats["passes"])


@pytest.mark.parametrize("kw,step", [
    # step 1's sampler modes, ported since: the ldsampler renders on the
    # loop road (tests/test_torch_sampler.py)
    pytest.param(dict(filter="gaussian", sampler="ldsampler"), None,
                 id="kw0-step 1"),
    # step 10's transient film, ported since: it renders
    # (tests/test_torch_transient.py)
    pytest.param(dict(filter="gaussian", decomposition="transient",
                      max_bound=4.0), None, id="kw1-step 10"),
    # step 9's surface integrators, ported since: "path" with a box filter
    # takes the wavefront road, as in the JAX package
    # (tests/test_torch_path.py)
    pytest.param(dict(filter="box", integrator="path"), None,
                 id="kw2-step 9"),
    # step 12's bdpt, ported since: it renders (tests/test_torch_bdpt.py)
    pytest.param(dict(filter="box", integrator="bdpt"), None,
                 id="kw3-step 12"),
    # step 7's medium_strategies on the wavefront road, ported since: it
    # renders (tests/test_torch_strategies.py)
    pytest.param(dict(filter="box", emitter_kind="point",
                      medium_strategies=True), None, id="kw4-step 7"),
    # step 12a's Metropolis and photon estimators, ported since: they
    # render (tests/test_torch_pssmlt.py, test_torch_erpt.py,
    # test_torch_photonmap.py, test_torch_bre.py); erpt and the photon
    # mapper on the cbox (path.li and the surface photons: the box has no
    # surface but its null cube)
    pytest.param(dict(integrator="pssmlt_volpath"), None,
                 id="kw5-step 12a pssmlt"),
    pytest.param(dict(scene="cbox", integrator="erpt"), None,
                 id="kw6-step 12a erpt"),
    pytest.param(dict(scene="cbox", integrator="sppm"), None,
                 id="kw7-step 12a photon mapping"),
    pytest.param(dict(emitter_kind="point", integrator="bre"), None,
                 id="kw8-step 12a bre"),
    # step 12b's many-light and subsurface integrators still raise
    pytest.param(dict(integrator="vpl"), "step 12", id="kw9-step 12b vpl"),
])
def test_other_roads_raise(kw, step):
    kw = dict(kw)
    if kw.pop("scene", None) == "cbox":
        scene, cfg = tpresets.cornell_box(res=8, spp=1, boxes=False, **kw)
    else:
        scene, cfg = tpresets.volumetric_box(res=8, spp=1,
                                             heterogeneous=True,
                                             density_res=8, **kw)
    if step is None:
        img = trender.render(scene, dataclasses.replace(cfg, max_depth=3),
                             device="cpu")
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
        return
    with pytest.raises(NotImplementedError, match=step):
        trender.render(scene, cfg, device="cpu")


def _with_phase_kind(scene, kind):
    media = scene.media
    phase = dataclasses.replace(
        media.phase, kind=torch.full_like(media.phase.kind, kind))
    return dataclasses.replace(scene, media=dataclasses.replace(
        media, phase=phase))


def _phase_box(kind, **kw):
    scene, cfg = tpresets.volumetric_box(res=16, spp=4, heterogeneous=True,
                                         density_res=8, max_depth=4, g=0.0,
                                         **kw)
    return _with_phase_kind(scene, kind), dataclasses.replace(
        cfg, phase_kinds=(kind,))


def _road_loop(kind):
    scene, cfg = _phase_box(kind)
    return trender.render(scene, cfg, seed=0, device="cpu")


def _road_wavefront(kind):
    scene, cfg = _phase_box(kind, filter="box", emitter_kind="point")
    return trender.render(scene, cfg, seed=0, device="cpu")


def _road_boxwalk_class(kind):
    """The beam box with a box filter: boxwalk's class but for the kind,
    which sends an unsupported kind to the wavefront road."""
    scene, cfg = _phase_box(kind, filter="box")
    return trender.render(scene, cfg, seed=0, device="cpu")


def _road_training(kind):
    from mitsubaer_tpu_torch.diff import render as dr
    scene, cfg = _phase_box(kind)
    cfg = dataclasses.replace(cfg, width=4, height=4, max_depth=2)
    p = dr.get_params(scene)
    return dr.loss_and_grad(scene, p, cfg, 1, 7, 0,
                            torch.zeros((4, 4, 3)), device="cpu")[0]


def _er_scene(kind, res=4):
    scene, cfg = tpresets.refractive_sphere(
        res=res, spp=1, max_depth=2, rif_kind=1, rif_params=(1.3, 0.15),
        er_stepsize=0.05, filter="box")
    return _with_phase_kind(scene, kind), dataclasses.replace(
        cfg, er_maxsteps=32, phase_kinds=(kind,))


def _road_eikonal(kind):
    scene, cfg = _er_scene(kind)
    return trender.render(scene, cfg, seed=0, device="cpu")


def _road_light_image(kind):
    from mitsubaer_tpu_torch.integrators import volpath_er as ter
    scene, cfg = _er_scene(kind, res=32)       # ~2% of particles enter
    return ter.render_er_light_image(scene, cfg, n_passes=1, device="cpu")


ROADS = {"loop": _road_loop, "wavefront": _road_wavefront,
         "boxwalk_class": _road_boxwalk_class, "training": _road_training,
         "eikonal": _road_eikonal, "light_image": _road_light_image}


@pytest.mark.parametrize("road", list(ROADS))
@pytest.mark.parametrize("kind", [2, 3])
def test_unported_phase_kinds_raise(road, kind):
    """Rayleigh (2) and vMF (3), which used to raise on every road that
    reads the phase table, render there now (tests/test_torch_phase.py
    holds each kind against JAX). The Rayleigh loop render is the JAX
    package's Rayleigh image, mean 0.156008, not the isotropic one's
    0.155699."""
    out = ROADS[road](kind)
    assert bool(torch.isfinite(out).all())
    if road != "training":
        assert float(out.mean()) > 0
    if road == "loop" and kind == 2:
        assert abs(float(out.mean()) / 0.156008 - 1) < 1e-5


@pytest.mark.parametrize("road", list(ROADS))
@pytest.mark.parametrize("kind", [0, 1])
def test_ported_phase_kinds_render(road, kind):
    """Isotropic and HG go on rendering on every road. The isotropic loop
    render is the image that Rayleigh and vMF used to render in its place,
    mean 0.155699 (the JAX package's Rayleigh render: 0.156008)."""
    out = ROADS[road](kind)
    assert bool(torch.isfinite(out).all())
    if road != "training":
        assert float(out.mean()) > 0
    if road == "loop" and kind == 0:
        assert abs(float(out.mean()) / 0.155699 - 1) < 1e-5


@pytest.mark.parametrize("name", ["volpth", "adaptive"])
def test_unknown_integrator_raises_as_jax(name):
    """A name neither package knows raises ValueError in both, as JAX's
    get_integrator does; the port used to render it as volpath."""
    scene, cfg = tpresets.volumetric_box(res=8, spp=1, heterogeneous=True,
                                         density_res=8, max_depth=3)
    with pytest.raises(ValueError, match=f"unknown integrator {name}"):
        trender.render(scene, dataclasses.replace(cfg, integrator=name),
                       device="cpu")
    with pytest.raises(ValueError, match=f"unknown integrator {name}"):
        jrender.get_integrator(name)


def test_render_defaults_to_cuda():
    """No device: the card, or an error where there is none; never a quiet
    fall-back to the CPU."""
    scene, cfg = tpresets.volumetric_box(res=4, spp=1, heterogeneous=True,
                                         density_res=8, max_depth=2,
                                         filter="box")
    if torch.cuda.is_available():
        assert trender._device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.render(scene, cfg)
    assert trender._device("cpu").type == "cpu"


def test_port_imports_and_renders_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import mitsubaer_tpu_torch
        from mitsubaer_tpu_torch.integrators import render
        from mitsubaer_tpu_torch.scene import presets
        scene, cfg = presets.volumetric_box(res=8, spp=2, heterogeneous=True,
                                            density_res=8, max_depth=2,
                                            filter="box")
        img = render.render(scene, cfg, seed=0, device="cpu")
        assert img.shape == (8, 8, 3) and float(img.mean()) > 0
        scene, cfg = presets.volumetric_box(res=6, spp=2, heterogeneous=True,
                                            density_res=8, max_depth=2)
        img = render.render(scene, cfg, seed=0, device="cpu")
        assert img.shape == (6, 6, 3) and float(img.mean()) > 0
        scene, cfg = presets.refractive_sphere(
            res=6, spp=1, max_depth=2, rif_kind=1, rif_params=(1.3, 0.15),
            filter="box")
        img = render.render(scene, cfg, seed=0, device="cpu")
        assert img.shape == (6, 6, 3) and float(img.mean()) > 0
        assert not any(m == "mitsubaer_tpu" or m.startswith("mitsubaer_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
