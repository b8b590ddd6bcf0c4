"""The port's training path (mitsubaer_tpu_torch/diff/render.py) against
the JAX package's (mitsubaer_tpu/diff/render.py) on the CPU: loss_and_grad
at equal scene, parameters, seed and target, and image_grad.

Two scenes, each with parameters made from a numpy seed and carried to
both packages (`params_from_numpy`):
- the heterogeneous box of tests/test_smoke_fast.py:49-51 (res 8,
  density_res 8, max_depth 3) lit by the preset's collimated beam, sppc
  2: Woodcock and ratio tracking, beam NEE with its score term and the
  attached beam-tau table, the density gradient through kernel A's plain
  versions;
- the homogeneous HG box of tests/test_grad.py::scattering_box (res 6,
  max_depth 4), sppc 2: the homogeneous sampler's log_pdf and the g
  gradient.

Each JAX reference is one jitted value_and_grad (its compile dominates the
file's time), made once per scene in a module fixture; it is the JAX
loss_and_grad with the rendered image as aux output. The image serves the
image_grad case: with the weight image 2 (img - target) / img.size, JAX's
loss gradient is JAX's image gradient at that weight, so the port's
image_grad is held against it without another compile.

Tolerances: the loss within rtol 1e-5; each gradient field within 1e-3
of the field's largest JAX magnitude. Measured on the CPU: the loss
within 4.3e-7 relative, the fields within 1.8e-6 (heterogeneous) and
5.3e-7 (homogeneous) of their largest magnitude, image_grad within
1.6e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.diff import render as jdiff
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import transform as tf
from mitsubaer_tpu_torch.diff import render as tdiff
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

SPPC, SEED = 2, 3
FIELDS = ("sigma_a", "sigma_s", "density", "g")
RTOL_LOSS, RTOL_GRAD = 1e-5, 1e-3


def _hg_box(B, types):
    """tests/test_grad.py::scattering_box (homogeneous HG medium in a null
    cube, a point light) at res 6, max_depth 4, in either package."""
    b = B.SceneBuilder()
    med = b.add_medium(kind=types.MED_HOMOGENEOUS, sigma_a=(0.2,) * 3,
                       sigma_s=(0.8,) * 3, phase_kind=types.PH_HG, g=0.3)
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    b.add_emitter(types.EM_POINT, radiance=(20.0,) * 3, position=(0, 0.5, -3))
    b.set_perspective_sensor(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), 30)
    kw = dict(width=6, height=6, spp=1, max_depth=4, integrator="volpath")
    cfg = (b.config._replace(**kw) if hasattr(b.config, "_replace")
           else dataclasses.replace(b.config, **kw))
    return b.build(), cfg


def _het_box(presets):
    return presets.volumetric_box(res=8, spp=1, heterogeneous=True,
                                  density_res=8, max_depth=3, filter="box")


# name: ((JAX scene, cfg), (port scene, cfg), pass index); image_grad runs
# pass 0, so the heterogeneous case takes it
CASES = {
    "heterogeneous_beam": lambda: (_het_box(jpresets), _het_box(tpresets),
                                   0),
    "homogeneous_hg": lambda: (_hg_box(jbuild, JT), _hg_box(tbuild, T), 1),
}


def _seeded_params(jparams, seed):
    """The JAX bundle's fields scaled by seeded factors (per channel for
    sigma, per voxel for the density), a seeded g and the scene's `rif`,
    as numpy arrays."""
    r = np.random.default_rng(seed)
    sa, ss, dens = (np.asarray(jparams.sigma_a), np.asarray(jparams.sigma_s),
                    np.asarray(jparams.density))
    return {k: v.astype(np.float32) for k, v in dict(
        sigma_a=sa * r.uniform(0.5, 1.5, sa.shape),
        sigma_s=ss * r.uniform(0.5, 1.5, ss.shape),
        density=dens * r.uniform(0.5, 1.5, dens.shape),
        g=r.uniform(0.2, 0.6, np.asarray(jparams.g).shape),
        rif=np.asarray(jparams.rif)).items()}


@functools.partial(jax.jit, static_argnames=("cfg", "sppc"))
def _jax_loss_and_grad(scene, params, cfg, sppc, seed, pass_idx, target):
    """jdiff.loss_and_grad with the image as aux output."""
    def loss(p):
        img = jdiff.render_diff(scene, p, cfg, sppc, seed, pass_idx)
        return jnp.mean((img - target) ** 2), img

    return jax.value_and_grad(loss, has_aux=True)(params)


def _run(name):
    (js, jc), (ts, tc), pass_idx = CASES[name]()
    arrays = _seeded_params(jdiff.get_params(js), 11)
    jparams = jdiff.MediumParams(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    target = np.random.default_rng(12).uniform(
        0.0, 0.1, (jc.height, jc.width, 3)).astype(np.float32)
    (loss_j, img_j), grad_j = _jax_loss_and_grad(
        js, jparams, jc, SPPC, jnp.uint32(SEED), jnp.uint32(pass_idx),
        target)
    params = tdiff.params_from_numpy(arrays)
    loss_t, grad_t = tdiff.loss_and_grad(ts, params, tc, SPPC, SEED,
                                         pass_idx, target, device="cpu")
    return dict(scene=ts, cfg=tc, params=params, target=target,
                loss_j=float(loss_j), img_j=np.asarray(img_j),
                grad_j=grad_j, loss_t=float(loss_t), grad_t=grad_t)


@pytest.fixture(scope="module")
def run():
    """The JAX reference and the port's result of each case, made once."""
    return functools.cache(_run)


def _assert_field_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"{what}: max |JAX| {scale:.4e}, max |diff| / max |JAX| "
          f"{err / scale if scale else err:.2e}")
    assert got.shape == want.shape
    assert err <= RTOL_GRAD * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(run, name):
    r = run(name)
    assert np.isfinite(r["loss_t"]) and r["loss_t"] > 0
    print(f"{name} loss: JAX {r['loss_j']:.8e}, relative difference "
          f"{abs(r['loss_t'] / r['loss_j'] - 1):.2e}")
    np.testing.assert_allclose(r["loss_t"], r["loss_j"], rtol=RTOL_LOSS)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", list(CASES))
def test_gradient_matches_jax(run, name, field):
    r = run(name)
    got = getattr(r["grad_t"], field).numpy()
    want = np.asarray(getattr(r["grad_j"], field))
    assert np.isfinite(got).all()
    # the fields the scene reads carry a gradient (a homogeneous scene's
    # density grid is never read, and both packages give it zeros)
    assert (np.abs(want).max() > 0) == (
        field != "density" or name == "heterogeneous_beam")
    _assert_field_close(got, want, f"{name} d loss / d {field}")


@pytest.mark.parametrize("name", list(CASES))
def test_jax_rif_gradient_is_zero(run, name):
    """The loop engine never reads the RIF grid: JAX's `rif` gradient and
    the port's are zero on this road."""
    r = run(name)
    assert not np.asarray(r["grad_j"].rif).any()
    assert r["grad_t"].rif.shape == np.asarray(r["grad_j"].rif).shape
    assert not r["grad_t"].rif.any()


def test_image_grad_matches_jax(run):
    """image_grad at the weight 2 (img - target) / img.size, with JAX's
    image and the seeded target, against JAX's loss gradient."""
    r = run("heterogeneous_beam")
    weight = 2.0 * (r["img_j"] - r["target"]) / r["img_j"].size
    scene = tdiff.put_params(r["scene"], r["params"])
    got = tdiff.image_grad(scene, r["cfg"], SPPC, seed=SEED,
                           weight_image=weight, device="cpu")
    for field in FIELDS:
        _assert_field_close(getattr(got, field).numpy(),
                            getattr(r["grad_j"], field),
                            f"image_grad d / d {field}")


def test_render_diff_runs_on_the_card_unless_cpu(monkeypatch):
    """No quiet CPU fall-back: without a card the entry points raise
    unless device="cpu" is passed."""
    scene, cfg = _het_box(tpresets)
    params = tdiff.get_params(scene)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdiff.render_diff(scene, params, cfg, 1, 0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdiff.loss_and_grad(scene, params, cfg, 1, 0, 0,
                            np.zeros((8, 8, 3), np.float32))
    img = tdiff.render_diff(scene, params, cfg, 1, 0, 0, device="cpu")
    assert img.shape == (8, 8, 3) and img.device.type == "cpu"


def _render_diff_as(integrator, preset):
    """render_diff of a small scene of `preset` with the config's
    integrator set to `integrator`, at the scene's parameters."""
    scene, cfg = preset()
    cfg = dataclasses.replace(cfg, integrator=integrator)
    return tdiff.render_diff(scene, tdiff.get_params(scene), cfg, 2, 5, 0,
                             device="cpu")


def test_eikonal_road_gradients_wait_for_step_8b():
    """render_diff on a volpath_er config renders what it renders with
    "volpath", as the JAX render_diff does: its volpath.li never reads the
    integrator's name. The eikonal road's gradients come from
    volpath_er.li(differentiable=True) instead (tests/test_torch_er_grad_li.py)."""
    def preset():
        return tpresets.refractive_sphere(res=6, spp=1, max_depth=3,
                                          rif_kind=1, rif_params=(1.3, 0.1),
                                          filter="box")

    er = _render_diff_as("volpath_er", preset)
    assert er.shape == (6, 6, 3) and er.sum() > 0
    torch.testing.assert_close(er, _render_diff_as("volpath", preset),
                               rtol=0, atol=0)


def _env_lit_box():
    """The HG box of _hg_box with a constant environment beside its point
    light: where emitters are hit or sampled with a pdf, MIS weights them,
    so volpath_simple's estimator differs from volpath's."""
    b = tbuild.SceneBuilder()
    med = b.add_medium(kind=T.MED_HOMOGENEOUS, sigma_a=(0.2,) * 3,
                       sigma_s=(0.8,) * 3, phase_kind=T.PH_HG, g=0.3)
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    b.add_emitter(T.EM_POINT, radiance=(20.0,) * 3, position=(0, 0.5, -3))
    b.add_emitter(T.EM_CONSTANT, radiance=(0.5,) * 3)
    b.set_perspective_sensor(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), 30)
    cfg = dataclasses.replace(b.config, width=6, height=6, spp=1,
                              max_depth=4)
    return b.build(), cfg


def test_render_diff_on_volpath_simple_renders_volpath(monkeypatch):
    """render_diff on a volpath_simple config gives full volpath's image
    (with MIS), as the JAX render_diff does; on this scene volpath_simple's
    own estimator (li with simple=True) gives another."""
    simple = _render_diff_as("volpath_simple", _env_lit_box)
    full = _render_diff_as("volpath", _env_lit_box)
    assert full.sum() > 0
    torch.testing.assert_close(simple, full, rtol=0, atol=0)
    monkeypatch.setattr(tvp, "li", functools.partial(tvp.li, simple=True))
    assert not torch.equal(_render_diff_as("volpath_simple", _env_lit_box),
                           full)
