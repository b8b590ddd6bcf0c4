"""The port's VPL integrator (integrators/vpl.py) against the JAX
package's on the CPU: the Cornell box without its boxes (BASELINE config
1's walls and light) and BASELINE config 2 (the box filled with a
homogeneous HG medium, which takes the media-aware walks), carried from
the JAX package with scene_from_numpy, at 8^2 and depth 2 (8 light paths
of 1 bounce: 16 VPLs). JAX's render runs op by op under
jax.disable_jit() (its jitted per-sample scan compiles for longer than
it runs here).

Tolerances, stated per case:
- generate_vpls field by field: the BSDF ids, kernel kinds and emitter
  ids equal; positions, normals, directions and fluxes within 1e-5
  relative plus 1e-5 of the field's largest magnitude (hit points on the
  550-unit box round apart by up to ~1e-3, as in the photon maps);
- render_vpl per pixel: within 1e-4 relative plus 1e-6 of the image's
  largest value, and the means within 1e-5 relative;
- render(): "vpl" the same bits as render_vpl, with its stages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import vpl as jvpl
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import vpl as tvpl
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

CONFIG2_MEDIUM = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


@pytest.fixture(scope="module", params=["config1", "config2"])
def scenes(request):
    medium = CONFIG2_MEDIUM if request.param == "config2" else None
    js, jc = jpresets.cornell_box(res=8, spp=1, max_depth=2, boxes=False,
                                  medium=medium, integrator="vpl")
    return (request.param, js, jc, T.scene_from_numpy(_tree(js)),
            T.config_from_dict(jc._asdict()))


def test_generate_vpls_matches_jax(scenes):
    _, js, jc, ts, tc = scenes
    with jax.disable_jit():
        want = jvpl.generate_vpls(js, jc, 8, 5, max_bounce=3)
    got = tvpl.generate_vpls(ts, tc, 8, 5, max_bounce=3)
    assert got["n_paths"] == want["n_paths"] == 8
    for f in ("bsdf", "kern", "em"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    for f in ("p", "n", "wi", "flux"):
        w = np.asarray(want[f])
        np.testing.assert_allclose(got[f].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=f)
    flux = np.asarray(want["flux"]).reshape(4, 8, 3)
    # emission VPLs on the area light, and some bounce VPLs carrying flux
    assert (np.asarray(want["kern"])[:8] == tvpl.K_AREA).all()
    assert (flux[1:].max(-1) > 0).sum() >= 8


def test_render_vpl_matches_jax(scenes):
    name, js, jc, ts, tc = scenes
    with jax.disable_jit():
        want = np.asarray(jvpl.render_vpl(js, jc, seed=2))
    stats = {}
    got = trender.render(ts, tc, seed=2, device="cpu", stats=stats)
    assert stats["vpls"] == 16
    assert set(stats["vpl_stage_s"]) == {"generate", "camera", "shading"}
    torch.testing.assert_close(got, tvpl.render_vpl(ts, tc, seed=2),
                               rtol=0, atol=0)
    got = got.numpy()
    assert np.isfinite(got).all() and want.mean() > 0
    print(f"{name}: mean rel {got.mean() / want.mean() - 1:+.3e}")
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    assert abs(got.mean() / want.mean() - 1) <= 1e-5


def test_emission_vpl_index_does_not_fault():
    """An emission VPL's BSDF index is -1: a step evaluates its own
    kernel only (no BSDF row -1), and nothing non-finite reaches the
    image, with a spot light (falloff kernel) and a point light."""
    from mitsubaer_tpu_torch.scene import presets as tpresets
    from mitsubaer_tpu_torch.scene import types as TT

    scene, cfg = tpresets.cornell_box(res=8, spp=1, max_depth=3,
                                      boxes=False, integrator="vpl")
    em = scene.emitters
    for kind in (TT.EM_SPOT, TT.EM_POINT):
        emitters = dataclasses.replace(
            em, kind=torch.full_like(em.kind, kind),
            position=torch.tensor([[278.0, 500.0, 279.6]]).expand_as(
                em.position).contiguous(),
            direction=torch.tensor([[0.0, -1.0, 0.0]]).expand_as(
                em.direction).contiguous(),
            radiance=em.radiance * 1e4,
            cutoff_cos=torch.full_like(em.cutoff_cos, 0.766),
            beam_falloff_cos=torch.full_like(em.cutoff_cos, 0.866))
        s = dataclasses.replace(scene, emitters=emitters)
        vpls = tvpl.generate_vpls(s, cfg, 8, 0)
        assert (vpls["bsdf"][:8] == -1).all()
        img = tvpl.render_vpl(s, cfg, seed=1)
        assert bool(torch.isfinite(img).all()) and img.mean() > 0
