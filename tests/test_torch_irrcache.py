"""The port's irradiance cache (integrators/irrcache.py) against the JAX
package's on the CPU: one pass of _irrcache_pass on the Cornell box
without its boxes (carried from the JAX package with scene_from_numpy) at
8^2, depth 3 (the gather's path.li at depth 2), 16 records of 4 gather
rays, for two pass indices. JAX's pass runs with its outer code op by op
(`__wrapped__` of the jitted pass) and its gather's `path.li` jitted once.
Then the port alone against tests/test_irrcache.py's bar (its mean within
0.75-1.3 of the path tracer's, on the cbox at 24^2).

Tolerances, stated per case:
- _irrcache_pass per pixel: within 1e-4 relative plus 1e-6 of the
  image's largest value, and the means within 1e-5 relative (the gather
  rays' path.li lane by lane as tests/test_torch_path.py holds it; the
  Ward blend's (npix, S) sums and the einsum add in another order);
- render(): "irrcache" the same bits as render_irrcache, with its stages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import irrcache as jirr
from mitsubaer_tpu.integrators import path as jpath
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import irrcache as tirr
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

SEED, N_SITES, N_HEMI = 4, 16, 4


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


@pytest.fixture(scope="module")
def cbox():
    js, jc = jpresets.cornell_box(res=8, spp=4, max_depth=3, boxes=False,
                                  integrator="irrcache")
    return js, jc, T.scene_from_numpy(_tree(js)), T.config_from_dict(
        jc._asdict())


@pytest.mark.parametrize("pass_idx", [0, 1])
def test_irrcache_pass_matches_jax(cbox, pass_idx, monkeypatch):
    js, jc, ts, tc = cbox
    monkeypatch.setattr(jirr, "path_li",
                        jax.jit(jpath.li, static_argnums=(1,)))
    want = np.asarray(jirr._irrcache_pass.__wrapped__(
        js, jc, jax.numpy.uint32(SEED), jax.numpy.uint32(pass_idx),
        n_sites=N_SITES, n_hemi=N_HEMI))
    stages = {}
    got = tirr._irrcache_pass(ts, tc, SEED, pass_idx, n_sites=N_SITES,
                              n_hemi=N_HEMI, stages=stages).numpy()
    assert set(stages) == {"camera", "gather", "blend"}
    assert np.isfinite(got).all() and want.mean() > 0
    print(f"pass {pass_idx}: mean rel {got.mean() / want.mean() - 1:+.3e}")
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    assert abs(got.mean() / want.mean() - 1) <= 1e-5


def test_render_routes_irrcache(cbox):
    _, _, ts, tc = cbox
    stats = {}
    cfg = dataclasses.replace(tc, spp=8)              # two passes
    got = trender.render(ts, cfg, seed=1, device="cpu", stats=stats)
    assert stats["irrcache_s"] > 0
    assert set(stats["irrcache_stage_s"]) == {"camera", "gather", "blend"}
    torch.testing.assert_close(got, tirr.render_irrcache(ts, cfg, seed=1),
                               rtol=0, atol=0)


def test_irrcache_mean_near_path_tracer():
    """tests/test_irrcache.py's check in the port: irrcache at spp 8 (two
    passes of 256 records of 32 gather rays) against path at spp 32 on the
    cbox at 24^2 (the JAX test's 32^2); its mean within 0.75-1.3 of
    path's, and above half of it (the cached indirect term contributes)."""
    scene, cfg = tpresets.cornell_box(res=24)
    ref = trender.render(scene, dataclasses.replace(cfg, spp=32), seed=3,
                         device="cpu")
    a = trender.render(scene, dataclasses.replace(
        cfg, spp=8, integrator="irrcache"), seed=1, device="cpu")
    assert bool(torch.isfinite(a).all())
    ratio = a.mean().item() / ref.mean().item()
    print(f"irrcache / path: {ratio:.4f}")
    assert 0.75 < ratio < 1.3
    assert a.mean() > 0.5 * ref.mean()
