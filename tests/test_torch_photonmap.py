"""The port's photon mapping (integrators/photonmap.py: photonmapper, ppm,
sppm) against the JAX package's on the CPU, on the Cornell box without its
boxes at 8^2, spp 4 (one progressive iteration), depth 3, 4,096 photons.

JAX's pass runs with its outer code op by op (`__wrapped__` of the jitted
pass), its gather jitted on its own and its photon map the fixture's
(jitted) of the same arguments, so that each piece compiles once (~25 s
for the jitted pass here).

Tolerances, stated per case:
- the photon map field for field, in the same (stable-sorted) order: the
  cell ids and valid flags equal, positions, powers and directions within
  1e-5 relative plus 1e-5 of the field's largest magnitude (hit points
  on the 550-unit box round apart by up to ~1e-3);
- gather_radiance per query, on the JAX map: within 1e-5 relative plus
  1e-7 of the largest estimate;
- the _pm_pass image: every pixel within 1e-4 relative plus 1e-6 of the
  largest value but at most 2% of pixels, and phase 8's rule of
  chip_smoke.py (the median pixel ratio and the means within 2%);
- render(): "photonmapper", "ppm" and "sppm" the same bits as
  render_photonmap, with its stage timings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import photonmap as jpm
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import photonmap as tpm
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

SEED, N_PHOTONS = 3, 4096
CBOX = dict(res=8, spp=4, max_depth=3, boxes=False, integrator="ppm")


def to_port_map(pm):
    """A JAX PhotonMap as the port's."""
    t = {f: torch.from_numpy(np.array(getattr(pm, f)))
         for f in ("pos", "power", "wi", "valid", "cell_of", "grid_min",
                   "cell_size")}
    return tpm.PhotonMap(res=int(pm.res), **t)


def assert_maps_equal(got, want):
    for f in ("cell_of", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("pos", "power", "wi", "grid_min", "cell_size"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=f)
    assert int(got.res) == int(want.res)


def card_rule(got, want, rel=0.02):
    """chip_smoke.py's phase 8 rule: the median pixel ratio over the
    reference's lit pixels within 1 +- rel and the means within rel."""
    lum_g, lum_w = got.mean(-1), want.mean(-1)
    sel = lum_w > 0
    ratio = np.median(lum_g[sel] / lum_w[sel])
    assert abs(ratio - 1) <= rel, ratio
    assert abs(got.mean() / want.mean() - 1) <= rel


def assert_image_close(got, want, frac=0.98):
    s = float(np.abs(want).max())
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6 * s).all(-1)
    print(f"pixels within tolerance: {ok.mean():.4f}")
    assert ok.mean() >= frac
    card_rule(got, want)


@pytest.fixture(scope="module")
def cbox():
    """Both scenes, the first iteration's radius and JAX's photon map of
    pass 0."""
    js, jc = jpresets.cornell_box(**CBOX)
    ts, tc = tpresets.cornell_box(**CBOX)
    radius = tpm.progressive_radii(tpm.default_radius(ts, 0.015), 1, 0.7)[0]
    jmap = jax.jit(jpm.trace_photons, static_argnums=(1, 2))(
        js, jc, N_PHOTONS, jnp.uint32(SEED), jnp.uint32(0),
        jnp.float32(radius))
    return js, jc, ts, tc, radius, jmap


def test_photon_map_matches_jax(cbox):
    _, _, ts, tc, radius, want = cbox
    got = tpm.trace_photons(ts, tc, N_PHOTONS, SEED, 0,
                            torch.tensor(radius))
    assert np.asarray(want.valid).sum() > N_PHOTONS // 2
    assert_maps_equal(got, want)


def test_gather_radiance_matches_jax(cbox):
    """Queries near stored photons (some cells overfull), facing them."""
    _, _, _, _, radius, jmap = cbox
    r = np.random.default_rng(0)
    valid = np.flatnonzero(np.asarray(jmap.valid))
    pick = r.choice(valid, 512, replace=False)
    p = (np.asarray(jmap.pos)[pick]
         + r.normal(0, 0.5 * radius, (512, 3))).astype(np.float32)
    n_srf = -np.asarray(jmap.wi)[pick]
    refl = r.uniform(0.2, 0.9, (512, 3)).astype(np.float32)
    want = np.asarray(jpm.gather_radiance(
        jmap, jnp.asarray(p), jnp.asarray(n_srf), jnp.asarray(refl),
        jnp.float32(radius), N_PHOTONS))
    got = tpm.gather_radiance(to_port_map(jmap), torch.from_numpy(p),
                              torch.from_numpy(n_srf), torch.from_numpy(refl),
                              torch.tensor(radius), N_PHOTONS).numpy()
    assert (want.sum(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())


def test_pm_pass_matches_jax(cbox, monkeypatch):
    js, jc, ts, tc, radius, jmap = cbox

    def photon_map(scene, cfg, n, seed, pass_idx, r):
        assert (n, int(seed), int(pass_idx), float(r)) == (
            N_PHOTONS, SEED, 0, np.float32(radius))
        return jmap

    monkeypatch.setattr(jpm, "trace_photons", photon_map)
    monkeypatch.setattr(jpm, "gather_radiance", jax.jit(
        jpm.gather_radiance, static_argnames=("n_emitted",)))
    want = np.asarray(jpm._pm_pass.__wrapped__(
        js, jc, N_PHOTONS, jnp.uint32(SEED), jnp.uint32(0),
        jnp.float32(radius)))
    stages = {}
    got = tpm._pm_pass(ts, tc, N_PHOTONS, SEED, 0, torch.tensor(radius),
                       stages).numpy()
    assert sorted(stages) == ["build", "camera", "gather", "trace"]
    assert (want.sum(-1) > 0).mean() > 0.5
    assert_image_close(got, want)


def test_render_routes_photon_mappers(cbox, monkeypatch):
    """render() hands "photonmapper", "ppm" and "sppm" to render_photonmap
    on the scene's device with its stats (the entry run here at this
    file's photon count)."""
    _, _, ts, tc, _, _ = cbox
    calls = []

    def entry(scene, cfg, seed=0, stats=None):
        calls.append((scene.aabb_min.device, cfg.integrator))
        return render_photonmap(scene, cfg, seed=seed, n_photons=N_PHOTONS,
                                stats=stats)

    render_photonmap = tpm.render_photonmap
    monkeypatch.setattr(tpm, "render_photonmap", entry)
    want = render_photonmap(ts, tc, seed=SEED, n_photons=N_PHOTONS)
    assert want.shape == (8, 8, 3) and float(want.mean()) > 0
    names = ("photonmapper", "ppm", "sppm")
    for name in names:
        stats = {}
        img = trender.render(ts, dataclasses.replace(tc, integrator=name),
                             seed=SEED, device="cpu", stats=stats)
        assert stats["photonmap_s"] > 0
        assert set(stats["photonmap_stage_s"]) == {"trace", "build",
                                                   "camera", "gather"}
        torch.testing.assert_close(img, want, rtol=0, atol=0)
    assert calls == [(torch.device("cpu"), name) for name in names]
