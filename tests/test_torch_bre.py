"""The port's beam radiance estimate (integrators/bre.py) against the JAX
package's on the CPU, on the point-lit heterogeneous box at 8^2, spp 4
(one progressive iteration), density 8^3, depth 4, 16,384 photons (one
particle in ten or so scatters in the medium: the beam term lights about
one pixel in eight, in both packages).

JAX's pass runs with its outer code op by op (`__wrapped__` of the jitted
pass) and its gathers jitted on their own, so that each compiles once
(~80 s for the jitted pass here). Both packages' passes trace their
volume photons over 2 events (trace_volume_photons' max_bounce, replaced
in both modules for the pass; JAX's pass reuses the fixture's map of the
same arguments): JAX's 8 unrolled events cost ~25 s of compiles and
dispatch more, and the events are the same code at every depth.

Tolerances, stated per case:
- _segment_tau: bit-exact on the same density lookups (its points,
  products and prefix sums in JAX's order), and the port's own lookups
  (kernel A's plain version, which lerps in another order than JAX's
  DensityBricks) within 4 ulp of the largest value JAX looks up
  (measured: 2);
- the volume photon map field for field, in the same (stable-sorted)
  order: the cell ids and valid flags equal, positions, powers and
  directions within 1e-5 relative plus 1e-5 of the field's largest
  magnitude (a photon whose Woodcock walk an ulp decided apart moves
  every later row, so there is no per-row allowance);
- gather_beam per query, on JAX's volume map: within 1e-5 relative plus
  1e-7 of the largest estimate;
- the _bre_pass image: every pixel within 1e-4 relative plus 1e-6 of the
  largest value but at most 2% of pixels, and phase 8's rule of
  chip_smoke.py (the median pixel ratio and the means within 2%);
- render(): "bre" the same bits as render_bre, with its stage timings.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import bre as jbre
from mitsubaer_tpu.models import medium as jmedium
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import bre as tbre
from mitsubaer_tpu_torch.integrators import photonmap as tpm
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import presets as tpresets
from test_torch_photonmap import assert_image_close, assert_maps_equal, \
    to_port_map

torch.set_num_threads(1)

SEED, N_PHOTONS, EVENTS = 3, 1 << 14, 2
BOX = dict(res=8, spp=4, heterogeneous=True, density_res=8, max_depth=4,
           emitter_kind="point", integrator="bre")


@pytest.fixture(scope="module")
def box():
    """Both scenes, the first iteration's radius and JAX's volume photon
    map of pass 0."""
    js, jc = jpresets.volumetric_box(**BOX)
    ts, tc = tpresets.volumetric_box(**BOX)
    radius = tpm.progressive_radii(tpm.default_radius(ts, 0.03), 1, 0.7)[0]
    jmap = jbre.trace_volume_photons(js, jc, N_PHOTONS, jnp.uint32(SEED),
                                     jnp.uint32(0), jnp.float32(radius),
                                     max_bounce=EVENTS)
    return js, jc, ts, tc, radius, jmap


class _JaxLookups:
    """JAX's DensityBricks behind the port's DensityGrid.lookup."""

    def __init__(self, media):
        self.bricks = jmedium.DensityBricks(media)
        self.points = []

    def lookup(self, p):
        self.points.append(p)
        return torch.from_numpy(np.array(self.bricks.lookup(
            jnp.asarray(p.numpy()))))


def test_segment_tau_matches_jax_exactly(box):
    """Segments from inside and outside the grid, in the medium (0) and in
    none (-1), lengths 0 to 2; JAX's function runs op by op, as its pass
    calls it inside a jit only on the card."""
    js, _, ts, _, _, _ = box
    r = np.random.default_rng(0)
    n = 512
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    seg = r.uniform(0, 2, n).astype(np.float32)
    seg[:8] = 0
    med = np.where(r.uniform(size=n) < 0.8, 0, -1).astype(np.int32)
    ts_j, tau_j = (np.asarray(a) for a in jbre._segment_tau(
        js, jmedium.DensityBricks(js.media), jnp.asarray(med),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(seg)))
    grid = _JaxLookups(js.media)
    ts_t, tau_t = tbre._segment_tau(
        ts, grid, torch.from_numpy(med).long(), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(seg))
    assert (tau_j[:, -1] > 0).mean() > 0.5
    np.testing.assert_array_equal(ts_t.numpy(), ts_j)
    np.testing.assert_array_equal(tau_t.numpy(), tau_j)
    # the port's own lookups at those points
    (p,) = grid.points
    want = grid.lookup(p).numpy()
    got = tmedium.DensityGrid(ts.media).lookup(p).numpy()
    assert np.abs(got - want).max() <= 4 * np.spacing(np.abs(want).max())


def test_volume_photon_map_matches_jax(box):
    _, jc, ts, tc, radius, want = box
    got = tbre.trace_volume_photons(ts, tc, N_PHOTONS, SEED, 0,
                                    torch.tensor(radius), max_bounce=EVENTS)
    assert np.asarray(want.valid).sum() > N_PHOTONS // 20
    assert_maps_equal(got, want)


def test_gather_beam_matches_jax(box):
    js, jc, ts, _, radius, jmap = box
    r = np.random.default_rng(1)
    valid = np.flatnonzero(np.asarray(jmap.valid))
    pick = r.choice(valid, 256, replace=False)
    x = (np.asarray(jmap.pos)[pick]
         + r.normal(0, 0.5 * radius, (256, 3))).astype(np.float32)
    w = r.normal(size=(256, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    med = np.zeros(256, np.int32)
    pact = jc.phase_kinds or None
    want = np.asarray(jbre.gather_beam(
        jmap, js, jnp.asarray(med), jnp.asarray(x), jnp.asarray(w),
        jnp.float32(radius), N_PHOTONS, pact))
    got = tbre.gather_beam(to_port_map(jmap), ts, torch.from_numpy(med).long(),
                           torch.from_numpy(x), torch.from_numpy(w),
                           torch.tensor(radius), N_PHOTONS, pact).numpy()
    assert (want.sum(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())


def test_bre_pass_matches_jax(box, monkeypatch):
    js, jc, ts, tc, radius, jmap = box

    def volume_map(scene, cfg, n, seed, pass_idx, r):
        assert (n, int(seed), int(pass_idx), float(r)) == (
            N_PHOTONS, SEED, 0, np.float32(radius))
        return jmap

    monkeypatch.setattr(jbre, "trace_volume_photons", volume_map)
    monkeypatch.setattr(jbre, "trace_photons", jax.jit(
        jbre.trace_photons, static_argnums=(1, 2)))
    for name, static in (("gather_beam", ("n_emitted", "pact")),
                         ("gather_radiance", ("n_emitted",))):
        monkeypatch.setattr(jbre, name, jax.jit(getattr(jbre, name),
                                                static_argnames=static))
    monkeypatch.setattr(tbre, "trace_volume_photons", functools.partial(
        tbre.trace_volume_photons, max_bounce=EVENTS))
    want = np.asarray(jbre._bre_pass.__wrapped__(
        js, jc, N_PHOTONS, jnp.uint32(SEED), jnp.uint32(0),
        jnp.float32(radius)))
    stages = {}
    got = tbre._bre_pass(ts, tc, N_PHOTONS, SEED, 0, torch.tensor(radius),
                         stages).numpy()
    assert set(stages) == {"volume_photons", "surface_photons", "beam",
                           "surface_gather"}
    assert (want.sum(-1) > 0).sum() >= 4
    assert_image_close(got, want)


def test_render_routes_bre(box, monkeypatch):
    """render() hands "bre" to render_bre on the scene's device with its
    stats (the entry run here at this file's photon count)."""
    _, _, ts, tc, _, _ = box
    calls = []

    def entry(scene, cfg, seed=0, stats=None):
        calls.append(scene.aabb_min.device)
        return render_bre(scene, cfg, seed=seed, n_photons=N_PHOTONS,
                          stats=stats)

    render_bre = tbre.render_bre
    monkeypatch.setattr(tbre, "render_bre", entry)
    stats = {}
    img = trender.render(ts, tc, seed=SEED, device="cpu", stats=stats)
    assert calls == [torch.device("cpu")]
    assert stats["bre_s"] > 0 and set(stats["bre_stage_s"]) == {
        "volume_photons", "surface_photons", "beam", "surface_gather"}
    assert img.shape == (8, 8, 3) and float(img.mean()) > 0
    torch.testing.assert_close(
        img, render_bre(ts, tc, seed=SEED, n_photons=N_PHOTONS), rtol=0,
        atol=0)
