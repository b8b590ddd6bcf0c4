"""The port's single-scatter (sphere and mesh boundary) and dipole
integrators against the JAX package's on the CPU, on
tests/test_singlescatter.py's scenes (built by the JAX SceneBuilder and
carried with scene_from_numpy) at 8^2, and held to that file's own bars.
JAX's renders run op by op under jax.disable_jit() (their jitted
per-sample functions compile for longer than they run here).

Tolerances, stated per case:
- _solve_phi and _solve_planar per lane, over 4,096 seeded (x, l) pairs:
  B within 2e-6 (scenes of unit radius; the bisection's last bracket is
  6e-8 of the arc, and a sign decision an ulp of g moves changes the
  bracket only where the midpoint is within ulps of the root), the ok
  flags equal on all but 0.1% of the lanes (|g| within ulps of the 1e-3
  acceptance);
- the single-scatter renders: every pixel within 2e-2 relative plus
  1e-6 of the image's largest value, and the image means within 1e-4
  relative. The geometry factor is a finite difference over delta 3e-3 R
  of three bisection solves, which multiplies their ulps (B 3.6e-7 apart
  at equal x) by ~1/delta: G 1.4e-3 apart on one lane of a sample; and
  the camera rays' directions, an ulp apart (XLA's and torch's rsqrt),
  move grazing entry points by up to 1e-5 through the discriminant's
  cancellation. Measured (spp 1; n_dist 2, the mesh 1): pixels 5.7e-4
  (eta 1), 9.2e-4 (eta 1.33) and 1.2e-2 (the mesh: one sample a pixel)
  apart at most, the means within 4.2e-5;
- _surface_samples bit-equal (the same numpy code on the same float32
  triangles); rd_dipole within 1e-6 relative (XLA's and torch's exp and
  sqrt an ulp apart: 4e-7 measured);
- the dipole image per pixel within 1e-5 relative plus 1e-7 of its
  largest value (each pixel a sum of 256 R_d E A terms added in another
  order), at n_cache % chunk == 0 and != 0 (JAX's clamped last chunk
  overlaps the one before it and counts 32 samples twice; so does the
  port).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.integrators import dipole as jdip
from mitsubaer_tpu.integrators import singlescatter as jss
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu.scene.build import SceneBuilder as JBuilder
from mitsubaer_tpu_torch.integrators import dipole as tdip
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import singlescatter as tss
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

IMG_RTOL, MEAN_RTOL = 2e-2, 1e-4
SOLVE_ATOL, MAX_FLAG_APART = 2e-6, 0.001


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _scenes(eta=1.0, sigma_s=0.4, sigma_a=0.05, res=8, subdiv=None,
            spp=4):
    """tests/test_singlescatter.py's sphere (subdiv None) or subdivided
    octahedron sphere scene, in the JAX package and carried into the
    port."""
    b = JBuilder()
    med = b.add_medium(kind=JT.MED_HOMOGENEOUS, sigma_a=(sigma_a,) * 3,
                       sigma_s=(sigma_s,) * 3, phase_kind=JT.PH_ISOTROPIC)
    bs = b.add_bsdf(kind=JT.BSDF_DIELECTRIC, eta=eta)
    if subdiv is None:
        b.add_sphere((0.0, 0.0, 0.0), 1.0, bsdf=bs, interior=med)
    else:
        b.add_mesh(*chip_smoke._octasphere(subdiv), bsdf=bs, interior=med)
    b.add_emitter(JT.EM_POINT, radiance=(10.0, 10.0, 10.0),
                  position=(2.5, 1.5, 0.0))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), fov_deg=35)
    b.config = b.config._replace(width=res, height=res, spp=spp,
                                 filter="box")
    js = b.build()
    return (js, b.config, T.scene_from_numpy(_tree(js)),
            T.config_from_dict(b.config._asdict()))


def assert_image_close(got, want, rtol=IMG_RTOL, atol_frac=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and want.mean() > 0
    lit = want > 0
    print(f"mean rel {got.mean() / want.mean() - 1:+.3e}, pixels at most "
          f"{(np.abs(got - want)[lit] / want[lit]).max():.3e} apart")
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())
    assert abs(got.mean() / want.mean() - 1) <= MEAN_RTOL


def _pairs(n, seed, inside):
    """n seeded scatter points inside the unit sphere (or on the plane's
    back side) and lights outside it."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 3))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    x = x * r.uniform(0.05, 0.95, (n, 1)) ** (1 / 3)
    l = r.normal(size=(n, 3))
    l = l / np.linalg.norm(l, axis=-1, keepdims=True) * r.uniform(
        1.5, 4.0, (n, 1))
    if not inside:
        x[:, 2] = -np.abs(x[:, 2]) - 0.01
        l[:, 2] = np.abs(l[:, 2]) + 0.01
    return x.astype(np.float32), l.astype(np.float32)


def _flags_and_points(got, want):
    (gB, gok), (wB, wok) = got, want
    gB, gok = gB.numpy(), gok.numpy()
    wB, wok = np.asarray(wB), np.asarray(wok)
    apart = (gok != wok).mean()
    print(f"ok flags apart on {apart:.5f} of the lanes; max |dB| "
          f"{np.abs(gB - wB).max():.3e}")
    assert apart <= MAX_FLAG_APART
    assert wok.mean() > 0.5
    np.testing.assert_allclose(gB, wB, rtol=0, atol=SOLVE_ATOL)


@pytest.mark.parametrize("eta", [1.0, 1.33])
def test_solve_phi_matches_jax(eta):
    x, l = _pairs(4096, 11, inside=True)
    want = jss._solve_phi(jnp.zeros((1, 3)), jnp.float32(1.0), eta,
                          jnp.asarray(x), jnp.asarray(l))
    got = tss._solve_phi(torch.zeros((1, 3)), torch.tensor(1.0), eta,
                         torch.from_numpy(x), torch.from_numpy(l))
    _flags_and_points(got, want)


def test_solve_planar_matches_jax():
    """Random planes through the origin: the plane (p0, n) with x below
    and l above it; (T, n) broadcast as render_singlescatter_mesh uses
    it."""
    x, l = _pairs(1024, 12, inside=False)
    r = np.random.default_rng(13)
    n = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (4, 1))
    n[1:] += r.normal(0, 0.2, (3, 3)).astype(np.float32)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    p0 = r.normal(0, 0.01, (4, 3)).astype(np.float32)
    want = jss._solve_planar(jnp.asarray(p0)[:, None], jnp.asarray(n)[:, None],
                             1.33, jnp.asarray(x)[None], jnp.asarray(l)[None])
    got = tss._solve_planar(torch.from_numpy(p0)[:, None],
                            torch.from_numpy(n)[:, None], 1.33,
                            torch.from_numpy(x)[None],
                            torch.from_numpy(l)[None])
    assert tuple(got[0].shape) == (4, 1024, 3)
    _flags_and_points(got, want)


@pytest.mark.parametrize("eta", [1.0, 1.33])
def test_render_singlescatter_matches_jax(eta):
    """spp 1, n_dist 2 (JAX's op-by-op render ~4 s a sample here)."""
    js, jc, ts, tc = _scenes(eta=eta, spp=1)
    with jax.disable_jit():
        want = np.asarray(jss.render_singlescatter(js, jc, seed=3, n_dist=2))
    stats = {}
    got = tss.render_singlescatter(ts, tc, seed=3, n_dist=2, stats=stats)
    assert stats["singlescatter_s"] > 0
    assert_image_close(got.numpy(), want)
    # render() routes the name to the entry (its default n_dist, 4)
    torch.testing.assert_close(
        trender.render(ts, dataclasses.replace(tc, integrator="singlescatter"),
                       seed=3, device="cpu"),
        tss.render_singlescatter(ts, tc, seed=3), rtol=0, atol=0)


def test_render_singlescatter_mesh_matches_jax():
    """The subdivision-2 icosphere (128 triangles) at eta 1.33, spp 1."""
    js, jc, ts, tc = _scenes(eta=1.33, subdiv=2, spp=1)
    with jax.disable_jit():
        want = np.asarray(jss.render_singlescatter_mesh(js, jc, seed=5,
                                                        n_dist=1))
    stats = {}
    old = tss.MESH_CHUNK_ELEMS
    tss.MESH_CHUNK_ELEMS = 128 * 7          # chunks of 7 lanes
    try:
        got = tss.render_singlescatter_mesh(ts, tc, seed=5, n_dist=1,
                                            stats=stats)
    finally:
        tss.MESH_CHUNK_ELEMS = old
    assert stats["singlescatter_mesh_s"] >= stats[
        "singlescatter_mesh_connect_s"] > 0
    assert_image_close(got.numpy(), want)
    # render() routes the name to the entry (its default n_dist, 4)
    whole = trender.render(ts, dataclasses.replace(
        tc, integrator="singlescatter_mesh"), seed=5, device="cpu")
    torch.testing.assert_close(
        whole, tss.render_singlescatter_mesh(ts, tc, seed=5), rtol=0, atol=0)


def test_surface_samples_bit_equal():
    js, _, ts, _ = _scenes(subdiv=2)
    sid = tss._find_mesh_target(ts)[0]
    assert sid == jss._find_mesh_target(js)[0]
    want = jdip._surface_samples(js, sid, 777, 9)
    got = tdip._surface_samples(ts, sid, 777, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rd_dipole_matches_jax():
    """tests/test_singlescatter.py's r range and coefficients, and two
    more (absorbing, forward-scattering), at eta 1.3 and 1.5."""
    r = np.linspace(0.01, 2.0, 64, dtype=np.float32)[:, None]
    for sa, ssp, eta in ((0.05, 2.0, 1.3), (0.8, 2.0, 1.3),
                         (0.3, 0.5, 1.5)):
        a = np.full((1, 3), sa, np.float32)
        s = np.full((1, 3), ssp, np.float32)
        want = np.asarray(jdip.rd_dipole(jnp.asarray(r), jnp.asarray(a),
                                         jnp.asarray(s), eta))
        got = tdip.rd_dipole(torch.from_numpy(r), torch.from_numpy(a),
                             torch.from_numpy(s), eta).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (got > 0).all() and (np.diff(got[:, 0]) < 0).all()


@pytest.mark.parametrize("n_cache,chunk", [(256, 128), (256, 96)])
def test_render_dipole_matches_jax(n_cache, chunk):
    """The subdivision-2 icosphere at eta 1.3, sigma_s 2.0, sigma_a 0.05,
    spp 1; 256 % 96 != 0: the last chunk starts at 160, not 192."""
    js, jc, ts, tc = _scenes(eta=1.3, sigma_s=2.0, sigma_a=0.05, subdiv=2,
                             spp=1)
    with jax.disable_jit():
        want = np.asarray(jdip.render_dipole(js, jc, seed=0,
                                             n_cache=n_cache, chunk=chunk))
    stats = {}
    got = tdip.render_dipole(ts, tc, seed=0, n_cache=n_cache, chunk=chunk,
                             stats=stats)
    assert set(stats["dipole_stage_s"]) == {"cache", "camera", "gather"}
    assert_image_close(got.numpy(), want, rtol=1e-5, atol_frac=1e-7)
    if chunk == 128:
        # render() routes the name to the entry (n_cache 4096, chunk 1024)
        torch.testing.assert_close(
            trender.render(ts, dataclasses.replace(tc, integrator="dipole"),
                           device="cpu"),
            tdip.render_dipole(ts, tc), rtol=0, atol=0)
