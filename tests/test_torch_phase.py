"""The port's phase functions and orientation field against the JAX
package's: every kind's eval / pdf / sample lane by lane at 4,096 lanes,
with the table's axis and with per-lane axes (within 1e-5 relative, the
Rayleigh sample's cube root 2e-5: torch has no cbrt, |x|^(1/3) differs by
ulps), vMF's helpers, `orientation_axis` (tests/test_volpath.py's
test_orientation_axis_lookup and test_oriented_render_runs, ported), and
the oriented microflake box rendered on the loop and wavefront roads and
each extended kind on the eikonal road against JAX's images."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import special as jspecial
from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.models import medium as jmedium
from mitsubaer_tpu.models import phase as jphase
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.core import special as tspecial
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.models import phase as tphase
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

N = 4096
KINDS = [T.PH_ISOTROPIC, T.PH_HG, T.PH_RAYLEIGH, T.PH_VMF, T.PH_MIXTURE,
         T.PH_KKAY, T.PH_MICROFLAKE]


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _tables():
    """One medium of each kind, mixed parameters."""
    nm = len(KINDS)
    r = np.random.default_rng(0)
    kw = dict(kind=np.array(KINDS, np.int32),
              g=np.linspace(-0.6, 0.8, nm).astype(np.float32),
              g2=np.linspace(0.5, -0.7, nm).astype(np.float32),
              mix=np.linspace(0.2, 0.9, nm).astype(np.float32),
              kappa=np.array([4, 4, 4, 50, 4, 4, 8], np.float32),
              axis=_unit(r, nm))
    return (jphase.PhaseTable(**{k: jnp.asarray(v) for k, v in kw.items()}),
            T.PhaseTable(**{k: torch.from_numpy(v) for k, v in kw.items()}))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_phase_kind_matches_jax(kind, override):
    """eval / pdf at random direction pairs and sample at random u, every
    kind, lane by lane (the phase_kinds filter holding only the kind)."""
    jt, tt = _tables()
    r = np.random.default_rng(kind + 10 * override)
    idx = np.full(N, KINDS.index(kind), np.int32)
    wi, wo, ax = _unit(r, N), _unit(r, N), _unit(r, N)
    u2 = r.random((N, 2), dtype=np.float32)
    jax_ax = jnp.asarray(ax) if override else None
    tax = torch.from_numpy(ax) if override else None
    for active in (None, (kind,)):
        want = jphase.eval(jt, jnp.asarray(idx), jnp.asarray(wi),
                           jnp.asarray(wo), active=active,
                           axis_override=jax_ax)
        got = tphase.eval(tt, torch.from_numpy(idx), torch.from_numpy(wi),
                          torch.from_numpy(wo), active=active,
                          axis_override=tax)
        _close(got, want)
        js = jphase.sample(jt, jnp.asarray(idx), jnp.asarray(wi),
                           jnp.asarray(u2), active=active,
                           axis_override=jax_ax)
        ts = tphase.sample(tt, torch.from_numpy(idx), torch.from_numpy(wi),
                           torch.from_numpy(u2), active=active,
                           axis_override=tax)
        tol = 2e-5 if kind == T.PH_RAYLEIGH else 1e-5
        _close(ts.wo, js.wo, rtol=tol, atol=tol)
        _close(ts.pdf, js.pdf, rtol=10 * tol)
        _close(ts.weight, js.weight, rtol=10 * tol)


def test_vmf_helpers_match_jax():
    """vmf_pdf over kappa in [6e-6, 150] (its three branches); vmf_sample
    over [0.1, 150]: below that its inverse cdf 1 + log(...) / kappa
    divides an ulp of the log by kappa in both packages (at kappa 6e-6 a
    component moved 8.5e-3 between them)."""
    r = np.random.default_rng(1)
    c = r.uniform(-1, 1, N).astype(np.float32)
    k = np.exp(r.uniform(-12, 5, N)).astype(np.float32)
    u = r.random((N, 2), dtype=np.float32)
    _close(tspecial.vmf_pdf(torch.from_numpy(c), torch.from_numpy(k)),
           jspecial.vmf_pdf(c, k))
    k = np.exp(r.uniform(np.log(0.1), 5, N)).astype(np.float32)
    _close(tspecial.vmf_sample(torch.from_numpy(u[:, 0]),
                               torch.from_numpy(u[:, 1]),
                               torch.from_numpy(k)),
           jspecial.vmf_sample(u[:, 0], u[:, 1], k), rtol=1e-5, atol=1e-5)
    m = np.linspace(0, 0.99, 50).astype(np.float32)
    _close(tspecial.vmf_kappa_for_mean_cosine(torch.from_numpy(m)),
           jspecial.vmf_kappa_for_mean_cosine(m))


def _oriented(P, n=8):
    orient = np.zeros((n, n, n, 3), np.float32)
    orient[..., 0] = 1.0                             # +x, lower half
    orient[n // 2:, :, :, :] = [0.0, 1.0, 0.0]       # +y, upper half
    b = P.SceneBuilder()
    b.add_medium(kind=T.MED_HETEROGENEOUS, sigma_a=(0.1,) * 3,
                 sigma_s=(1.0,) * 3, phase_kind=T.PH_MICROFLAKE, kappa=8.0,
                 density=np.ones((n, n, n), np.float32),
                 density_aabb=((-1, -1, -1), (1, 1, 1)), orientation=orient)
    b.add_sphere([0, 0, 0], 1.0, bsdf=-1, interior=0)
    b.add_emitter(T.EM_POINT, radiance=(1.0,) * 3, position=(2, 2, 2))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0]), fov_deg=45)
    return b.build(), b.config


def test_orientation_axis_lookup():
    """tests/test_volpath.py's check: the field's axis in each half, and
    the phase value differs between them for the same directions; the
    port's axes equal JAX's at random points inside and outside."""
    scene, cfg = _oriented(tbuild)
    assert cfg.phase_orient and cfg.phase_kinds == (T.PH_MICROFLAKE,)
    p = torch.tensor([[0.0, 0.0, -0.7], [0.0, 0.0, 0.7]])
    idx = torch.zeros((2,), dtype=torch.int64)
    ax = tmedium.orientation_axis(scene.media, idx, p)
    np.testing.assert_allclose(ax[0].numpy(), [1, 0, 0], atol=1e-5)
    np.testing.assert_allclose(ax[1].numpy(), [0, 1, 0], atol=1e-5)
    wi = torch.tensor([[0.6, 0.0, 0.8]] * 2)
    wo = torch.tensor([[0.8, 0.0, -0.6]] * 2)
    v = tphase.eval(scene.media.phase, idx, wi, wo, axis_override=ax)
    assert abs(float(v[0] - v[1])) > 1e-4, v
    js, _ = _oriented(jbuild)
    r = np.random.default_rng(2)
    pts = r.uniform(-1.3, 1.3, (N, 3)).astype(np.float32)
    want = jmedium.orientation_axis(js.media, jnp.zeros((N,), jnp.int32),
                                    jnp.asarray(pts))
    got = tmedium.orientation_axis(scene.media,
                                   torch.zeros((N,), dtype=torch.int64),
                                   torch.from_numpy(pts))
    _close(got, want)
    # no field: the table's axis
    plain, _ = tpresets.volumetric_box(res=4, heterogeneous=True,
                                       density_res=8)
    got = tmedium.orientation_axis(plain.media, torch.zeros(3, dtype=torch.int64),
                                   torch.zeros((3, 3)))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 1]] * 3)


def _oriented_cube(P, filt):
    """test_oriented_render_runs's scene: a point-lit oriented microflake
    cube."""
    n = 8
    orient = np.zeros((n, n, n, 3), np.float32)
    orient[..., 2] = 1.0
    orient[:, :, : n // 2] = [0.6, 0.8, 0.0]
    b = P.SceneBuilder()
    m = b.add_medium(kind=T.MED_HETEROGENEOUS, sigma_a=(0.05,) * 3,
                     sigma_s=(2.0,) * 3, phase_kind=T.PH_MICROFLAKE,
                     kappa=6.0, density=np.ones((n, n, n), np.float32),
                     density_aabb=((-1, -1, -1), (1, 1, 1)),
                     orientation=orient)
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=m)
    b.add_emitter(T.EM_POINT, radiance=(30.0,) * 3, position=(1.5, 1.5, -1.5))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0]), fov_deg=45)
    scene = b.build()
    return scene, dataclasses.replace(b.config, width=12, height=12, spp=4,
                                      integrator="volpath", max_depth=3,
                                      filter=filt) if P is tbuild else \
        b.config._replace(width=12, height=12, spp=4, integrator="volpath",
                          max_depth=3, filter=filt)


@pytest.mark.parametrize("filt", ["gaussian", "box"])
def test_oriented_render_matches_jax(filt):
    """test_oriented_render_runs, on the loop road (gaussian) and the
    wavefront road (box; JAX's tracks through kernel C in interpret mode):
    the port's image against JAX's, within 1e-3 on >= 95% of the pixels;
    the field changes the image."""
    js, jc = _oriented_cube(jbuild, filt)
    ts, tc = _oriented_cube(tbuild, filt)
    if filt == "box":
        jc = jc._replace(wf_track_mega=1)
    want = np.asarray(jrender.render(js, jc, seed=0))
    got = trender.render(ts, tc, seed=0, device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.95, close.mean()
    flat = trender.render(ts, dataclasses.replace(tc, phase_orient=False),
                          seed=0, device="cpu").numpy()
    assert not np.allclose(flat, got)


@pytest.fixture(scope="module")
def _acoustic_stub():
    """JAX's acoustic-RIF Bessel functions as zeros while this file runs
    (tests/test_torch_er_grad.py::_acoustic_stub): the sphere's RIF is
    linear, so the branch is selected away, and the compile is 3-6x
    shorter without it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


EXT = (T.PH_RAYLEIGH, T.PH_VMF, T.PH_MIXTURE, T.PH_KKAY, T.PH_MICROFLAKE)


@pytest.mark.parametrize("kind", EXT)
def test_eikonal_road_phase_kinds_match_jax(kind, _acoustic_stub):
    """Each extended kind inside the refractive sphere on the eikonal road
    (single-solve BVP, 6x6, depth 3; phase_kinds holds all five, so JAX
    compiles once): the image equal to JAX's within 1e-3 on >= 90% of the
    lit pixels (the BVP's stop test flips lanes, ROADMAP Queue 3), mean
    within 1%."""
    def make(P):
        s, c = P.refractive_sphere(res=6, spp=2, max_depth=3, rif_kind=1,
                                   rif_params=(1.3, 0.15), er_stepsize=0.05,
                                   filter="box", sigma_s=(0.8,) * 3)
        return s, c
    js, jc = make(jpresets)
    ts, tc = make(tpresets)
    jph = js.media.phase._replace(
        kind=jnp.full_like(js.media.phase.kind, kind),
        mix=jnp.full_like(js.media.phase.g, 0.4),
        g2=jnp.full_like(js.media.phase.g, -0.5),
        kappa=jnp.full_like(js.media.phase.g, 6.0))
    js = js._replace(media=js.media._replace(phase=jph))
    tph = dataclasses.replace(
        ts.media.phase, kind=torch.full_like(ts.media.phase.kind, kind),
        mix=torch.full_like(ts.media.phase.g, 0.4),
        g2=torch.full_like(ts.media.phase.g, -0.5),
        kappa=torch.full_like(ts.media.phase.g, 6.0))
    ts = dataclasses.replace(ts, media=dataclasses.replace(ts.media,
                                                           phase=tph))
    jc = jc._replace(er_host_stepped=True, er_maxsteps=64, phase_kinds=EXT)
    tc = dataclasses.replace(tc, er_maxsteps=64, phase_kinds=EXT)
    want = np.asarray(jrender.render(js, jc, seed=0))
    got = trender.render(ts, tc, seed=0, device="cpu").numpy()
    assert np.isfinite(got).all()
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.2
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close[lit].mean() >= 0.9, close[lit].mean()
    assert abs(got.mean() / want.mean() - 1) <= 0.01
