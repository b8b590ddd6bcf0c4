"""The port's bidirectional path tracer (integrators/bdpt.py) against the
JAX package's `render_bdpt`, pixel by pixel on the same seeds at 8^2: the
cbox (spp 2, depth 3), the homogeneous point-lit box and the collimated
beam box of tests/test_bdpt.py (depth 3), the heterogeneous box (kernel
A's plain version), the refractive sphere with 64 transient frames
(t_max = s_max = 3, single BVP solve), and CW-ToF through bdpt; and
`_transient_slot`'s out-of-range lengths, which land in the first or last
frame.

JAX's reference runs eagerly (jax.disable_jit): its jitted pass takes
30-50 s to trace and compile for each configuration on the CPU, its eager
run 5-15 s, and both give the same image here. The eikonal case runs
JAX's passes eagerly with the curved march and the BVP solve jitted
(`_jax_render_bdpt_er`), and JAX's acoustic Bessel functions stubbed
(tests/test_torch_er_grad.py::_acoustic_stub): the linear RIF never
reads them.

Tolerances: a pixel agrees within 1e-4 relative plus 1e-6 of the image's
largest value; every pixel must agree but MAX_FLIPPED on the refractive
sphere (a BVP connection whose convergence test the two packages' ulps
decide differently moves its pixel), and the means within 1e-5 (1e-3 on
the sphere)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import bdpt as jbdpt
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import bdpt as tbdpt
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

MAX_FLIPPED = 2        # pixels of the sphere's 64 (measured: 0)
ER_FRAMES = dict(decomposition="transient", min_bound=2.0, max_bound=14.0,
                 bin_width=0.1875)


def _box(**kw):
    base = dict(res=8, spp=1, max_depth=3, heterogeneous=False,
                sigma_s=(0.6, 0.6, 0.6), sigma_a=(0.05, 0.05, 0.05),
                emitter_kind="point", filter="box", integrator="bdpt")
    base.update(kw)
    return (jpresets.volumetric_box(**base),
            tpresets.volumetric_box(**base))


def _cbox():
    kw = dict(res=8, spp=2, max_depth=3, boxes=False, filter="box",
              integrator="bdpt")
    return jpresets.cornell_box(**kw), tpresets.cornell_box(**kw)


def _sphere():
    kw = dict(res=8, spp=1, max_depth=3, rif_kind=1, rif_params=(1.3, 0.15),
              er_stepsize=2e-2, filter="box")
    ex = dict(integrator="bdpt", er_maxsteps=128, bvp_restarts=0,
              **ER_FRAMES)
    (js, jc), (ts, tc) = (jpresets.refractive_sphere(**kw),
                          tpresets.refractive_sphere(**kw))
    return (js, jc._replace(**ex)), (ts, dataclasses.replace(tc, **ex))


CASES = {
    "cbox": (_cbox, None),
    "point_box": (_box, None),
    "beam_box": (lambda: _box(sigma_s=(1.0, 1.0, 1.0),
                              emitter_kind="collimated"), None),
    "heterogeneous_box": (lambda: _box(heterogeneous=True, density_res=8),
                          None),
    "cwtof_box": (lambda: _box(modulation="sine", lambda_=4.0, phase=30.0),
                  None),
    "sphere_transient": (_sphere, 3),
}


@pytest.fixture
def _acoustic_stub():
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


def _jax_render_bdpt_er(js, jc, seed, t_max, monkeypatch):
    """JAX's render_bdpt with its passes run eagerly but the curved march
    and the BVP solve jitted: eagerly the solves take ~10 minutes, the
    whole pass jitted ~57 s to compile, this ~30 s."""
    monkeypatch.setattr(jek, "solve_bvp", jax.jit(
        jek.solve_bvp, static_argnames=(
            "h", "max_steps", "tol2", "newton_iters", "differentiable",
            "rr_weight", "max_restarts", "dir_match_tol2")))
    monkeypatch.setattr(jek, "trace_curved", jax.jit(
        jek.trace_curved, static_argnums=(5, 6)))
    npix = jc.width * jc.height
    eye = jnp.zeros((npix, 3 * jc.n_frames))
    splat = jnp.zeros((npix, 3 * jc.n_frames))
    for i in range(jc.spp):
        eye, splat = jbdpt._bdpt_pass(js, eye, splat, jc, t_max, t_max,
                                      jnp.uint32(seed), jnp.uint32(i),
                                      any_het=False, any_er=True)
    img = eye / jc.spp + splat / (jc.spp * npix)     # bdpt.py:685-686
    return img.reshape(jc.height, jc.width, 3 * jc.n_frames)


@pytest.mark.parametrize("name", list(CASES))
def test_render_bdpt_matches_jax(name, _acoustic_stub, monkeypatch):
    make, t_max = CASES[name]
    (js, jc), (ts, tc) = make()
    if name == "sphere_transient":
        want = np.asarray(_jax_render_bdpt_er(js, jc, 3, t_max, monkeypatch))
    else:
        with jax.disable_jit():
            want = np.asarray(jbdpt.render_bdpt(js, jc, seed=3, t_max=t_max,
                                                s_max=t_max))
    got = tbdpt.render_bdpt(ts, tc, seed=3, t_max=t_max,
                            s_max=t_max).numpy()
    assert got.shape == want.shape == (8, 8, 3 * tc.n_frames)
    assert np.isfinite(got).all() and (want != 0).any()
    scale = np.abs(want).max()
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6 * scale).all(-1)
    flipped = int((~ok).sum())
    print(f"{name}: {flipped} of {ok.size} pixels differ; means "
          f"{got.mean():.7g} / {want.mean():.7g}")
    if name == "sphere_transient":
        assert flipped <= MAX_FLIPPED
        assert abs(got.sum() / want.sum() - 1) <= 1e-3
    else:
        assert flipped == 0
        mean_scale = max(abs(float(want.mean())), 1e-6 * scale)
        assert abs(float(got.mean() - want.mean())) <= 1e-5 * mean_scale


def test_transient_slot_keeps_out_of_range_lengths_as_jax():
    """bdpt truncates the bin and clips it, without the common sink's mask:
    lengths before min_bound land in frame 0, lengths at or past
    max_bound in the last frame (bdpt.py:689-698)."""
    cfg = dict(decomposition="transient", min_bound=2.0, max_bound=6.0,
               bin_width=0.5)
    jc = jpresets.cornell_box(res=2, **cfg)[1]
    tc = tpresets.cornell_box(res=2, **cfg)[1]
    plen = np.float32([-5.0, 1.9, 2.0, 2.49, 5.99, 6.0, 40.0, 1.5])
    contrib = np.arange(24, dtype=np.float32).reshape(8, 3) + 1
    base = np.random.default_rng(0).uniform(0, 1, (8, 3 * 8)).astype(
        np.float32)
    want = np.asarray(jbdpt._transient_slot(jc, jnp.asarray(contrib),
                                            jnp.asarray(plen),
                                            jnp.asarray(base)))
    got = tbdpt._transient_slot(tc, torch.from_numpy(contrib),
                                torch.from_numpy(plen),
                                torch.from_numpy(base.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    frame = (got - base).reshape(8, 8, 3).sum(-1).argmax(-1)
    np.testing.assert_array_equal(frame, [0, 0, 0, 0, 7, 7, 7, 0])


def test_render_routes_bdpt():
    """render(integrator="bdpt") is render_bdpt on the scene's device, and
    a steady cbox render agrees with the path tracer's (a statistical
    check: the means within 15% at spp 16)."""
    (_, _), (ts, tc) = _cbox()
    stats = {}
    a = trender.render(ts, tc, seed=3, device="cpu", stats=stats)
    b = tbdpt.render_bdpt(ts, tc, seed=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(stats["passes"]) == tc.spp and stats["bdpt_s"] > 0
    cfg = dataclasses.replace(tc, spp=16, width=16, height=16)
    img_b = trender.render(ts, cfg, seed=1, device="cpu")
    img_p = trender.render(ts, dataclasses.replace(cfg, integrator="path"),
                           seed=2, device="cpu")
    assert abs(img_b.mean().item() / img_p.mean().item() - 1) < 0.15


def test_woodcock_settles_lanes_that_left_the_grid(monkeypatch):
    """bdpt's walks track with t_max 3e37 where no surface lies ahead, so a
    lane that left the density grid runs JAX's while loop to its cap
    (4,096 trips; 256 here) through zero density. The port stops such a
    loop once every running lane has left the grid for good and advances
    the sampler by the trips left: hits, distances, weights, trip count and
    the sampler equal the loop run to its cap, bit for bit."""
    from mitsubaer_tpu_torch.core import rng as trng
    from mitsubaer_tpu_torch.models import medium as tmedium

    (_, _), (ts, _) = _box(heterogeneous=True, density_res=8)
    n = 256
    r = np.random.default_rng(3)
    o = torch.from_numpy(r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
    d = r.normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)
                          ).astype(np.float32))
    t_max = torch.from_numpy(np.where(r.uniform(size=n) < 0.5, 3e37,
                                      r.uniform(0.5, 3.0, n)
                                      ).astype(np.float32))
    idx = torch.zeros((n,), dtype=torch.int64)
    _, sa, ss, scale = tmedium.params(ts.media, idx)

    def run():
        smp = trng.make_sampler(4, torch.arange(n), 1)
        return tmedium.sample_distance_woodcock(
            ts.media, sa, ss, scale, o, d, t_max, smp,
            torch.ones((n,), dtype=torch.bool), max_steps=256)

    hit, dist, w, _, smp, it, _ = run()
    monkeypatch.setattr(tmedium, "SETTLE_EVERY", 10 ** 9)
    hit_f, dist_f, w_f, _, smp_f, it_f, _ = run()
    assert it == it_f == 256 and hit.any()
    for a, b in ((hit, hit_f), (dist, dist_f), (w, w_f),
                 (smp.dim, smp_f.dim)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a loop that ends by itself is never settled: checked after every
    # trip, lanes that all stop at a trip end the loop there
    t_max = torch.clamp_max(t_max, 2.0)
    monkeypatch.setattr(tmedium, "SETTLE_EVERY", 1)
    hit_1, dist_1, w_1, _, smp_1, it_1, _ = run()
    monkeypatch.setattr(tmedium, "SETTLE_EVERY", 10 ** 9)
    hit_f, dist_f, w_f, _, smp_f, it_f, _ = run()
    assert it_1 == it_f < 256
    for a, b in ((hit_1, hit_f), (dist_1, dist_f), (w_1, w_f),
                 (smp_1.dim, smp_f.dim)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
