"""The homogeneous distance-sampling strategies (cfg.medium_strategies,
homogeneous.cpp EBalance / ESingle / EManual / EMaximum) in the port
against the JAX package on the CPU: the sampler and its pdfs lane by lane,
the three engines that read them (the loop engine's li, the wavefront
engine, the eikonal li) lane by lane on a homogeneous medium, the training
path's loss_and_grad under STRAT_MAXIMUM, and the scene fields.

Each JAX engine is jitted once with the scene as an argument and run for
every strategy: the strategy is data (Media.strategy), only the config's
medium_strategies flag is static. Tolerances: the sampler within 1e-5
relative (its distances and pdfs) and 1e-5 absolute; the engines at the
tolerances of their files (tests/test_torch_volpath.py: sinks within rtol
1e-4, atol 1e-6 on >= 98% of lanes, after the sampler dimensions agree;
tests/test_torch_wavefront.py: pass films within rtol 1e-3 on >= 99% of
pixels; tests/test_torch_volpath_er.py: rtol 1e-3 on >= 95% of lit pixels,
one lane a pixel at spp 1 and a box filter, so pixel by pixel is lane by
lane); loss_and_grad at tests/test_torch_diff.py's (the loss within rtol
1e-5, each gradient field within 1e-3 of its largest JAX magnitude).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.diff import render as jdiff
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.integrators import volpath as jvp
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.models import medium as jmedium
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import transform as tf
from mitsubaer_tpu_torch.diff import render as tdiff
from mitsubaer_tpu_torch.integrators import common as tcommon
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _acoustic_stub():
    """JAX's acoustic Bessel functions as zeros while this file runs (see
    tests/test_torch_er_grad.py::_acoustic_stub): the eikonal case's RIF
    is linear, which selects that branch away, and without it the JAX
    bounce compiles in a fraction of the time."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


STRATS = {"balance": T.STRAT_BALANCE, "single": T.STRAT_SINGLE,
          "manual": T.STRAT_MANUAL, "maximum": T.STRAT_MAXIMUM}
ENGINE_STRATS = ("single", "manual", "maximum")
MANUAL_DENSITY = 1.7
SIGMA_S = (0.5, 3.5, 7.5)          # chromatic, as volumetric_box's


# ---------------------------------------------------------------------------
# the sampler and its pdfs
# ---------------------------------------------------------------------------
def _sampler_inputs(n, equal, seed):
    r = np.random.default_rng(seed)
    sa = r.uniform(0.01, 0.3, (n, 3))
    ss = r.uniform(0.2, 4.0, (n, 3))
    if equal:
        # equal channels, and pairs closer than the crossover's 1e-9 test
        ss[:, 1:] = ss[:, :1]
        sa[:, 1:] = sa[:, :1]
    ss[: n // 8, 2] = ss[: n // 8, 0]
    sa[: n // 8, 2] = sa[: n // 8, 0]
    f = lambda a: a.astype(np.float32)
    return dict(sa=f(sa), ss=f(ss), w=f(r.uniform(0.4, 1.0, n)),
                t_max=f(np.where(r.uniform(size=n) < 0.3, 1e7,
                                 r.uniform(0.05, 3.0, n))),
                u=f(r.uniform(0, 1, n)), uc=f(r.uniform(0, 1, n)),
                md=f(r.uniform(0.3, 5.0, n)))


@jax.jit
def _jax_sampler(sa, ss, w, t_max, u, uc, strat, md):
    out = jmedium.sample_distance_homogeneous(sa, ss, w, t_max, u, uc,
                                              strategy=strat,
                                              manual_density=md)
    pdfs = jmedium.homog_strategy_pdfs(sa + ss, out[1], strat, md)
    return out, pdfs


@pytest.mark.parametrize("equal", [False, True], ids=["chromatic", "equal"])
@pytest.mark.parametrize("strat", list(STRATS))
def test_sampler_matches_jax_per_lane(strat, equal):
    """sample_distance_homogeneous (success, distance, weight, log_pdf)
    and homog_strategy_pdfs at its distance, lane by lane; every decision
    equal."""
    x = _sampler_inputs(512, equal, 3 + STRATS[strat])
    strat_lanes = np.full(512, STRATS[strat], np.int32)
    (want, pdfs_j) = _jax_sampler(x["sa"], x["ss"], x["w"], x["t_max"],
                                  x["u"], x["uc"], strat_lanes, x["md"])
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = tmedium.sample_distance_homogeneous(
        t["sa"], t["ss"], t["w"], t["t_max"], t["u"], t["uc"],
        torch.from_numpy(strat_lanes), t["md"])
    pdfs_t = tmedium.homog_strategy_pdfs(t["sa"] + t["ss"], got[1],
                                         torch.from_numpy(strat_lanes),
                                         t["md"])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0.2 < got[0].float().mean() < 0.9
    for a, b, what in zip(got[1:], want[1:], ("dist", "weight", "log_pdf")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
    for a, b in zip(pdfs_t, pdfs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_strategies_differ_and_balance_is_the_default():
    """Each strategy samples its own distances; STRAT_BALANCE gives what
    the balance sampler without a strategy gives."""
    x = {k: torch.from_numpy(v)
         for k, v in _sampler_inputs(256, False, 9).items()}
    args = (x["sa"], x["ss"], x["w"], x["t_max"], x["u"], x["uc"])
    plain = tmedium.sample_distance_homogeneous(*args)
    dists = {}
    for name, k in STRATS.items():
        out = tmedium.sample_distance_homogeneous(
            *args, torch.full((256,), k, dtype=torch.int32), x["md"])
        dists[name] = out[1]
        if name == "balance":
            for a, b in zip(out, plain):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a in STRATS:
        for b in STRATS:
            if a < b:
                assert not torch.equal(dists[a], dists[b]), (a, b)


def test_maxexp_pdf_integrates_to_its_cdf():
    """The MaxExpDist's pdf integrates to its cdf and the cdf reaches 1."""
    sigma = torch.tensor([[3.0, 0.5, 1.2], [2.0, 2.0, 0.1],
                          [1.0, 1.0, 1.0]], dtype=torch.float64)
    t = torch.linspace(0, 150, 300001, dtype=torch.float64)
    for s in sigma:
        pdf, cdf = tmedium._maxexp_pdf_cdf(s.expand(t.shape[0], 3), t)
        integral = torch.cumulative_trapezoid(pdf, t)
        torch.testing.assert_close(integral, cdf[1:], rtol=0, atol=1e-6)
        assert abs(float(cdf[-1]) - 1) < 1e-4


# ---------------------------------------------------------------------------
# the scene fields
# ---------------------------------------------------------------------------
def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _strategy_media(B, types, strategy):
    b = B.SceneBuilder()
    b.add_medium(kind=types.MED_HOMOGENEOUS, sigma_s=SIGMA_S,
                 strategy=strategy, manual_density=MANUAL_DENSITY)
    b.add_medium(kind=types.MED_HOMOGENEOUS, sigma_s=(1.0,) * 3)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    return b.build(), b.config


@pytest.mark.parametrize("strat", list(STRATS))
def test_builder_and_scene_from_numpy_carry_the_strategy(strat):
    """Both builders store the strategy and manual density per medium and
    set medium_strategies where some medium leaves balance;
    scene_from_numpy carries the JAX scene's two fields."""
    js, jc = _strategy_media(jbuild, JT, STRATS[strat])
    ts, tc = _strategy_media(tbuild, T, STRATS[strat])
    carried = T.scene_from_numpy(_tree(js))
    for scene in (ts, carried):
        assert scene.media.strategy.tolist() == [STRATS[strat], 0]
        np.testing.assert_array_equal(
            scene.media.manual_density.numpy(),
            np.asarray(js.media.manual_density))
        assert scene.media.strategy.dtype == torch.int32
    assert tc.medium_strategies == jc.medium_strategies == (strat !=
                                                           "balance")


# ---------------------------------------------------------------------------
# the engines on a homogeneous medium
# ---------------------------------------------------------------------------
def _with_strategy(scene, strat, jax_scene):
    if jax_scene:
        media = scene.media._replace(
            strategy=jnp.full_like(scene.media.strategy, strat),
            manual_density=jnp.full_like(scene.media.manual_density,
                                         MANUAL_DENSITY))
        return scene._replace(media=media)
    media = dataclasses.replace(
        scene.media, strategy=torch.full_like(scene.media.strategy, strat),
        manual_density=torch.full_like(scene.media.manual_density,
                                       MANUAL_DENSITY))
    return dataclasses.replace(scene, media=media)


LOOP_RES, LOOP_SPPC, LOOP_SEED = 10, 4, 7


def _loop_scenes():
    kw = dict(res=LOOP_RES, spp=LOOP_SPPC, max_depth=6, heterogeneous=False,
              sigma_s=SIGMA_S)
    (js, jc), (ts, tc) = (jpresets.volumetric_box(**kw),
                          tpresets.volumetric_box(**kw))
    return (js, jc._replace(medium_strategies=True), ts,
            dataclasses.replace(tc, medium_strategies=True))


@functools.cache
def _jax_loop_li():
    js, jc, _, _ = _loop_scenes()

    @jax.jit
    def run(scene, o, d, lane, index):
        s = jrng.make_sampler(jnp.uint32(LOOP_SEED), lane, index)
        s = s._replace(dim=s.dim + jnp.uint32(4))       # the camera draws
        sink, s = jvp.li(scene, jc, o, d, s)
        return sink.steady, s.dim

    return run


@pytest.mark.parametrize("strat", ENGINE_STRATS)
def test_loop_li_matches_jax_per_lane(strat):
    js, _, ts, tc = _loop_scenes()
    ts = _with_strategy(ts, STRATS[strat], False)
    rays, _, smp = tcommon.camera_samples(ts, tc, LOOP_SPPC, LOOP_SEED, 0)
    got, smp_t, _ = tvp.li(ts, tc, rays.o, rays.d, smp)
    want, dim = _jax_loop_li()(
        _with_strategy(js, STRATS[strat], True), rays.o.numpy(),
        rays.d.numpy(), smp.lane.numpy().astype(np.uint32),
        smp.index.numpy().astype(np.uint32))
    np.testing.assert_array_equal(smp_t.dim.numpy(), np.asarray(dim))
    want = np.asarray(want)
    got = got.steady.numpy()
    assert np.isfinite(got).all() and (want.sum(-1) > 0).mean() > 0.03
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"loop li {strat}: {int((~close).sum())} of {close.size} lanes "
          f"differ")
    assert close.mean() >= 0.98, close.mean()
    # the strategy changes what the engine renders
    base, _, _ = tvp.li(_with_strategy(ts, T.STRAT_BALANCE, False), tc,
                        rays.o, rays.d, smp)
    assert not torch.equal(base.steady, torch.from_numpy(got))


WF_RES, WF_SPPC = 8, 4


def _wf_scenes():
    kw = dict(res=WF_RES, spp=WF_SPPC, max_depth=4, heterogeneous=False,
              emitter_kind="point", sigma_s=SIGMA_S)
    js, jc = jpresets.volumetric_box(**kw)
    jc = jc._replace(filter="box", engine="wavefront", wf_track_mega=1,
                     medium_strategies=True)
    ts, tc = tpresets.volumetric_box(filter="box", **kw)
    return js, jc, ts, dataclasses.replace(tc, medium_strategies=True)


@pytest.mark.parametrize("strat", ENGINE_STRATS)
def test_wavefront_pass_matches_jax(strat):
    """A wavefront pass's film and stats on the point-lit homogeneous
    box."""
    js, jc, ts, tc = _wf_scenes()
    L_j, st_j = jrender.render_pass_wavefront(
        _with_strategy(js, STRATS[strat], True),
        jnp.zeros((WF_RES * WF_RES, 3), jnp.float32), jc, WF_SPPC,
        jnp.uint32(3), jnp.uint32(1), has_direct=True, any_het=False)
    L_t, st_t = trender.render_pass_wavefront(
        _with_strategy(ts, STRATS[strat], False),
        torch.zeros((WF_RES * WF_RES, 3)), tc, WF_SPPC, 3, 1,
        has_direct=True, any_het=False)
    st_j, st_t = [int(s) for s in st_j], st_t.tolist()
    for i in range(3):
        assert abs(st_t[i] - st_j[i]) <= 0.01 * st_j[i], (st_t, st_j)
    want, got = np.asarray(L_j), L_t.numpy()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert want.mean() > 0


ER_KW = dict(res=12, spp=1, max_depth=3, rif_kind=1,
             rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=1e-2,
             filter="box", sigma_s=(0.2, 0.6, 1.4))
ER_CFG = dict(er_maxsteps=64, er_bvp_hscale=4.0, medium_strategies=True)


@pytest.mark.parametrize("strat", ENGINE_STRATS)
def test_eikonal_li_matches_jax_per_lane(strat):
    """The eikonal render at spp 1 with a box filter (a pixel is a lane)
    against the JAX render's host-stepped ER loop, whose jitted bounce
    takes the scene as an argument."""
    js, jc = jpresets.refractive_sphere(**ER_KW)
    jc = jc._replace(er_host_stepped=True, **ER_CFG)
    want = np.asarray(jrender.render(
        _with_strategy(js, STRATS[strat], True), jc, seed=0))
    ts, tc = tpresets.refractive_sphere(**ER_KW)
    tc = dataclasses.replace(tc, **ER_CFG)
    got = trender.render(_with_strategy(ts, STRATS[strat], False), tc,
                         seed=0, device="cpu").numpy()
    assert got.shape == want.shape == (12, 12, 3)
    assert np.isfinite(got).all()
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=0).all(-1)
    print(f"eikonal li {strat}: {int((~close[lit]).sum())} of "
          f"{int(lit.sum())} lit lanes differ")
    assert close[lit].mean() >= 0.95


# ---------------------------------------------------------------------------
# the training path under STRAT_MAXIMUM
# ---------------------------------------------------------------------------
def _hg_box(B, types):
    """tests/test_torch_diff.py's homogeneous HG box, sampled with the
    maximum strategy."""
    b = B.SceneBuilder()
    med = b.add_medium(kind=types.MED_HOMOGENEOUS, sigma_a=(0.2,) * 3,
                       sigma_s=(0.8,) * 3, phase_kind=types.PH_HG, g=0.3,
                       strategy=types.STRAT_MAXIMUM)
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    b.add_emitter(types.EM_POINT, radiance=(20.0,) * 3, position=(0, 0.5, -3))
    b.set_perspective_sensor(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), 30)
    kw = dict(width=6, height=6, spp=1, max_depth=4, integrator="volpath")
    b.config = (b.config._replace(**kw) if hasattr(b.config, "_replace")
                else dataclasses.replace(b.config, **kw))
    return b.build(), b.config


@functools.partial(jax.jit, static_argnames=("cfg", "sppc"))
def _jax_loss_and_grad(scene, params, cfg, sppc, seed, pass_idx, target):
    def loss(p):
        img = jdiff.render_diff(scene, p, cfg, sppc, seed, pass_idx)
        return jnp.mean((img - target) ** 2), img

    return jax.value_and_grad(loss, has_aux=True)(params)


def test_loss_and_grad_under_maximum_matches_jax():
    """loss_and_grad on the HG box under STRAT_MAXIMUM, its sigma made
    chromatic by seeded factors (so the MaxExpDist has three segments):
    the loss and the sigma_a, sigma_s and g gradients, with the maximum
    strategy's attached log-density in the score term."""
    (js, jc), (ts, tc) = _hg_box(jbuild, JT), _hg_box(tbuild, T)
    assert jc.medium_strategies and tc.medium_strategies
    jp = jdiff.get_params(js)
    r = np.random.default_rng(11)
    arrays = {k: np.asarray(v, np.float32) for k, v in jp._asdict().items()}
    arrays["sigma_a"] = (arrays["sigma_a"] * r.uniform(0.5, 1.5, (1, 3))
                         ).astype(np.float32)
    arrays["sigma_s"] = (arrays["sigma_s"] * r.uniform(0.3, 2.0, (1, 3))
                         ).astype(np.float32)
    target = r.uniform(0.0, 0.1, (6, 6, 3)).astype(np.float32)
    (loss_j, _), grad_j = _jax_loss_and_grad(
        js, jdiff.MediumParams(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
        jc, 2, jnp.uint32(3), jnp.uint32(1), target)
    loss_t, grad_t = tdiff.loss_and_grad(
        ts, tdiff.params_from_numpy(arrays), tc, 2, 3, 1, target,
        device="cpu")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for field in ("sigma_a", "sigma_s", "g"):
        got = getattr(grad_t, field).numpy()
        want = np.asarray(getattr(grad_j, field))
        scale = np.abs(want).max()
        assert scale > 0 and np.isfinite(got).all()
        err = np.abs(got - want).max()
        print(f"d loss / d {field}: max |diff| / max |JAX| {err / scale:.2e}")
        assert err <= 1e-3 * scale, (field, err, scale)
