"""The port's wavefront engine against the JAX package's, on the CPU.

The JAX side runs render_pass_wavefront with wf_track_mega=1, so kernel C
runs in Pallas interpret mode (as bench.py and tests/test_megatrack.py run
it), and the port runs megatrack.run_plain. Both engines draw the same
sampler and tap bits, so a lane takes the same branches in both unless a
float differs by an ulp right at a decision (XLA fuses multiply-adds on the
CPU, the port rounds every product). Four JAX configurations are compiled,
each once: the point-lit heterogeneous box (its first two event passes and
a whole pass, in one jit), the beam box, the homogeneous point-lit box, and
the single-scatter quadrature.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.integrators import wavefront as jwf
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.utils import validate as jvalidate
from mitsubaer_tpu_torch.integrators import boxwalk as tbw
from mitsubaer_tpu_torch.integrators import megatrack as tmt
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import wavefront as twf
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T
from mitsubaer_tpu_torch.utils import validate as tvalidate

torch.set_num_threads(1)

RES, SPPC = 8, 4
# name: (volumetric_box kwargs, wf_mini_passes, has_direct, any_het)
CASES = {
    "point_het": (dict(heterogeneous=True, density_res=16,
                       emitter_kind="point"), 1, True, True),
    "beam": (dict(heterogeneous=True, density_res=16), 2, False, True),
    "point_homogeneous": (dict(heterogeneous=False, emitter_kind="point"), 1,
                          True, False),
}


def _scenes(name):
    kw, mini, _, _ = CASES[name]
    js, jc = jpresets.volumetric_box(res=RES, spp=SPPC, max_depth=4, **kw)
    jc = jc._replace(filter="box", engine="wavefront", wf_track_mega=1,
                     wf_mini_passes=mini)
    ts, tc = tpresets.volumetric_box(res=RES, spp=SPPC, max_depth=4,
                                     filter="box", wf_mini_passes=mini, **kw)
    return js, jc, ts, tc


@functools.cache
def _jax_pass(name):
    """(film, stats, first two event-pass states or None) of the JAX
    engine. The point-lit case steps its first passes inside the same jit,
    so that it compiles once."""
    _, _, hd, het = CASES[name]
    js, jc, _, _ = _scenes(name)
    seed, pass_idx = jnp.uint32(3), jnp.uint32(1)
    if name != "point_het":
        L, stats = jrender.render_pass_wavefront(
            js, jnp.zeros((RES * RES, 3), jnp.float32), jc, SPPC, seed,
            pass_idx, has_direct=hd, any_het=het)
        return np.asarray(L), [int(s) for s in stats], None

    @jax.jit
    def run(scene):
        st, event_pass, _, _, _ = jwf.make_engine(scene, jc, SPPC, seed,
                                                  pass_idx)
        s1 = event_pass(st)
        firsts = (s1, event_pass(s1, mini=True))
        return jwf.render_wavefront(scene, jc, SPPC, seed, pass_idx), firsts

    (L, stats), firsts = run(js)
    return (np.asarray(L), [int(s) for s in stats],
            jax.tree_util.tree_map(np.asarray, firsts))


@functools.cache
def _port_pass(name):
    _, _, hd, het = CASES[name]
    _, _, ts, tc = _scenes(name)
    L, stats = trender.render_pass_wavefront(
        ts, torch.zeros((RES * RES, 3)), tc, SPPC, 3, 1, has_direct=hd,
        any_het=het)
    return L.numpy(), stats.tolist()


_INT_FIELDS = ("hit_valid", "hit_shape", "medium", "depth", "last_delta",
               "sample_idx", "path_alive", "ext_tracking", "ext_done",
               "ext_scat", "sh_active", "sh_need_isect", "sh_med",
               "sh_hit_null", "sh_cross_med", "pix", "sample_open", "tap_ctr",
               "n_segments", "n_taps", "pending")


@pytest.mark.parametrize("passes", [1, 2])
def test_event_passes_match_jax_state(passes):
    """After a full event pass (and then a transition pass) from the initial
    state, every WFState field equals JAX's, the sampler's lane, index and
    dim included: this pins the order of the sampler draws."""
    want = _jax_pass("point_het")[2][passes - 1]
    _, _, ts, tc = _scenes("point_het")
    st, event_pass, _, _, _ = twf.make_engine(ts, tc, SPPC, 3, 1)
    st = event_pass(st)
    if passes == 2:
        st = event_pass(st, mini=True)
    assert st.it == int(want.it) == 1
    for f in ("lane", "index", "dim"):
        np.testing.assert_array_equal(getattr(st.sampler, f).numpy(),
                                      getattr(want.sampler, f), err_msg=f)
    for f in twf.WFState.__dataclass_fields__:
        if f in ("sampler", "it"):
            continue
        got, ref = getattr(st, f).numpy(), getattr(want, f)
        if f in _INT_FIELDS:
            np.testing.assert_array_equal(got, ref, err_msg=f)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f)
    # pass 1 starts every sample in vacuum; pass 2 carries lanes over the
    # box's null wall into the medium, where tracking begins
    assert bool(st.sample_open.all())
    assert bool(st.ext_tracking.any()) == (passes == 2)


@pytest.mark.parametrize("name", list(CASES))
def test_pass_stats_match_jax(name):
    """[segments, taps, super-iterations, unfinished] within 1% of JAX's."""
    got, want = _port_pass(name)[1], _jax_pass(name)[1]
    for i in range(3):
        assert abs(got[i] - want[i]) <= 0.01 * want[i], (got, want)
    assert got[3] == want[3] == 0
    assert (got[1] > 0) == CASES[name][3]            # taps only when het


@pytest.mark.parametrize("name", list(CASES))
def test_pass_film_matches_jax(name):
    """The (npix, 3) radiance sums within rtol 1e-3 on >= 99% of pixels."""
    got, want = _port_pass(name)[0], _jax_pass(name)[0]
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert want.mean() > 0


def test_every_pixel_gets_exactly_sppc_samples():
    """A constant environment seen by every camera ray renders to a
    constant image only if the rotated lane->pixel assignment gives every
    pixel exactly sppc samples."""
    b = tbuild.SceneBuilder()
    b.add_emitter(T.EM_CONSTANT, radiance=(0.5, 0.5, 0.5))
    b.set_perspective_sensor(to_world=np.eye(4, dtype=np.float32),
                             fov_deg=45.0)
    b.config = replace(b.config, width=8, height=6, max_depth=2,
                       integrator="volpath", filter="box")
    scene, cfg = b.build(), b.config
    L, stats = trender.render_pass_wavefront(
        scene, torch.zeros((48, 3)), cfg, 5, 0, 0,
        has_direct=trender._has_direct(scene), any_het=False)
    np.testing.assert_allclose(L.numpy() / 5.0, 0.5, atol=1e-6)
    assert stats.tolist()[3] == 0


def _anchor_scene():
    return tpresets.volumetric_box(res=12, spp=256, max_depth=2,
                                   heterogeneous=True, density_res=32,
                                   emitter_kind="point", filter="box")


@functools.cache
def _port_quadrature():
    scene, cfg = _anchor_scene()
    return tvalidate.single_scatter_quadrature(scene, cfg)


def test_quadrature_matches_jax():
    js, jc = jpresets.volumetric_box(res=12, spp=1, max_depth=2,
                                     heterogeneous=True, density_res=32,
                                     emitter_kind="point", filter="box")
    want = jvalidate.single_scatter_quadrature(js, jc)
    got = _port_quadrature()
    assert got.shape == (12, 12, 3) and want.mean() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * want.max())


def test_render_matches_quadrature_anchor():
    """render() on the point-lit heterogeneous box at max_depth 2 (single
    scatter) within 5% of the deterministic quadrature, over seeds 1 and 3,
    as tests/test_wavefront.py holds the JAX engines."""
    scene, cfg = _anchor_scene()
    truth = _port_quadrature().mean()
    stats = {}
    got = np.mean([trender.render(scene, cfg, seed=s, device="cpu",
                                  stats=stats).mean().item() for s in (1, 3)])
    assert abs(got - truth) / truth < 0.05, (got, truth)
    assert "wavefront_s" in stats and "boxwalk_s" not in stats
    assert all(p[3] == 0 for p in stats["passes"])


@pytest.mark.parametrize("emitter_kind,road", [("point", "wavefront"),
                                               ("collimated", "boxwalk")])
def test_render_routing(emitter_kind, road):
    """The point-lit box takes the wavefront road and the beam box keeps
    boxwalk; both run on the card unless device="cpu" is passed. On the
    CPU neither kernel wrapper counts a launch."""
    scene, cfg = tpresets.volumetric_box(res=6, spp=2, heterogeneous=True,
                                         density_res=8, max_depth=2,
                                         filter="box",
                                         emitter_kind=emitter_kind)
    assert tbw.supported(scene, cfg) == (road == "boxwalk")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.render(scene, cfg)
    launches = tmt.run.launches, tbw.walk.launches
    stats = {}
    img = trender.render(scene, cfg, seed=0, device="cpu", stats=stats)
    assert set(stats) == {"passes", f"{road}_s"}
    assert (tmt.run.launches, tbw.walk.launches) == launches
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    if road == "wavefront":
        L, _ = trender.render_pass_wavefront(
            scene, torch.zeros((36, 3)), cfg, 2, 0, 0)
        np.testing.assert_allclose(img.numpy(), (L / 2).reshape(6, 6, 3),
                                   rtol=1e-6)
