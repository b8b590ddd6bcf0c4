"""The port's multi-process driver (parallel/driver.py) on the CPU against
the JAX package's shard_map driver on the 8-device virtual mesh: the
sharded render over a (2, 2) layout at world size 1 against JAX's
render_sharded(n_devices=4, tile=2) on the loop road and on the wavefront
road, a row block of the wavefront engine (row0 / full_height) against
JAX's, one sharded training step against JAX's make_train_step with
optax.adam, and two processes over gloo against one, bit for bit."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mitsubaer_tpu.diff import render as jdiff
from mitsubaer_tpu.integrators import wavefront as jwf
from mitsubaer_tpu.parallel import driver as jdriver
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.diff import render as tdiff
from mitsubaer_tpu_torch.integrators import wavefront as twf
from mitsubaer_tpu_torch.parallel import driver as tdriver
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

RES = 16
LAYOUT = (2, 2)
# the loop road: the heterogeneous box with its beam and gaussian filter;
# the wavefront road: the homogeneous point-lit box, box filter (no
# tracking, so the JAX engine's tracking variant does not matter)
ROADS = {
    "loop": (dict(heterogeneous=True, density_res=8), {}),
    "wavefront": (dict(heterogeneous=False, emitter_kind="point",
                       filter="box"), dict(engine="wavefront")),
}


def _pair(kw, cfg_kw, **more):
    js, jc = jpresets.volumetric_box(res=RES, **kw, **more)
    ts, tc = tpresets.volumetric_box(res=RES, **kw, **more)
    return (js, jc._replace(**cfg_kw), ts,
            dataclasses.replace(tc, **cfg_kw))


def _assert_close(got, want, share=0.99):
    """The image within rtol 1e-3 on >= share of the pixels, as the loop
    road's test holds render() (tests/test_torch_loop_render.py), and a
    median pixel ratio within 1e-3 of 1."""
    assert got.shape == want.shape and np.isfinite(got).all()
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.1
    ratio = np.median(got.mean(-1)[lit] / want.mean(-1)[lit])
    assert 0.999 <= ratio <= 1.001, ratio
    close = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= share, close.mean()


@pytest.mark.parametrize("road", sorted(ROADS))
def test_render_sharded_matches_jax(road):
    js, jc, ts, tc = _pair(*ROADS[road], spp=4, max_depth=3)
    want = np.asarray(jdriver.render_sharded(js, jc, n_devices=4, tile=2,
                                             seed=3))
    stats = {}
    got = tdriver.render_sharded(ts, tc, LAYOUT, seed=3, device="cpu",
                                 stats=stats).numpy()
    assert stats["shards"] == [0, 1, 2, 3]
    _assert_close(got, want)


def test_wavefront_row_block_matches_jax():
    """Rows [8, 16) of a 16-row image through the engine, with the
    heterogeneous point-lit box: kernel C tracks (the JAX engine in its
    Pallas interpret mode, the port's plain version), and row0 enters the
    tracking seed and the lanes' global pixels."""
    js, jc, ts, tc = _pair(dict(heterogeneous=True, density_res=8,
                                emitter_kind="point", filter="box"),
                           dict(engine="wavefront"), spp=2, max_depth=3)
    rows = RES // 2
    want, _ = jwf.render_wavefront(js, jc._replace(height=rows,
                                                   wf_track_mega=1), 2,
                                   jnp.uint32(3), jnp.uint32(1), row0=rows,
                                   full_height=RES)
    got, st = twf.render_wavefront(ts, dataclasses.replace(tc, height=rows),
                                   2, 3, 1, row0=rows, full_height=RES)
    want = np.asarray(want)
    close = np.isclose(got.numpy(), want, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert want.mean() > 0 and st.tolist()[1] > 0       # taps: C tracked
    # another block is another image
    other, _ = twf.render_wavefront(ts, dataclasses.replace(tc, height=rows),
                                    2, 3, 1, row0=0, full_height=RES)
    assert not torch.equal(other, got)


TRAIN_LR = 5e-2
# Adam's epsilon, large: the first step then moves each entry by
# -lr g / (|g| + 1), a smooth function of the gradient g, from which JAX's
# gradient is recovered (with the default epsilon the step is lr sign(g),
# which hides the gradient's value and flips with it where g is tiny)
TRAIN_EPS = 1.0
FIELDS = ("sigma_a", "sigma_s", "density", "g")


@functools.cache
def _train_pair():
    """JAX's (initial params, updated params, loss) and the port's
    (updated leaves with their gradients, loss) of one training step at
    layout (2, 2) on the beam-lit heterogeneous box at 16^2, sppc 1, depth
    3, Adam, against a target rendered with sigma_s scaled by 1.5."""
    kw = dict(res=RES, spp=2, heterogeneous=True, density_res=8,
              max_depth=3)
    js, jc = jpresets.volumetric_box(**kw)
    ts, tc = tpresets.volumetric_box(**kw)
    p0 = tdiff.get_params(ts)
    with torch.no_grad():
        target = tdiff.render_diff(ts, p0._replace(sigma_s=p0.sigma_s * 1.5),
                                   tc, 2, 11, 0, device="cpu").numpy()
    jp = jdiff.get_params(js)
    opt = optax.adam(TRAIN_LR, eps=TRAIN_EPS)
    jstep = jdriver.make_train_step(jc, opt, jdriver.make_mesh(4, tile=2),
                                    sppc=1)
    jp2, _, jloss = jstep(js, opt.init(jp), jp, jnp.asarray(target),
                          jnp.asarray(5, jnp.uint32))
    leaves = tdiff.MediumParams(*(t.detach().clone().requires_grad_()
                                  for t in p0))
    topt = torch.optim.Adam(leaves, lr=TRAIN_LR, eps=TRAIN_EPS)
    tstep = tdriver.make_train_step(tc, topt, LAYOUT, sppc=1, device="cpu")
    tloss = tstep(ts, leaves, target, 5)
    return (jp, jp2, float(jloss)), (leaves, float(tloss))


def test_train_step_matches_jax():
    """The loss within rtol 1e-5, and each field's gradient (the port's
    .grad against the one JAX's update implies) and update within 1e-3 of
    the field's largest JAX magnitude, as tests/test_torch_diff.py holds
    loss_and_grad; no field's gradient is zero."""
    (jp0, jp2, jloss), (tp, tloss) = _train_pair()
    assert np.isfinite(tloss) and tloss > 0
    assert abs(tloss - jloss) <= 1e-5 * jloss, (tloss, jloss)
    for f in FIELDS:
        u_j = (np.asarray(getattr(jp2, f), np.float64)
               - np.asarray(getattr(jp0, f), np.float64))
        g_j = -u_j * TRAIN_EPS / (TRAIN_LR - np.abs(u_j))
        g_t = getattr(tp, f).grad.numpy()
        u_t = (getattr(tp, f).detach().numpy().astype(np.float64)
               - np.asarray(getattr(jp0, f), np.float64))
        scale = np.abs(g_j).max()
        assert np.isfinite(g_t).all()
        assert scale > 0, f
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-3 * scale,
                                   err_msg=f"d loss / d {f}")
        np.testing.assert_allclose(u_t, u_j, rtol=0,
                                   atol=1e-3 * np.abs(u_j).max(),
                                   err_msg=f"update of {f}")


def test_two_processes_equal_one():
    """dryrun_multiprocess at world size 2 runs; a sharded render over one
    (2, 2) layout by two gloo processes equals one process's, bit for
    bit."""
    import json

    assert "OK" in tdriver.dryrun_multiprocess(2, "cpu")
    kw = json.dumps(dict(res=RES, spp=4, heterogeneous=True, density_res=8,
                         max_depth=3))
    outs = {n: json.loads(tdriver.spawn(
        n, "mitsubaer_tpu_torch.parallel.driver:render_child", kw, "2,2",
        "1", "cpu")[0].strip().splitlines()[-1]) for n in (1, 2)}
    assert outs[1]["shards"] == [0, 1, 2, 3] and outs[2]["shards"] == [0, 2]
    assert outs[1]["crc32"] == outs[2]["crc32"]
    assert outs[1]["mean"] > 0
