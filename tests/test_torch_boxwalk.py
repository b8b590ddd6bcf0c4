"""Kernel B's plain version (the boxwalk state machine) against the JAX
package's render_boxwalk in Pallas interpret mode, lane by lane.

Both walks draw the same lowbias32 bits, so a lane takes the same branches
in both unless a float differs by an ulp right at a decision (XLA's and
PyTorch's CPU log/sin/cos may differ by an ulp). The tolerance allows up to
5% of pixels to differ for that reason; measured on these cases the rate is
0 (every pixel within rtol 1e-3, equal segment and tap counts).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.integrators import boxwalk as jbw
from mitsubaer_tpu.integrators import megatrack as jmt
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.integrators import boxwalk as tbw
from mitsubaer_tpu_torch.integrators import megatrack as tmt
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _jax_scene(res=12, density_res=16, max_depth=3, g=0.7):
    scene, cfg = jpresets.volumetric_box(
        res=res, spp=1, heterogeneous=True, density_res=density_res,
        max_depth=max_depth, g=g)
    return scene, cfg._replace(filter="box", engine="wavefront")


def _carry(scene, cfg):
    return T.scene_from_numpy(_tree(scene)), T.config_from_dict(cfg._asdict())


def test_supported_gate_parity():
    """The cases of tests/test_boxwalk.py::test_supported_gate."""
    js, jc = _jax_scene()
    cb, cbc = jpresets.cornell_box(res=8)
    cases = [(js, jc), (js, jc._replace(filter="gaussian")),
             (js, jc._replace(engine="loop")),
             (cb, cbc._replace(filter="box", engine="wavefront"))]
    want = [jbw.supported(s, c) for s, c in cases]
    assert want == [True, False, False, False]
    assert [tbw.supported(*_carry(s, c)) for s, c in cases] == want


def test_supported_rejects_point_light_and_homogeneous():
    for kw in (dict(emitter_kind="point"), dict(heterogeneous=False)):
        scene, cfg = tpresets.volumetric_box(res=8, filter="box", **kw)
        assert not tbw.supported(scene, cfg)
    scene, cfg = tpresets.volumetric_box(res=8, heterogeneous=True,
                                         density_res=8, filter="box")
    assert tbw.supported(scene, cfg)
    assert not tbw.supported(scene, dataclasses.replace(cfg, integrator="path"))


@pytest.mark.parametrize("density_res", [16, 20])
def test_megatable_equals_jax(density_res):
    js, _ = _jax_scene(density_res=density_res)
    ts, _ = tpresets.volumetric_box(res=8, heterogeneous=True,
                                    density_res=density_res)
    jm, tm = jmt.MegaTable(js.media), tmt.MegaTable(ts.media)
    assert tm.res == jm.res and tm.nb == jm.nb
    np.testing.assert_array_equal(
        tm.table.view(torch.int16).numpy(),
        np.asarray(jm.table).view(np.int16))
    np.testing.assert_allclose(tm.inv_h.numpy(), np.asarray(jm.inv_h),
                               rtol=1e-6)
    assert tmt.MegaTable.fits(ts.media)


@pytest.mark.parametrize("res,sppc,seed,pass_idx,g", [
    (8, 2, 1, 0, 0.7),
    (12, 4, 5, 1, 0.7),
    (16, 3, 11, 2, 0.0),
])
def test_plain_walk_matches_jax_interpret(res, sppc, seed, pass_idx, g):
    js, jc = _jax_scene(res=res, g=g)
    jL, jst = jbw.render_boxwalk(js, jc, sppc, jnp.uint32(seed),
                                 jnp.uint32(pass_idx), interpret=True)
    ts, tc = _carry(js, jc)
    tL, tst = tbw.render_boxwalk(ts, tc, sppc, seed, pass_idx)
    jL = np.asarray(jL)
    close = np.isclose(tL.numpy(), jL, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.95, close.mean()
    jst = [int(v) for v in jst]
    tst = tst.tolist()
    for i in (0, 1):                                 # segments, taps
        assert abs(tst[i] - jst[i]) <= 0.01 * jst[i], (tst, jst)
    assert tst[3] == jst[3] == 0                     # unfinished
    assert jL.mean() > 0
