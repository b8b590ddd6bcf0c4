"""The port's front door on the CPU: the CLI (cli.py) on the main path as
XML (chip_smoke.main_path_xml: the heterogeneous box from a .vol grid, its
collimated beam, the gaussian filter) against the JAX package's CLI and
against an in-process render(); util.py's tonemap, addimages and joinrgb;
a render checkpointed after k passes and resumed against the
uninterrupted one, and one that the JAX package checkpointed, resumed in
the port, against JAX's resumed render."""
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from mitsubaer_tpu import cli as jcli
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.scene import xml as jxml
from mitsubaer_tpu.utils import io as jio
from mitsubaer_tpu_torch import cli as tcli
from mitsubaer_tpu_torch import util as tutil
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import xml as txml
from mitsubaer_tpu_torch.utils import io as tio
from mitsubaer_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)

# the main path cut to 16^2, depth 4, a 16^3 grid
DEFINES = dict(res=16, spp=4, depth=4, filter="gaussian")


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return chip_smoke.main_path_xml(str(tmp_path_factory.mktemp("main")), 16)


def _d(defines):
    return [x for k, v in defines.items() for x in ("-D", f"{k}={v}")]


def _close(got, want):
    """tests/test_torch_loop_render.py's rule for render() against JAX's:
    the median pixel ratio within 1e-3 of 1 and >= 99% of the pixels
    within rtol 1e-3."""
    assert got.shape == want.shape and np.isfinite(got).all()
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.1
    ratio = np.median(got.mean(-1)[lit] / want.mean(-1)[lit])
    assert 0.999 <= ratio <= 1.001, ratio
    close = np.isclose(got, want, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_cli_matches_jax_and_render(xml, tmp_path, capsys):
    t_out, j_out = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    assert tcli.main([xml, "-o", t_out, *_d(DEFINES), "--cpu"]) == 0
    err = capsys.readouterr().err
    assert "[scene] loaded" in err and "[render]" in err and "1 device(s)" in err
    assert jcli.main([xml, "-o", j_out, *_d(DEFINES), "--cpu"]) == 0
    got, names = tio.read_exr(t_out)
    want, _ = jio.read_exr(j_out)
    assert names == ["R", "G", "B"]
    _close(got, want)
    # the EXR is the in-process render of the same loaded scene, bit for bit
    scene, cfg = txml.load_scene(xml, DEFINES)
    img = trender.render(scene, cfg, seed=0, device="cpu").numpy()
    assert got.tobytes() == img.astype(np.float32).tobytes()
    # the annotations, as the JAX CLI bakes them
    with open(t_out, "rb") as f:
        head = f.read(4096)
    for key in (b"renderTime", b"sampleCount", b"integrator", b"devices",
                b"generatedBy"):
        assert key in head


def test_cli_outputs_and_frames(xml, tmp_path):
    """.npy and .png outputs, and a framed film's channel names."""
    npy = str(tmp_path / "o.npy")
    assert tcli.main([xml, "-o", npy, *_d(dict(DEFINES, res=8)),
                      "--cpu", "--depth", "2"]) == 0
    assert np.load(npy).shape == (8, 8, 3)
    png = str(tmp_path / "o.png")
    assert tcli.main([xml, "-o", png, *_d(dict(DEFINES, res=8)),
                      "--cpu"]) == 0
    assert tio.read_image(png).shape == (8, 8, 3)
    text = open(xml).read().replace(
        '<rfilter type="$filter"/>', '<rfilter type="$filter"/>'
        '<string name="decomposition" value="transient"/>'
        '<float name="maxBound" value="4"/><float name="binWidth" value="2"/>')
    framed = tmp_path / "framed.xml"
    framed.write_text(text)
    shutil.copy(os.path.join(os.path.dirname(xml), "density.vol"), tmp_path)
    exr = str(tmp_path / "f.exr")
    assert tcli.main([str(framed), "-o", exr, *_d(dict(DEFINES, res=8)),
                      "--cpu"]) == 0
    img, names = tio.read_exr(exr)
    assert img.shape == (8, 8, 6)
    assert sorted(names) == sorted(f"frame{f:03d}.{c}" for f in range(2)
                                   for c in "RGB")


def test_util_commands(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 2, (6, 5, 3)).astype(np.float32)
    b = rng.uniform(0, 2, (6, 5, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
    jio.write_exr(pa, a)
    jio.write_exr(pb, b)
    s = str(tmp_path / "s.exr")
    tutil.main(["addimages", pa, pb, "-o", s, "-w", "0.25,2"])
    np.testing.assert_array_equal(tio.read_exr(s)[0],
                                  a * np.float32(0.25) + b * np.float32(2))
    rgb = str(tmp_path / "rgb.exr")
    tutil.main(["joinrgb", pa, pb, s, "-o", rgb])
    joined = tio.read_exr(rgb)[0]
    np.testing.assert_array_equal(joined[..., 0], a[..., 0])
    np.testing.assert_array_equal(joined[..., 1], b[..., 0])
    png = str(tmp_path / "t.png")
    tutil.main(["tonemap", pa, "-o", png, "--exposure", "0.5"])
    got = jio.read_image(png)               # the JAX reader reads it
    lin = np.clip(a * np.float32(0.5), 0, 1)
    assert np.abs(got - lin).max() < 0.02
    with pytest.raises(SystemExit):
        tutil.main(["addimages", pa, pb, "-o", s, "-w", "1"])


def test_checkpoint_resume_equals_uninterrupted(xml, tmp_path):
    """Passes of 2 samples: a render of 4 samples checkpointed after its
    second pass, resumed to 8 samples, equals an 8-sample render bit for
    bit; the stats counters see the passes."""
    scene, cfg = txml.load_scene(xml, dict(DEFINES, spp=8))
    whole = trender.render(scene, cfg, seed=5, device="cpu", spp_per_pass=2)
    ck = str(tmp_path / "state.npz")
    trender.render(scene, cfg, spp=4, seed=5, device="cpu", spp_per_pass=2,
                   checkpoint_path=ck, checkpoint_every=2)
    tstats.reset()
    resumed = trender.render(scene, cfg, seed=5, device="cpu",
                             spp_per_pass=2, checkpoint_path=ck)
    snap = tstats.snapshot()
    assert snap["render.passes"] == 2
    assert snap["render.camera_rays"] == 2 * 2 * 16 * 16
    assert snap["render.wall.seconds"] > 0
    assert torch.equal(resumed, whole)


def test_jax_checkpoint_resumes_in_the_port(xml, tmp_path):
    """A state that JAX's render() wrote after the first of two passes of 4
    samples (the CLI test's configuration, so its compile is shared)
    resumes in the port as in JAX, within the loop road's rule."""
    jscene, jcfg = jxml.load_scene(xml, DEFINES)
    ck = str(tmp_path / "jax.npz")
    jrender.render(jscene, jcfg, seed=5, spp_per_pass=4, checkpoint_path=ck,
                   checkpoint_every=1)
    shutil.copy(ck, tmp_path / "port.npz")
    want = np.asarray(jrender.render(jscene, jcfg, spp=8, seed=5,
                                     spp_per_pass=4, checkpoint_path=ck))
    scene, cfg = txml.load_scene(xml, DEFINES)
    got = trender.render(scene, cfg, spp=8, seed=5, device="cpu",
                         spp_per_pass=4,
                         checkpoint_path=str(tmp_path / "port.npz")).numpy()
    _close(got, want)


def test_train_state_round_trip_and_jax_state_raises(tmp_path):
    """save_train_state / load_train_state keep MediumParams and an Adam
    state_dict: a step after a reload equals a step without one, bit for
    bit. A state the JAX package wrote (optax's leaves) raises."""
    import optax

    from mitsubaer_tpu.diff import render as jdiff
    from mitsubaer_tpu.scene import presets as jpresets
    from mitsubaer_tpu.utils import checkpoint as jckpt
    from mitsubaer_tpu_torch.diff import render as tdiff
    from mitsubaer_tpu_torch.utils import checkpoint as tckpt

    rng = np.random.default_rng(4)

    def leaves():
        return tdiff.MediumParams(*(torch.from_numpy(rng.uniform(
            0.1, 1, s).astype(np.float32)).requires_grad_()
            for s in ((1, 3), (1, 3), (4, 4, 4), (1,), (2, 2, 2))))

    def step(p, opt, g):
        for t, gt in zip(p, g):
            t.grad = gt.clone()
        opt.step()

    p, q = leaves(), leaves()
    opt = torch.optim.Adam(p, lr=5e-2)
    grads = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
             for t in p]
    step(p, opt, grads)
    path = str(tmp_path / "train.npz")
    tckpt.save_train_state(path, p, opt, 1, extra={"note": "x"})
    opt_q = torch.optim.Adam(q, lr=1.0)
    assert tckpt.load_train_state(path, q, opt_q) == (1, {"note": "x"})
    step(p, opt, grads)
    step(q, opt_q, grads)
    for a, b in zip(p, q):
        assert torch.equal(a, b)
    assert tckpt.load_train_state(str(tmp_path / "none.npz"), q, opt_q) \
        is None
    jp = jdiff.get_params(jpresets.volumetric_box(res=4, spp=1)[0])
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_train_state(jpath, jp, optax.adam(1e-2).init(jp), 3)
    with pytest.raises(ValueError, match="optax"):
        tckpt.load_train_state(jpath, q, opt_q)


def test_util_bvhbench(tmp_path, capsys):
    """bvhbench on a 1,024-triangle mesh (a BVH from 512) on the CPU."""
    u = np.linspace(0, 1, 17)
    X, Y = np.meshgrid(u, u)
    verts = np.stack([X, Y, 0.1 * np.sin(6 * X)], -1).reshape(-1, 3)
    i = (np.arange(16)[:, None] * 17 + np.arange(16)[None]).reshape(-1)
    faces = np.concatenate([np.stack([i, i + 1, i + 18], -1),
                            np.stack([i, i + 18, i + 17], -1)])
    path = tmp_path / "grid.obj"
    path.write_text("".join("v %f %f %f\n" % tuple(v) for v in verts)
                    + "".join("f %d %d %d\n" % tuple(f + 1) for f in faces))
    tutil.main(["bvhbench", str(path), "--rays", "256", "--reps", "1",
                "--cpu"])
    out = capsys.readouterr().out
    assert out.startswith("bvh: 289 verts 512 tris") and "Mrays/s" in out


def test_cli_sharded_under_torchrun(xml, tmp_path):
    """`torchrun --nproc_per_node=2 -m mitsubaer_tpu_torch.cli ... --sharded
    --cpu`: rank 0 alone writes the EXR, which is render_sharded's image
    over the (2, 1) layout, bit for bit, with "devices" the world size."""
    import subprocess
    import sys

    from mitsubaer_tpu_torch.parallel import driver

    out = tmp_path / "s.exr"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "mitsubaer_tpu_torch.cli", xml,
         "--sharded", "--cpu", "-o", str(out), *_d(DEFINES)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("[output]") == 1
    assert proc.stderr.count("2 device(s)") == 2
    got, _ = tio.read_exr(str(out))
    scene, cfg = txml.load_scene(xml, DEFINES)
    want = driver.render_sharded(scene, cfg, (2, 1), seed=0, device="cpu")
    assert got.tobytes() == want.numpy().astype(np.float32).tobytes()
    assert b"devices" in out.read_bytes()[:4096]
