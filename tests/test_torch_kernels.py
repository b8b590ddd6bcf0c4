"""The CUDA kernels' wrappers: dispatch by device, launch counting, the
output layout of the walk, and (tests marked `cuda`, which skip without a
GPU) each kernel against its plain PyTorch version on the card.

This file imports neither jax nor the JAX package, so on a GPU machine
without jax it runs as
    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""
import re

import numpy as np
import pytest
import torch

from mitsubaer_tpu_torch import kernels
from mitsubaer_tpu_torch.integrators import boxwalk as tbw
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)


def _points(n, seed):
    """Points in, out of and on the boundary of the [-1, 1]^3 grid AABB."""
    r = np.random.default_rng(seed)
    p = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    k = n // 5
    p[:k, r.integers(0, 3)] = r.choice([-1.0, 1.0], k)
    p[k:2 * k] = r.choice([-1.0, 1.0], (k, 3))
    return p


def _box(res=8, density_res=8, max_depth=3):
    return tpresets.volumetric_box(res=res, heterogeneous=True,
                                   density_res=density_res,
                                   max_depth=max_depth, filter="box")


def test_library_path_is_keyed_by_sources():
    path = kernels.library_path()
    assert path.name == "libmitsubaer_kernels.so"
    assert re.fullmatch(r"[0-9a-f]{16}", path.parent.name)
    assert path.parent.parent == kernels.BUILD_ROOT
    assert {s.name for s in kernels.CSRC.glob("*.cu")} == {"boxwalk.cu",
                                                           "trilinear.cu"}


def test_lookup_on_cpu_runs_plain_version_without_counting():
    scene, _ = _box()
    grid = tmedium.DensityGrid(scene.media)
    p = torch.from_numpy(_points(1000, 0))
    before = tmedium.trilinear_lookup.launches
    got = grid.lookup(p)
    assert tmedium.trilinear_lookup.launches == before
    want = tmedium.trilinear_lookup_plain(grid.grid, grid.aabb6, p)
    assert torch.equal(got, want)


def test_lookup_rejects_other_devices():
    scene, _ = _box()
    grid = tmedium.DensityGrid(scene.media)
    with pytest.raises(ValueError, match="unsupported device"):
        tmedium.trilinear_lookup(grid.grid, grid.aabb6,
                                 torch.zeros((4, 3), device="meta"))


def test_walk_output_layout():
    scene, cfg = _box()
    params, table, beam_tab, shape = tbw.walk_inputs(scene, cfg, 2)
    assert params.shape == (tbw._P_NP,) and beam_tab.shape == (8, 256)
    assert table.dtype == torch.bfloat16 and table.shape == (512, 1)
    before = tbw.walk.launches
    out = tbw.walk(params, tbw.pass_seed(0, 0), table, beam_tab, shape)
    assert tbw.walk.launches == before
    assert out.shape == (2 * 3 + 4, 64)
    assert (out[6] >= 2).all()         # >= one camera segment a sample
    np.testing.assert_array_equal(out[9].numpy(), np.ones(64))  # last sample
    assert int(out[8].max()) <= shape.max_trips


def test_walk_rejects_other_devices():
    scene, cfg = _box()
    params, table, beam_tab, shape = tbw.walk_inputs(scene, cfg, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tbw.walk(params.to("meta"), 0, table, beam_tab, shape)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU build here)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_trilinear_kernel_matches_plain_on_cuda(cuda, bf16):
    scene, _ = _box(density_res=64)
    grid = tmedium.DensityGrid(scene.media.to(cuda),
                               dtype=torch.bfloat16 if bf16 else None)
    p = torch.from_numpy(_points(200_000, seed=3)).to(cuda)
    before = tmedium.trilinear_lookup.launches
    got = grid.lookup(p)
    assert tmedium.trilinear_lookup.launches == before + 1
    want = tmedium.trilinear_lookup_plain(grid.grid, grid.aabb6, p)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * grid.grid.max().item()


@pytest.mark.cuda
def test_walk_kernel_matches_plain_on_cuda(cuda):
    scene, cfg = _box(res=64, density_res=64, max_depth=12)
    params, table, beam_tab, shape = tbw.walk_inputs(scene.to(cuda), cfg, 8)
    seed = tbw.pass_seed(7, 0)
    before = tbw.walk.launches
    out_k = tbw.walk(params, seed, table, beam_tab, shape)
    assert tbw.walk.launches == before + 1
    out_p = tbw.walk_plain(params, seed, table, beam_tab, shape)
    film_k, st_k = tbw.fold(out_k, shape)
    film_p, st_p = tbw.fold(out_p, shape)
    close = torch.isclose(film_k, film_p, rtol=1e-3, atol=1e-6).all(-1)
    assert close.float().mean().item() >= 0.99
    st_k, st_p = st_k.tolist(), st_p.tolist()
    assert abs(st_k[0] - st_p[0]) <= 0.005 * st_p[0]
    assert abs(st_k[1] - st_p[1]) <= 0.005 * st_p[1]
    assert st_k[3] == st_p[3] == 0


@pytest.mark.cuda
def test_render_on_cuda_goes_through_kernels_and_matches_cpu(cuda):
    scene, cfg = tpresets.volumetric_box(res=24, spp=4, heterogeneous=True,
                                         density_res=16, max_depth=4,
                                         filter="box")
    a0, b0 = tmedium.trilinear_lookup.launches, tbw.walk.launches
    img_g = trender.render(scene, cfg, seed=2, device=cuda).cpu()
    assert tbw.walk.launches == b0 + 1
    assert tmedium.trilinear_lookup.launches >= a0 + 5
    img_c = trender.render(scene, cfg, seed=2, device="cpu")
    assert abs(img_g.mean().item() / img_c.mean().item() - 1) <= 1e-3
    lit = img_c.mean(-1) > 0
    ratio = (img_g.mean(-1)[lit] / img_c.mean(-1)[lit]).median().item()
    assert 0.999 <= ratio <= 1.001
