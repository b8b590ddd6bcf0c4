"""Kernel A's plain version (trilinear density lookup) and a mirror of the
kernel's cell-table indexing against the JAX package's
DensityBricks.lookup(fused=False), and the beam-tau table and
ratio-tracking transmittance at equal seed. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_kernels.py and
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.integrators import volpath as jvp
from mitsubaer_tpu.models import medium as jmedium
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)


def _scenes(density_res=16):
    kw = dict(res=8, heterogeneous=True, density_res=density_res)
    return jpresets.volumetric_box(**kw)[0], tpresets.volumetric_box(**kw)[0]


def _points(n=10_000, seed=0):
    """Points in, out of and on the boundary of the [-1, 1]^3 grid AABB."""
    r = np.random.default_rng(seed)
    p = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    k = n // 5
    p[:k, r.integers(0, 3)] = r.choice([-1.0, 1.0], k)       # on a face
    p[k:2 * k] = r.choice([-1.0, 1.0], (k, 3))                # on corners
    return p


@pytest.mark.parametrize("bf16", [False, True])
def test_trilinear_plain_matches_density_bricks(bf16):
    js, ts = _scenes()
    p = _points()
    dtype = jnp.bfloat16 if bf16 else None
    want = np.asarray(jmedium.DensityBricks(js.media, dtype=dtype).lookup(
        jnp.asarray(p), fused=False))
    grid = tmedium.DensityGrid(ts.media,
                               dtype=torch.bfloat16 if bf16 else None)
    got = grid.lookup(torch.from_numpy(p)).numpy()
    assert (want == 0).mean() > 0.1 and (want > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _kernel_a_mirror(grid, cells, aabb6, p):
    """csrc/trilinear.cu's indexing in PyTorch: cell and t per axis, then
    one record of the cell table and the lerp in the kernel's order."""
    nz, ny, nx = grid.shape
    res = torch.tensor([nx, ny, nz], dtype=torch.float32)
    h = (aabb6[3:] - aabb6[:3]) / torch.clamp_min(res - 1.0, 1.0)
    v = (p - aabb6[:3]) / h
    inside = ((v >= 0.0) & (v <= res - 1.0)).all(-1)
    v = torch.minimum(torch.clamp_min(v, 0.0), res - 1.0)
    cell = torch.minimum(torch.clamp_min(torch.floor(v), 0.0),
                         torch.clamp_min(res - 2.0, 0.0))
    t = v - cell
    c = cell.to(torch.int64)
    _, cy, cx, _ = cells.shape
    r = cells.reshape(-1, 8)[(c[:, 2] * cy + c[:, 1]) * cx + c[:, 0]].float()
    tx, ty, tz = t.unbind(-1)
    c00 = r[:, 0] * (1.0 - tx) + r[:, 1] * tx
    c01 = r[:, 2] * (1.0 - tx) + r[:, 3] * tx
    c10 = r[:, 4] * (1.0 - tx) + r[:, 5] * tx
    c11 = r[:, 6] * (1.0 - tx) + r[:, 7] * tx
    c0 = c00 * (1.0 - ty) + c01 * ty
    c1 = c10 * (1.0 - ty) + c11 * ty
    return torch.where(inside, c0 * (1.0 - tz) + c1 * tz, 0.0)


@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_a_indexing_equals_plain_and_density_bricks(bf16):
    """Kernel A's cell-table indexing gives trilinear_lookup_plain bit for
    bit on points inside, outside, on faces and on corners, and stays within
    rtol 1e-5 of the JAX DensityBricks.lookup(fused=False)."""
    js, ts = _scenes(density_res=13)
    p = _points(seed=4)
    grid = tmedium.DensityGrid(ts.media,
                               dtype=torch.bfloat16 if bf16 else None)
    got = _kernel_a_mirror(grid.grid, grid.cells, grid.aabb6,
                           torch.from_numpy(p))
    assert torch.equal(got, tmedium.trilinear_lookup_plain(
        grid.grid, grid.aabb6, torch.from_numpy(p)))
    want = np.asarray(jmedium.DensityBricks(
        js.media, dtype=jnp.bfloat16 if bf16 else None).lookup(
            jnp.asarray(p), fused=False))
    assert (want == 0).mean() > 0.1 and (want > 0).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_density_at_matches_spline_trilinear():
    js, ts = _scenes(density_res=12)
    p = _points(seed=1)
    want = np.asarray(jmedium.density_at(js.media, jnp.asarray(p)))
    got = tmedium.density_at(ts.media, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_build_beam_tau_matches(bf16):
    js, ts = _scenes()
    jbricks = jmedium.DensityBricks(js.media,
                                    dtype=jnp.bfloat16 if bf16 else None)
    tbricks = tmedium.DensityGrid(ts.media,
                                  dtype=torch.bfloat16 if bf16 else None)
    want = np.asarray(jvp.build_beam_tau(js, jvp.get_beam(js), jbricks))
    got = tvp.build_beam_tau(ts, tvp.get_beam(ts), tbricks).numpy()
    assert got.shape == (256, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_transmittance_ratio_tracking_matches():
    js, ts = _scenes()
    n = 4096
    r = np.random.default_rng(2)
    o = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = r.uniform(0.0, 2.5, n).astype(np.float32)
    active = r.uniform(size=n) < 0.9
    idx = np.zeros(n, np.int32)
    lanes = np.arange(n, dtype=np.uint32)

    _, sa, ss, _, scale = jmedium.params(js.media, jnp.asarray(idx))
    want, _ = jmedium.transmittance_ratio_tracking(
        js.media, sa, ss, scale, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), jrng.make_sampler(jnp.uint32(9), lanes, 3),
        jnp.asarray(active), bricks=jmedium.DensityBricks(js.media))
    _, tsa, tss, tscale = tmedium.params(ts.media, torch.from_numpy(idx))
    got, _ = tmedium.transmittance_ratio_tracking(
        ts.media, tsa, tss, tscale, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_max),
        trng.make_sampler(9, torch.from_numpy(lanes.astype(np.int64)), 3),
        torch.from_numpy(active))
    want = np.asarray(want)
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
