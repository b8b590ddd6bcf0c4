"""The pieces of the port's training path (models/medium.py and
integrators/volpath.py in differentiable mode): kernel A's gradient
(`TrilinearLookup`, kernel A' and its plain version), Woodcock's log_p and
the tracking loops' 64-test cap against the JAX package's, and the
checkpointed bounce loop.

Kernel A' itself runs only on the card: the tests marked `cuda` skip here,
and on a GPU machine (no jax needed for them) run as
    python -m pytest --noconftest tests/test_torch_medium_grad.py -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.core.math import take_rows
from mitsubaer_tpu_torch.diff import render as tdiff
from mitsubaer_tpu_torch.integrators import volpath as tvp
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

AABB6 = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0])


def _points(n, seed):
    """Points in, out of and on the boundary of the [-1, 1]^3 AABB."""
    r = np.random.default_rng(seed)
    p = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    k = n // 5
    p[:k, r.integers(0, 3)] = r.choice([-1.0, 1.0], k)
    p[k:2 * k] = r.choice([-1.0, 1.0], (k, 3))
    return torch.from_numpy(p)


def _grid(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.0, 1.0, shape).astype(np.float32))


def _clustered(n, seed, centre=(0.1, -0.2, 0.3), radius=0.02):
    """n points in a ball of the given radius: a few cells take them all,
    so the scatter's adds collide."""
    r = np.random.default_rng(seed)
    return torch.from_numpy((np.asarray(centre) + r.uniform(
        -radius, radius, (n, 3))).astype(np.float32))


# (nz, ny, nx): a cube, a flat grid, one-voxel axes
SHAPES = [(8, 8, 8), (1, 6, 7), (5, 1, 1), (1, 1, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_equals_autograd_of_forward_plain(shape):
    """Kernel A's plain backward against autograd through its plain
    forward: every term is formed in autograd's order, only the sums'
    order differs (measured: within 2 ulp of the largest voxel)."""
    grid = _grid(shape, 1).requires_grad_()
    p = torch.cat([_points(3000, 2), _clustered(1000, 3)])
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=p.shape[0]).astype(np.float32))
    tmedium.trilinear_lookup_plain(grid, AABB6, p).backward(g)
    got = tmedium.trilinear_lookup_backward_plain(shape, AABB6, p, g)
    assert got.shape == shape and grid.grad.abs().max() > 0
    torch.testing.assert_close(got, grid.grad, rtol=0,
                               atol=1e-6 * grid.grad.abs().max().item())


def test_backward_plain_skips_points_outside_the_aabb():
    p = torch.tensor([[1.5, 0.0, 0.0], [0.0, -1.01, 0.0], [0.0, 0.0, 2.0]])
    got = tmedium.trilinear_lookup_backward_plain((4, 4, 4), AABB6, p,
                                                  torch.ones(3))
    assert not got.any()
    # on one-voxel axes (inside only at their lower face) the coinciding
    # corners add both their weights to the one voxel
    one = tmedium.trilinear_lookup_backward_plain(
        (1, 1, 3), AABB6, torch.tensor([[0.5, -1.0, -1.0]]),
        torch.tensor([2.5]))
    assert one.flatten().tolist() == [0.0, 1.25, 1.25]


@pytest.mark.parametrize("shape", [(4, 5, 6), (1, 3, 4)])
def test_trilinear_function_gradcheck_float64(shape):
    """TrilinearLookup on the CPU (both plain versions) in float64."""
    grid = _grid(shape, 5).double().requires_grad_()
    p = _points(64, 6).double()
    aabb6 = AABB6.double()
    assert torch.autograd.gradcheck(
        lambda g: tmedium.TrilinearLookup.apply(g, None, aabb6, p), (grid,))


@pytest.mark.parametrize("shape", [(1, 3), (4, 3), (4,), (20, 3)])
def test_take_rows_gradient_equals_indexing(shape):
    """take_rows (the per-medium tables' gather) against plain indexing:
    the same values, the same gradient up to the order of the sums."""
    r = np.random.default_rng(14)
    table = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    i = torch.from_numpy(r.integers(0, shape[0], 5000))
    g = torch.from_numpy(r.normal(size=(5000,) + shape[1:]).astype(
        np.float32))
    a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
    out = take_rows(a, i)
    assert torch.equal(out, b[i])
    out.backward(g)
    b[i].backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(take_rows(a, i), table[i])


def test_trilinear_function_refuses_points_that_require_grad():
    grid = _grid((4, 4, 4), 7).requires_grad_()
    p = _points(10, 8).requires_grad_()
    with pytest.raises(ValueError, match="no gradient flows to the points"):
        tmedium.TrilinearLookup.apply(grid, None, AABB6, p)


def test_density_grid_routes_attached_lookups_through_the_function():
    """An attached grid under grad gives an attached lookup and its cell
    table is built from the detached grid; under no_grad, or for a grid
    that needs no grad, the lookup is the direct call."""
    scene, _ = tpresets.volumetric_box(res=4, heterogeneous=True,
                                       density_res=8)
    leaf = scene.media.density.data.clone().requires_grad_()
    media = dataclasses.replace(scene.media, density=dataclasses.replace(
        scene.media.density, data=leaf))
    grid = tmedium.DensityGrid(media)
    p = _points(500, 9)
    out = grid.lookup(p)
    assert out.requires_grad and out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "TrilinearLookupBackward"
    with torch.no_grad():
        assert not grid.lookup(p).requires_grad
    assert not grid.cells.requires_grad
    assert not tmedium.DensityGrid(scene.media).lookup(p).requires_grad
    torch.testing.assert_close(out.detach(), tmedium.trilinear_lookup_plain(
        leaf.detach(), grid.aabb6, p), rtol=0, atol=0)


def _woodcock_inputs(n=4096):
    """Lanes across the heterogeneous box with the majorant raised 10x, so
    p_real stays below 0.05 and many lanes are still tracking at 64 tests
    (the differentiable cap)."""
    r = np.random.default_rng(5)
    o = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = r.uniform(0.5, 3.0, n).astype(np.float32)
    active = r.uniform(size=n) < 0.9
    return o, d, t_max, active, np.arange(n, dtype=np.uint32)


def _jax_tracking(o, d, t_max, active, lanes):
    """JAX's sample_distance_woodcock and transmittance_ratio_tracking with
    differentiable=True (one forward compile)."""
    import jax
    import jax.numpy as jnp

    from mitsubaer_tpu.core import rng as jrng
    from mitsubaer_tpu.models import medium as jmedium
    from mitsubaer_tpu.scene import presets as jpresets

    js, _ = jpresets.volumetric_box(res=4, heterogeneous=True,
                                    density_res=16)
    media = js.media._replace(majorant=js.media.majorant * 10.0)
    idx = jnp.zeros(o.shape[0], jnp.int32)
    _, sa, ss, _, scale = jmedium.params(media, idx)

    @jax.jit
    def run(o, d, t, a):
        bricks = jmedium.DensityBricks(media)
        wood = jmedium.sample_distance_woodcock(
            media, sa, ss, scale, o, d, t,
            jrng.make_sampler(jnp.uint32(9), lanes, 3), a,
            differentiable=True, bricks=bricks)
        tr, smp = jmedium.transmittance_ratio_tracking(
            media, sa, ss, scale, o, d, t,
            jrng.make_sampler(jnp.uint32(10), lanes, 3), a,
            differentiable=True, bricks=bricks)
        return wood, (tr, smp.dim)

    return jax.tree_util.tree_map(np.asarray, run(o, d, t_max, active))


def _port_tracking(o, d, t_max, active, lanes, differentiable):
    ts, _ = tpresets.volumetric_box(res=4, heterogeneous=True,
                                    density_res=16)
    media = dataclasses.replace(ts.media, majorant=ts.media.majorant * 10.0)
    _, sa, ss, scale = tmedium.params(media, torch.zeros(o.shape[0],
                                                         dtype=torch.int64))
    args = [torch.from_numpy(x) for x in (o, d, t_max)]
    lanes = torch.from_numpy(lanes.astype(np.int64))
    wood = tmedium.sample_distance_woodcock(
        media, sa, ss, scale, *args, trng.make_sampler(9, lanes, 3),
        torch.from_numpy(active), differentiable=differentiable)
    tr, smp = tmedium.transmittance_ratio_tracking(
        media, sa, ss, scale, *args, trng.make_sampler(10, lanes, 3),
        torch.from_numpy(active), differentiable=differentiable)
    return wood, (tr, smp.dim)


def test_differentiable_tracking_matches_jax_at_the_cap():
    """Woodcock's hit, dist, weight, log_p and sampler, and ratio
    tracking's transmittance and sampler, lane by lane against JAX's
    differentiable tracking, on lanes of which a tenth or more end
    otherwise in forward tracking, cut at 64 tests (measured: 13.7% of the
    4,096 lanes cut, every lane's hit agrees)."""
    inputs = _woodcock_inputs()
    (hit_j, dist_j, w_j, _, smp_j, logp_j), (tr_j, rdim_j) = \
        _jax_tracking(*inputs)
    (hit_t, dist_t, w_t, _, smp_t, trips, logp_t), (tr_t, rdim_t) = \
        _port_tracking(*inputs, differentiable=True)
    # the scan draws 16 trips of 4 tests on every lane, run or not
    assert trips <= 16
    np.testing.assert_array_equal(smp_t.dim.numpy(), smp_j.dim)
    assert (smp_j.dim == 16 * 8).all()
    np.testing.assert_array_equal(rdim_t.numpy(), rdim_j)
    agree = hit_t.numpy() == hit_j
    assert agree.mean() >= 0.99
    for got, want in ((dist_t, dist_j), (w_t, w_j), (logp_t, logp_j)):
        np.testing.assert_allclose(got.numpy()[agree], want[agree],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr_t.numpy(), tr_j, rtol=1e-5, atol=1e-6)
    # the cap cut lanes that forward tracking carries on, to a hit or to
    # more null collisions
    (hit_f, _, w_f, *_), _ = _port_tracking(*inputs, differentiable=False)
    cut = (hit_f.numpy() != hit_j) | ~np.isclose(w_f.numpy(), w_j).all(-1)
    print(f"cut at 64 tests: {cut.mean():.3f} of lanes")
    assert cut.mean() > 0.1, cut.mean()
    # a cut lane reports no hit, t_max and the log_p of its null collisions
    assert not hit_t.numpy()[cut].any()
    np.testing.assert_array_equal(dist_t.numpy()[cut], inputs[2][cut])
    assert (logp_t.numpy()[cut] < 0).all()


def test_forward_tracking_returns_no_log_p():
    inputs = _woodcock_inputs(64)
    (*_, log_p), _ = _port_tracking(*inputs, differentiable=False)
    assert log_p is None


def _small_training_case():
    scene, cfg = tpresets.volumetric_box(res=6, spp=1, heterogeneous=True,
                                         density_res=8, max_depth=3)
    target = np.full((6, 6, 3), 0.05, np.float32)
    return scene, cfg, tdiff.get_params(scene), target


def test_checkpointed_li_gives_the_uncheckpointed_gradients(monkeypatch):
    """li(differentiable=True) with each bounce checkpointed against the
    same loop with no checkpoint, on the beam-lit heterogeneous box (beam
    NEE through the attached tau table): equal loss and gradients. Every
    bounce is recomputed once in the backward with the trip counts of its
    tracking loops unchanged (the host syncs of a recomputed bounce see
    the same values)."""
    scene, cfg, params, target = _small_training_case()
    trips, current = {}, []
    body, bounded_while = tvp.body, tmedium.bounded_while

    def counting_body(scene_, cfg_, s, *a, **k):
        current[:] = [[]]
        trips.setdefault(s.iters, []).append(current[0])
        return body(scene_, cfg_, s, *a, **k)

    def counting_while(*a, **k):
        out = bounded_while(*a, **k)
        if current:
            current[0].append(out[1])
        return out

    monkeypatch.setattr(tvp, "body", counting_body)
    monkeypatch.setattr(tmedium, "bounded_while", counting_while)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        loss_c, grad_c = tdiff.loss_and_grad(scene, params, cfg, 2, 4, 0,
                                             target, device="cpu")
    assert len(trips) >= 3
    for k, runs in trips.items():
        assert len(runs) == 2 and runs[0] == runs[1], (k, runs)
    monkeypatch.setattr(tvp, "_checkpointed", lambda step, s: step(s))
    trips.clear()
    loss_u, grad_u = tdiff.loss_and_grad(scene, params, cfg, 2, 4, 0, target,
                                         device="cpu")
    assert all(len(runs) == 1 for runs in trips.values())
    assert loss_c == loss_u
    for f in tdiff.MediumParams._fields:
        torch.testing.assert_close(getattr(grad_c, f), getattr(grad_u, f),
                                   rtol=0, atol=0)
        # the loop engine reads every field but the eikonal road's rif
        assert (getattr(grad_c, f).abs().max() > 0) == (f != "rif"), f


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU build here)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["uniform", "clustered"])
def test_backward_kernel_matches_plain_on_cuda(cuda, points):
    """Kernel A' against its plain version on the 64^3 grid. Float atomics
    add in a varying order: within 1e-5 of the largest voxel for spread
    points (~24 terms a voxel), 1e-4 for the cluster, whose few voxels sum
    ~60,000 terms each in float32 in either order."""
    n = 200_000
    p = (_points(n, 11) if points == "uniform" else _clustered(n, 11)).to(cuda)
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=n).astype(np.float32)).to(cuda)
    aabb6 = AABB6.to(cuda)
    before = tmedium.trilinear_lookup_backward.launches
    got = tmedium.trilinear_lookup_backward((64, 64, 64), aabb6, p, g)
    assert tmedium.trilinear_lookup_backward.launches == before + 1
    want = tmedium.trilinear_lookup_backward_plain((64, 64, 64), aabb6, p, g)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    tol = 1e-5 if points == "uniform" else 1e-4
    assert scale > 0 and (got - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_trilinear_function_on_cuda_runs_both_kernels(cuda):
    scene, _ = tpresets.volumetric_box(res=4, heterogeneous=True,
                                       density_res=64)
    leaf = scene.media.density.data.to(cuda).requires_grad_()
    media = scene.media.to(cuda)
    media = dataclasses.replace(media, density=dataclasses.replace(
        media.density, data=leaf))
    grid = tmedium.DensityGrid(media)
    p = _points(100_000, 13).to(cuda)
    fwd, bwd = (tmedium.trilinear_lookup.launches,
                tmedium.trilinear_lookup_backward.launches)
    out = grid.lookup(p)
    out.sum().backward()
    assert tmedium.trilinear_lookup.launches == fwd + 1
    assert tmedium.trilinear_lookup_backward.launches == bwd + 1
    assert torch.equal(out.detach(), tmedium.trilinear_lookup_plain(
        leaf.detach(), grid.aabb6, p))
    want = tmedium.trilinear_lookup_backward_plain(
        tuple(leaf.shape), grid.aabb6, p, torch.ones_like(out))
    assert (leaf.grad - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_training_step_on_cuda_builds_one_cell_table(cuda, monkeypatch):
    """loss_and_grad on the card: the recomputed bounces find kernel A's
    cell table built (one table a render, from the detached grid), A and
    A' launch, and the gradients agree with the CPU's."""
    scene, cfg, params, target = _small_training_case()
    built, cell_table = [], tmedium.cell_table

    def counting(grid, *a):
        built.append(grid.requires_grad)
        return cell_table(grid, *a)

    monkeypatch.setattr(tmedium, "cell_table", counting)
    bwd = tmedium.trilinear_lookup_backward.launches
    loss_g, grad_g = tdiff.loss_and_grad(scene, params, cfg, 2, 4, 0, target,
                                         device=cuda)
    assert built == [False]
    assert tmedium.trilinear_lookup_backward.launches > bwd
    loss_c, grad_c = tdiff.loss_and_grad(scene, params, cfg, 2, 4, 0, target,
                                         device="cpu")
    assert abs(loss_g.item() / loss_c.item() - 1) <= 1e-4
    for f in tdiff.MediumParams._fields:
        want = getattr(grad_c, f)
        err = (getattr(grad_g, f).cpu() - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item(), f


def test_beam_tau_gradients_match_jax():
    """The beam-NEE tau table on an attached grid: the gradient of a seeded
    weighting of beam_transmittance (through build_beam_tau's lookups)
    with respect to the density grid and sigma, against JAX's (one small
    value_and_grad compile). Measured: within 1e-6 of each field's
    largest magnitude."""
    import jax
    import jax.numpy as jnp

    from mitsubaer_tpu.integrators import volpath as jvp
    from mitsubaer_tpu.models import medium as jmedium
    from mitsubaer_tpu.scene import presets as jpresets

    js, _ = jpresets.volumetric_box(res=4, heterogeneous=True, density_res=8)
    ts, _ = tpresets.volumetric_box(res=4, heterogeneous=True, density_res=8)
    r = np.random.default_rng(21)
    s = r.uniform(-0.5, 4.0, 512).astype(np.float32)
    w = r.uniform(0.0, 1.0, (512, 3)).astype(np.float32)

    @jax.jit
    def jax_grads(density, sigma_s):
        def scalar(density, sigma_s):
            media = js.media._replace(
                sigma_s=sigma_s,
                density=js.media.density._replace(data=density))
            scene = js._replace(media=media)
            beam = jvp.get_beam(scene)
            tau = jvp.build_beam_tau(scene, beam,
                                     jmedium.DensityBricks(media))
            return jnp.sum(w * jvp.beam_transmittance(beam, tau, s))
        return jax.value_and_grad(scalar, argnums=(0, 1))(density, sigma_s)

    value_j, grads_j = jax_grads(js.media.density.data, js.media.sigma_s)
    density = ts.media.density.data.clone().requires_grad_()
    sigma_s = ts.media.sigma_s.clone().requires_grad_()
    media = dataclasses.replace(ts.media, sigma_s=sigma_s,
                                density=dataclasses.replace(
                                    ts.media.density, data=density))
    scene = dataclasses.replace(ts, media=media)
    beam = tvp.get_beam(scene)
    tau = tvp.build_beam_tau(scene, beam, tmedium.DensityGrid(media))
    value = torch.sum(torch.from_numpy(w) * tvp.beam_transmittance(
        beam, tau, torch.from_numpy(s)))
    value.backward()
    np.testing.assert_allclose(value.item(), float(value_j), rtol=1e-5)
    for got, want in ((density.grad, grads_j[0]), (sigma_s.grad, grads_j[1])):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
