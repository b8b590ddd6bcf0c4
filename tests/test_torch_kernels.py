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
from mitsubaer_tpu_torch.integrators import megatrack as tmt
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import wavefront as twf
from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.models import ermarch as tem
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
    assert {s.name for s in kernels.CSRC.glob("*.cu")} == {
        "boxwalk.cu", "ermarch.cu", "megatrack.cu", "trilinear.cu"}


def test_lookup_on_cpu_runs_plain_version_without_counting():
    scene, _ = _box()
    grid = tmedium.DensityGrid(scene.media)
    p = torch.from_numpy(_points(1000, 0))
    before = tmedium.trilinear_lookup.launches
    got = grid.lookup(p)
    assert tmedium.trilinear_lookup.launches == before
    want = tmedium.trilinear_lookup_plain(grid.grid, grid.aabb6, p)
    assert torch.equal(got, want)


def test_density_grid_builds_its_table_only_for_the_kernel():
    """CPU lookups run the plain version on the grid and leave the cell
    table unbuilt; the table is built once, when first asked for."""
    scene, _ = _box(density_res=6)
    grid = tmedium.DensityGrid(scene.media)
    grid.lookup(torch.from_numpy(_points(100, 2)))
    assert grid._cells is None
    cells = grid.cells
    assert grid.cells is cells and cells.is_contiguous()
    assert torch.equal(cells, tmedium.cell_table(grid.grid))


def test_lookup_rejects_other_devices():
    scene, _ = _box()
    grid = tmedium.DensityGrid(scene.media)
    with pytest.raises(ValueError, match="unsupported device"):
        tmedium.trilinear_lookup(grid.grid, grid.cells, grid.aabb6,
                                 torch.zeros((4, 3), device="meta"))


@pytest.mark.parametrize("shape,bf16", [((5, 7, 9), False), ((2, 6, 3), False),
                                        ((4, 1, 2), False), ((5, 7, 9), True)])
def test_cell_table_holds_each_cells_corners(shape, bf16):
    """Kernel A's record of cell (z, y, x) holds grid[z+dz, y+dy, x+dx] for
    (dz, dy, dx) = 000, 001, 010, ..., 111, each index clamped to res - 1;
    a bf16 table of a bf16-rounded grid holds its values exactly."""
    r = np.random.default_rng(sum(shape))
    grid = torch.from_numpy(r.uniform(0, 2, shape).astype(np.float32))
    dtype = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        grid = grid.to(torch.bfloat16).to(torch.float32)
    cells = tmedium.cell_table(grid, dtype)
    nz, ny, nx = shape
    assert cells.dtype == dtype and cells.is_contiguous()
    assert cells.shape == (max(nz - 1, 1), max(ny - 1, 1), max(nx - 1, 1), 8)
    for z, y, x in np.ndindex(*cells.shape[:3]):
        want = [grid[min(z + dz, nz - 1), min(y + dy, ny - 1),
                     min(x + dx, nx - 1)].item()
                for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        assert cells[z, y, x].float().tolist() == want


def test_density_grid_keeps_its_table_in_the_stored_type():
    scene, _ = _box(density_res=6)
    f32 = tmedium.DensityGrid(scene.media)
    b16 = tmedium.DensityGrid(scene.media, dtype=torch.bfloat16)
    assert f32.cells.dtype == torch.float32 and f32.cells.shape == (5, 5, 5, 8)
    assert b16.cells.dtype == torch.bfloat16
    assert torch.equal(b16.cells, tmedium.cell_table(b16.grid, torch.bfloat16))
    assert torch.equal(b16.cells.float(), tmedium.cell_table(b16.grid))


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


def _er_fields(kind=tek.RIF_LINEAR):
    prm = {tek.RIF_LINEAR: (1.3, 0.15, 0.05, -0.1),
           tek.RIF_RADIAL: (1.2, 0.4, 0.6, 0.1, -0.1, 0.0)}[kind]
    return tek.RifField(kind, prm), tek.SdfField(tek.SDF_SPHERE, (0, 0, 0, 1))


def _er_trace_inputs(rif, n, seed, device="cpu"):
    """Lanes in the unit-sphere medium with unit directions scaled by n(p)."""
    r = np.random.default_rng(seed)
    p = torch.from_numpy(r.uniform(-0.55, 0.55, (n, 3)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    v = d / d.norm(dim=-1, keepdim=True) * tek.rif_value(rif, p)[:, None]
    dist = torch.from_numpy(r.uniform(0.05, 2.0, n).astype(np.float32))
    act = torch.from_numpy(r.uniform(size=n) < 0.9)
    return [t.to(device) for t in (p, v, dist, act)]


def _er_sens_inputs(rif, n, seed, device="cpu"):
    """The state integrate_with_sensitivities hands kernel E."""
    r = np.random.default_rng(seed)
    p1 = torch.from_numpy(r.uniform(-0.55, 0.55, (n, 3)).astype(np.float32))
    p2 = torch.from_numpy(r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32))
    v0 = p2 - p1
    r0 = tek.rif_value(rif, p1)
    nv = v0.norm(dim=-1)
    dvdv0 = (r0 / nv ** 3)[:, None, None] * (
        (nv ** 2)[:, None, None] * torch.eye(3) - v0[:, :, None] * v0[:, None])
    v = v0 / nv[:, None] * r0[:, None]
    act = torch.from_numpy(r.uniform(size=n) < 0.9)
    return [t.to(device) for t in (p1, v, torch.zeros((n, 3, 3)), dvdv0, p2,
                                   act)]


def test_er_params_layout():
    """The 16 floats of kernels D and E: RIF kind, RIF params[0:8], SDF
    kind, SDF params[0:6]."""
    rif, sdf = _er_fields(tek.RIF_RADIAL)
    q = list(tem._params(rif, sdf).q)
    assert q[0] == tek.RIF_RADIAL and q[9] == tek.SDF_SPHERE
    np.testing.assert_array_equal(q[1:9], np.float32([1.2, 0.4, 0.6, 0.1, -0.1,
                                                      0, 0, 0]))
    assert q[10:16] == [0, 0, 0, 1, 0, 0]


def test_er_marches_on_cpu_run_plain_versions_without_counting():
    rif, sdf = _er_fields()
    before = tem.trace.launches, tem.sens_march.launches
    p, v, dist, act = _er_trace_inputs(rif, 64, 0)
    got = tem.trace(rif, sdf, p, v, dist, 0.01, 64, act)
    want = tem.trace_plain(rif, sdf, p, v, dist, 0.01, 64, act)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    args = _er_sens_inputs(rif, 64, 1)
    got = tem.sens_march(rif, sdf, *args[:5], 0.04, 16, args[5])
    want = tem.sens_march_plain(rif, sdf, *args[:5], 0.04, 16, args[5])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (tem.trace.launches, tem.sens_march.launches) == before


@pytest.mark.parametrize("kind", [tek.RIF_LINEAR, tek.RIF_RADIAL])
def test_sens_march_plain_splits_by_column(kind):
    """The column split kernel E relies on: sens_march_plain run on column j
    of dp/dv0 and dv/dv0 alone gives the full run's column j and its p, v,
    opt, marched, crossed and steps bit for bit."""
    rif, sdf = _er_fields(kind)
    p1, v, dp, dv, p2, act = _er_sens_inputs(rif, 512, 4)
    dp = dp + torch.from_numpy(np.random.default_rng(5).normal(
        size=(512, 3, 3)).astype(np.float32))     # a column mix to carry
    full = tem.sens_march_plain(rif, sdf, p1, v, dp, dv, p2, 0.04, 64, act)
    assert int(full[-1]) > 4 and bool(full[6].any())
    for j in range(3):
        col = tem.sens_march_plain(rif, sdf, p1, v, dp[..., j:j + 1],
                                   dv[..., j:j + 1], p2, 0.04, 64, act)
        assert torch.equal(col[2], full[2][..., j:j + 1])
        assert torch.equal(col[3], full[3][..., j:j + 1])
        for i in (0, 1, 4, 5, 6, 7):
            assert torch.equal(col[i], full[i])


@pytest.mark.parametrize("kind,lanes_h", [(tek.RIF_RADIAL, False),
                                          (tek.RIF_LINEAR, True)])
def test_sens_march_on_cpu_equals_plain(kind, lanes_h):
    rif, sdf = _er_fields(kind)
    args = _er_sens_inputs(rif, 96, 6)
    h = torch.full((96,), 0.03) if lanes_h else 0.03
    before = tem.sens_march.launches
    got = tem.sens_march(rif, sdf, *args[:5], h, 32, args[5])
    want = tem.sens_march_plain(rif, sdf, *args[:5], h, 32, args[5])
    assert tem.sens_march.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sens_march_rejects_other_devices():
    rif, sdf = _er_fields()
    args = [t.to("meta") for t in _er_sens_inputs(rif, 8, 0)]
    with pytest.raises(ValueError, match="unsupported device"):
        tem.sens_march(rif, sdf, *args[:5], 0.04, 8, args[5])


def _mega_inputs(n, seed, device="cpu"):
    """Rows and counters kernel C takes in the 512^2 render's first
    tracking call: the point-lit box's state after an event pass and a
    transition pass (res 16 stands in for the CPU)."""
    scene, cfg = tpresets.volumetric_box(res=n, spp=2, heterogeneous=True,
                                         density_res=64, max_depth=12,
                                         filter="box", emitter_kind="point")
    scene = scene.to(device)
    st, event_pass, _, _, _ = twf.make_engine(scene, cfg, 2, seed, 0)
    st = event_pass(event_pass(st), mini=True)
    mega = tmt.MegaTable(scene.media)
    _, need, rows = twf.pack_rows(scene, mega, st)
    ctr = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, rows.shape[1]),
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.int32).to(device)
    return rows, ctr, mega, bool(need.any())


def test_megatrack_on_cpu_runs_plain_version_without_counting():
    rows, ctr, mega, busy = _mega_inputs(16, 0)
    assert busy and rows.shape == (tmt.C_IN, 256)
    before = tmt.run.launches
    got = tmt.run(rows, ctr, mega.table, 5, 6, mega.res, mega.nb)
    want = tmt.run_plain(rows, ctr, mega.table, 5, 6, mega.res, mega.nb)
    assert tmt.run.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, ctr_out = got
    assert out.shape == (tmt.C_OUT, 256) and ctr_out.dtype == torch.int32
    assert int((out[6] > 0).sum()) == int((rows[17] > 0.5).sum())


def test_megatrack_rejects_other_devices():
    rows, ctr, mega, _ = _mega_inputs(4, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tmt.run(rows.to("meta"), ctr, mega.table, 0, 6, mega.res, mega.nb)


def test_walk_rejects_other_devices():
    scene, cfg = _box()
    params, table, beam_tab, shape = tbw.walk_inputs(scene, cfg, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tbw.walk(params.to("meta"), 0, table, beam_tab, shape)


@pytest.mark.parametrize("change", [
    {"npix": 65}, {"width": 4}, {"sppc": 0}, {"stride": 64}, {"stride": -1},
    {"max_trips": -1}, {"npix": 1 << 26, "width": 1 << 13,
                        "height": 1 << 13, "sppc": 16}])
def test_walk_rejects_shapes_it_cannot_index(change):
    """The walk's sizes are checked before either version runs: a film that
    is not width x height, no samples, a lane rotation outside [0, npix), a
    negative trip cap, or output offsets past int32."""
    from dataclasses import replace

    scene, cfg = _box()
    params, table, beam_tab, shape = tbw.walk_inputs(scene, cfg, 1)
    tbw.check_shape(shape)
    with pytest.raises(ValueError, match="unsupported walk shape"):
        tbw.walk(params, 0, table, beam_tab, replace(shape, **change))


def _c_parameters(source: str, name: str) -> list[str]:
    """The parameter list of `extern "C" int name(...)` in a csrc source."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


def test_bindings_match_the_c_interfaces():
    """Every ctypes signature in kernels.py has as many arguments as its C
    function in csrc/, pointers where the C side takes pointers, and the
    stream last: a mismatch would pass garbage to a launch on the card."""
    source = "".join(s.read_text() for s in kernels.CSRC.glob("*.cu"))
    for name, argtypes in kernels._SIGNATURES.items():
        params = _c_parameters(source, name)
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            if "*" in param:
                assert argtype is kernels._P, (name, param)
        if "stream" in params[-1]:
            assert argtypes[-1] is kernels._P
    boxwalk_params = _c_parameters(source, "mk_boxwalk")
    assert boxwalk_params[-2] == "int* next_lane"
    assert _c_parameters(source, "mk_er_trace")[:2] == ["ErParams q",
                                                         "TraceIO io"]
    assert [f for f, _ in kernels.TraceIO._fields_] == [
        "p", "v", "active", "dist_lanes", "h_lanes", "dist", "h",
        "sphere_t", "po", "vo", "opt", "marched", "exited", "trips", "steps"]


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
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_walk_kernel_matches_plain_on_cuda(cuda):
    """Kernel B against walk_plain: every output row equal on every lane."""
    scene, cfg = _box(res=64, density_res=64, max_depth=12)
    params, table, beam_tab, shape = tbw.walk_inputs(scene.to(cuda), cfg, 8)
    seed = tbw.pass_seed(7, 0)
    before = tbw.walk.launches
    out_k = tbw.walk(params, seed, table, beam_tab, shape)
    assert tbw.walk.launches == before + 1
    out_p = tbw.walk_plain(params, seed, table, beam_tab, shape)
    assert torch.equal(out_k, out_p)
    st_k, st_p = tbw.fold(out_k, shape)[1], tbw.fold(out_p, shape)[1]
    assert st_k.tolist() == st_p.tolist() and st_k[3] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("res,sppc,max_trips", [(13, 4, None), (24, 2, 17),
                                                (1, 3, None)])
def test_walk_kernel_edge_cases_match_plain_on_cuda(cuda, res, sppc,
                                                    max_trips):
    """Lanes not a multiple of the block (169, 576), lanes cut by
    max_trips mid-sample, and a one-pixel film."""
    from dataclasses import replace

    scene, cfg = _box(res=res, density_res=64, max_depth=12)
    params, table, beam_tab, shape = tbw.walk_inputs(scene.to(cuda), cfg,
                                                     sppc)
    if max_trips is not None:
        shape = replace(shape, max_trips=max_trips)
    seed = tbw.pass_seed(3, 1)
    out_k = tbw.walk(params, seed, table, beam_tab, shape)
    out_p = tbw.walk_plain(params, seed, table, beam_tab, shape)
    assert torch.equal(out_k, out_p)
    if max_trips is not None:
        assert int(out_k[sppc * 3 + 2].max()) == max_trips


@pytest.mark.cuda
def test_walk_plain_agrees_on_cuda_and_cpu(cuda):
    """walk_plain on the card follows the paths it follows on the CPU, for a
    film whose width and height are not powers of two (13^2): kernel B is
    held to it on the card, and it is held to the JAX kernel on the CPU.
    The two are not bit-equal: torch's CPU and CUDA exp, log, sin and cos
    differ by ulps. So nearly every lane must keep its counts and its
    radiance within rtol 1e-4."""
    scene, cfg = _box(res=13, density_res=64, max_depth=12)
    params, table, beam_tab, shape = tbw.walk_inputs(scene, cfg, 4)
    seed = tbw.pass_seed(3, 1)
    out_c = tbw.walk_plain(params, seed, table, beam_tab, shape)
    out_g = tbw.walk_plain(params.to(cuda), seed, table.to(cuda),
                           beam_tab.to(cuda), shape).cpu()
    counts = shape.sppc * 3
    same = ((out_g[counts:] == out_c[counts:]).all(0)
            & torch.isclose(out_g, out_c, rtol=1e-4, atol=1e-6).all(0))
    assert same.float().mean().item() >= 0.98, same.float().mean().item()


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


@pytest.mark.cuda
def test_megatrack_kernel_matches_plain_on_cuda(cuda):
    """Kernel C against run_plain on the card: both round every product
    (--fmad=false) and use the card's logf, so every output of every lane
    is equal."""
    rows, ctr, mega, busy = _mega_inputs(128, 2, cuda)
    assert busy
    for trips in (6, 64):
        before = tmt.run.launches
        out_k, ctr_k = tmt.run(rows, ctr, mega.table, 9, trips, mega.res,
                               mega.nb)
        assert tmt.run.launches == before + 1
        out_p, ctr_p = tmt.run_plain(rows, ctr, mega.table, 9, trips,
                                     mega.res, mega.nb)
        torch.cuda.synchronize()
        assert torch.equal(ctr_k, ctr_p)
        assert torch.equal(out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["none valid", "all valid", "ragged n",
                                  "one lane", "cut by max_trips"])
def test_megatrack_kernel_edge_cases_match_plain_on_cuda(cuda, case):
    """No lane or every lane with work, n not a multiple of a block's lanes
    (1,000 of 16,384 lanes), one lane, and lanes cut by max_trips."""
    rows, ctr, mega, busy = _mega_inputs(128, 4, cuda)
    trips = 2 if case == "cut by max_trips" else 6
    if case in ("none valid", "all valid"):
        rows = rows.clone()
        rows[17] = 0.0 if case == "none valid" else 1.0
    elif case == "ragged n":
        rows, ctr = rows[:, :1000].contiguous(), ctr[:, :1000].contiguous()
    elif case == "one lane":
        j = int((rows[17] > 0.5).nonzero()[0])
        rows, ctr = rows[:, j:j + 1].contiguous(), ctr[:, j:j + 1].contiguous()
    out_k, ctr_k = tmt.run(rows, ctr, mega.table, 9, trips, mega.res, mega.nb)
    out_p, ctr_p = tmt.run_plain(rows, ctr, mega.table, 9, trips, mega.res,
                                 mega.nb)
    assert torch.equal(ctr_k, ctr_p) and torch.equal(out_k, out_p)
    if case == "cut by max_trips":
        assert int(out_k[6].max()) == 2
        assert not bool(out_k[5][rows[17] > 0.5].all())


@pytest.mark.cuda
def test_wavefront_render_on_cuda_goes_through_kernel_c_and_matches_cpu(cuda):
    scene, cfg = tpresets.volumetric_box(res=24, spp=4, heterogeneous=True,
                                         density_res=16, max_depth=4,
                                         filter="box", emitter_kind="point")
    before = tmt.run.launches
    stats = {}
    img_g = trender.render(scene, cfg, seed=2, device=cuda, stats=stats).cpu()
    assert tmt.run.launches >= before + stats["passes"][0][2]
    img_c = trender.render(scene, cfg, seed=2, device="cpu")
    assert abs(img_g.mean().item() / img_c.mean().item() - 1) <= 1e-2
    lit = img_c.mean(-1) > 0
    ratio = (img_g.mean(-1)[lit] / img_c.mean(-1)[lit]).median().item()
    assert 0.99 <= ratio <= 1.01


_BOX = tek.SdfField(tek.SDF_BOX, (0.0, 0.05, -0.05, 0.6, 0.7, 0.8))


def _trace_equal(got, want):
    """Kernel D against trace_plain: every output equal, the step count
    too."""
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["sphere", "box"])
@pytest.mark.parametrize("kind", [tek.RIF_LINEAR, tek.RIF_RADIAL])
def test_er_trace_kernel_matches_plain_on_cuda(cuda, kind, box):
    rif, sdf = _er_fields(kind)
    sdf = _BOX if box else sdf
    p, v, dist, act = _er_trace_inputs(rif, 18_432, 2, cuda)
    before = tem.trace.launches
    got = tem.trace(rif, sdf, p, v, dist, 0.01, 256, act)
    assert tem.trace.launches == before + 1
    want = tem.trace_plain(rif, sdf, p, v, dist, 0.01, 256, act)
    torch.cuda.synchronize()
    assert int(want[-1]) > 30 and bool(want[4].any())
    _trace_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["per-lane h", "ragged n", "n = 0",
                                  "max_steps 30", "constant RIF, no SDF"])
def test_er_trace_kernel_edge_cases_match_plain_on_cuda(cuda, case):
    """Per-lane step sizes and arc lengths, n not a multiple of the block,
    no lanes, a cut of the march at 30 steps, and the constant RIF with no
    SDF (every active lane leaves at its first step); kernel D's launch
    counted only where it runs."""
    rif, sdf = _er_fields(tek.RIF_RADIAL)
    n = {"ragged n": 1_000, "n = 0": 0}.get(case, 4_096)
    p, v, dist, act = _er_trace_inputs(rif, n, 9, cuda)
    h, steps = 0.01, 256
    if case == "per-lane h":
        h = torch.linspace(0.005, 0.03, n, device=cuda)
    elif case == "max_steps 30":
        steps = 30
    elif case == "constant RIF, no SDF":
        rif = tek.RifField(tek.RIF_CONST, (1.33,))
        sdf = tek.SdfField(tek.SDF_NONE, ())
    else:
        dist = 0.8
    before = tem.trace.launches
    got = tem.trace(rif, sdf, p, v, dist, h, steps, act)
    assert tem.trace.launches == before + (n > 0)
    want = tem.trace_plain(rif, sdf, p, v, dist, h, steps, act)
    torch.cuda.synchronize()
    _trace_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [tek.RIF_LINEAR, tek.RIF_RADIAL])
def test_er_sens_kernel_matches_plain_on_cuda(cuda, kind):
    rif, sdf = _er_fields(kind)
    args = _er_sens_inputs(rif, 36_864, 3, cuda)
    before = tem.sens_march.launches
    got = tem.sens_march(rif, sdf, *args[:5], 0.04, 64, args[5])
    assert tem.sens_march.launches == before + 1
    want = tem.sens_march_plain(rif, sdf, *args[:5], 0.04, 64, args[5])
    torch.cuda.synchronize()
    assert int(want[-1]) > 4 and bool(want[6].any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_er_sens_kernel_takes_per_lane_steps_on_cuda(cuda):
    rif, sdf = _er_fields(tek.RIF_RADIAL)
    args = _er_sens_inputs(rif, 4096, 7, cuda)
    h = torch.linspace(0.01, 0.05, 4096, device=cuda)
    got = tem.sens_march(rif, sdf, *args[:5], h, 64, args[5])
    want = tem.sens_march_plain(rif, sdf, *args[:5], h, 64, args[5])
    torch.cuda.synchronize()
    assert int(want[-1]) > 4 and bool(want[6].any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_er_render_on_cuda_goes_through_kernels(cuda):
    scene, cfg = tpresets.refractive_sphere(res=12, spp=2, max_depth=3,
                                            rif_kind=tek.RIF_LINEAR,
                                            rif_params=(1.3, 0.15),
                                            filter="box")
    before = tem.trace.launches, tem.sens_march.launches
    img = trender.render(scene, cfg, seed=0, device=cuda)
    assert tem.trace.launches > before[0]
    assert tem.sens_march.launches > before[1]
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
