"""Kernels A, A', B, C, D and E of this tree against those of an earlier
tree, on one NVIDIA GPU, each driven through its own tree's Python wrappers.

    python3 scripts/compare_kernels_torch.py --old DIR [--kernels "AA'BCDE"]
        [--out FILE]

DIR is the root of an unpacked earlier tree of this repository holding at
least its `mitsubaer_tpu_torch/` package (for example `git archive <commit>
mitsubaer_tpu_torch | tar -x -C DIR`). Each tree runs in a process of its
own, in turns old, new, new, old; each imports its own package, which builds
its own kernels, and is called only through the wrappers both trees have
(`DensityGrid(...).lookup`, `medium.trilinear_lookup_backward`,
`boxwalk.walk`, `megatrack.run`, `ermarch.trace`, `ermarch.sens_march`), so
the comparison does not depend on either tree's C interface (D's per-lane
trip counts, which no wrapper returns, come through each tree's own
interface; A''s bare launch through each tree's C entry, _a_bwd_bare). DIR may
also be a copy of this tree with a launch constant changed, to time a
variant of a kernel against the kernel as it stands; --kernels limits the
run to the kernels named (default all six).

Each process, on chip_smoke.py's inputs (A: 10^6 points in and around the
64^3 grid, f32 and bf16-rounded; A': phase 16's 2^20 spread and clustered
points and calls 0, 4, 16, 64, 256 and the busiest of each point count of
phase 17's training step, captured in the process from its own tree's
loss_and_grad; B: the 512^2 bounded volume's pass, sppc 8,
depth 12; C: the first three tracking calls of the 512^2 point-lit render's
first pass, captured in the process from its own tree's render_wavefront;
D: 18,432 lanes of the eikonal bench's linear RIF and of a radial one, h
1e-2, at most 256 steps; E: 36,864 lanes of the same two RIFs, h 4e-2, at
most 64 steps):
  * checks the wrapper's result against its tree's plain version (exact;
    A' within chip_smoke.A_BWD_TOL);
  * times the wrapper with CUDA events (50 calls for A and A', 5 for B, 20
    for C, D and E, after a warm-up), and its host time a call;
  * traces the same calls with torch.profiler and reports, a call, the
    device time of the tree's kernel (found by name) and of all the device
    work the wrapper made, and how many launches and copies that was.
For A it does the same for torch's grid_sample on the same points. For A'
it also reports the bare launch's time, the wrapper's launches a call, its
bound on the call's data (chip_smoke._a_bwd_bound), how the points fall on
the grid (_a_bwd_stats), each point count's calls in the step with their
non-zero output gradients, and registers and SASS counts. For D
it also reports the chain floor (the device time of one launch holding only
the lane with the most trips), the kernel-D calls of chip_smoke.py's
phase-7 eikonal render (96^2, spp 2, captured from the tree's own render:
their lanes, active lanes and trips a lane, and the kernel's device time
over all of them, replayed) and, per compiled function, registers and SASS
instruction counts. Prints the card's name and power limit and one line a
measurement, and writes all numbers to FILE as JSON.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL_NAMES = {"A": "trilinear_kernel", "A'": "trilinear_backward_kernel",
                "B": "boxwalk_kernel",
                "C": "megatrack_kernel", "D": "er_trace_kernel",
                "E": "er_sens_kernel", "grid_sample": "grid_sampler"}


def _smoke():
    """chip_smoke.py of this tree, loaded by path (an earlier tree on
    sys.path may hold its own), for its timers and seeded inputs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MEASURED = ("ms", "host_us", "kernel_device_ms", "device_ms", "device_ops")


def _measure(cs, name, fn, reps):
    ms = cs._cuda_ms(fn, reps)
    host = cs._host_us(fn, reps)
    own, every, count = cs._device_per_call(fn, reps,
                                             KERNEL_NAMES[name])
    return {"ms": ms, "host_us": host, "kernel_device_ms": own,
            "device_ms": every, "device_ops": count}


def worker(tree: Path, which: str) -> dict:
    """The measurements of one tree's wrappers of the kernels named in
    `which` (run in its own process)."""
    sys.path.insert(0, str(tree))
    import torch

    import mitsubaer_tpu_torch

    cs = _smoke()
    dev = torch.device("cuda", 0)
    res = {"tree": str(tree), "package": mitsubaer_tpu_torch.__file__}
    for name, measure in (("A", _kernel_a), ("A'", _kernel_a_bwd),
                          ("B", _kernel_b), ("C", _kernel_c),
                          ("D", _kernel_d), ("E", _kernel_e)):
        if name in _kernels(which):
            measure(cs, dev, res)
    return res


def _kernels(which):
    """The kernels named in a --kernels string such as "A'BD"."""
    names = re.findall(r"A'|[A-E]", which)
    if "".join(names) != which:
        raise ValueError(f"--kernels takes A, A', B, C, D and E: {which!r}")
    return names


def _kernel_a(cs, dev, res):
    import torch

    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    scene, _ = presets.volumetric_box(res=64, spp=1, heterogeneous=True,
                                      density_res=64, max_depth=12,
                                      filter="box")
    scene = scene.to(dev)
    n = 1_000_000
    pts = cs._a_points(n, dev)
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        grid = medium.DensityGrid(scene.media, dtype=dtype)
        got = grid.lookup(pts)
        want = medium.trilinear_lookup_plain(grid.grid, grid.aabb6, pts)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel A ({label}) differs from plain")
        res[f"A_{label}"] = _measure(cs, "A", lambda: grid.lookup(pts), 50)
    grid = medium.DensityGrid(scene.media)
    lo, hi = grid.aabb6[:3], grid.aabb6[3:]
    vol = grid.grid[None, None]
    coords = ((pts - lo) / (hi - lo) * 2.0 - 1.0).reshape(1, 1, 1, n, 3)
    res["grid_sample"] = _measure(
        cs, "grid_sample", lambda: torch.nn.functional.grid_sample(
            vol, coords, mode="bilinear", padding_mode="zeros",
            align_corners=True), 50)


def _kernel_a_bwd(cs, dev, res):
    """A' on phase 16's 2^20 spread and clustered points and on calls 0, 4,
    16, 64 and 256 of each point count that the tree's own training step
    gives it, and on its call with the most non-zero output gradients (phase
    17's step: 512^2 beam volume, sppc 4, seed 7, the target at
    sigma_s x 1.5): checked against the plain version, timed through the
    wrapper and as a bare C launch, the launches a call counted, and how
    the points fall on the grid."""
    import torch

    from mitsubaer_tpu_torch.diff import render as diff_m
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    sets = {name: cs._a_bwd_case(name, dev) for name in ("uniform",
                                                         "clustered")}
    scene, cfg = presets.volumetric_box(res=512, spp=4, heterogeneous=True,
                                        density_res=64, max_depth=12)
    scene = scene.to(dev)
    params = diff_m.get_params(scene)
    with torch.no_grad():
        target = diff_m.render_diff(
            scene, params._replace(sigma_s=params.sigma_s * 1.5), cfg, 4,
            123, 0, device=dev)
    leaves = diff_m.MediumParams(*(t.detach().clone().requires_grad_()
                                   for t in params))
    calls = cs._capture_a_bwd(scene, leaves, cfg, 4, 7, 0, target, dev)
    for n, (count, taken, nonzero, busiest) in sorted(calls.items()):
        for k, call in zip(cs.A_BWD_STEP_CALLS, taken):
            sets[f"step{n}_call{k}"] = call[:4] + ("step",)
        sets[f"step{n}_busiest"] = busiest[:4] + ("step",)
        res[f"A'_step{n}"] = {"calls": count, "nonzero_mean": sum(nonzero)
                              / count, "nonzero_max": max(nonzero)}
    fn = medium.trilinear_lookup_backward
    for label, (shape, aabb6, p, g, tol) in sets.items():
        want = medium.trilinear_lookup_backward_plain(shape, aabb6, p, g)
        before = fn.launches
        got = fn(shape, aabb6, p, g)
        launches = fn.launches - before
        rel, _ = cs._a_bwd_check(got, want, cs.A_BWD_TOL[tol], label)
        m = _measure(cs, "A'", lambda: fn(shape, aabb6, p, g), 50)
        m["bare_ms"] = cs._cuda_ms(_a_bwd_bare(
            shape, aabb6, p, g, torch.zeros(shape, device=dev)), 50)
        bound = cs._a_bwd_bound(shape, g)
        m.update(launches_a_call=launches, max_rel_err=rel,
                 bound_ms=bound[0], bound_by=bound[1],
                 points=_a_bwd_stats(shape, aabb6, p, g))
        res[f"A'_{label}"] = m
    res["A'_sass"] = _sass(KERNEL_NAMES["A'"])


def _a_bwd_bare(shape, aabb6, p, grad_out, grad):
    """One bare launch of this process's tree's kernel A' into `grad` (not
    counted): with the int64 scratch argument where the tree's C entry
    takes one (the fixed-point sums), without it where it does not."""
    import torch

    from mitsubaer_tpu_torch import kernels

    nz, ny, nx = shape
    fn = kernels.library().mk_trilinear_lookup_backward
    acc = torch.empty((nz * ny * nx + 1,), dtype=torch.int64,
                      device=p.device)
    scratch = [acc.data_ptr()] if len(fn.argtypes) == 10 else []
    args = (p.data_ptr(), grad_out.data_ptr(), aabb6.data_ptr(),
            grad.data_ptr(), *scratch, p.shape[0], nx, ny, nz,
            kernels.stream(p))
    return lambda keep=acc: fn(*args)


def _a_bwd_stats(shape, aabb6, p, grad_out):
    """How kernel A''s points fall on the grid: the shares outside the AABB
    and with a zero output gradient; over the points that add (inside,
    gradient non-zero): the distinct cells a warp of 32 consecutive points
    holds, the extent (x, y, z) and volume of the box of the corner voxels
    of 256 and of 1,024 consecutive points, and the voxels touched."""
    import torch

    from mitsubaer_tpu_torch.models import medium

    nz, ny, nx = shape
    n = p.shape[0]
    inside, cell, _ = medium._cell_weights(shape, aabb6, p)
    adds = inside & (grad_out != 0)
    cx, cy = max(nx - 1, 1), max(ny - 1, 1)
    key = torch.where(adds, (cell[:, 2] * cy + cell[:, 1]) * cx + cell[:, 0],
                      -1)

    def rows(x, size, fill):
        pad = -x.shape[0] % size
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
        return x.reshape((-1, size) + x.shape[1:])

    w = rows(key, 32, -1).sort(dim=1).values
    live = w[:, -1] >= 0
    distinct = ((w[:, 1:] != w[:, :-1]) & (w[:, :-1] >= 0)).sum(1) + live
    top = torch.tensor([nx - 1, ny - 1, nz - 1], device=p.device)
    out = dict(n=n, outside=1.0 - inside.float().mean().item(),
               g_zero=(grad_out == 0).float().mean().item(),
               adds=adds.float().mean().item(),
               cells_per_warp=distinct[live].float().mean().item()
               if live.any() else 0.0,
               adding_lanes_per_warp=(w >= 0).sum(1)[live].float().mean()
               .item() if live.any() else 0.0)
    for size in (256, 1024):
        lo = rows(torch.where(adds[:, None], cell, 1 << 30), size,
                  1 << 30).amin(1)
        hi = rows(torch.where(adds[:, None], torch.minimum(cell + 1, top),
                              -1), size, -1).amax(1)
        ext = (hi - lo + 1)[hi[:, 0] >= 0]
        if not ext.numel():
            continue
        vol = ext.prod(1).double()
        q = torch.quantile(vol, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                             device=p.device)).tolist()
        out[f"box{size}"] = dict(
            blocks=int(ext.shape[0]),
            extent_p50=ext.double().median(0).values.tolist(),
            volume_mean=vol.mean().item(), volume_p50=q[0], volume_p99=q[1],
            volume_le_4096=(vol <= 4096).double().mean().item())
    corners = [((cell[adds, 2] + dz).clamp_max(nz - 1) * ny
                + (cell[adds, 1] + dy).clamp_max(ny - 1)) * nx
               + (cell[adds, 0] + dx).clamp_max(nx - 1)
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    out["voxels_touched"] = int(torch.unique(torch.cat(corners)).numel())
    return out


def _kernel_b(cs, dev, res):
    import torch

    from mitsubaer_tpu_torch.integrators import boxwalk
    from mitsubaer_tpu_torch.scene import presets

    b_scene, b_cfg = presets.volumetric_box(res=512, spp=8, heterogeneous=True,
                                            density_res=64, max_depth=12,
                                            filter="box")
    params, table, beam_tab, shape = boxwalk.walk_inputs(b_scene.to(dev),
                                                         b_cfg, 8)
    seed = boxwalk.pass_seed(7, 0)

    def walk():
        return boxwalk.walk(params, seed, table, beam_tab, shape)

    if not torch.equal(walk(), boxwalk.walk_plain(params, seed, table,
                                                  beam_tab, shape)):
        raise AssertionError("kernel B differs from plain")
    res["B_512"] = _measure(cs, "B", walk, 5)


def _kernel_c(cs, dev, res):
    import torch

    from mitsubaer_tpu_torch.integrators import megatrack, wavefront
    from mitsubaer_tpu_torch.integrators.megatrack import run_plain
    from mitsubaer_tpu_torch.scene import presets

    c_scene, c_cfg = presets.volumetric_box(res=512, spp=32, heterogeneous=True,
                                            density_res=64, max_depth=12,
                                            filter="box", emitter_kind="point")
    run, calls = megatrack.run, []

    def capture(*args):
        if len(calls) < 3:
            calls.append(args)
        return run(*args)

    capture.launches = 0
    megatrack.run = capture
    try:
        wavefront.render_wavefront(c_scene.to(dev), c_cfg, 8, 0, 0)
    finally:
        megatrack.run = run
    for i, args in enumerate(calls):
        (out_k, ctr_k), (out_p, ctr_p) = run(*args), run_plain(*args)
        if not (torch.equal(out_k, out_p) and torch.equal(ctr_k, ctr_p)):
            raise AssertionError(f"kernel C differs from plain at call {i}")
        res[f"C_call{i}"] = _measure(cs, "C", lambda: run(*args), 20)
        res[f"C_call{i}"]["lanes_with_work"] = int((args[0][17] > 0.5).sum())


# a SASS line's opcode: after the address and an optional predicate
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)")


def _sass(kernel):
    """Each compiled function of `kernel` in the tree's library, by its
    mangled name: registers (ptxas' report in the build log) and SASS
    instruction counts (`cuobjdump -sass`): all, and FCHK (the IEEE
    division's range check), MUFU, CALL, BRA, the local-memory LDL/STL, the
    global reductions and atomics REDG/ATOMG, the shared atomics ATOMS, and
    MATCH and SHFL."""
    from mitsubaer_tpu_torch import kernels

    lib = kernels.library_path()
    log = (lib.parent / "build.log").read_text().splitlines()
    regs = {}
    for i, line in enumerate(log):
        if "Compiling entry function" in line and kernel in line:
            name = line.split("'")[1]
            for later in log[i + 1:]:
                if "Used" in later and "registers" in later:
                    regs[name] = int(later.split("Used")[1].split()[0])
                    break
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if kernel not in name:
            continue
        ops = _OPCODE.findall(block)
        out[name] = {"registers": regs.get(name), "instructions": len(ops),
                     **{op: ops.count(op) for op in (
                         "FCHK", "MUFU", "CALL", "BRA", "LDL", "STL", "REDG",
                         "ATOMG", "ATOMS", "MATCH", "SHFL")}}
    return out


def _d_trips(cs, ermarch, rif, sdf, d_in, h, steps):
    """Kernel D's per-lane trip counts through the tree's own interface:
    the earlier (12, n) row stack (`run_kernel`), or the bare launch on the
    caller's tensors (chip_smoke.py's `_d_bare`)."""
    p, v, dist, act = d_in
    if hasattr(ermarch, "run_kernel"):
        rows = ermarch.trace_rows(p, v, dist, h, act)
        return ermarch.run_kernel(rif, sdf, rows, steps)[1]
    launch, outs = cs._d_bare(rif, sdf, d_in, h, steps)
    launch()
    return outs[-1]


def _kernel_d(cs, dev, res):
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.models import ermarch
    from mitsubaer_tpu_torch.scene import presets

    sdf = ek.SdfField(ek.SDF_SPHERE, (0.0, 0.0, 0.0, 1.0))
    linear = ek.RifField(ek.RIF_LINEAR, (1.3, 0.15, 0.0, 0.0))
    radial = ek.RifField(ek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0))
    h, steps = 1e-2, 256
    for label, rif, seed in (("linear", linear, 11), ("radial", radial, 12)):
        d_in = cs._er_inputs(rif, 18_432, 0, seed, dev)[0]

        def call(d_in=d_in, rif=rif):
            return ermarch.trace(rif, sdf, *d_in[:3], h, steps, d_in[3])

        want = ermarch.trace_plain(rif, sdf, *d_in[:3], h, steps, d_in[3])
        if not all(torch.equal(a, b) for a, b in zip(call(), want)):
            raise AssertionError(f"kernel D ({label}) differs from plain")
        m = _measure(cs, "D", call, 20)
        # the chain floor: one launch of the lane with the most trips alone
        trips = _d_trips(cs, ermarch, rif, sdf, d_in, h, steps)
        j = int(trips.argmax())
        one = [t[j:j + 1].contiguous() for t in d_in]
        m["chain_floor_ms"] = cs._device_per_call(
            lambda: call(one), 20, KERNEL_NAMES["D"])[0]
        # the bound of the work, counted from this tree's kernel D
        bound = cs._bound(d_in[0].shape[0] * 70 + 8,
                          int(trips.sum()) * cs.OPS_D_STEP[rif.kind])
        m.update(max_trips=int(trips[j]), lane_steps=int(trips.sum()),
                 steps=int(want[-1]), bound_ms=bound[0], bound_by=bound[1])
        res[f"D_{label}"] = m
    # the calls of chip_smoke.py's phase-7 render (bench_er_forward's 96^2,
    # spp 2), captured from the tree's own render
    scene, cfg = cs._er_bench_scene(presets, 96, 2, 256)
    img, calls = cs._trace_calls(
        lambda: render_m.render(scene, cfg, seed=1, device=dev))
    res["D_image"] = img.cpu().flatten().tolist()
    calls = [c for c in calls if c[2].shape[0]]
    sizes, all_trips = [], []
    for c in calls:
        d_in = (c[2], c[3], c[4], c[7])
        trips = _d_trips(cs, ermarch, c[0], c[1], d_in, c[5], c[6])
        active = trips[c[7]].to(torch.float64)
        all_trips.append(active)
        sizes.append([c[2].shape[0], int(c[7].sum()), cs._spread(active)])
    own, every, ops = cs._device_per_call(
        lambda: [ermarch.trace(*c) for c in calls], 3, KERNEL_NAMES["D"])
    res["D_render"] = {"launches": len(calls),
                       "kernel_device_ms_total": own * len(calls),
                       "device_ms_total": every * len(calls),
                       "device_ops_total": ops * len(calls),
                       "trips": cs._spread(torch.cat(all_trips)),
                       "calls": sizes}
    res["D_sass"] = _sass(KERNEL_NAMES["D"])


def _kernel_e(cs, dev, res):
    import torch

    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.models import ermarch

    sdf = ek.SdfField(ek.SDF_SPHERE, (0.0, 0.0, 0.0, 1.0))
    linear = ek.RifField(ek.RIF_LINEAR, (1.3, 0.15, 0.0, 0.0))
    radial = ek.RifField(ek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0))
    h, steps = 4e-2, 64
    for label, rif, seed, n_d in (("linear", linear, 11, 18_432),
                                  ("radial", radial, 12, 0)):
        e_in = cs._er_inputs(rif, n_d, 36_864, seed, dev)[1]

        def call():
            return ermarch.sens_march(rif, sdf, *e_in[:5], h, steps, e_in[5])

        got = call()
        want = ermarch.sens_march_plain(rif, sdf, *e_in[:5], h, steps,
                                        e_in[5])
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"kernel E ({label}) differs from plain")
        res[f"E_{label}"] = _measure(cs, "E", call, 20)


def _image_diffs(runs, card):
    """Where each run rendered D's phase-7 image: the pixels in which two
    runs' images differ, for each pair of consecutive runs and the two old
    ones. The images leave the runs' record."""
    import torch

    images = [torch.tensor(got.pop("D_image")) if "D_image" in got else None
              for _, got in runs]
    for i, j in ((0, 1), (1, 2), (2, 3), (0, 3)):
        if images[i] is None or images[j] is None:
            continue
        a, b = images[i].view(-1, 3), images[j].view(-1, 3)
        differ = (a != b).any(-1)
        print(f"D render image, run {i} ({runs[i][0]}) against run {j} "
              f"({runs[j][0]}): {int(differ.sum())} of {a.shape[0]} pixels "
              f"differ, max abs diff {(a - b).abs().max().item():.3e} "
              f"[{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path)
    ap.add_argument("--kernels", default="AA'BCDE",
                    help="the kernels to measure, of A, A', B, C, D and E "
                         "(for example \"A'B\")")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "compare" / "compare_kernels.json")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.kernels)))
        return 0
    if args.old is None:
        ap.error("--old DIR is required")
    _kernels(args.kernels)

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"old": args.old.resolve(), "new": ROOT}
    runs = []
    for which in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(trees[which]), "--kernels", args.kernels],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {which} tree's run failed")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((which, got))
        for key, m in got.items():
            if not isinstance(m, dict):
                continue
            if "ms" not in m:
                print(f"{which} {key}: {json.dumps(m)} [{card}]", flush=True)
                continue
            extra = {k: x for k, x in m.items() if k not in _MEASURED}
            print(f"{which} {key}: {m['ms']:.4f} ms a call (host "
                  f"{m['host_us']:.2f} us), device {m['device_ms']:.4f} "
                  f"ms in {m['device_ops']:.1f} launches and copies, of "
                  f"which the kernel {m['kernel_device_ms']:.4f} ms"
                  f"{' ' + json.dumps(extra) if extra else ''} [{card}]",
                  flush=True)
    _image_diffs(runs, card)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
