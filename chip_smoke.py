"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile csrc/*.cu with nvcc (or load the cached library);
  3. kernel A (trilinear density lookup from the cell table) against its
     plain version on 10^6 points in and around the 64^3 grid, f32 and
     bf16-rounded grids, exact; its time through its wrapper and as a bare
     launch, each with its host time a call, the cell table's build time,
     and torch's grid_sample on the same points as the yardstick;
  4. kernel B (boxwalk) against its plain version at depth 12, density
     64^3: at res 64 and at the main path's 512^2 (sppc 8), and at 100^2
     (10,000 lanes, not a multiple of the block; sppc 4) with and without a
     cut of max_trips to 30; every output row equal on every lane; the
     per-lane trip counts' spread, the device time from a profiler trace,
     registers and resident blocks;
  5. the bounded-volume path: render() at 512^2, spp 32, depth 12, density
     64^3, box filter, on the card; every kernel's launch counter must be
     non-zero. Then the same render at a small size on the card and on the
     CPU (plain versions), which must agree;
  6. kernels D and E (the eikonal marches) against their plain versions on
     the card at the eikonal bench's shapes (18,432 and 36,864 lanes), each
     exact for the linear and radial RIFs, every output and flag equal on
     every lane, per-lane trip counts checked; each timed bare and as the
     whole trace / sens_march call, with host time; D also with its
     profiler device time, its chain floor (the lane with the most trips
     alone in a launch) and registers;
  7. the eikonal path: render() of refractive_sphere at the eikonal bench's
     full width (96^2, spp 2, depth 6, linear RIF, h 1e-2, 8 BVP restarts
     at 4x h) on the card; both march kernels must have launched; kernel
     D's launches in it (lanes, active lanes, trips a lane) and its device
     time over them;
  8. the same eikonal render at 24^2 on the card and on the CPU (plain
     versions), which must agree;
  9. kernel C (megatrack) against its plain version on the arguments of
     the first three tracking calls of the 512^2 point-lit render's first
     pass (captured from render_wavefront), on edge cases made from them
     (no lane or every lane with work, 100,000 lanes, one lane, max_trips
     2), and on the three synthetic cases of tests/test_megatrack.py at
     262,144 lanes; every output row and the counter equal on every lane;
     the taps' spread, device time a call and registers;
 10. the wavefront path: render() of the point-lit heterogeneous box at
     512^2, spp 32, depth 12, density 64^3, on the card; kernel C must
     launch at least once a pass;
 11. the same render at 24^2 on the card and on the CPU, which must agree;
 12. render_wavefront on the beam scene (512^2, sppc 8, depth 12, no
     emitter NEE, two transition passes) against render_boxwalk at the same
     seed, for two seeds: pixel-by-pixel median ratio within 0.95-1.05;
 13. the loop road, the main path's default: render() of the beam scene at
     512^2, spp 32, depth 12, density 64^3, with its gaussian film filter
     (4 passes of 8 spp through volpath.li, then 4 beam-splat passes) on
     the card; kernel A must launch; its wall, bounces and Woodcock
     iterations a pass, kernel A's launches, peak device memory and image
     mean. Then that render's first pass again with kernel A's lookups
     captured: every captured output (calls 0, 4, 16, 64, 256 and 1024 of
     each point count: the Woodcock and beam-point lookups at 2,097,152
     points, the batched visibility walk at 4,194,304) must equal the
     plain version on the same inputs, and A is timed at each count;
 14. the same render at 24^2, spp 4, on the card and on the CPU, which
     must agree by phase 8's rule;
 15. one loop-engine pass (engine "loop", box filter) on the 512^2 beam
     scene (sppc 8) against render_boxwalk at the same seed:
     pixel-by-pixel median ratio within 0.95-1.05.
Prints one JSON line of per-kernel results (time, bound, plain version,
library yardstick, launches on the main paths; for A also its launches on
the loop road and its checks and times at the loop road's point counts;
for B, C and D also the device time and registers), then
the contract line {"ok": true, "device": {...}} last.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores and HBM3 bandwidth. A kernel's bound is the larger of its
# operations over the first and its bytes (each input read once, each output
# written once) over the second.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Operations per unit of work, counted from the CUDA sources (adds,
# multiplies, compares, selects, divisions, transcendentals, and the shifts,
# xors and conversions of the hashing one each): kernel A per point; kernel
# B per density tap and per path segment; kernels D and E per march step by
# RIF kind (linear, radial).
OPS_A_POINT = 45
# B per tap, item by item from the tap stage of boxwalk.cu: the trip and
# counter increments 2; the chain's start (counter conversion, multiply, two
# adds) 4; its seven steps b0..b6 (add, three xor-shifts, two multiplies)
# 63; u[2..6] (shift, conversion, multiply) 15; the free-flight step 5; the
# position 6; voxel coordinates, inside test, clamp and stochastic corners
# 44; brick index, address, load, widening and the outside select 19; the
# tap count 1; the three factors 12; the escape test and clip 2; the
# cheaper of the two modes' updates (shadow) 6. A real collision's u[0],
# u[1], u[7], u[8] (two more steps of the chain) go with its body, beam
# NEE, phase sample and roulette, spread over the segments it opens at 100
# a segment: no output counts real collisions.
OPS_B_TAP, OPS_B_SEGMENT = 179, 100
# D per lane-trip, from trace_lane: the candidate (v1 6, p1 with its three
# divisions 9), the field at its end point (6 linear, 17 radial), v2 6, the
# next step's length 5, the sphere test 9, the opt update 2, and the loop's
# done, trip and exit tests 4
OPS_D_STEP = {1: 47, 2: 58}
# E per lane-step, from sens_step and its loop: the work the lane's three
# column threads share counted once (v1 and v2 6 each, the position 9, one
# RIF evaluation with its Hessian at the new point, 6 linear or 38 radial,
# 1/n and -1/n^2 3, the row factors 3, the sphere SDF 13, the plane side 9,
# the stop test 2, the loop's opt, marched, crossed and trip count 6) and
# the column work three times (dv1 and dv2 21 each, g.dp 5, dp 15)
OPS_E_STEP = {1: 63 + 3 * 62, 2: 95 + 3 * 62}
# kernel C per density tap: five lowbias32 hashes and their uniforms, the
# exponential step, the voxel position, the inside test and clip, three
# stochastic corners, the brick index and load, and the weight update
OPS_C_TAP = 160


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps):
    """Host time of one call in microseconds: reps calls queued with no
    synchronisation between them. Where it exceeds _cuda_ms's time of the
    same calls, the device waited on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _device_per_call(fn, reps, kernel, attempts=5):
    """(device ms of `kernel`, device ms of all device work, launches and
    copies) a call, from a torch.profiler trace of reps calls of `fn`, each
    of which launches `kernel` once. The trace at times drops a call's
    events, so the sums are divided by the launches of `kernel` it holds,
    and a trace that holds none is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        own = every = count = calls = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                every += us
                count += e.count
                if kernel in e.key:
                    own += us
                    calls += e.count
        if calls:
            return own / calls / 1e3, every / calls / 1e3, count / calls
    raise AssertionError(f"{attempts} profiler traces held no launch of "
                         f"{kernel}")


def _registers(build_log, kernel):
    """Registers a thread of `kernel`, from ptxas' report (-Xptxas -v) in
    the build log."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for later in lines[i + 1:]:
                if "Used" in later and "registers" in later:
                    return int(later.split("Used")[1].split()[0])
    raise AssertionError(f"the build log has no ptxas report of {kernel}")


def _differ(a, b):
    """Where two tensors of one shape differ (NaN equals NaN)."""
    return (a != b) & ~(a.isnan() & b.isnan())


def _spread(x):
    """'mean m, p50 a, p99 b, max c' of a 1-D tensor of counts."""
    import torch

    if not x.numel():
        return "no lanes"
    x = x.to(torch.float64)
    q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                       device=x.device)).tolist()
    return (f"mean {x.mean().item():.2f}, p50 {q[0]:.0f}, p99 {q[1]:.0f}, "
            f"max {x.max().item():.0f}")


def _bound(nbytes, ops):
    """(bound in ms, what bounds it) for the given bytes and operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_row(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms)


def _a_points(n, dev):
    """Kernel A's points: uniform in and around the [-1, 1]^3 grid AABB, a
    tenth of them on its faces."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(1234)
    pts = torch.rand((n, 3), generator=gen) * 2.4 - 1.2    # in and around
    face = torch.randint(0, 3, (n // 10,), generator=gen)
    side = torch.randint(0, 2, (n // 10,), generator=gen).float() * 2 - 1
    pts[torch.arange(n // 10), face] = side                 # on the faces
    return pts.to(dev)


def _a_bare(grid, pts, out):
    """One bare launch of kernel A: the C call alone, with its arguments
    formed once (no checks, no allocation, not counted)."""
    import torch

    from mitsubaer_tpu_torch import kernels

    nz, ny, nx = grid.grid.shape
    args = (pts.data_ptr(), grid.cells.data_ptr(), grid.aabb6.data_ptr(),
            out.data_ptr(), pts.shape[0], nx, ny, nz,
            int(grid.cells.dtype == torch.bfloat16), kernels.stream(pts))
    fn = kernels.library().mk_trilinear_lookup
    return lambda: fn(*args)


def _e_bare(rif, sdf, e_in, h, max_steps):
    """(one bare launch of kernel E on preallocated outputs, those outputs:
    sens_march's, then the per-lane trip counts); the launch is not
    counted."""
    from mitsubaer_tpu_torch import kernels
    from mitsubaer_tpu_torch.models import ermarch

    io, outs = ermarch.sens_io(*e_in[:5], h, e_in[5])
    args = (ermarch._params(rif, sdf), io, e_in[0].shape[0], max_steps,
            kernels.stream(e_in[0]))
    fn = kernels.library().mk_er_sens
    return lambda: fn(*args), outs


def _d_bare(rif, sdf, d_in, h, max_steps):
    """(one bare launch of kernel D on preallocated outputs, those outputs:
    trace's, then the per-lane trip counts); the launch is not counted.
    d_in is (p, v, distance, active) with at least one lane."""
    from mitsubaer_tpu_torch import kernels
    from mitsubaer_tpu_torch.models import ermarch

    p, v, dist, act = d_in
    io, outs = ermarch.trace_io(sdf, p, v, dist, h, act)
    args = (ermarch._params(rif, sdf), io, p.shape[0], max_steps,
            kernels.stream(p))
    fn = kernels.library().mk_er_trace
    return lambda: fn(*args), outs


def _plain_trips(want, active, h, max_steps):
    """Per-lane trip counts of sens_march_plain's loop, from its output: a
    lane that took k steps ran k + 1 trips (the last one stopped it) unless
    it reached max_steps; an inactive lane ran none."""
    import torch

    k = torch.round(want[5] / h).to(torch.int32)
    return torch.where(active, torch.clamp_max(k + 1, max_steps), 0)


def _er_inputs(rif, n_d, n_e, seed, dev):
    """Seeded lanes for kernels D and E in the unit-sphere medium: D marches
    from inside points along random directions for a sampled arc length (a
    tenth march to the boundary); E starts as integrate_with_sensitivities
    starts it, half the targets at the bench scene's point light."""
    import numpy as np
    import torch

    from mitsubaer_tpu_torch.models import eikonal as ek

    r = np.random.default_rng(seed)

    def unit(k):
        d = r.normal(size=(k, 3))
        return torch.from_numpy(
            (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))

    p = torch.from_numpy(r.uniform(-0.55, 0.55, (n_d, 3)).astype(np.float32))
    v = unit(n_d) * ek.rif_value(rif, p)[:, None]
    dist = torch.from_numpy(np.where(r.uniform(size=n_d) < 0.1, 1e6,
                                     r.exponential(2.4, n_d)).astype(np.float32))
    act = torch.from_numpy(r.uniform(size=n_d) < 0.9)
    d_in = [t.to(dev) for t in (p, v, dist, act)]

    p1 = torch.from_numpy(r.uniform(-0.55, 0.55, (n_e, 3)).astype(np.float32))
    p2 = torch.from_numpy(r.uniform(-0.9, 0.9, (n_e, 3)).astype(np.float32))
    p2[: n_e // 2] = torch.tensor([2.0, 2.0, -2.0])
    v0 = p2 - p1
    r0 = ek.rif_value(rif, p1)
    nv = v0.norm(dim=-1)
    dvdv0 = (r0 / nv ** 3)[:, None, None] * (
        (nv ** 2)[:, None, None] * torch.eye(3) - v0[:, :, None] * v0[:, None])
    v = v0 / nv[:, None] * r0[:, None]
    act = torch.from_numpy(r.uniform(size=n_e) < 0.9)
    e_in = [t.to(dev) for t in (p1, v, torch.zeros((n_e, 3, 3)), dvdv0, p2,
                                act)]
    return d_in, e_in


def _trace_calls(run):
    """(run(), the arguments of each kernel-D call it made): run() with
    eikonal.trace_curved wrapped to keep a copy of its inputs, which leaves
    ermarch.trace and its launch count as they are."""
    import torch

    from mitsubaer_tpu_torch.models import eikonal as ek

    trace_curved, calls = ek.trace_curved, []

    def capture(rif, sdf, p, v, distance, h, max_steps, active,
                differentiable=False):
        dist = (distance.clone() if isinstance(distance, torch.Tensor)
                else distance)
        calls.append((rif, sdf, p.clone(), v.clone(), dist, h, max_steps,
                      active.clone()))
        return trace_curved(rif, sdf, p, v, distance, h, max_steps, active,
                            differentiable)

    ek.trace_curved = capture
    try:
        out = run()
    finally:
        ek.trace_curved = trace_curved
    return out, calls


def main() -> int:
    import torch

    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch import kernels
    from mitsubaer_tpu_torch.integrators import boxwalk
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.models import ermarch
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    path, nvcc_s = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s) "
          f"-> {path.relative_to(path.parents[2])}", flush=True)
    log = path.parent / "build.log"
    build_log = log.read_text() if log.exists() else ""
    if build_log:
        for line in build_log.splitlines():
            if "Compiling entry function" in line:
                print("  ptxas:", line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print("  ptxas:   ", line.strip())
    results = {}

    # ---- phase 3: kernel A against its plain version ----
    scene, cfg = presets.volumetric_box(res=512, spp=32, heterogeneous=True,
                                        density_res=64, max_depth=12,
                                        filter="box")
    scene = scene.to(dev)
    n = 1_000_000
    pts = _a_points(n, dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    errs, ms, plain_ms, bare_ms = [], [], [], []
    for dtype in (None, torch.bfloat16):
        grid = medium.DensityGrid(scene.media, dtype=dtype)
        got = grid.lookup(pts)
        ref = medium.trilinear_lookup_plain(grid.grid, grid.aabb6, pts)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        print(f"kernel A ({dtype or 'f32'}): max abs err {err:.3e}, equal on "
              f"every point: {torch.equal(got, ref)}", flush=True)
        if not torch.equal(got, ref):
            raise AssertionError(f"trilinear_lookup differs from its plain "
                                 f"version: max abs err {err}")
        errs.append(err)
        bare = _a_bare(grid, pts, out)
        bare_ms.append(_cuda_ms(bare, 50))
        ms.append(_cuda_ms(lambda: grid.lookup(pts), 50))
        host = [_host_us(f, 50) for f in (bare, lambda: grid.lookup(pts))]
        plain_ms.append(_cuda_ms(
            lambda: medium.trilinear_lookup_plain(grid.grid, grid.aabb6, pts),
            20))
        table_ms = _cuda_ms(lambda: medium.cell_table(
            grid.grid, grid.cells.dtype), 20)
        print(f"kernel A ({dtype or 'f32'}) at N=1e6: bare launch "
              f"{bare_ms[-1]:.4f} ms (host {host[0]:.2f} us a call), through "
              f"the wrapper {ms[-1]:.4f} ms (host {host[1]:.2f} us a call), "
              f"plain {plain_ms[-1]:.4f} ms; cell table "
              f"{tuple(grid.cells.shape)} {grid.cells.dtype} "
              f"{grid.cells.numel() * grid.cells.element_size()} B built in "
              f"{table_ms:.4f} ms [{card}]", flush=True)
    # yardstick: one grid_sample call on the same points (trilinear,
    # align_corners=True puts the voxel centres on the AABB as kernel A
    # does; zeros padding fades to 0 over the voxel outside the AABB, where
    # kernel A returns 0)
    grid = medium.DensityGrid(scene.media)
    lo, hi = grid.aabb6[:3], grid.aabb6[3:]
    vol = grid.grid[None, None]
    coords = ((pts - lo) / (hi - lo) * 2.0 - 1.0).reshape(1, 1, 1, n, 3)
    def lib_a():
        return torch.nn.functional.grid_sample(
            vol, coords, mode="bilinear", padding_mode="zeros",
            align_corners=True)

    lib_a_ms = _cuda_ms(lib_a, 50)
    lib_a_host = _host_us(lib_a, 50)
    bound_a = _bound(n * 16 + grid.grid.numel() * 4, n * OPS_A_POINT)
    print(f"kernel A at N=1e6: through the wrapper {ms[0]:.4f} ms (bf16 "
          f"{ms[1]:.4f} ms), bare launch {bare_ms[0]:.4f} ms (bf16 "
          f"{bare_ms[1]:.4f} ms), plain {plain_ms[0]:.4f} ms, grid_sample "
          f"{lib_a_ms:.4f} ms (host {lib_a_host:.2f} us a call), bound "
          f"{bound_a[0]:.4f} ms ({bound_a[1]}) [{card}]", flush=True)
    results["trilinear_lookup"] = _kernel_row(
        "trilinear_lookup", "mitsubaer_tpu_torch/csrc/trilinear.cu",
        "mitsubaer_tpu/models/medium.py:118", max(errs), ms[0], plain_ms[0],
        bound_a, lib_a_ms)
    results["trilinear_lookup"]["bare_ms"] = bare_ms[0]
    del out

    # ---- phase 4: kernel B against its plain version, at res 64, at the
    # main path's pass shape (512^2, sppc 8), and at 100^2 (10,000 lanes,
    # not a multiple of the block) with and without a max_trips cut ----
    from dataclasses import replace

    regs_b = _registers(build_log, "boxwalk_kernel")
    blocks_b = boxwalk.blocks_per_sm()
    for res, sppc, cut in ((64, 8, None), (100, 4, None), (100, 4, 30),
                           (512, 8, None)):
        b_scene, b_cfg = presets.volumetric_box(
            res=res, spp=sppc, heterogeneous=True, density_res=64,
            max_depth=12, filter="box")
        params, table, beam_tab, shape = boxwalk.walk_inputs(
            b_scene.to(dev), b_cfg, sppc)
        if cut is not None:
            shape = replace(shape, max_trips=cut)
        seed = boxwalk.pass_seed(7, 0)
        out_k = boxwalk.walk(params, seed, table, beam_tab, shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = boxwalk.walk_plain(params, seed, table, beam_tab, shape)
        torch.cuda.synchronize()
        plain_b_ms = (time.perf_counter() - t0) * 1e3
        bad = _differ(out_k, out_p).any(0)
        st_k = boxwalk.fold(out_k, shape)[1].tolist()
        st_p = boxwalk.fold(out_p, shape)[1].tolist()
        b_err = (out_k - out_p).abs().max().item()
        what = f"res {res} sppc {sppc}" + (f" max_trips {cut}" if cut else "")
        print(f"kernel B at {what} ({shape.npix} lanes): every output row "
              f"equal on {shape.npix - int(bad.sum())} lanes; stats [segs, "
              f"taps, iters, unfinished] kernel {st_k} plain {st_p}; trips a "
              f"lane {_spread(out_k[sppc * 3 + 2])}", flush=True)
        if bool(bad.any()) or st_k != st_p:
            raise AssertionError(f"kernel B at {what} differs from its plain "
                                 f"version on {int(bad.sum())} lanes")
        if cut is None and st_k[3] != 0:
            raise AssertionError("boxwalk left samples unfinished")
        if res in (64, 512):
            def walk():
                return boxwalk.walk(params, seed, table, beam_tab, shape)

            b_ms = _cuda_ms(walk, 5)
            b_dev = _device_per_call(walk, 5, "boxwalk_kernel")[0]
            bytes_b = (out_k.numel() * 4 + table.numel() * 2
                       + beam_tab.numel() * 4 + params.numel() * 4)
            bound_b = _bound(bytes_b,
                             st_k[1] * OPS_B_TAP + st_k[0] * OPS_B_SEGMENT)
            print(f"kernel B at res {res} sppc 8: {b_ms:.4f} ms, device "
                  f"{b_dev:.4f} ms, plain {plain_b_ms:.1f} ms, bound "
                  f"{bound_b[0]:.4f} ms ({bound_b[1]}); {regs_b} registers, "
                  f"{blocks_b} blocks of 128 a multiprocessor [{card}]",
                  flush=True)
    results["boxwalk"] = _kernel_row(
        "boxwalk", "mitsubaer_tpu_torch/csrc/boxwalk.cu",
        "mitsubaer_tpu/integrators/boxwalk.py:153", b_err, b_ms, plain_b_ms,
        bound_b, None)
    results["boxwalk"].update(device_ms=b_dev, registers=regs_b,
                              blocks_per_sm=blocks_b)

    # ---- phase 5: the bounded-volume path ----
    medium.trilinear_lookup.launches = 0
    boxwalk.walk.launches = 0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=0, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"trilinear_lookup": medium.trilinear_lookup.launches,
                "boxwalk": boxwalk.walk.launches}
    n_pass = len(stats["passes"])
    segs = sum(p[0] for p in stats["passes"])
    mrays = segs / stats["boxwalk_s"] / 1e6
    mean = img.mean().item()
    print(f"main path: 512x512 spp 32 depth 12 in {n_pass} passes, wall "
          f"{wall:.3f} s, boxwalk {stats['boxwalk_s']:.3f} s, {segs} "
          f"segments, {mrays:.3f} Mrays/s, mean {mean:.6f}, launches "
          f"{launches} [{card}]", flush=True)
    if tuple(img.shape) != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render produced a non-finite or misshapen image")
    if not mean > 0:
        raise AssertionError("render produced a black image")
    if any(p[3] != 0 for p in stats["passes"]):
        raise AssertionError("render left samples unfinished")
    if launches["boxwalk"] < n_pass or launches["trilinear_lookup"] < n_pass + 4:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    for name, count in launches.items():
        results[name]["launches"] = count

    # the same render small, on the card and on the CPU (plain versions)
    c_scene, c_cfg = presets.volumetric_box(res=32, spp=8, heterogeneous=True,
                                            density_res=32, max_depth=6,
                                            filter="box")
    img_g = render_m.render(c_scene, c_cfg, seed=3, device=dev).cpu()
    img_c = render_m.render(c_scene, c_cfg, seed=3, device="cpu")
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c > 0
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    mean_rel = abs(img_g.mean().item() / img_c.mean().item() - 1)
    print(f"card vs CPU render at 32x32 spp 8: median pixel ratio "
          f"{ratio:.6f}, mean rel diff {mean_rel:.2e}", flush=True)
    if not (0.99 <= ratio <= 1.01 and mean_rel <= 0.01):
        raise AssertionError("card and CPU renders disagree")

    # ---- phase 6: kernels D and E against their plain versions, at the
    # eikonal bench's shapes ----
    rif = ek.RifField(ek.RIF_LINEAR, (1.3, 0.15, 0.0, 0.0))
    radial = ek.RifField(ek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0))
    sdf = ek.SdfField(ek.SDF_SPHERE, (0.0, 0.0, 0.0, 1.0))
    d_in, e_in = _er_inputs(rif, 18_432, 36_864, 11, dev)
    h_d, steps_d, h_e, steps_e = 1e-2, 256, 4e-2, 64
    regs_d = _registers(build_log, "er_trace_kernelILi1ELi1E")

    # kernel D, exact against its plain version for the bench's linear RIF
    # and a radial one, every output and the step count; per-lane trip
    # counts consistent with it; the row below reports the linear case
    for d_rif, d_in in ((radial, _er_inputs(radial, 18_432, 0, 12, dev)[0]),
                        (rif, d_in)):
        def call(d_in=d_in, d_rif=d_rif):
            return ermarch.trace(d_rif, sdf, *d_in[:3], h_d, steps_d,
                                 d_in[3])

        got = call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ermarch.trace_plain(d_rif, sdf, *d_in[:3], h_d, steps_d,
                                   d_in[3])
        torch.cuda.synchronize()
        plain_d_ms = (time.perf_counter() - t0) * 1e3
        launch, outs = _d_bare(d_rif, sdf, d_in, h_d, steps_d)
        launch()
        trips = outs[-1]
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        if bad or not all(torch.equal(a, b) for a, b in zip(outs[:-1], got)):
            raise AssertionError(f"kernel D ({d_rif.kind}) differs from its "
                                 f"plain version: outputs {bad}")
        if (int(trips.max()) != int(want[-1])
                or bool(trips[~d_in[3]].any()) or int(trips.min()) < 0):
            raise AssertionError("kernel D's per-lane trip counts disagree "
                                 "with its step count")
        err_d = max((a - b).abs().max().item()
                    for a, b in zip(got[:4], want[:4]))
        bare_d_ms = _cuda_ms(launch, 20)
        d_ms = _cuda_ms(call, 20)
        host_d = [_host_us(f, 20) for f in (launch, call)]
        dev_d, dev_all_d, ops_d = _device_per_call(call, 20,
                                                   "er_trace_kernel")
        # the chain floor: the lane with the most trips alone in a launch
        j = int(trips.argmax())
        one = [t[j:j + 1].contiguous() for t in d_in]
        floor_d = _device_per_call(lambda: call(one), 20,
                                   "er_trace_kernel")[0]
        n_d = d_in[0].shape[0]
        # in: p, v (24 B), distance (4 B), active (1 B); out: p, v (24 B),
        # opt, marched (8 B), trips (8 B), exited (1 B); the step count
        bound_d = _bound(n_d * 70 + 8,
                         int(trips.sum()) * OPS_D_STEP[d_rif.kind])
        kind = {1: "linear", 2: "radial"}[d_rif.kind]
        print(f"kernel D ({kind} RIF) at {n_d} lanes, h {h_d}, max_steps "
              f"{steps_d}: bare launch {bare_d_ms:.4f} ms (host "
              f"{host_d[0]:.2f} us a call), whole trace {d_ms:.4f} ms (host "
              f"{host_d[1]:.2f} us a call), device {dev_d:.4f} ms (all "
              f"device work {dev_all_d:.4f} ms in {ops_d:.1f} operations a "
              f"call), chain floor {floor_d:.4f} ms (lane {j}, "
              f"{int(trips[j])} trips), plain {plain_d_ms:.1f} ms, bound "
              f"{bound_d[0]:.5f} ms ({bound_d[1]}), steps {int(got[-1])}, "
              f"lane steps {int(trips.sum())}, trips a lane "
              f"{_spread(trips[d_in[3]])}, max abs err {err_d:.3e}: every "
              f"output equal; {regs_d} registers [{card}]", flush=True)
    results["er_trace"] = _kernel_row(
        "er_trace", "mitsubaer_tpu_torch/csrc/ermarch.cu",
        "mitsubaer_tpu/models/ermarch.py:122", err_d, d_ms, plain_d_ms,
        bound_d, None)
    results["er_trace"].update(bare_ms=bare_d_ms, device_ms=dev_d,
                               host_us=host_d[1], chain_floor_ms=floor_d,
                               registers=regs_d)
    del outs, launch

    # kernel E, exact against its plain version for the bench's linear RIF
    # and a radial one; the row below reports the linear case
    cases = [(radial, _er_inputs(radial, 0, 36_864, 12, dev)[1]),
             (rif, e_in)]
    for e_rif, e_in in cases:
        got = ermarch.sens_march(e_rif, sdf, *e_in[:5], h_e, steps_e,
                                 e_in[5])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ermarch.sens_march_plain(e_rif, sdf, *e_in[:5], h_e, steps_e,
                                        e_in[5])
        torch.cuda.synchronize()
        plain_e_ms = (time.perf_counter() - t0) * 1e3
        launch, outs = _e_bare(e_rif, sdf, e_in, h_e, steps_e)
        launch()
        trips = outs[-1]
        trips_plain = _plain_trips(want, e_in[5], h_e, steps_e)
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not torch.equal(a, b)]
        bad_trips = int((trips != trips_plain).sum())
        if bad or bad_trips or not all(
                torch.equal(a, b) for a, b in zip(outs[:-1], got)):
            raise AssertionError(f"kernel E ({e_rif.kind}) differs from its "
                                 f"plain version: outputs {bad}, trips on "
                                 f"{bad_trips} lanes")
        err_e = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(got[:6], want[:6]))
        bare_e_ms = _cuda_ms(launch, 20)

        def call():
            return ermarch.sens_march(e_rif, sdf, *e_in[:5], h_e, steps_e,
                                      e_in[5])

        e_ms = _cuda_ms(call, 20)
        host = [_host_us(f, 20) for f in (launch, call)]
        n_e = e_in[0].shape[0]
        # in: p1, v, p2 (12 B each), two 3x3 (36 B each), active (1 B); out:
        # p, v, two 3x3, opt, marched (4 B each), trips (8 B), crossed (1 B)
        bound_e = _bound(n_e * (109 + 113),
                         int(trips.sum()) * OPS_E_STEP[e_rif.kind])
        kind = {1: "linear", 2: "radial"}[e_rif.kind]
        print(f"kernel E ({kind} RIF) at {n_e} lanes, h {h_e}, max_steps "
              f"{steps_e}: bare launch {bare_e_ms:.4f} ms (host "
              f"{host[0]:.2f} us a call), whole sens_march {e_ms:.4f} ms "
              f"(host {host[1]:.2f} us a call), plain {plain_e_ms:.1f} ms, "
              f"bound {bound_e[0]:.5f} ms ({bound_e[1]}), steps "
              f"{int(got[-1])}, lane steps {int(trips.sum())}, crossed lanes "
              f"{int(got[6].sum())}, max abs err {err_e:.3e}: every output, "
              f"flag and per-lane trip count equal [{card}]", flush=True)
    results["er_sens"] = _kernel_row(
        "er_sens", "mitsubaer_tpu_torch/csrc/ermarch.cu",
        "mitsubaer_tpu/models/ermarch.py:194", err_e, e_ms, plain_e_ms,
        bound_e, None)
    results["er_sens"]["bare_ms"] = bare_e_ms
    del outs, launch

    # ---- phase 7: the eikonal path at full width ----
    er_scene, er_cfg = _er_bench_scene(presets, 96, 2, 256)
    ermarch.trace.launches = 0
    ermarch.sens_march.launches = 0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, d_calls = _trace_calls(lambda: render_m.render(
        er_scene, er_cfg, seed=1, device=dev, stats=stats))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"er_trace": ermarch.trace.launches,
                "er_sens": ermarch.sens_march.launches}
    mean = img.mean().item()
    print(f"eikonal path: 96x96 spp 2 depth 6, bounces "
          f"{[p_[0] for p_ in stats['passes']]}, wall {wall:.3f} s, "
          f"{96 * 96 * 2 / wall / 1e6:.6f} Msamples/s, mean {mean:.6f}, "
          f"launches {launches} [{card}]", flush=True)
    if tuple(img.shape) != (96, 96, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("ER render produced a non-finite or misshapen "
                             "image")
    if not mean > 0:
        raise AssertionError("ER render produced a black image")
    if min(launches.values()) < 1:
        raise AssertionError(f"eikonal path skipped a kernel: {launches}")
    for name, count in launches.items():
        results[name]["launches"] = count
    # kernel D's launches in that render: lanes, active lanes and trips a
    # lane, and its device time over all of them (replayed as bare
    # launches, which count nothing)
    bares, sizes, trips = [], [], []
    for c in d_calls:
        if c[2].shape[0]:
            bares.append(_d_bare(c[0], c[1], (c[2], c[3], c[4], c[7]), c[5],
                                 c[6]))
            bares[-1][0]()
            trips.append(bares[-1][1][-1][c[7]])
            sizes.append((c[2].shape[0], int(c[7].sum()),
                          int(trips[-1].max()) if trips[-1].numel() else 0))
    d_render = _device_per_call(lambda: [b[0]() for b in bares], 3,
                                "er_trace_kernel")[0] * len(bares)
    print(f"kernel D in the eikonal path: {len(bares)} launches (lanes, "
          f"active lanes, most trips) {sizes}; trips an active lane "
          f"{_spread(torch.cat(trips))}; device time over them "
          f"{d_render:.4f} ms [{card}]", flush=True)
    results["er_trace"]["render_device_ms"] = d_render
    del bares, d_calls

    # ---- phase 8: the eikonal render small, card against CPU ----
    s_scene, s_cfg = _er_bench_scene(presets, 24, 4, 128)
    img_g = render_m.render(s_scene, s_cfg, seed=3, device=dev).cpu()
    img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c > 0
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    mean_rel = abs(img_g.mean().item() / img_c.mean().item() - 1)
    print(f"card vs CPU eikonal render at 24x24 spp 4: median pixel ratio "
          f"{ratio:.6f}, mean rel diff {mean_rel:.2e}", flush=True)
    if not (0.98 <= ratio <= 1.02 and mean_rel <= 0.02):
        raise AssertionError("card and CPU eikonal renders disagree")

    _megatrack_phases(dev, card, results, build_log)
    _loop_phases(dev, card, results)

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _mega_synthetic(n):
    """The three cases of tests/test_megatrack.py at n lanes: (name, rows,
    ctr, density grid, max_trips)."""
    import numpy as np

    r = np.random.default_rng(0)

    def rows(o, d, tlim, maj, stm, stc, w_real, is_sh):
        z = np.zeros((n,), np.float32)
        return np.stack([
            o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], z, tlim,
            maj, stm, stc[:, 0], stc[:, 1], stc[:, 2], w_real[:, 0],
            w_real[:, 1], w_real[:, 2], np.full(n, is_sh, np.float32),
            np.ones(n, np.float32), z, z, z, z, z, z]).astype(np.float32)

    def full(v, k=None):
        return np.full((n,) if k is None else (n, k), v, np.float32)

    dirs = r.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x_dir = np.tile(np.float32([[1, 0, 0]]), (n, 1))
    ramp = np.zeros((8, 8, 16), np.float32)
    ramp[:] = np.linspace(0.0, 1.0, 16)[None, None, :]
    ctr = np.zeros((1, n), np.int32)
    return [
        ("zero density", rows(r.random((n, 3)).astype(np.float32) * 7, dirs,
                              (r.random(n) * 2 + 0.5).astype(np.float32),
                              full(4.0), full(1.0), full(1.0, 3),
                              full(1.0, 3), 0.0),
         ctr, np.zeros((8, 8, 8), np.float32), 64),
        ("constant density", rows(np.tile(np.float32([[0.5, 3.5, 3.5]]),
                                          (n, 1)), x_dir, full(4.0),
                                  full(1.0), full(2.0), full(2.0, 3),
                                  full(0.9, 3), 0.0),
         ctr, np.full((8, 8, 8), 0.5, np.float32), 64),
        ("shadow ramp", rows(np.tile(np.float32([[0.0, 3.5, 3.5]]), (n, 1)),
                             x_dir, full(15.0), full(1.5), full(1.5),
                             full(1.5, 3), full(1.0, 3), 1.0),
         ctr, ramp, 128),
    ]


def _compare_mega(name, got, want):
    """Kernel C against run_plain: every output row and the counter equal on
    every lane. Returns the largest absolute difference (0)."""
    (out_k, ctr_k), (out_p, ctr_p) = got, want
    bad = _differ(out_k, out_p).any(0) | (ctr_k != ctr_p)[0]
    if bool(bad.any()):
        raise AssertionError(f"kernel C {name}: outputs or counter differ on "
                             f"{int(bad.sum())} lanes")
    return (out_k - out_p).abs().max().item()


def _megatrack_phases(dev, card, results, build_log):
    """Phases 9-12: kernel C and the wavefront road."""
    import torch

    from mitsubaer_tpu_torch.integrators import boxwalk, megatrack, wavefront
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.scene import presets

    # ---- phase 9: kernel C against its plain version ----
    scene, cfg = presets.volumetric_box(res=512, spp=32, heterogeneous=True,
                                        density_res=64, max_depth=12,
                                        filter="box", emitter_kind="point")
    scene = scene.to(dev)
    # the arguments of the first three tracking calls of the render's first
    # pass, captured from the engine that render_wavefront drives
    run, calls = megatrack.run, []

    def capture(*args):
        if len(calls) < 3:
            calls.append(args)
        return run(*args)

    capture.launches = 0        # run() counts on whatever megatrack.run is
    megatrack.run = capture
    try:
        wavefront.render_wavefront(scene, cfg, 8, 0, 0)
    finally:
        megatrack.run = run
    if len(calls) < 3:
        raise AssertionError(f"the first pass made {len(calls)} tracking "
                             "calls, not 3")
    err = 0.0
    for i, args in enumerate(calls):
        valid = args[0][17] > 0.5
        n_need = int(valid.sum())
        got = megatrack.run(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = megatrack.run_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, _compare_mega(f"render call {i}", got, want))
        taps = int(got[0][6].sum().item())
        print(f"kernel C on render tracking call {i} (512^2, {n_need} lanes "
              f"with work, {taps} taps; taps a lane with work "
              f"{_spread(got[0][6][valid])}): every output equal to plain",
              flush=True)
        if i == 0:
            c_rows, c_ms_plain, c_taps, c_need = args, plain_ms, taps, n_need
    # edge cases on the first call's lanes: none or all with work, n not a
    # multiple of the lanes a block owns, one lane, lanes cut by max_trips
    rows0, ctr0 = c_rows[0], c_rows[1]
    rest = c_rows[2:]
    j = int(valid.nonzero()[0])             # call 2's first lane with work
    edges = [("all lanes without work", rows0.clone().index_fill_(
                  0, torch.tensor([17], device=dev), 0.0), ctr0, rest),
             ("all lanes with work", rows0.clone().index_fill_(
                  0, torch.tensor([17], device=dev), 1.0), ctr0, rest),
             ("n = 100,000", rows0[:, :100_000].contiguous(),
              ctr0[:, :100_000].contiguous(), rest),
             ("n = 1", calls[2][0][:, j:j + 1].contiguous(),
              calls[2][1][:, j:j + 1].contiguous(), rest),
             ("max_trips 2", rows0, ctr0, (rest[0], rest[1], 2, *rest[3:]))]
    for name, rows_e, ctr_e, rest_e in edges:
        args = (rows_e, ctr_e, *rest_e)
        got = megatrack.run(*args)
        err = max(err, _compare_mega(name, got, megatrack.run_plain(*args)))
        print(f"kernel C, {name} ({rows_e.shape[1]} lanes, "
              f"{int((rows_e[17] > 0.5).sum())} with work, "
              f"{int(got[0][6].sum().item())} taps, "
              f"{int(got[0][5].sum().item())} resolved): every output equal "
              "to plain", flush=True)
    for name, rows_np, ctr_np, grid, trips in _mega_synthetic(512 * 512):
        table, nb = megatrack.build_table(torch.from_numpy(grid).to(dev))
        nz, ny, nx = grid.shape
        args = (torch.from_numpy(rows_np).to(dev),
                torch.from_numpy(ctr_np).to(dev), table, 7, trips,
                (nx, ny, nz), nb)
        got = megatrack.run(*args)
        err = max(err, _compare_mega(name, got, megatrack.run_plain(*args)))
        print(f"kernel C on the {name} case (262144 lanes, max_trips "
              f"{trips}, {int(got[0][6].sum().item())} taps): equal to plain",
              flush=True)
    c_ms = _cuda_ms(lambda: megatrack.run(*c_rows), 20)
    c_dev = [_device_per_call(lambda: megatrack.run(*a), 20,
                              "megatrack_kernel")[0] for a in calls]
    regs_c = _registers(build_log, "megatrack_kernel")
    print(f"kernel C device time a call at the render's first three tracking "
          f"calls: {', '.join(f'{x:.4f}' for x in c_dev)} ms; {regs_c} "
          f"registers [{card}]", flush=True)
    n = c_rows[0].shape[1]
    # a lane with work reads 18 rows and its counter; one without reads its
    # valid flag, t and counter; each writes 8 rows and its counter
    out_b = megatrack.C_OUT * 4 + 4
    bytes_c = (c_need * (18 * 4 + 4 + out_b)
               + (n - c_need) * (2 * 4 + 4 + out_b) + c_rows[2].numel() * 2)
    bound_c = _bound(bytes_c, c_taps * OPS_C_TAP)
    print(f"kernel C at the render's first tracking call ({n} lanes, "
          f"{c_need} with work, {c_taps} taps, {bytes_c} B): {c_ms:.4f} ms, "
          f"plain {c_ms_plain:.1f} ms, bound "
          f"{bound_c[0]:.5f} ms ({bound_c[1]}), max abs err {err:.3e} "
          f"[{card}]", flush=True)
    results["megatrack"] = _kernel_row(
        "megatrack", "mitsubaer_tpu_torch/csrc/megatrack.cu",
        "mitsubaer_tpu/integrators/megatrack.py:94", err, c_ms, c_ms_plain,
        bound_c, None)
    results["megatrack"].update(device_ms=c_dev[0], registers=regs_c)
    del calls, c_rows

    # ---- phase 10: the wavefront path at full width ----
    megatrack.run.launches = 0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=0, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = megatrack.run.launches
    passes = stats["passes"]
    segs = sum(p_[0] for p_ in passes)
    mrays = segs / stats["wavefront_s"] / 1e6
    mean = img.mean().item()
    print(f"wavefront path: 512x512 spp 32 depth 12 point light in "
          f"{len(passes)} passes [segments, taps, super-iterations, "
          f"unfinished] {passes}, wall {wall:.3f} s, wavefront "
          f"{stats['wavefront_s']:.3f} s, {mrays:.3f} Mrays/s, mean "
          f"{mean:.6f}, kernel C launches {launches} [{card}]", flush=True)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all())):
        raise AssertionError("wavefront render produced a non-finite or "
                             "misshapen image")
    if not mean > 0:
        raise AssertionError("wavefront render produced a black image")
    if any(p_[3] != 0 for p_ in passes):
        raise AssertionError("wavefront render left samples unfinished")
    if launches < len(passes):
        raise AssertionError(f"wavefront path skipped kernel C: {launches}")
    results["megatrack"]["launches"] = launches

    # ---- phase 11: card against CPU ----
    s_scene, s_cfg = presets.volumetric_box(
        res=24, spp=8, heterogeneous=True, density_res=32, max_depth=4,
        filter="box", emitter_kind="point")
    img_g = render_m.render(s_scene, s_cfg, seed=3, device=dev).cpu()
    img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c > 0
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    mean_rel = abs(img_g.mean().item() / img_c.mean().item() - 1)
    print(f"card vs CPU wavefront render at 24x24 spp 8: median pixel ratio "
          f"{ratio:.6f}, mean rel diff {mean_rel:.2e}", flush=True)
    if not (0.99 <= ratio <= 1.01 and mean_rel <= 0.01):
        raise AssertionError("card and CPU wavefront renders disagree")

    # ---- phase 12: wavefront against boxwalk on the beam scene ----
    from dataclasses import replace

    b_scene, b_cfg = presets.volumetric_box(
        res=512, spp=8, heterogeneous=True, density_res=64, max_depth=12,
        filter="box")
    b_scene = b_scene.to(dev)
    b_cfg = replace(b_cfg, wf_mini_passes=2)
    for seed in (5, 6):                     # two seeds: does the gap move?
        out = {}
        for road in ("wavefront", "boxwalk"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if road == "wavefront":
                L, st_ = wavefront.render_wavefront(b_scene, b_cfg, 8, seed,
                                                    0, has_direct=False)
            else:
                L, st_ = boxwalk.render_boxwalk(b_scene, b_cfg, 8, seed, 0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            st_ = st_.tolist()
            out[road] = L.mean(-1)
            print(f"beam scene 512x512 sppc 8 seed {seed} on {road}: "
                  f"[segments, taps, iters, unfinished] {st_}, {secs:.3f} s, "
                  f"{st_[0] / secs / 1e6:.3f} Mrays/s, mean "
                  f"{L.mean().item() / 8:.6f} [{card}]", flush=True)
            if st_[3] != 0:
                raise AssertionError(f"{road} left samples unfinished")
        both = (out["wavefront"] > 0) & (out["boxwalk"] > 0)
        ratio = (out["wavefront"][both] / out["boxwalk"][both]).median().item()
        mean_ratio = (out["wavefront"].mean() / out["boxwalk"].mean()).item()
        print(f"beam scene seed {seed} wavefront / boxwalk: pixel-by-pixel "
              f"median ratio {ratio:.6f} over {int(both.sum())} pixels, mean "
              f"ratio {mean_ratio:.6f}", flush=True)
        if not 0.95 <= ratio <= 1.05:
            raise AssertionError("wavefront and boxwalk disagree on the beam "
                                 "scene")


def _loop_phases(dev, card, results):
    """Phases 13-15: the loop road (volpath.li through kernel A)."""
    import torch

    from mitsubaer_tpu_torch.integrators import boxwalk
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    # ---- phase 13: the loop road at full width ----
    scene, cfg = presets.volumetric_box(res=512, spp=32, heterogeneous=True,
                                        density_res=64, max_depth=12)
    scene = scene.to(dev)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    medium.trilinear_lookup.launches = 0
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=0, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = medium.trilinear_lookup.launches
    peak = torch.cuda.max_memory_allocated(dev)
    mean = img.mean().item()
    print(f"loop path: 512x512 spp 32 depth 12 gaussian filter in "
          f"{len(stats['passes'])} passes [bounces, Woodcock iterations] "
          f"{stats['passes']}, wall {wall:.3f} s, loop passes "
          f"{stats['loop_s']:.3f} s, kernel A launches {launches}, peak "
          f"device memory {peak / 2**30:.3f} GiB, mean {mean:.6f} [{card}]",
          flush=True)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all())):
        raise AssertionError("loop render produced a non-finite or "
                             "misshapen image")
    if not mean > 0:
        raise AssertionError("loop render produced a black image")
    if launches < len(stats["passes"]):
        raise AssertionError(f"loop path skipped kernel A: {launches}")
    results["trilinear_lookup"]["launches_loop"] = launches
    results["trilinear_lookup"]["loop_shapes"] = _loop_lookups(
        scene, cfg, dev, card)

    # ---- phase 14: card against CPU ----
    s_scene, s_cfg = presets.volumetric_box(res=24, spp=4, heterogeneous=True,
                                            density_res=64, max_depth=12)
    img_g = render_m.render(s_scene, s_cfg, seed=3, device=dev).cpu()
    img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c > 0
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    mean_rel = abs(img_g.mean().item() / img_c.mean().item() - 1)
    print(f"card vs CPU loop render at 24x24 spp 4: median pixel ratio "
          f"{ratio:.6f}, mean rel diff {mean_rel:.2e}", flush=True)
    if not (0.98 <= ratio <= 1.02 and mean_rel <= 0.02):
        raise AssertionError("card and CPU loop renders disagree")

    # ---- phase 15: the loop engine against boxwalk on the beam scene ----
    from dataclasses import replace

    b_cfg = replace(cfg, spp=8, filter="box", engine="loop")
    seed = 5
    out = {}
    for road in ("loop", "boxwalk"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if road == "loop":
            accum, st_ = render_m.render_pass(
                scene, torch.zeros((512, 512, 4), device=dev), b_cfg, 8,
                seed, 0)
            L = accum[..., :3] / accum[..., 3:]
        else:
            L, st_ = boxwalk.render_boxwalk(scene, b_cfg, 8, seed, 0)
            L, st_ = (L / 8).reshape(512, 512, 3), st_.tolist()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[road] = L.mean(-1).flatten()
        print(f"beam scene 512x512 sppc 8 seed {seed} on {road}: {st_}, "
              f"{secs:.3f} s, mean {L.mean().item():.6f} [{card}]",
              flush=True)
    both = (out["loop"] > 0) & (out["boxwalk"] > 0)
    ratio = (out["loop"][both] / out["boxwalk"][both]).median().item()
    print(f"beam scene seed {seed} loop / boxwalk: pixel-by-pixel median "
          f"ratio {ratio:.6f} over {int(both.sum())} pixels, mean ratio "
          f"{(out['loop'].mean() / out['boxwalk'].mean()).item():.6f}",
          flush=True)
    if not 0.95 <= ratio <= 1.05:
        raise AssertionError("the loop engine and boxwalk disagree on the "
                             "beam scene")


def _loop_lookups(scene, cfg, dev, card):
    """Kernel A at the point counts the loop road gives it: the first pass
    of phase 13's render again (same seed, same lanes) with the lookups
    captured. Every captured output, as the pass received it, must equal
    the plain version on the same inputs; the kernel's grid must be f32.
    Returns per point count its calls in the pass, the calls checked, and
    the times through the wrapper and of the plain version with the bound.
    These launches come after phase 13's count was read."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import film, medium

    lookup, calls = medium.DensityGrid.lookup, {}

    def capture(self, p):
        out = lookup(self, p)
        seen = calls.setdefault(p.shape[0], [0, []])
        if seen[0] in (0, 4, 16, 64, 256, 1024):
            seen[1].append((self, p.clone(), out.clone()))
        seen[0] += 1
        return out

    sppc = render_m._spp_per_pass(cfg)
    medium.DensityGrid.lookup = capture
    try:
        render_m.render_pass(scene, film.new_accumulator(cfg, dev), cfg,
                             sppc, 0, 0)
    finally:
        medium.DensityGrid.lookup = lookup
    lanes = sppc * cfg.height * cfg.width
    if lanes not in calls or 2 * lanes not in calls:
        raise AssertionError(f"the loop pass looked up no {lanes} or "
                             f"{2 * lanes} points: {sorted(calls)}")
    rows = []
    for n in sorted(calls):
        count, taken = calls[n]
        for grid, p, out in taken:
            if grid.cells.dtype != torch.float32:
                raise AssertionError(f"the loop road's grid is "
                                     f"{grid.cells.dtype}, not f32")
            ref = medium.trilinear_lookup_plain(grid.grid, grid.aabb6, p)
            if not torch.equal(out, ref):
                err = (out - ref).abs().max().item()
                raise AssertionError(f"kernel A differs from its plain "
                                     f"version in the loop pass at {n} "
                                     f"points: max abs err {err}")
        if n == 0:
            continue
        grid, p, _ = taken[0]
        ms = _cuda_ms(lambda g=grid, q=p: g.lookup(q), 20)
        plain_ms = _cuda_ms(lambda g=grid, q=p: medium.trilinear_lookup_plain(
            g.grid, g.aabb6, q), 10)
        bound = _bound(n * 16 + grid.grid.numel() * 4, n * OPS_A_POINT)
        print(f"kernel A in the loop pass at {n} points: {count} calls, "
              f"{len(taken)} captured and equal to the plain version on "
              f"every point; {ms:.4f} ms through the wrapper, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) "
              f"[{card}]", flush=True)
        rows.append(dict(n=n, calls=count, checked=len(taken), equal=True,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1]))
    return rows


def _er_bench_scene(presets, res, spp, max_steps):
    """bench.py::bench_er_forward's configuration at res^2 and spp."""
    from dataclasses import replace

    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, max_depth=6, rif_kind=1, rif_params=(1.3, 0.15),
        er_stepsize=1e-2, filter="box")
    return scene, replace(cfg, er_maxsteps=max_steps, bvp_restarts=8,
                          er_bvp_hscale=4.0)


if __name__ == "__main__":
    sys.exit(main())
