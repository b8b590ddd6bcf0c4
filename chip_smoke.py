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
     pixel-by-pixel median ratio within 0.95-1.05;
 16. kernel A' (the grid gradient of kernel A's lookups) against its plain
     version on A_BWD_CASES: 2^20 points on the 64^3 grid spread uniformly
     and in a dense cluster, and the adversarial sets (one cell, cell and
     AABB faces, outside, zero and NaN output gradients, the grids
     (1, 5, 6), (5, 1, 1) and (1, 1, 1), N of 0, 1, 31, 33, 257 and
     200,000, a warp alternating between two cells), each within
     A_BWD_TOL of the largest voxel (float atomics add in a varying order)
     with the same NaN voxels, and within A_BWD_TOL["float64"] of the
     float64 sums of the same terms (the plain version's distance from
     them printed beside); gradcheck of TrilinearLookup in float64 on the
     CPU;
     at the spread and clustered points its time through the wrapper and
     as a bare launch, the plain version's, grid_sample's backward and the
     bound;
 17. the training path at full width: render_diff of the 512^2 beam scene
     (sppc 4, depth 12, density 64^3, beam NEE) at sigma_s x 1.5 as the
     target, then 3 Adam steps (lr 5e-2) of loss_and_grad from the
     preset's parameters; the loss and every gradient finite, each
     gradient non-zero, kernels A and A' launched, one cell table a render
     built from the detached grid; each step's wall, peak device memory,
     launches of A and A', bounces and Woodcock iterations, and how far
     sigma_s moved. One more step with kernel A''s calls captured (calls
     0, 4, 16, 64, 256 of each point count, and its busiest): each result
     within A_BWD_TOL["step"] of its largest voxel from the plain version
     on the same points and output gradients and within
     A_BWD_TOL["float64"] of the float64 sums; A' timed at each count's
     first call, through the wrapper and bare. Then
     tests/test_inverse.py's sigma_s recovery on the card, 3 steps:
     sigma_s must move toward its target;
 18. loss_and_grad at 16^2, density 16^3, depth 4, sppc 4 on the card and
     on the CPU: the loss within rtol 1e-4, each gradient field within
     GRAD_CARD_CPU_TOL of its largest CPU magnitude;
 19. the eikonal training path at full width: bench.py::bench_er_grad's
     configuration (radial RIF, 32^2 spp 2, 2,048 lanes, depth 4, h 1e-2,
     er_maxsteps 192, 8 BVP restarts), the gradient of mean(sink) of
     volpath_er.li(differentiable=True) with respect to rif_params, twice
     (seeds 0 and 1): finite, p0, a and w non-zero, kernel E launched (in
     the detached BVP solves) and kernel D not; each call's wall, fwd+bwd
     samples/s, peak device memory and the launches; the central
     difference of the loss along rif_params (eps 1e-3, common random
     numbers, the gradient's solved BVP connections held) against the
     gradient at test_inverse.py's tolerance. Kernel
     E's calls in the first run are captured (calls 0, 4, 16 and 64 of
     each lane count, and its busiest): every output equal to its plain
     version on the same inputs, and E timed at the busiest;
 20. the spline RIF's voxel gradient: test_inverse.py's scene (a Gaussian
     index bump, sphere SDF, point light, h 0.05, er_maxsteps 96, depth 4)
     with a 32^3 grid at 64^2 sppc 2, twice: finite, non-zero, more than
     0.3 of its mass on the interior voxels, no kernel launched; the same
     measures as phase 19. Then at test_inverse.py's own size (12^3, 8^2,
     sppc 4, seed 3) its directional finite-difference check, the
     connections held as in phase 19;
 21. phase 19's configuration at 8^2 sppc 2, and phase 20's gradient at
     test_inverse.py's size, on the card and on the CPU at the card's
     solved BVP connections: the loss and each gradient within
     ER_CARD_CPU_TOL.
Prints one JSON line of per-kernel results (time, bound, plain version,
library yardstick, launches on the main paths; for A also its launches on
the loop road and its checks and times at the loop road's point counts,
and its launches in a training step; for B, C and D also the device time
and registers; for A' its bare-launch and clustered times and its checks
and times at the training step's point counts; for E its launches in an eikonal
gradient, its checks and times at that gradient's calls, and the walls of
phases 19 and 20), then the contract line
{"ok": true, "device": {...}} last.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types

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
# kernel A' per point that adds, from trilinear_backward_kernel: kernel A's cell
# arithmetic (20 an axis: conversions, the spacing, the position, the
# inside tests, clamps, floor and fraction), the zero test, the upper corner
# indices 6, the weight products with their one-minus terms 21, the
# addresses 24 and the 8 atomic adds
OPS_A_BWD_POINT = 120
# phases 16 and 17: kernel A' against its plain version, max |diff| over the
# largest voxel. Both sum in float32 in a varying order (atomics,
# index_add_): the spread points' voxels take ~32 terms each; the clustered
# sets' voxels thousands (one cell, two alternating cells, the grids of 1 to
# 30 voxels) to ~300,000 (the cluster's 27); a training step's calls spread
# as the uniform points (measured on an H100: at most 2.1e-8). On the
# clustered sets the plain version's own sums lie up to 7.3e-6 from the
# float64 sums of the same terms (the kernel's at most 5.9e-7; on an H100),
# so the kernel is also held within "float64" of those sums on every set.
A_BWD_TOL = {"uniform": 1e-5, "clustered": 1e-4, "step": 1e-5,
             "float64": 1e-5}
# phase 18: card against CPU, each gradient field's largest difference over
# its largest CPU magnitude: ulp-level exp/log differences and the atomics'
# order (measured on an H100: at most 1.6e-6, no collision test flipped)
GRAD_CARD_CPU_TOL = 1e-4
# phases 17 and 18: the parameters the loop road reads (not `rif`, which
# only the eikonal road reads)
LOOP_FIELDS = ("sigma_a", "sigma_s", "density", "g")
# phase 21: the eikonal gradients, card against CPU at 8x8 at the card's
# solved BVP connections: the loss within ER_CARD_CPU_TOL[0] relative,
# each gradient within ER_CARD_CPU_TOL[1] of its largest CPU magnitude, as
# phase 18 holds the loop road (measured on an H100: the loss within
# 4.95e-7, the gradients within 8.8e-7 radial and 4.6e-6 spline)
ER_CARD_CPU_TOL = (1e-4, 1e-4)
# phases 19 and 20: tests/test_inverse.py's finite-difference tolerance
ER_FD_RTOL, ER_FD_ATOL = 0.5, 5e-3


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


def _a_bwd_bound(shape, grad_out):
    """Kernel A''s bound on one call's data: each output gradient read (4
    B), the position of each point whose gradient is not zero (12 B: a
    point with a zero gradient adds nothing, and only a non-zero one needs
    its position to tell whether it lies inside), the grid written once,
    and OPS_A_BWD_POINT for each point with a non-zero gradient."""
    import torch

    adding = int(torch.count_nonzero(grad_out))            # NaN adds too
    voxels = shape[0] * shape[1] * shape[2]
    return _bound(4 * grad_out.shape[0] + 12 * adding + 4 * voxels,
                  adding * OPS_A_BWD_POINT)


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


def _a_bwd_bare(shape, aabb6, p, grad_out, grad):
    """One bare launch of kernel A' into `grad`: the C call alone, with its
    arguments formed once (no checks, no allocation, not counted)."""
    from mitsubaer_tpu_torch import kernels

    nz, ny, nx = shape
    args = (p.data_ptr(), grad_out.data_ptr(), aabb6.data_ptr(),
            grad.data_ptr(), p.shape[0], nx, ny, nz, kernels.stream(p))
    fn = kernels.library().mk_trilinear_lookup_backward
    return lambda: fn(*args)


# kernel A''s sets: the 2^20 spread and clustered points of phase 16, then
# the adversarial ones (tests/test_torch_medium_grad.py runs each too)
A_BWD_CASES = ("uniform", "clustered", "one_cell", "faces", "outside",
               "zero_and_nan", "grid_1x5x6", "grid_5x1x1", "grid_1x1x1",
               "n0", "n1", "n31", "n33", "n257", "n200000", "alternating")


def _a_bwd_faces(r, n, shape):
    """n points on the cells' faces of a grid of `shape` over [-1, 1]^3,
    drawn from the numpy generator r: each coordinate on a voxel plane (on
    a one-voxel axis the AABB's lower face, the only place inside there), a
    third of them with one axis free."""
    import numpy as np

    res = np.asarray(shape[::-1])                    # (x, y, z)
    p = -1.0 + r.integers(0, res, (n, 3)) * (2.0 / np.maximum(res - 1, 1))
    free = r.integers(0, 3, n // 3)
    p[np.arange(n // 3), free] = r.uniform(-1.0, 1.0, n // 3)
    return p


def _a_bwd_case(name, dev):
    """(shape, aabb6, p, grad_out, A_BWD_TOL key) of kernel A''s set `name`
    on the [-1, 1]^3 AABB, made with numpy from a seed of the name:
    uniform / clustered: phase 16's 2^20 points spread over the 64^3 grid
    or in a ball across 8 cells (27 voxels); one_cell: 4,096 points in one
    cell; faces: points on the cells' faces (a third with one axis free)
    and on the AABB's; outside: half of them just or far outside the AABB;
    zero_and_nan: 30% of the output gradients 0 and 20 NaN; grid_*: the
    flat and one-voxel grids, most points on the lower face of each
    one-voxel axis (the only place inside there); nK: K spread points;
    alternating: a warp's lanes alternate between two adjacent cells."""
    import numpy as np
    import torch

    if name not in A_BWD_CASES:
        raise ValueError(f"no set of kernel A' named {name!r}")
    aabb6 = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], device=dev)

    def tensors(shape, p, g, tol):
        return (shape, aabb6, torch.from_numpy(p.astype(np.float32)).to(dev),
                torch.from_numpy(g.astype(np.float32)).to(dev), tol)

    if name in ("uniform", "clustered"):
        n = 1 << 20
        r = np.random.default_rng(16)
        g = r.normal(size=n)
        p = r.uniform(-1.0, 1.0, (n, 3))
        if name == "clustered":
            p = np.asarray([0.1, -0.2, 0.3]) + r.uniform(-0.02, 0.02, (n, 3))
        return tensors((64, 64, 64), p, g, name)
    r = np.random.default_rng(sum(ord(c) * 31 ** i
                                  for i, c in enumerate(name)) % 2 ** 32)
    shape, n, tol = (64, 64, 64), 200_000, "uniform"
    if name.startswith("grid_"):
        shape = tuple(int(k) for k in name[5:].split("x"))
        tol = "clustered"           # 1 to 30 voxels: ~3,000-80,000 terms each
    elif name[0] == "n":
        n = int(name[1:])
    h = 2.0 / 63
    p = r.uniform(-1.2, 1.2, (n, 3))                 # in and around
    k = n // 5
    if name == "one_cell":
        n = 4096
        p = -1.0 + (np.asarray([40, 25, 33]) + r.uniform(0, 1, (n, 3))) * h
        tol = "clustered"
    elif name == "faces":
        p = _a_bwd_faces(r, n, shape)
        p[:k, r.integers(0, 3)] = r.choice([-1.0, 1.0], k)
    elif name == "alternating":
        lane = np.arange(n)[:, None]
        p = -1.0 + (np.asarray([20, 30, 40]) + (lane % 2) * [1, 0, 0]
                    + r.uniform(0, 1, (n, 3))) * h
        tol = "clustered"
    else:
        p[:k, r.integers(0, 3)] = r.choice([-1.0, 1.0], k)   # on the faces
        p[k:2 * k] = r.choice([-1.0, 1.0], (k, 3))            # corners
    if name == "outside":
        axis = r.integers(0, 3, n // 2)
        p[np.arange(n // 2), axis] = r.choice([-1.0, 1.0], n // 2) * (
            1.0 + r.choice([1e-6, 1e-3, 0.5], n // 2))
    if name[0] == "n" and n:
        p[0] = r.uniform(-0.9, 0.9, 3)               # one point inside
    for a, res in enumerate(shape[::-1]):            # (x, y, z)
        if res == 1:
            p[r.uniform(size=n) < 0.7, a] = -1.0
    g = r.normal(size=n)
    if name == "zero_and_nan":
        g[r.uniform(size=n) < 0.3] = 0.0
        g[r.choice(n, 20, replace=False)] = np.nan
    return tensors(shape, p, g, tol)


def _a_bwd_rel64(results, exact):
    """max |x - exact| / max |exact| of each of `results` over the voxels
    where the float64 sums `exact` are finite (0 where those are all 0)."""
    fin = exact.isfinite()
    exact = exact[fin]
    scale = exact.abs().max().item() if exact.numel() else 0.0
    if scale == 0.0:
        return [0.0] * len(results)
    return [((x[fin].double() - exact).abs().max() / scale).item()
            for x in results]


def _a_bwd_check(got, want, tol, what, exact=None):
    """max |got - want| / max |want| over the voxels where want is finite;
    raises if it exceeds tol, if the NaN voxels differ, or if got is not
    zero where want is zero everywhere. Given the float64 sums `exact` of
    the same terms, also raises if got lies further than
    A_BWD_TOL["float64"] from them (_a_bwd_rel64). Returns the ratio and
    got's and want's _a_bwd_rel64 (None without `exact`)."""
    rel64 = None if exact is None else _a_bwd_rel64((got, want), exact)
    if rel64 is not None and not rel64[0] <= A_BWD_TOL["float64"]:
        raise AssertionError(f"kernel A' ({what}) differs from the float64 "
                             f"sums: max |diff| / max |grad| {rel64[0]}")
    nan = want.isnan()
    if not (got.shape == want.shape and (got.isnan() == nan).all()):
        raise AssertionError(f"kernel A' ({what}): the NaN voxels differ "
                             f"from the plain version's")
    got, want = got[~nan], want[~nan]
    scale = want.abs().max().item() if want.numel() else 0.0
    err = (got - want).abs().max().item() if want.numel() else 0.0
    if scale == 0.0:
        if err != 0.0:
            raise AssertionError(f"kernel A' ({what}): {err} where the plain "
                                 f"version is zero")
        return 0.0, rel64
    if not err <= tol * scale:
        raise AssertionError(f"kernel A' ({what}) differs from its plain "
                             f"version: max |diff| / max |grad| "
                             f"{err / scale}")
    return err / scale, rel64


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
    _training_phases(dev, card, results)
    _er_grad_phases(dev, card, results)

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


def _training_phases(dev, card, results):
    """Phases 16-18: kernel A' and the training path (diff.render)."""
    import numpy as np
    import torch

    from mitsubaer_tpu_torch.diff import render as diff_m
    from mitsubaer_tpu_torch.integrators import volpath
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    # ---- phase 16: kernel A' against its plain version ----
    scene, cfg = presets.volumetric_box(res=512, spp=4, heterogeneous=True,
                                        density_res=64, max_depth=12)
    scene = scene.to(dev)
    grid = medium.DensityGrid(scene.media)
    err, t = 0.0, {}
    for name in A_BWD_CASES:
        shape, aabb6, p, grad_out, tol = _a_bwd_case(name, dev)
        got = medium.trilinear_lookup_backward(shape, aabb6, p, grad_out)
        want = medium.trilinear_lookup_backward_plain(shape, aabb6, p,
                                                      grad_out)
        # the same float32 weights, summed in float64
        exact = medium.trilinear_lookup_backward_plain(shape, aabb6, p,
                                                       grad_out.double())
        torch.cuda.synchronize()
        rel, rel64 = _a_bwd_check(got, want, A_BWD_TOL[tol], name, exact)
        fin = want.isfinite()
        if fin.any():
            err = max(err, (got - want)[fin].abs().max().item())
        print(f"kernel A' ({name}, N={p.shape[0]}, {shape}): max |diff| / "
              f"max |grad| {rel:.3e} (tolerance {A_BWD_TOL[tol]:.0e}); "
              f"against the float64 sums: kernel {rel64[0]:.3e} (tolerance "
              f"{A_BWD_TOL['float64']:.0e}), plain {rel64[1]:.3e}; "
              f"{int((want != 0).sum())} voxels non-zero, "
              f"{int(want.isnan().sum())} NaN", flush=True)
        if name not in ("uniform", "clustered"):
            continue
        n = p.shape[0]
        t[name] = dict(
            bound=_a_bwd_bound(shape, grad_out),
            ms=_cuda_ms(lambda: medium.trilinear_lookup_backward(
                shape, aabb6, p, grad_out), 50),
            bare_ms=_cuda_ms(_a_bwd_bare(shape, aabb6, p, grad_out,
                                         torch.zeros(shape, device=dev)), 50),
            plain_ms=_cuda_ms(lambda: medium.trilinear_lookup_backward_plain(
                shape, aabb6, p, grad_out), 10))
        # yardstick: grid_sample's backward to the volume (trilinear,
        # align_corners=True: the voxel centres on the AABB, as A)
        vol = grid.grid[None, None].clone().requires_grad_()
        lo, hi = aabb6[:3], aabb6[3:]
        coords = ((p - lo) / (hi - lo) * 2.0 - 1.0).reshape(1, 1, 1, n, 3)
        out = torch.nn.functional.grid_sample(
            vol, coords, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        g_view = grad_out.reshape(out.shape)
        t[name]["library_ms"] = _cuda_ms(lambda: torch.autograd.grad(
            out, vol, g_view, retain_graph=True), 50)
        del out, vol, coords
        print(f"kernel A' ({name}): through the wrapper "
              f"{t[name]['ms']:.4f} ms (zeroing included), bare launch "
              f"{t[name]['bare_ms']:.4f} ms, plain {t[name]['plain_ms']:.4f} "
              f"ms, grid_sample backward {t[name]['library_ms']:.4f} ms "
              f"[{card}]", flush=True)
    u, c = t["uniform"], t["clustered"]
    bound = u["bound"]
    print(f"kernel A' at N=2^20 on 64^3: uniform {u['ms']:.4f} ms, "
          f"clustered {c['ms']:.4f} ms ({c['ms'] / u['ms']:.2f}x uniform), "
          f"bound {bound[0]:.4f} ms ({bound[1]}; uniform at "
          f"{u['ms'] / bound[0]:.1f}x it, clustered at "
          f"{c['ms'] / c['bound'][0]:.1f}x its {c['bound'][0]:.4f} ms) "
          f"[{card}]", flush=True)
    results["trilinear_lookup_backward"] = _kernel_row(
        "trilinear_lookup_backward", "mitsubaer_tpu_torch/csrc/trilinear.cu",
        "mitsubaer_tpu/models/medium.py:206", err, u["ms"], u["plain_ms"],
        bound, u["library_ms"])
    results["trilinear_lookup_backward"].update(
        bare_ms=u["bare_ms"], ms_clustered=c["ms"],
        bare_ms_clustered=c["bare_ms"], plain_ms_clustered=c["plain_ms"],
        library_ms_clustered=c["library_ms"],
        bound_ms_clustered=c["bound"][0], sets_checked=len(A_BWD_CASES))
    g64 = torch.rand((4, 5, 6), dtype=torch.float64, requires_grad=True)
    p64 = torch.rand((64, 3), dtype=torch.float64) * 2.4 - 1.2
    a64 = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], dtype=torch.float64)
    if not torch.autograd.gradcheck(
            lambda g: medium.TrilinearLookup.apply(g, None, a64, p64), (g64,)):
        raise AssertionError("TrilinearLookup fails gradcheck")
    print("TrilinearLookup gradcheck (float64, CPU plain versions): passed",
          flush=True)

    # ---- phase 17: the training path at full width ----
    li, counts = volpath.li, []

    def counting_li(*a, **k):
        out = li(*a, **k)
        counts.append(out[2])
        return out

    cell_table, tables = medium.cell_table, []

    def counting_table(g, *a):
        tables.append(g.requires_grad)
        return cell_table(g, *a)

    sppc, target_seed, seed = 4, 123, 7
    params = diff_m.get_params(scene)
    volpath.li, medium.cell_table = counting_li, counting_table
    try:
        with torch.no_grad():
            target = diff_m.render_diff(
                scene, params._replace(sigma_s=params.sigma_s * 1.5), cfg,
                sppc, target_seed, 0, device=dev)
        leaves = diff_m.MediumParams(*(t.detach().clone().requires_grad_()
                                       for t in params))
        opt = torch.optim.Adam(leaves, lr=5e-2)
        steps = []
        for i in range(3):
            counts.clear()
            tables.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            medium.trilinear_lookup.launches = 0
            medium.trilinear_lookup_backward.launches = 0
            t0 = time.perf_counter()
            loss, grads = diff_m.loss_and_grad(scene, leaves, cfg, sppc, seed,
                                               i, target, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = (medium.trilinear_lookup.launches,
                        medium.trilinear_lookup_backward.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            for leaf, g in zip(leaves, grads):
                leaf.grad = g
            opt.step()
            mags = {f: getattr(grads, f).abs().max().item()
                    for f in LOOP_FIELDS}
            steps.append(dict(wall=wall, peak=peak, launches=launches,
                              counts=counts[0], loss=loss.item()))
            print(f"training step {i}: {cfg.width}x{cfg.height} sppc {sppc} "
                  f"({cfg.width * cfg.height * sppc} lanes), loss {loss.item():.6e}, wall {wall:.3f} s, peak "
                  f"device memory {peak / 2**30:.3f} GiB, launches A "
                  f"{launches[0]} A' {launches[1]}, [bounces, Woodcock "
                  f"iterations] {counts[0]}, max |grad| {mags}, sigma_s now "
                  f"{leaves.sigma_s.detach().cpu().tolist()} [{card}]",
                  flush=True)
            if not (np.isfinite(loss.item()) and all(
                    bool(torch.isfinite(g).all()) for g in grads)):
                raise AssertionError(f"training step {i}: non-finite loss "
                                     f"or gradient")
            if not all(v > 0 for v in mags.values()):
                raise AssertionError(f"training step {i}: a zero gradient "
                                     f"{mags}")
            if launches[0] == 0 or launches[1] == 0:
                raise AssertionError(f"training step {i} skipped a kernel: "
                                     f"{launches}")
            if tables != [False]:
                raise AssertionError(f"training step {i} built cell tables "
                                     f"{tables} (want one, detached)")
    finally:
        volpath.li, medium.cell_table = li, cell_table
    moved = (leaves.sigma_s.detach() - params.sigma_s).flatten().tolist()
    wanted = (0.5 * params.sigma_s).flatten().tolist()
    print(f"training: sigma_s moved by {moved}, the target is {wanted} away "
          f"(per channel; reported, not held: the sign of this scene's "
          f"sigma_s gradient at sppc 4 varies from pass to pass, PERF.md), "
          f"losses "
          f"{[s_['loss'] for s_ in steps]} [{card}]", flush=True)
    results["trilinear_lookup_backward"]["train_shapes"] = _train_backward(
        scene, leaves, cfg, sppc, seed, target, dev, card)
    _recovery(dev, card)
    results["trilinear_lookup_backward"]["launches"] = steps[0]["launches"][1]
    results["trilinear_lookup"]["launches_train"] = steps[0]["launches"][0]
    results["trilinear_lookup_backward"]["train_steps"] = [
        dict(wall_s=s_["wall"], peak_gib=s_["peak"] / 2**30,
             launches_a=s_["launches"][0], launches_a_bwd=s_["launches"][1],
             bounces_woodcock=s_["counts"]) for s_ in steps]

    # ---- phase 18: card against CPU ----
    s_scene, s_cfg = presets.volumetric_box(res=16, spp=4, heterogeneous=True,
                                            density_res=16, max_depth=4)
    s_params = diff_m.get_params(s_scene)
    s_target = np.full((16, 16, 3), 0.05, np.float32)
    loss_g, grad_g = diff_m.loss_and_grad(s_scene, s_params, s_cfg, 4, 3, 0,
                                          s_target, device=dev)
    loss_c, grad_c = diff_m.loss_and_grad(s_scene, s_params, s_cfg, 4, 3, 0,
                                          s_target, device="cpu")
    rel_loss = abs(loss_g.item() / loss_c.item() - 1)
    rel = {}
    for f in LOOP_FIELDS:
        want = getattr(grad_c, f)
        rel[f] = ((getattr(grad_g, f).cpu() - want).abs().max()
                  / want.abs().max()).item()
    print(f"card vs CPU loss_and_grad at 16x16 sppc 4: loss rel diff "
          f"{rel_loss:.2e}, gradient max |diff| / max |CPU| {rel}",
          flush=True)
    if not rel_loss <= 1e-4:
        raise AssertionError("card and CPU losses disagree")
    if not all(v <= GRAD_CARD_CPU_TOL for v in rel.values()):
        raise AssertionError(f"card and CPU gradients disagree: {rel}")


# the calls of each point count that phase 17 captures from a training step
A_BWD_STEP_CALLS = (0, 4, 16, 64, 256)


def _capture_a_bwd(scene, leaves, cfg, sppc, seed, it, target, dev):
    """One loss_and_grad of phase 17 with TrilinearLookup.backward wrapped:
    per point count, [its calls, the calls in A_BWD_STEP_CALLS with their
    shape, AABB, points, output gradients and grid gradient, each call's
    count of non-zero output gradients, the call with the most of them].
    The step must give A' its lanes' and twice its lanes' points."""
    import torch

    from mitsubaer_tpu_torch.diff import render as diff_m
    from mitsubaer_tpu_torch.models import medium

    fn = medium.TrilinearLookup
    backward, calls = vars(fn)["backward"], {}

    def capture(ctx, grad_out):
        # saved tensors unpack once under checkpointing: hand them over
        aabb6, p = ctx.saved_tensors
        out = backward.__func__(types.SimpleNamespace(
            saved_tensors=(aabb6, p), shape=ctx.shape), grad_out)
        seen = calls.setdefault(p.shape[0], [0, [], [], None])
        nonzero = int(torch.count_nonzero(grad_out))
        call = (ctx.shape, aabb6, p.clone(), grad_out.clone(), out[0].clone())
        if seen[0] in A_BWD_STEP_CALLS:
            seen[1].append(call)
        if seen[3] is None or nonzero > max(seen[2]):
            seen[3] = call
        seen[0] += 1
        seen[2].append(nonzero)
        return out

    fn.backward = staticmethod(capture)
    try:
        diff_m.loss_and_grad(scene, leaves, cfg, sppc, seed, it, target,
                             device=dev)
    finally:
        fn.backward = backward
    lanes = sppc * cfg.height * cfg.width
    if lanes not in calls or 2 * lanes not in calls:
        raise AssertionError(f"the training step's backward took no {lanes} "
                             f"or {2 * lanes} points: {sorted(calls)}")
    return calls


def _train_backward(scene, leaves, cfg, sppc, seed, target, dev, card):
    """Kernel A' at the point counts the training step gives it: one more
    loss_and_grad of phase 17 with TrilinearLookup.backward wrapped, which
    captures calls 0, 4, 16, 64 and 256 of each point count, and the call
    with the most non-zero output gradients, with their points, output
    gradients and grid gradient. Each captured result must lie within
    A_BWD_TOL["step"] of its largest voxel from the plain version on the
    same inputs (a result that is zero there must be zero) and within
    A_BWD_TOL["float64"] of the float64 sums of its terms. Returns per
    point count its calls in the step, the calls checked, the largest
    error, the time of A' (through the wrapper and bare) at the first call
    with its bound, and the plain version's time. These launches come after
    phase 17's counts were read."""
    import torch

    from mitsubaer_tpu_torch.models import medium

    calls = _capture_a_bwd(scene, leaves, cfg, sppc, seed, 3, target, dev)
    rows = []
    for n in sorted(calls):
        count, taken, nonzero, busiest = calls[n]
        worst, worst64 = 0.0, [0.0, 0.0]
        for shape, aabb6, p, g_out, got in taken + [busiest]:
            rel, rel64 = _a_bwd_check(
                got, medium.trilinear_lookup_backward_plain(
                    shape, aabb6, p, g_out), A_BWD_TOL["step"],
                f"{n} points in the training step",
                medium.trilinear_lookup_backward_plain(shape, aabb6, p,
                                                       g_out.double()))
            worst = max(worst, rel)
            worst64 = [max(a, b) for a, b in zip(worst64, rel64)]
        shape, aabb6, p, g_out, _ = taken[0]
        ms = _cuda_ms(lambda: medium.trilinear_lookup_backward(
            shape, aabb6, p, g_out), 20)
        bare_ms = _cuda_ms(_a_bwd_bare(shape, aabb6, p, g_out, torch.zeros(
            shape, device=p.device)), 20)
        plain_ms = _cuda_ms(lambda: medium.trilinear_lookup_backward_plain(
            shape, aabb6, p, g_out), 10)
        bound = _a_bwd_bound(shape, g_out)
        print(f"kernel A' in the training step at {n} points: {count} calls, "
              f"{len(taken)} captured and the busiest, max |diff| / max "
              f"|grad| against the plain version {worst:.3e} (against the "
              f"float64 sums: kernel {worst64[0]:.3e}, plain "
              f"{worst64[1]:.3e}); non-zero output gradients a call: mean "
              f"{sum(nonzero) / count:.1f}, max {max(nonzero)}, "
              f"{sum(k > 0 for k in nonzero)} calls with any; the first "
              f"call ({nonzero[0]} non-zero) {ms:.4f} ms through the "
              f"wrapper, bare launch {bare_ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]",
              flush=True)
        rows.append(dict(n=n, calls=count, checked=len(taken) + 1,
                         max_rel_err=worst, ms=ms, bare_ms=bare_ms,
                         plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], nonzero_first=nonzero[0],
                         nonzero_mean=sum(nonzero) / count,
                         nonzero_max=max(nonzero)))
    return rows


def _inverse_scene(sigma_s):
    """tests/test_inverse.py::small_volume_scene: a homogeneous box (sigma_a
    0.1), a point light, 8x8 pixels, depth 6."""
    from dataclasses import replace

    import numpy as np

    from mitsubaer_tpu_torch.core import transform as tf
    from mitsubaer_tpu_torch.scene import types as T
    from mitsubaer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    med = b.add_medium(kind=T.MED_HOMOGENEOUS, sigma_a=(0.1,) * 3,
                       sigma_s=(sigma_s,) * 3)
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)
    b.add_emitter(T.EM_POINT, radiance=(20.0,) * 3, position=(0, 0.5, -3))
    b.set_perspective_sensor(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), 30)
    cfg = replace(b.config, width=8, height=8, spp=1, max_depth=6,
                  integrator="volpath")
    return b.build(), cfg


def _recovery(dev, card):
    """tests/test_inverse.py::TestSigmaRecovery on the card, cut to 3
    steps: the target at sigma_s 0.8 (64 spp), Adam (lr 5e-2) on
    loss_and_grad at sppc 32 from 0.3; sigma_s must rise by more than one
    step's 0.05."""
    import torch

    from mitsubaer_tpu_torch.diff import render as diff_m

    scene_t, cfg = _inverse_scene(0.8)
    with torch.no_grad():
        target = diff_m.render_diff(scene_t, diff_m.get_params(scene_t), cfg,
                                    64, 123, 0, device=dev)
    scene = _inverse_scene(0.3)[0]
    leaves = diff_m.MediumParams(*(
        t.detach().to(dev).requires_grad_()
        for t in diff_m.get_params(scene)))
    opt = torch.optim.Adam(leaves, lr=5e-2)
    path = []
    for i in range(3):
        loss, grads = diff_m.loss_and_grad(scene, leaves, cfg, 32, 7, i,
                                           target, device=dev)
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        opt.step()
        path.append(leaves.sigma_s.detach().mean().item())
    print(f"sigma_s recovery (tests/test_inverse.py's scene, 0.3 -> 0.8): "
          f"after each step {path}, last loss {loss.item():.6e} [{card}]",
          flush=True)
    if not path[-1] > 0.35:
        raise AssertionError(f"sigma_s did not move toward the target: "
                             f"{path}")


def _er_bench_scene(presets, res, spp, max_steps):
    """bench.py::bench_er_forward's configuration at res^2 and spp."""
    from dataclasses import replace

    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, max_depth=6, rif_kind=1, rif_params=(1.3, 0.15),
        er_stepsize=1e-2, filter="box")
    return scene, replace(cfg, er_maxsteps=max_steps, bvp_restarts=8,
                          er_bvp_hscale=4.0)


def _er_loss(scene, cfg, sppc, seed, dev, solves=None, **media):
    """bench.py::bench_er_grad's loss: the mean of
    volpath_er.li(differentiable=True)'s sink over res^2 x sppc lanes (lane
    s npix + pixel is sample s of its pixel), with the media fields in
    `media` (rif_params, rif_coeff) replaced. `solves`, a dict, holds
    the solved BVP connections across calls (li's private hook): the first
    call fills it, a later one at the same seed reuses them."""
    from dataclasses import replace

    import torch

    from mitsubaer_tpu_torch.core import rng
    from mitsubaer_tpu_torch.integrators import volpath_er
    from mitsubaer_tpu_torch.models import sensor as sensor_m

    scene = replace(scene, media=replace(scene.media, **media))
    H, W = cfg.height, cfg.width
    npix = H * W
    pixel = torch.arange(npix, device=dev).repeat(sppc)
    sample_index = torch.repeat_interleave(torch.arange(sppc, device=dev),
                                           npix)
    smp = rng.make_sampler(seed, pixel, sample_index)
    jitter, smp = rng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jitter[:, 0]
    py = (pixel // W).to(torch.float32) + jitter[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
    volpath_er._held_solves = solves
    try:
        sink, _, _ = volpath_er.li(scene, cfg, rays.o, rays.d, smp,
                                   differentiable=True)
    finally:
        volpath_er._held_solves = None
    return sink.mean()


def _er_grad_scene(res):
    """bench.py::bench_er_grad's configuration at res^2 (spp 2)."""
    from dataclasses import replace

    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.scene import presets

    scene, cfg = presets.refractive_sphere(
        res=res, spp=2, max_depth=4, rif_kind=ek.RIF_RADIAL,
        rif_params=(1.33, 0.1, 0.5, 0.0, 0.0, 0.0), er_stepsize=1e-2,
        emitter="point", filter="box")
    return scene, replace(cfg, er_maxsteps=192, bvp_restarts=8)


def _spline_scene(res, n_grid):
    """tests/test_inverse.py::spline_rif_sphere with an n_grid^3 grid
    sampled from its Gaussian index bump over [-1.2, 1.2]^3."""
    from dataclasses import replace

    import numpy as np

    from mitsubaer_tpu_torch.core import transform as tf
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.scene import types as T
    from mitsubaer_tpu_torch.scene.build import SceneBuilder

    zs = np.linspace(-1.2, 1.2, n_grid)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    rif = (1.33 + 0.15 * np.exp(-(X**2 + Y**2 + Z**2) / 0.36)).astype(
        np.float32)
    b = SceneBuilder()
    med = b.add_medium(
        kind=T.MED_REFRACTIVE, sigma_a=(0.02,) * 3, sigma_s=(0.4,) * 3,
        rif_kind=ek.RIF_SPLINE, rif=rif, rif_aabb=((-1.2,) * 3, (1.2,) * 3),
        sdf_kind=ek.SDF_SPHERE, sdf_params=(0.0, 0.0, 0.0, 1.0))
    b.add_sphere([0, 0, 0], 1.0, bsdf=-1, interior=med)
    b.add_emitter(T.EM_POINT, radiance=(40.0,) * 3, position=(2.0, 2.0, -2.0))
    b.set_perspective_sensor(tf.look_at([0, 0, -3.5], [0, 0, 0], [0, 1, 0]),
                             40)
    cfg = replace(b.config, width=res, height=res, spp=1, max_depth=4,
                  integrator="volpath_er", er_stepsize=0.05, er_maxsteps=96)
    return b.build(), cfg


def _er_grad_step(scene, cfg, sppc, seed, dev, field):
    """(loss, gradient, wall s, peak device bytes, launches of D and E, the
    solved connections) of one eikonal gradient: the loss built, then
    torch.autograd.grad with respect to the media's `field` (rif_params or
    rif_coeff). The counts are set to 0 just before and read just after."""
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    leaf = getattr(scene.media, field).detach().clone().requires_grad_()
    solves = {}
    ermarch.trace.launches = ermarch.sens_march.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss = _er_loss(scene, cfg, sppc, seed, dev, solves, **{field: leaf})
    (grad,) = torch.autograd.grad(loss, leaf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (loss.detach(), grad, wall, torch.cuda.max_memory_allocated(dev),
            (ermarch.trace.launches, ermarch.sens_march.launches), solves)


def _er_fd(scene, cfg, sppc, seed, dev, field, direction, step, what,
           card, eps=1e-3):
    """tests/test_inverse.py's check, at the connections that the gradient
    `step` (an _er_grad_step at this seed) solved: the central difference
    of the loss along `direction` (common random numbers, the BVP
    directions, convergence and weights of `step` held) against the
    gradient's directional derivative. With the connections solved anew
    the difference is the Levenberg stop test's: its solutions sit just
    inside bvp_tol2, so any change of the RIF flips some of them, and
    their restart weights (up to 1 / rr_weight) swamp the transport (on
    the card at 32^2: 0.70 against a derivative of 0.062, PERF.md). eps
    is a tenth of test_inverse.py's 0.01: at 0.01 along rif_params at
    32^2 the Fresnel and roulette decisions of a few of the 2,048 lanes
    flip too (0.022 against 0.113 on the CPU; 0.108 at 1e-3)."""
    import numpy as np
    import torch

    base = getattr(scene.media, field)
    directional = (step[1] * direction).sum().item()
    with torch.no_grad():
        f = [_er_loss(scene, cfg, sppc, seed, dev, step[5],
                      **{field: base + s * eps * direction}).item()
             for s in (1, -1)]
    fd = (f[0] - f[1]) / (2 * eps)
    print(f"{what}: directional derivative {directional:.6e}, central "
          f"difference at the solved connections {fd:.6e} (eps {eps}) "
          f"[{card}]", flush=True)
    if not (np.isfinite(directional) and np.isfinite(fd)):
        raise AssertionError(f"{what}: non-finite derivative")
    if not (np.sign(directional) == np.sign(fd) or abs(fd) < 1e-4):
        raise AssertionError(f"{what}: the gradient and the finite "
                             f"difference differ in sign")
    if not abs(directional - fd) <= ER_FD_ATOL + ER_FD_RTOL * abs(fd):
        raise AssertionError(f"{what}: the gradient and the finite "
                             f"difference disagree")


def _er_grad_phases(dev, card, results):
    """Phases 19-21: the eikonal training path (volpath_er.li with
    differentiable=True)."""
    import numpy as np
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    # ---- phase 19: the eikonal gradient at full width ----
    scene, cfg = _er_grad_scene(32)
    scene = scene.to(dev)
    sppc, lanes = 2, 32 * 32 * 2
    sens_march, captured = ermarch.sens_march, {}

    def capture(rif, sdf, p1, v, dpdv0, dvdv0, p2, h, max_steps, active):
        out = sens_march(rif, sdf, p1, v, dpdv0, dvdv0, p2, h, max_steps,
                         active)
        # per lane count: [calls, calls 0, 4, 16 and 64, the call with the
        # most active lanes]
        seen = captured.setdefault(p1.shape[0], [0, [], None])
        busy = int(active.sum())
        if seen[0] in (0, 4, 16, 64) or seen[2] is None or busy > int(
                seen[2][0][9].sum()):
            call = ((rif, sdf) + tuple(
                t.clone() for t in (p1, v, dpdv0, dvdv0, p2)) + (
                h, max_steps, active.clone()), [t.clone() for t in out])
            if seen[0] in (0, 4, 16, 64):
                seen[1].append(call)
            if seen[2] is None or busy > int(seen[2][0][9].sum()):
                seen[2] = call
        seen[0] += 1
        return out

    # the first call with kernel E's calls captured (the wrapper takes the
    # launch counts while it stands in), the second one timed
    capture.launches = 0
    ermarch.sens_march = capture
    try:
        first = _er_grad_step(scene, cfg, sppc, 0, dev, "rif_params")
    finally:
        ermarch.sens_march = sens_march
    step = _er_grad_step(scene, cfg, sppc, 1, dev, "rif_params")
    loss, grad, wall, peak, launches, _ = step
    g = grad.cpu()
    print(f"eikonal gradient (bench_er_grad: radial RIF, 32x32 spp 2, "
          f"{lanes} lanes, depth 4, h 1e-2, er_maxsteps 192, 8 BVP "
          f"restarts): first call {first[2]:.3f} s, second {wall:.3f} s, "
          f"{lanes / wall:.1f} fwd+bwd samples/s, peak device memory "
          f"{peak / 2**30:.3f} GiB, launches of D and E {launches}, loss "
          f"{loss.item():.6e}, d loss / d rif_params {g.tolist()} [{card}]",
          flush=True)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("phase 19: a non-finite RIF gradient")
    if not bool((g[:3] != 0).all()):
        raise AssertionError("phase 19: a zero p0, a or w gradient")
    if launches[1] == 0:
        raise AssertionError("phase 19: kernel E never launched")
    if launches[0] != 0:
        raise AssertionError("phase 19: kernel D launched on the "
                             "differentiable path")
    _er_fd(scene, cfg, sppc, 1, dev, "rif_params", scene.media.rif_params,
           step, "phase 19 along rif_params", card)
    results["er_sens"]["launches_er_grad"] = launches[1]
    results["er_sens"]["er_grad_shapes"] = _er_grad_kernel_e(captured, card)
    results["er_sens"]["er_grad_step"] = dict(
        first_s=first[2], wall_s=wall, samples_per_s=lanes / wall,
        peak_gib=peak / 2**30)

    # ---- phase 20: the spline RIF's voxel gradient ----
    s_scene, s_cfg = _spline_scene(64, 32)
    s_scene = s_scene.to(dev)
    runs = [_er_grad_step(s_scene, s_cfg, 2, seed, dev, "rif_coeff")
            for seed in (0, 1)]
    loss, grad, wall, peak, launches, _ = runs[1]
    gr = grad.cpu()
    mass = gr.abs().sum().item()
    interior = gr[3:-3, 3:-3, 3:-3].abs().sum().item()
    print(f"spline RIF gradient (test_inverse's scene, 32^3 grid, 64x64 "
          f"sppc 2, {64 * 64 * 2} lanes, depth 4, h 0.05, er_maxsteps 96): "
          f"first call {runs[0][2]:.3f} s, second {wall:.3f} s, "
          f"{64 * 64 * 2 / wall:.1f} fwd+bwd samples/s, peak device memory "
          f"{peak / 2**30:.3f} GiB, launches of D and E {launches}, loss "
          f"{loss.item():.6e}, max |grad| {gr.abs().max().item():.4e}, "
          f"interior share {interior / max(mass, 1e-30):.4f} [{card}]",
          flush=True)
    if not bool(torch.isfinite(gr).all()) or mass == 0:
        raise AssertionError("phase 20: the RIF voxel gradient is "
                             "non-finite or zero")
    if not interior > 0.3 * mass:
        raise AssertionError("phase 20: the interior voxels carry too "
                             "little of the gradient")
    if launches != (0, 0):
        raise AssertionError("phase 20: a spline march launched a kernel")
    results["er_sens"]["spline_grad_step"] = dict(
        first_s=runs[0][2], wall_s=wall, samples_per_s=64 * 64 * 2 / wall,
        peak_gib=peak / 2**30)
    # at tests/test_inverse.py's own size
    j_scene, j_cfg = _spline_scene(8, 12)
    j_scene = j_scene.to(dev)
    step = _er_grad_step(j_scene, j_cfg, 4, 3, dev, "rif_coeff")
    zs = np.linspace(-1, 1, 12)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    bump = torch.from_numpy(np.exp(-(X**2 + Y**2 + Z**2) / 0.5).astype(
        np.float32)).to(dev)
    _er_fd(j_scene, j_cfg, 4, 3, dev, "rif_coeff", bump, step,
           "phase 20 along the smooth bump (12^3 grid, 8x8 sppc 4, seed 3)",
           card)

    # ---- phase 21: card against CPU (the spline at phase 20's own size,
    # whose card gradient is in hand) ----
    r_scene, r_cfg = _er_grad_scene(8)
    radial = _er_grad_step(r_scene.to(dev), r_cfg, 2, 5, dev, "rif_params")
    pairs = (
        ("radial, 8x8 sppc 2", radial,
         _er_grad_at(r_scene, r_cfg, 2, 5, "rif_params", radial[5])),
        ("spline, 8x8 sppc 4", step,
         _er_grad_at(j_scene, j_cfg, 4, 3, "rif_coeff", step[5])))
    for name, (loss, grad, *_), cpu_out in pairs:
        card_out = loss.item(), grad.cpu()
        rel_loss = abs(card_out[0] / cpu_out[0] - 1)
        scale = cpu_out[1].abs().max().item()
        rel = (card_out[1] - cpu_out[1]).abs().max().item() / scale
        print(f"card vs CPU eikonal gradient ({name}): loss rel diff "
              f"{rel_loss:.2e}, gradient max |diff| / max |CPU| {rel:.3e} "
              f"(max |CPU| {scale:.4e})", flush=True)
        if not (rel_loss <= ER_CARD_CPU_TOL[0]
                and rel <= ER_CARD_CPU_TOL[1]):
            raise AssertionError(f"card and CPU eikonal gradients disagree "
                                 f"({name})")


def _er_grad_at(scene, cfg, sppc, seed, field, solves):
    """(loss, gradient) of the eikonal loss on the CPU at the BVP
    connections that a run on the card solved (`solves`): the
    devices' Levenberg iterates differ in their last bits, so their
    solutions' acceptance (the stop and re-find tests) and restart weights
    could differ on a lane and move the loss by that lane's weighted
    share; held, what is compared is the transport and its gradient."""
    import dataclasses

    import torch

    held = {k: {"detached": dataclasses.replace(m["detached"], **{
        f.name: getattr(m["detached"], f.name).cpu()
        for f in dataclasses.fields(m["detached"])}),
        "converged": m["converged"].cpu()} for k, m in solves.items()}
    scene = scene.to("cpu")
    leaf = getattr(scene.media, field).detach().clone().requires_grad_()
    loss = _er_loss(scene, cfg, sppc, seed, "cpu", held, **{field: leaf})
    (grad,) = torch.autograd.grad(loss, leaf)
    return loss.item(), grad


def _er_grad_kernel_e(captured, card):
    """Kernel E at the calls phase 19's eikonal gradient made (calls 0, 4,
    16 and 64 of each lane count, and the one with the most active lanes):
    each output equal to the plain version on the same inputs, and E timed
    at the busiest. Returns per lane count its calls in the step, the
    calls checked, the busiest call's active lanes and steps, the largest
    difference and the times of E, its bare launch and the plain version,
    with the bound. These launches come after phase 19's counts were
    read."""
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    if not captured:
        raise AssertionError("phase 19 made no call of kernel E")
    rows = []
    for n in sorted(captured):
        count, taken, busiest = captured[n]
        taken = taken + [busiest]
        err = 0.0
        for args, got in taken:
            want = ermarch.sens_march_plain(*args)
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"kernel E differs from its plain "
                                     f"version at {n} lanes in the eikonal "
                                     f"gradient: outputs {bad}")
            err = max(err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(got[:6], want[:6])))
        args = busiest[0]
        rif, sdf, h, max_steps = args[0], args[1], args[7], args[8]
        e_in = list(args[2:7]) + [args[9]]
        launch, outs = _e_bare(rif, sdf, e_in, h, max_steps)
        launch()
        torch.cuda.synchronize()
        trips = outs[-1]
        ms = _cuda_ms(lambda: ermarch.sens_march(*args), 20)
        bare_ms = _cuda_ms(launch, 20)
        plain_ms = _cuda_ms(lambda: ermarch.sens_march_plain(*args), 3)
        bound = _bound(n * (109 + 113), int(trips.sum())
                       * OPS_E_STEP[rif.kind])
        print(f"kernel E in the eikonal gradient at {n} lanes: {count} "
              f"calls, {len(taken)} checked, every output equal to the "
              f"plain version (max abs err {err:.3e}); the busiest call "
              f"({int(args[9].sum())} active lanes, {int(trips.max())} "
              f"steps): {ms:.4f} ms through the wrapper, bare {bare_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]}) [{card}]", flush=True)
        rows.append(dict(n=n, calls=count, checked=len(taken),
                         active=int(args[9].sum()), steps=int(trips.max()),
                         max_abs_err=err, ms=ms, bare_ms=bare_ms,
                         plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1]))
        del launch, outs
    return rows


if __name__ == "__main__":
    sys.exit(main())
