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
     A_BWD_TOL of the largest voxel (the plain version's float sums round
     in index_add_'s order) with the same NaN voxels, a second call
     bit-equal to the first (the kernel sums in fixed point), and within A_BWD_TOL["float64"] of the
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
     volpath_er.li(differentiable=True) with respect to rif_params, once
     (seed 1): finite, p0, a and w non-zero, kernel E launched (in the
     detached BVP solves) and kernel D not; the call's wall, fwd+bwd
     samples/s, peak device memory and the launches; the central
     difference of the loss along rif_params (eps 1e-3, common random
     numbers, the gradient's solved BVP connections held) against the
     gradient at test_inverse.py's tolerance. Kernel E's calls are
     captured (calls 0, 4, 16 and 64 of each lane count, and its
     busiest): every output equal to its plain version on the same
     inputs, and E timed at the busiest. (A second, timed call in a warm
     process: scripts/profile_er_grad_torch.py --repeat);
 20. the spline RIF's voxel gradient: test_inverse.py's scene (a Gaussian
     index bump, sphere SDF, point light, h 0.05, er_maxsteps 96) with a
     32^3 grid at 64^2 sppc 2, depth SPLINE_DEPTH, once (seed 1; a
     second call: the profile script's --scene spline --repeat): finite,
     non-zero, more than 0.3 of its mass on the interior voxels, no
     kernel launched; the same measures as phase 19. Then at test_inverse.py's own size (12^3, 8^2,
     sppc 4, seed 3) its directional finite-difference check, the
     connections held as in phase 19;
 21. phase 19's configuration at 8^2 sppc 2, and phase 20's gradient at
     test_inverse.py's size, on the card and on the CPU at the card's
     solved BVP connections: the loss and each gradient within
     ER_CARD_CPU_TOL;
 22. the homogeneous distance-sampling strategies in the refractive
     medium: phase 7's render with sigma_s (0.2, 0.4, 0.8) under
     STRAT_MAXIMUM, then STRAT_MANUAL (density 0.5); kernels D and E must
     launch; each render's wall; then each at 16^2 spp 4 on the card and
     on the CPU, by phase 8's rule;
 23. the light image (volpath_er.render_er_light_image) at 96^2, 8 passes
     of 9,216 particles, through the strong radial lens of
     tests/test_volpath_er.py (a 0.5, 4 BVP restarts): D and E must
     launch; their first and busiest calls captured, each output equal to
     the plain version's on the same inputs, timed at the busiest; the
     wall, launches and film sum. Then at 24^2 (a 0) on the card and on
     the CPU pass by pass: the connections both devices splat within rtol
     1e-3, at most LIGHT_MAX_FLIPPED on one only;
 24. the acoustic RIF (mode 2): one plain kernel-E march at the bench's
     36,864 lanes, then phase 7's render with it at ACOUSTIC_RES^2 (32^2)
     spp 2, depth ACOUSTIC_DEPTH, through the plain loops (no kernel may
     launch; the plain curved march and BVP solve must run on some
     lanes): the wall (the 96^2 render: scripts/profile_er_torch.py
     --acoustic);
 25. er_f64: one float64 plain kernel-E march at 36,864 lanes, then phase
     7's render in float64 at depth F64_DEPTH through the plain loops (no
     kernel may launch): the wall and the image's difference from the
     float32 render (phase 7's, or one at that depth);
 26. the surface path, BASELINE config 1: render() of cornell_box at
     256^2, spp 64, depth 40, "path", gaussian filter (2 passes of 32 spp
     through path.li), every kernel count 0 before and after (the cbox
     roads run no hand-written kernel: no pallas_call lies on them): the
     wall, bounces a pass, peak device memory and mean; one pass again
     under the profiler (launches a bounce, device time, busy share);
     then "direct", whose mean must not exceed the path's;
 27. the same two renders at 16^2 spp 8 on the card and on the CPU, by
     phase 8's rule; every one of the 21 BSDF kinds' eval, pdf and sample
     (tests/test_torch_bsdf.py's table) at 2^20 seeded lanes on the card
     and on the CPU, within that test's tolerance;
 28. BASELINE config 2: the cbox filled with a homogeneous HG medium
     (CBOX_MEDIUM), "volpath" on the loop engine, measured as phase 26;
     then card against CPU at 16^2 spp 8;
 29. the box-filter cbox on the wavefront road at 256^2 spp 64, "path" and
     the config-2 medium: no sample left unfinished, the pixel-by-pixel
     median ratio against the loop road (engine "loop", box filter, same
     seed) within 0.95-1.05; WF_PROFILE_SUPERS super-iterations
     profiled (launches a super-iteration, busy share);
 30. the BVH: the cbox with a subdivided sphere of 81,920 triangles; the
     256^2 camera rays through the BVH and through the brute-force sweep
     in chunks (equal hits, t within 1e-5 relative, equal triangle ids but
     at ties: rays that meet both triangles at one t, on a shared edge or
     corner or in one plane; `_bvh_ties`), both
     timed; a 64^2 spp 4 path render through the BVH at depth BVH_DEPTH;
 31. the area-lit refractive sphere (refractive_sphere(emitter=
     "area_behind") at bench_er_forward's settings, 96^2 spp 2): D and E
     must launch; their first and busiest calls captured, each output
     equal to the plain version's, timed at the busiest; then card
     against CPU at 16^2 spp 4, single solve, by phase 22's rule.
     Phases 26-31 print their measures as one {"surface": ...} JSON line.
 32. the phase kinds: the heterogeneous bounded volume at 512^2, spp 32,
     depth 12 with a microflake medium and a 64^3 orientation field on the
     loop road (kernel A must launch), and with a Rayleigh medium and a
     box filter on the wavefront road (kernels A and C must launch, no
     sample left unfinished); vMF, the HG mixture and Kajiya-Kay at 64^2
     spp 8; each card against CPU by phase 8's rule at 16^2-24^2; every
     kind's eval and sample at 2^20 seeded lanes, card against CPU
     within MODEL_PHASE_TOL (scripts/profile_models_torch.py profiles the
     full-width renders of phases 32-35);
 33. every sensor kind on config 1 at 64^2 spp 16 (no kernel may
     launch); the thin lens at config 1's full width, timed, and card
     against CPU at 16^2;
 34. the sky-lit scene (_sky_scene: make_sky_envmap(res=128) over the
     cbox's floor and boxes) at 256^2 spp 64 depth 40 on the loop road,
     timed, with peak memory; the envmap's sampling on the card as
     tests/test_texture_bsdf.py::TestEnvmap checks it (2^20 samples);
     the wavefront road against the loop road at 128^2 spp 16, median
     pixel ratio within 0.95-1.05; card against CPU at 16^2;
 35. each sampler mode's stream at 2^20 lanes x 16 dimensions, card equal
     to CPU bit for bit; config 1 at full width with the ldsampler and
     the independent sampler in turns (independent, lds, lds,
     independent); the box-filter cbox with the ldsampler on the
     wavefront road at 64^2 spp 4; card against CPU at 16^2;
 36. "ao" and every "field" on config 1 at 128^2 spp 64,
     render_multichannel and render_adaptive (4 passes of spp 16 at
     most); then the light image of the refractive sphere (phase 23's
     strong lens, 96^2, 2 passes) lit by the area quad behind it (no
     backdrop), a spot and a directional emitter: D and E must launch,
     their first and busiest calls held exact (_check_d_calls,
     _check_e_calls). Phases 32-36 print one {"models": ...} JSON line.
 37. the transient main path: the 512^2 spp 32 depth 12 volume (density
     64^3, gaussian filter, loop road) with 128 transient frames of 0.5
     over [0, 64) (TRANSIENT): kernel A must launch; the wall, bounces
     and Woodcock iterations a pass, peak memory. Then, box filter and
     engine "loop", one pass (spp 8, 2,097,152 lanes), transient and
     steady at one seed: the frames summed
     must equal the steady image within FRAME_SUM_TOL of its largest
     pixel, and the energy the sink drops outside [0, 64) must be 0;
     bounce frames 0-13 (BOUNCE) and the sine and depth-selective CW-ToF
     weights (lambda TOF_LAMBDA) at 128^2 spp 8, the square, hamiltonian
     and m-sequence weights at 64^2 spp 4;
 38. card against CPU: the transient, bounce and sine films at 16^2 spp 4
     (phase 8's rule, signed for CW-ToF), the transient cbox path at 16^2,
     the transient eikonal road (ER_FRAMES, single solve) at 16^2 spp 2;
 39. bdpt at full width: the refractive sphere (bench_er_forward's 96^2
     spp 2 depth 6, 8 BVP restarts, 64 transient frames ER_FRAMES):
     kernels D and E must launch, their first and busiest calls held
     exact (_check_d_calls, _check_e_calls); the heterogeneous box lit by
     a point emitter at 256^2 spp 8 depth 6 (kernel A must launch; its
     first pass again with DensityGrid.lookup wrapped, every captured
     call of A held exact against the plain version, the first and the
     largest point counts timed) and the cbox (BASELINE config 1) at
     256^2 spp 16 depth 8 (no kernel may launch; one pass profiled:
     launches, busy share): walls and passes;
     each card against CPU at 16^2, spp 1 and 2 (the sphere at 8^2 spp 1,
     single solve);
 40. the particle tracer on config 1 at 256^2 spp 4: the wall; card
     against CPU at 16^2. Phases 37-40 print one {"transient": ...} JSON
     line (scripts/profile_bdpt_torch.py profiles a pass of each bdpt
     path and of the particle tracer);
 41. the front door: the main path written as Mitsuba XML with its 64^3
     density grid as a .vol file (main_path_xml; the collimated beam, the
     null-bounded cube with `interior`, the perspective sensor, the
     filter a $define), loaded and compared field by field with the
     preset; `python -m mitsubaer_tpu_torch.cli` renders it in a process
     of its own at 512^2 spp 32 depth 12 with the gaussian filter (the
     loop road, kernel A) and the box filter (the boxwalk road, kernel B)
     while this process renders the same loaded scene: each EXR, read
     back with the port's io, bit-equal to the in-process image; kernel A
     held against its plain version at the loop pass's calls (as phase
     13); two 256^2 renders with the beam and 128 frames bit-equal; the
     beam splat's accumulation timed before (index_add_ / index_put_) and
     after (render.add_rows);
 42. the render farm: the (2, 2) layout of the 512^2 spp 32 depth 12
     volume sharded on the loop road (kernel A) and, point-lit, on the
     wavefront road (kernel C, its first call held against its plain
     version), at world 1 in this process and world 2 in two processes on
     the card (gloo): bit-equal; no sample of the wavefront shards left
     unfinished; the mean within FARM_MEAN_TOL of the unsharded render's
     (less its beam splat, which the sharded render does not add), the
     per-pixel difference's mean over its standard error printed;
 43. phase 17's training step over that layout (Adam, lr 5e-2) at world 1
     and world 2: the loss, the density's gradient and the updated
     parameters bit-equal, A and A' launched; at world 1 kernel A's and
     A''s calls captured and held against their plain versions (A
     exactly, A' as phase 17); dryrun_multiprocess(2) beside it.
     Phases 41-43 print one {"front_door": ...} JSON line.
 44. the Metropolis estimators: (a) "pssmlt" on BASELINE config 1
     (256^2 spp 4 depth 40: 8,192 chains, 32 rounds, 65,536 bootstrap
     lanes, D 120; no kernel may launch): the wall, the path.li calls,
     one round's device launches and time (profiled), the mean within
     EST_MEAN_TOL of config 1's path render (phase 26's image where it
     ran); "mlt" and a second "pssmlt" bit-equal to a first at 32^2;
     (b) "pssmlt_volpath" on the main path's volume (512^2 spp 1 depth
     12, density 64^3: 32,768 chains, 8 rounds): kernel A must launch,
     its calls captured during the render (the bootstrap's and the first
     rounds') and held exact against the plain version (the first and
     largest point counts timed), the mean
     over the main path's loop-road render less its beam splat (phase
     42's where it ran) within VOL_MLT_RATIO; (c) "erpt" on tests/test_erpt.py's
     caustic scene at 256^2 spp 4 depth 5, the mean against a path
     render at spp 64; (d) solve_specular_chain on the two-refraction
     glass sphere at 2^16 lanes, card against CPU (CHAIN_TOL,
     CHAIN_MAX_APART, CHAIN_MAX_ROOTS), timed. Each of (a)-(c) card against CPU at 16^2
     (bootstrap 2^12): the first round chain by chain from the same
     states (MLT_RTOL, MLT_MAX_APART) and the whole renders' means;
 45. "ppm" on config 1 at 256^2 spp 16 (4 iterations of 65,536 photons, 8
     bounces; no kernel may launch): the wall split into photon tracing,
     map build, camera walk and gather; the mean and the pixel
     correlation against config 1's path render (EST_MEAN_TOL,
     PPM_MIN_CORR); "photonmapper", "sppm" and a second "ppm" bit-equal
     to the first; card against CPU at 16^2 spp 4 by phase 8's rule;
 46. "bre" on phase 10's point-lit volume (512^2 spp 8 depth 12, density
     64^3: 2 iterations of 262,144 volume and 262,144 surface photons):
     kernel A must launch, its calls captured during the render (the
     first pass's Woodcock lookups at 262,144 points and segment
     quadrature at 4,194,304) and held exact, the first and largest
     timed; the wall split into volume photons, surface photons, beam
     gathers and the surface gather, peak memory; the mean over phase
     10's wavefront mean within BRE_RATIO; card against CPU at 16^2 spp 4
     by phase 8's rule.
     Phases 44-46 print one {"estimators": ...} JSON line.
With `--phases a-b[,c-d]` only those phase groups run (3-8, 9-12, 13-15,
16-18, 19-21, 22-25, 26-31, 32-36, 37-40, 41-43, 44-46; 1 and 2 always),
for iterating on the card.
Prints one JSON line of per-kernel results (time, bound, plain version,
library yardstick, launches on the main paths; for A also its launches on
the loop road and its checks and times at the loop road's point counts,
and its launches in a training step; for B, C and D also the device time
and registers; for A' its bare-launch and clustered times and its checks
and times at the training step's point counts; for E its launches in an eikonal
gradient, its checks and times at that gradient's calls, and the walls of
phases 19 and 20; for D and E their launches, checks and times in the
light image and in the area-lit sphere, and the walls of phases 22-25;
for A and C their launches in phase 32, for D and E in phase 36's light
images; for A its launches on the transient main path (phase 37) and in
bdpt's heterogeneous box, with its checks and times at bdpt's point
counts, for D and E their launches and checks in bdpt's
refractive sphere (phase 39); for A its launches on the XML main path
and its checks there, and for A, A' and C their launches in the sharded
renders and step (phases 41-43); for A its launches on the pssmlt_volpath
and bre paths and its checks and times at their captured calls (phases
44, 46)), then the contract line
{"ok": true, "device": {...}} last.
"""
from __future__ import annotations

import contextlib
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
# largest voxel. The plain version sums in float32 in index_add_'s order,
# the kernel each warp's peers in float32 and the rest in fixed point: the
# spread points' voxels take ~32 terms each; the clustered
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
# phase 20: the depth of the spline gradient at 64^2 (the scene's own is
# 4: 55.5-98 s a call on an H100), cut to make room for
# phases 26-31 (at depth 2 no path reaches the light through the medium:
# the loss and gradient are 0); its finite-difference check at
# test_inverse.py's size keeps depth 4
SPLINE_DEPTH = 3


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
    arguments formed once (no checks, no allocation, not counted; the
    kernel's int64 scratch is allocated here, once)."""
    import torch

    from mitsubaer_tpu_torch import kernels

    nz, ny, nx = shape
    acc = torch.empty((nz * ny * nx + 1,), dtype=torch.int64,
                      device=p.device)
    args = (p.data_ptr(), grad_out.data_ptr(), aabb6.data_ptr(),
            grad.data_ptr(), acc.data_ptr(), p.shape[0], nx, ny, nz,
            kernels.stream(p))
    fn = kernels.library().mk_trilinear_lookup_backward
    return lambda keep=acc: fn(*args)


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

    phases = _phase_range(sys.argv[1:])
    groups = {}

    def timed(first, last, fn, *args):
        if not phases & set(range(first, last + 1)):
            return None
        t0 = time.perf_counter()
        out = fn(dev, card, results, *args)
        groups[f"{first}-{last}"] = time.perf_counter() - t0
        print(f"phases {first}-{last}: {groups[f'{first}-{last}']:.1f} s",
              flush=True)
        return out

    er_img = timed(3, 8, _core_phases, build_log)
    timed(9, 12, _megatrack_phases, build_log)
    timed(13, 15, _loop_phases)
    timed(16, 18, _training_phases)
    timed(19, 21, _er_grad_phases)
    timed(22, 25, _er_rest_phases, er_img)
    timed(26, 31, _surface_phases)
    timed(32, 36, _model_phases)
    timed(37, 40, _transient_phases)
    timed(41, 43, _front_door_phases)
    timed(44, 46, _estimator_phases)
    print(json.dumps({"phase_group_s": groups}))

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _phase_range(argv):
    """The phases to run: all with no argument (as the check runs the
    script), else those of `--phases a-b[,c-d...]`; phases 1 and 2 always
    run, and a phase group runs whole where any of its phases is asked
    for."""
    if not argv:
        return set(range(1, 47))
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases a-b[,c-d...]]")
    phases = set()
    for part in argv[1].split(","):
        a, _, b = part.partition("-")
        phases |= set(range(int(a), int(b or a) + 1))
    return phases


def _core_phases(dev, card, results, build_log):
    """Phases 3-8: kernels A, B, D and E against their plain versions, the
    bounded-volume and eikonal paths at full width and small, card against
    CPU. Returns phase 7's eikonal image."""
    import torch

    from mitsubaer_tpu_torch.integrators import boxwalk
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.models import ermarch
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

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
    er_img, d_calls = _trace_calls(lambda: render_m.render(
        er_scene, er_cfg, seed=1, device=dev, stats=stats))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"er_trace": ermarch.trace.launches,
                "er_sens": ermarch.sens_march.launches}
    img = er_img
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

    return er_img


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
    IMAGES["wavefront"] = img.cpu()                   # phase 42 reads it

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


def _capture_lookups(calls, picks=(0, 4, 16, 64, 256, 1024)):
    """A stand-in for DensityGrid.lookup (kernel A's caller) that calls it
    and keeps, per point count in `calls` (in the order the counts first
    appear), [calls, the calls numbered in `picks` (grid, points and
    output, cloned; the grid a copy whose values an optimizer step that
    updates the parameters in place leaves alone)]."""
    import copy

    from mitsubaer_tpu_torch.models import medium

    lookup = medium.DensityGrid.lookup

    def capture(self, p):
        out = lookup(self, p)
        seen = calls.setdefault(p.shape[0], [0, []])
        if seen[0] in picks:
            grid = copy.copy(self)
            grid.grid = self.grid.detach().clone()
            seen[1].append((grid, p.clone(), out.detach().clone()))
        seen[0] += 1
        return out

    return capture


def _check_lookups(calls, card, where, timed):
    """Kernel A at the calls _capture_lookups kept in `where`: every
    captured output equal to the plain version on the same inputs, on an
    f32 grid; the point counts in `timed` timed through the wrapper and
    plain at their first captured call, with the bound. Returns a row per
    timed count: its calls, the calls checked, the times."""
    import torch

    from mitsubaer_tpu_torch.models import medium

    if not calls:
        raise AssertionError(f"{where} looked up no density")
    rows = []
    for n in sorted(calls):
        count, taken = calls[n]
        for grid, p, out in taken:
            if grid.cells.dtype != torch.float32:
                raise AssertionError(f"the grid of {where} is "
                                     f"{grid.cells.dtype}, not f32")
            ref = medium.trilinear_lookup_plain(grid.grid, grid.aabb6, p)
            if not torch.equal(out, ref):
                err = (out - ref).abs().max().item()
                raise AssertionError(f"kernel A differs from its plain "
                                     f"version in {where} at {n} points: "
                                     f"max abs err {err}")
        if n == 0 or n not in timed:
            continue
        grid, p, _ = taken[0]
        ms = _cuda_ms(lambda g=grid, q=p: g.lookup(q), 20)
        plain_ms = _cuda_ms(lambda g=grid, q=p: medium.trilinear_lookup_plain(
            g.grid, g.aabb6, q), 10)
        bound = _bound(n * 16 + grid.grid.numel() * 4, n * OPS_A_POINT)
        print(f"kernel A in {where} at {n} points: {count} calls, "
              f"{len(taken)} captured and equal to the plain version on "
              f"every point; {ms:.4f} ms through the wrapper, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) "
              f"[{card}]", flush=True)
        rows.append(dict(n=n, calls=count, checked=len(taken), equal=True,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1]))
    return rows


def _loop_lookups(scene, cfg, dev, card):
    """Kernel A at the point counts the loop road gives it: the first pass
    of phase 13's render again (same seed, same lanes) with the lookups
    captured and held against the plain version (_check_lookups), every
    point count timed. These launches come after phase 13's count was
    read."""
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import film, medium

    lookup, calls = medium.DensityGrid.lookup, {}
    sppc = render_m._spp_per_pass(cfg)
    medium.DensityGrid.lookup = _capture_lookups(calls)
    try:
        render_m.render_pass(scene, film.new_accumulator(cfg, dev), cfg,
                             sppc, 0, 0)
    finally:
        medium.DensityGrid.lookup = lookup
    lanes = sppc * cfg.height * cfg.width
    if lanes not in calls or 2 * lanes not in calls:
        raise AssertionError(f"the loop pass looked up no {lanes} or "
                             f"{2 * lanes} points: {sorted(calls)}")
    return _check_lookups(calls, card, "the loop pass", set(calls))


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
        _bits_equal(medium.trilinear_lookup_backward(shape, aabb6, p,
                                                     grad_out).cpu(),
                    got.cpu(), f"kernel A' ({name}) called twice")
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


@contextlib.contextmanager
def _a_bwd_capturing(calls):
    """TrilinearLookup.backward wrapped while the block runs: per point
    count in `calls`, [its calls, the calls in A_BWD_STEP_CALLS with their
    shape, AABB, points, output gradients and grid gradient, each call's
    count of non-zero output gradients, the call with the most of them]."""
    import torch

    from mitsubaer_tpu_torch.models import medium

    fn = medium.TrilinearLookup
    backward = vars(fn)["backward"]

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
        yield calls
    finally:
        fn.backward = backward


def _capture_a_bwd(scene, leaves, cfg, sppc, seed, it, target, dev):
    """One loss_and_grad of phase 17 with kernel A''s calls captured
    (_a_bwd_capturing). The step must give A' its lanes' and twice its
    lanes' points."""
    from mitsubaer_tpu_torch.diff import render as diff_m

    with _a_bwd_capturing({}) as calls:
        diff_m.loss_and_grad(scene, leaves, cfg, sppc, seed, it, target,
                             device=dev)
    lanes = sppc * cfg.height * cfg.width
    if lanes not in calls or 2 * lanes not in calls:
        raise AssertionError(f"the training step's backward took no {lanes} "
                             f"or {2 * lanes} points: {sorted(calls)}")
    return calls


def _check_a_bwd_calls(calls, where):
    """Kernel A' at the calls _a_bwd_capturing kept in `where`: each
    captured result within A_BWD_TOL["step"] of its largest voxel from the
    plain version on the same inputs (a result that is zero there must be
    zero) and within A_BWD_TOL["float64"] of the float64 sums of its terms.
    Returns per point count (its largest error, its largest errors against
    the float64 sums, kernel and plain)."""
    from mitsubaer_tpu_torch.models import medium

    if not calls:
        raise AssertionError(f"{where} ran no backward of kernel A")
    out = {}
    for n in sorted(calls):
        _, taken, _, busiest = calls[n]
        worst, worst64 = 0.0, [0.0, 0.0]
        for shape, aabb6, p, g_out, got in taken + [busiest]:
            rel, rel64 = _a_bwd_check(
                got, medium.trilinear_lookup_backward_plain(
                    shape, aabb6, p, g_out), A_BWD_TOL["step"],
                f"{n} points in {where}",
                medium.trilinear_lookup_backward_plain(shape, aabb6, p,
                                                       g_out.double()))
            worst = max(worst, rel)
            worst64 = [max(a, b) for a, b in zip(worst64, rel64)]
        out[n] = (worst, worst64)
    return out


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
    errs = _check_a_bwd_calls(calls, "the training step")
    rows = []
    for n in sorted(calls):
        count, taken, nonzero, _ = calls[n]
        worst, worst64 = errs[n]
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
    return sink.steady.mean()


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


def _lap_clock(record=None):
    """A lap timer: each call lap(phase) prints the seconds since the last
    as "phase N: x s", and keeps them in record[phase] where a dict is
    given."""
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s", flush=True)
        if record is not None:
            record[phase] = now - clock[0]
        clock[0] = now

    return lap


def _er_grad_phases(dev, card, results):
    """Phases 19-21: the eikonal training path (volpath_er.li with
    differentiable=True)."""
    import dataclasses

    import numpy as np
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    # E's row (phase 6's), or a bare one where phases 3-8 did not run
    e_row = results.setdefault("er_sens", {})

    lap = _lap_clock()

    # ---- phase 19: the eikonal gradient at full width ----
    scene, cfg = _er_grad_scene(32)
    scene = scene.to(dev)
    sppc, lanes = 2, 32 * 32 * 2
    sens_march, captured = ermarch.sens_march, {}
    capture = _capture_calls(sens_march, captured, (0, 4, 16, 64))

    # one call, with kernel E's calls captured (the wrapper takes the
    # launch counts while it stands in); a second, timed call in a warm
    # process is scripts/profile_er_grad_torch.py --repeat's
    ermarch.sens_march = capture
    try:
        step = _er_grad_step(scene, cfg, sppc, 1, dev, "rif_params")
    finally:
        ermarch.sens_march = sens_march
    loss, grad, wall, peak, launches, _ = step
    g = grad.cpu()
    print(f"eikonal gradient (bench_er_grad: radial RIF, 32x32 spp 2, "
          f"{lanes} lanes, depth 4, h 1e-2, er_maxsteps 192, 8 BVP "
          f"restarts): first call {wall:.3f} s (calls captured), "
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
    e_row["launches_er_grad"] = launches[1]
    e_row["er_grad_shapes"] = _check_e_calls(
        captured, card, "the eikonal gradient")
    e_row["er_grad_step"] = dict(
        first_s=wall, samples_per_s=lanes / wall, peak_gib=peak / 2**30)

    lap(19)

    # ---- phase 20: the spline RIF's voxel gradient ----
    s_scene, s_cfg = _spline_scene(64, 32)
    s_cfg = dataclasses.replace(s_cfg, max_depth=SPLINE_DEPTH)
    s_scene = s_scene.to(dev)
    # one call; a second of a warm process is
    # scripts/profile_er_grad_torch.py --scene spline --repeat's
    loss, grad, wall, peak, launches, _ = _er_grad_step(
        s_scene, s_cfg, 2, 1, dev, "rif_coeff")
    gr = grad.cpu()
    mass = gr.abs().sum().item()
    interior = gr[3:-3, 3:-3, 3:-3].abs().sum().item()
    print(f"spline RIF gradient (test_inverse's scene, 32^3 grid, 64x64 "
          f"sppc 2, {64 * 64 * 2} lanes, depth {SPLINE_DEPTH}, h 0.05, "
          f"er_maxsteps 96): "
          f"first call {wall:.3f} s, "
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
    e_row["spline_grad_step"] = dict(
        first_s=wall, samples_per_s=64 * 64 * 2 / wall,
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

    lap(20)

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


def _capture_calls(fn, captured, picks):
    """A stand-in for the march wrapper fn (ermarch.trace or sens_march)
    that calls it and keeps, per lane count in `captured`, [calls, the
    calls numbered in `picks` (their arguments and outputs cloned), the
    call with the most active lanes]. The wrapper counts its launches on
    the stand-in while it stands in (its `launches` attribute)."""
    import torch

    def capture(*args):
        out = fn(*args)
        seen = captured.setdefault(args[2].shape[0], [0, [], None])
        busy = int(args[-1].sum())
        if seen[0] in picks or seen[2] is None or busy > int(
                seen[2][0][-1].sum()):
            call = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args), [t.clone() for t in out])
            if seen[0] in picks:
                seen[1].append(call)
            if seen[2] is None or busy > int(seen[2][0][-1].sum()):
                seen[2] = call
        seen[0] += 1
        return out

    capture.launches = 0
    return capture


def _check_d_calls(captured, card, where):
    """Kernel D at the captured calls of `where` (_capture_calls): each
    output equal to trace_plain on the same inputs, and D timed at the
    busiest through its wrapper and bare, with the plain version and the
    bound. Returns a row per lane count, as _check_e_calls does."""
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    if not captured:
        raise AssertionError(f"{where} made no call of kernel D")
    rows = []
    for n in sorted(captured):
        count, taken, busiest = captured[n]
        taken = taken + [busiest]
        err = 0.0
        for args, got in taken:
            want = ermarch.trace_plain(*args)
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"kernel D differs from its plain "
                                     f"version at {n} lanes in {where}: "
                                     f"outputs {bad}")
            err = max(err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(got[:4], want[:4])))
        args = busiest[0]
        rif, sdf, h, max_steps = args[0], args[1], args[5], args[6]
        launch, outs = _d_bare(rif, sdf, (args[2], args[3], args[4],
                                          args[7]), h, max_steps)
        launch()
        torch.cuda.synchronize()
        trips = outs[-1]
        ms = _cuda_ms(lambda: ermarch.trace(*args), 20)
        bare_ms = _cuda_ms(launch, 20)
        plain_ms = _cuda_ms(lambda: ermarch.trace_plain(*args), 3)
        bound = _bound(n * 70 + 8, int(trips.sum()) * OPS_D_STEP[rif.kind])
        print(f"kernel D in {where} at {n} lanes: {count} calls, "
              f"{len(taken)} checked, every output equal to the plain "
              f"version (max abs err {err:.3e}); the busiest call "
              f"({int(args[7].sum())} active lanes, {int(trips.max())} "
              f"trips): {ms:.4f} ms through the wrapper, bare {bare_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]}) [{card}]", flush=True)
        rows.append(dict(n=n, calls=count, checked=len(taken),
                         active=int(args[7].sum()), steps=int(trips.max()),
                         max_abs_err=err, ms=ms, bare_ms=bare_ms,
                         plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1]))
        del launch, outs
    return rows


def _check_e_calls(captured, card, where):
    """Kernel E at the captured calls of `where` (_capture_calls; phase
    19's eikonal gradient: calls 0, 4, 16 and 64 of each lane count, and
    the one with the most active lanes): each output equal to the plain
    version on the same inputs, and E timed at the busiest. Returns per
    lane count its calls, the calls checked, the busiest call's active
    lanes and steps, the largest difference and the times of E, its bare
    launch and the plain version, with the bound. These launches come
    after the counts of `where` were read."""
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    if not captured:
        raise AssertionError(f"{where} made no call of kernel E")
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
                                     f"version at {n} lanes in {where}: "
                                     f"outputs {bad}")
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
        print(f"kernel E in {where} at {n} lanes: {count} "
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


# phases 24 and 25 march the plain loops, launch-bound on the card: their
# renders' depth (bench_er_forward's is 6), cut where the script's time
# needs it. On an H100 the acoustic render took 1.9 s at depth 2, 69.2 s
# at depth 3 and 215.6 s at depth 4 (one plain acoustic E march at 36,864
# lanes 0.49-0.81 s, ~5x the linear one's); the float64 render 32.0-51.2
# s at depth 6. A camera ray enters the sphere at depth 2, and curved
# NEE and continuation need depth < max_depth: depth 3 is the least at
# which the medium is marched. F64_DEPTH 3 leaves room for phases 26-31
ACOUSTIC_DEPTH = 3
# phase 24 renders the acoustic sphere at this width; its 96^2 render (67.3
# s on an H100) is scripts/profile_er_torch.py --acoustic
ACOUSTIC_RES = 32
F64_DEPTH = 3
# phase 23: the light image, card against CPU at 24^2 pass by pass: pixels
# lit on one device only (connections whose Levenberg stop test the two
# devices' ulps decided differently) over LIGHT_PASSES passes
LIGHT_PASSES, LIGHT_MAX_FLIPPED = 6, 2


def _light_scene(presets, res, a):
    """tests/test_volpath_er.py::TestSensorSideConnections's scene at
    res^2: the refractive sphere with a point light and a radial RIF of
    strength a (w 0.5), h 0.02, er_maxsteps 256, 4 BVP restarts, depth 4."""
    from dataclasses import replace

    scene, cfg = presets.refractive_sphere(
        res=res, spp=1, max_depth=4, rif_kind=2,
        rif_params=(1.33, a, 0.5, 0.0, 0.0, 0.0), er_stepsize=0.02,
        emitter="point", filter="box")
    return scene, replace(cfg, er_maxsteps=256, bvp_restarts=4)


def _er_variant(presets, res, spp, max_steps, strategy=None, **kw):
    """_er_bench_scene with refractive_sphere's keywords `kw` and, where
    given, the medium's distance-sampling strategy (manual density 0.5)."""
    import dataclasses

    import torch

    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, max_depth=kw.pop("max_depth", 6),
        rif_kind=kw.pop("rif_kind", 1),
        rif_params=kw.pop("rif_params", (1.3, 0.15)), er_stepsize=1e-2,
        filter="box", **kw)
    cfg = dataclasses.replace(cfg, er_maxsteps=max_steps, bvp_restarts=8,
                              er_bvp_hscale=4.0)
    if strategy is not None:
        media = dataclasses.replace(
            scene.media, strategy=torch.full_like(scene.media.strategy,
                                                  strategy),
            manual_density=torch.full_like(scene.media.manual_density, 0.5))
        scene = dataclasses.replace(scene, media=media)
        cfg = dataclasses.replace(cfg, medium_strategies=True)
    return scene, cfg


@contextlib.contextmanager
def _plain_march_lanes():
    """Count the active lanes that ermarch's plain marches (D's and E's
    plain versions: the curved march and the BVP solve's inner loop) are
    called with, by name, while the block runs."""
    from mitsubaer_tpu_torch.models import ermarch

    names = ("trace_plain", "sens_march_plain")
    lanes = dict.fromkeys(names, 0)
    saved = {k: getattr(ermarch, k) for k in names}

    def counted(name):
        def march(*args):
            lanes[name] += int(args[-1].sum())
            return saved[name](*args)
        return march

    for k in names:
        setattr(ermarch, k, counted(k))
    try:
        yield lanes
    finally:
        for k, f in saved.items():
            setattr(ermarch, k, f)


def _er_render(scene, cfg, dev, seed=1):
    """(image, wall s, launches of D and E) of one eikonal render on the
    card, the counts set to 0 just before and read just after."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import ermarch

    ermarch.trace.launches = ermarch.sens_march.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (ermarch.trace.launches, ermarch.sens_march.launches)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all()) or not img.mean() > 0):
        raise AssertionError("an eikonal render gave a non-finite, black "
                             "or misshapen image")
    return img, wall, launches


def _card_vs_cpu(img_g, img_c, what, rel=0.02):
    """Phase 8's rule: the median pixel ratio over the CPU image's lit
    pixels within 1 +- rel and the means within rel."""
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c > 0
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    mean_rel = abs(img_g.mean().item() / img_c.mean().item() - 1)
    print(f"card vs CPU {what}: median pixel ratio {ratio:.6f}, mean rel "
          f"diff {mean_rel:.2e}", flush=True)
    if not (1 - rel <= ratio <= 1 + rel and mean_rel <= rel):
        raise AssertionError(f"card and CPU disagree: {what}")
    return ratio, mean_rel


def _plain_e_ms(rif, sdf, e_in, dtype):
    """One plain kernel-E march (sens_march_plain) on the card at e_in's
    lanes, in `dtype`: h 4e-2, 64 steps, as phase 6 times it."""
    import torch

    from mitsubaer_tpu_torch.models import ermarch

    args = [t.to(dtype) if t.is_floating_point() else t for t in e_in]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ermarch.sens_march_plain(rif, sdf, *args[:5], 4e-2, 64, args[5])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _er_rest_phases(dev, card, results, er_img):
    """Phases 22-25: the eikonal road's strategies, light image, acoustic
    RIF and float64 core."""
    import dataclasses

    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.integrators import volpath_er as er_m
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.models import ermarch
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T

    sphere = ek.SdfField(ek.SDF_SPHERE, (0.0, 0.0, 0.0, 1.0))
    # D's and E's rows (phase 6's), or bare ones where phases 3-8 did not
    # run (--phases)
    d_row = results.setdefault("er_trace", {})
    e_row = results.setdefault("er_sens", {})

    lap = _lap_clock()

    # ---- phase 22: the homogeneous strategies in the refractive medium,
    # at bench_er_forward's width with a chromatic sigma_s ----
    sigma_s = (0.2, 0.4, 0.8)
    rows = {}
    for name, strat in (("maximum", T.STRAT_MAXIMUM),
                        ("manual", T.STRAT_MANUAL)):
        scene, cfg = _er_variant(presets, 96, 2, 256, strat, sigma_s=sigma_s)
        img, wall, launches = _er_render(scene, cfg, dev)
        print(f"eikonal path, strategy {name} (96x96 spp 2 depth 6, sigma_s "
              f"{sigma_s}): wall {wall:.3f} s, "
              f"{96 * 96 * 2 / wall / 1e6:.6f} Msamples/s, mean "
              f"{img.mean().item():.6f}, launches of D and E {launches} "
              f"[{card}]", flush=True)
        if min(launches) < 1:
            raise AssertionError(f"phase 22 ({name}) skipped a kernel: "
                                 f"{launches}")
        # the single-solve BVP here: with restarts, a connection whose
        # stop or re-find test the devices' ulps decide differently moves
        # a 16^2 image's mean by up to ~25% (float32 against float64 on
        # the CPU: 5-15%); single-solve, 0.5%
        s_scene, s_cfg = _er_variant(presets, 16, 4, 128, strat,
                                     sigma_s=sigma_s)
        s_cfg = dataclasses.replace(s_cfg, bvp_restarts=0)
        img_g = _er_render(s_scene, s_cfg, dev, seed=3)[0].cpu()
        img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
        ratio = _card_vs_cpu(img_g, img_c, f"eikonal render, strategy "
                             f"{name}, 16x16 spp 4")
        rows[name] = dict(wall_s=wall, launches=launches,
                          mean=img.mean().item(), card_vs_cpu=ratio)
    d_row["strategies"] = rows

    lap(22)

    # ---- phase 23: the light image at full width (96^2, 8 passes of
    # 9,216 particles) through the strong lens, its kernel calls captured
    # and held exact; then card against CPU at 24^2 ----
    scene, cfg = _light_scene(presets, 96, 0.5)
    trace, sens_march = ermarch.trace, ermarch.sens_march
    d_calls, e_calls = {}, {}
    ermarch.trace = _capture_calls(trace, d_calls, (0,))
    ermarch.sens_march = _capture_calls(sens_march, e_calls, (0,))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = er_m.render_er_light_image(scene, cfg, seed=0, n_passes=8,
                                          device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (ermarch.trace.launches, ermarch.sens_march.launches)
    finally:
        ermarch.trace, ermarch.sens_march = trace, sens_march
    total = film.sum().item()
    lit = int((film.sum(-1) > 0).sum())
    print(f"light image (96x96, 8 passes, {8 * 96 * 96} particles, radial "
          f"RIF a 0.5): wall {wall:.3f} s, film sum {total:.6f}, {lit} lit "
          f"pixels, launches of D and E {launches} [{card}]", flush=True)
    if not bool(torch.isfinite(film).all()) or not total > 0:
        raise AssertionError("the light image is non-finite or black")
    if min(launches) < 1:
        raise AssertionError(f"the light image skipped a kernel: "
                             f"{launches}")
    d_row["light_image"] = dict(
        wall_s=wall, launches=launches[0], film_sum=total,
        calls=_check_d_calls(d_calls, card, "the light image"))
    e_row["light_image"] = dict(
        launches=launches[1],
        calls=_check_e_calls(e_calls, card, "the light image"))
    del d_calls, e_calls
    s_scene, s_cfg = _light_scene(presets, 24, 0.0)
    g_scene, c_scene = s_scene.to(dev), s_scene.to("cpu")
    both = flipped = 0
    worst = 0.0
    for i in range(LIGHT_PASSES):
        fg = er_m.trace_er_particles(g_scene, s_cfg, 576, 0, i).cpu()
        fc = er_m.trace_er_particles(c_scene, s_cfg, 576, 0, i)
        lg, lc = fg.sum(-1) > 0, fc.sum(-1) > 0
        both += int((lg & lc).sum())
        flipped += int((lg ^ lc).sum())
        if bool((lg & lc).any()):
            worst = max(worst, ((fg - fc).abs() / fc.abs().clamp_min(1e-30))
                        [lg & lc].max().item())
    print(f"card vs CPU light image (24x24, {LIGHT_PASSES} passes of 576, "
          f"a 0): {both} connections on both devices, largest relative "
          f"difference {worst:.3e}, {flipped} on one only", flush=True)
    if both < 6 or worst > 1e-3 or flipped > LIGHT_MAX_FLIPPED:
        raise AssertionError("card and CPU light images disagree")

    lap(23)

    # ---- phase 24: the acoustic RIF (mode 2) through the plain loops ----
    acoustic = (1.3333, 0.03, 6.0, 2.0)
    _, e_in = _er_inputs(ek.RifField(ek.RIF_ACOUSTIC, acoustic), 0, 36_864,
                         13, dev)
    plain_ac = _plain_e_ms(ek.RifField(ek.RIF_ACOUSTIC, acoustic), sphere,
                           e_in, torch.float32)
    scene, cfg = _er_variant(presets, ACOUSTIC_RES, 2, 256,
                             rif_kind=ek.RIF_ACOUSTIC, rif_params=acoustic,
                             max_depth=ACOUSTIC_DEPTH)
    with _plain_march_lanes() as marched:
        img, wall, launches = _er_render(scene, cfg, dev)
    print(f"acoustic RIF (mode 2, kr 6): one plain kernel-E march at 36864 "
          f"lanes {plain_ac:.1f} ms; eikonal render {ACOUSTIC_RES}x"
          f"{ACOUSTIC_RES} spp 2 depth {ACOUSTIC_DEPTH}: wall {wall:.3f} s, "
          f"mean "
          f"{img.mean().item():.6f}, launches of D and E {launches}, active "
          f"lanes of the plain marches {marched} [{card}]", flush=True)
    if launches != (0, 0):
        raise AssertionError("the acoustic RIF reached a kernel")
    if not marched["sens_march_plain"] or not marched["trace_plain"]:
        raise AssertionError("the acoustic render ran no curved march or "
                             "no BVP solve in the medium")
    e_row["acoustic"] = dict(
        plain_ms=plain_ac, wall_s=wall, res=ACOUSTIC_RES,
        depth=ACOUSTIC_DEPTH,
        mean=img.mean().item(), plain_march_lanes=marched)

    lap(24)

    # ---- phase 25: er_f64 through the plain loops, against phase 7's
    # float32 render ----
    linear = ek.RifField(ek.RIF_LINEAR, (1.3, 0.15))
    _, e_in = _er_inputs(linear, 0, 36_864, 11, dev)
    plain64 = _plain_e_ms(linear, sphere, e_in, torch.float64)
    scene, cfg = _er_variant(presets, 96, 2, 256, max_depth=F64_DEPTH)
    img64, wall, launches = _er_render(
        scene, dataclasses.replace(cfg, er_f64=True), dev)
    if er_img is None or F64_DEPTH != 6:
        er_img = _er_render(scene, cfg, dev)[0]
    diff = (img64 - er_img).abs()
    print(f"er_f64: one plain float64 kernel-E march at 36864 lanes "
          f"{plain64:.1f} ms; eikonal render 96x96 spp 2 depth {F64_DEPTH}: "
          f"wall {wall:.3f} s, mean {img64.mean().item():.6f} (float32 "
          f"{er_img.mean().item():.6f}), max |f64 - f32| "
          f"{diff.max().item():.4e}, mean |f64 - f32| "
          f"{diff.mean().item():.4e}, launches of D and E {launches} "
          f"[{card}]", flush=True)
    if launches != (0, 0):
        raise AssertionError("a float64 march reached a kernel")
    # recorded, not held: float64 paths take other branches than float32
    # ones where a decision sits within the float32 ulps (the BVP's stop
    # and re-find tests with restarts), and float64 accepts more
    # connections (at 16^2 spp 4 on the CPU its mean is 5-15% higher)
    lum64, lum32 = img64.mean(-1), er_img.mean(-1)
    sel = lum32 > 0
    ratio = (lum64[sel] / lum32[sel]).median().item()
    mean_rel = img64.mean().item() / er_img.mean().item() - 1
    print(f"er_f64 against float32: median pixel ratio {ratio:.6f}, mean "
          f"rel diff {mean_rel:.3e}", flush=True)
    e_row["f64"] = dict(
        plain_ms=plain64, wall_s=wall, depth=F64_DEPTH,
        max_abs_diff_f32=diff.max().item(), median_ratio_f32=ratio,
        mean_rel_f32=mean_rel)


# ---------------------------------------------------------------------------
# Phases 26-31: the surface path
# ---------------------------------------------------------------------------
# BASELINE config 2's medium: sigma_s 1e-3 over the ~550-unit box gives a
# camera ray to the back wall an optical depth of about 1.5 (the preset's
# default, 0.5, would extinguish every ray before the box)
CBOX_MEDIUM = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)
# phase 27: the BSDFs card against CPU, tests/test_torch_bsdf.py's rule
# (there held against the JAX package): a lane agrees within 1e-4 relative
# plus 1e-6 of the quantity's 99th-percentile magnitude; at most 2% of a
# kind's lanes and 0.1% of all may disagree
BSDF_RTOL, BSDF_ATOL_SCALE, BSDF_MAX_BAD = 1e-4, 1e-6, 0.02
# phase 30: subdivisions of the icosahedron (20 4^k triangles), and the
# depth of the path render through the BVH: each traversal is a host loop
# of ~130 launches a trip (scene/bvh.py), ~350 trips, two traversals a
# bounce (24.2 s at depth 8 on an H100)
BVH_SUBDIV = 6
BVH_DEPTH = 2
# phase 29: the wavefront engine profiled over WF_PROFILE_SUPERS
# super-iterations after WF_PROFILE_SUPERS of warm-up, in a pass of sppc
# WF_PROFILE_SPPC (a 32-spp pass holds ~600,000 launches, whose trace
# takes ~0.2 ms an event to aggregate)
WF_PROFILE_SPPC, WF_PROFILE_SUPERS = 4, 5


def _kernel_counts():
    """Every kernel wrapper's launch count."""
    from mitsubaer_tpu_torch.integrators import boxwalk, megatrack
    from mitsubaer_tpu_torch.models import ermarch, medium

    return {"trilinear_lookup": medium.trilinear_lookup.launches,
            "trilinear_lookup_backward":
                medium.trilinear_lookup_backward.launches,
            "boxwalk": boxwalk.walk.launches, "megatrack": megatrack.run.launches,
            "er_trace": ermarch.trace.launches,
            "er_sens": ermarch.sens_march.launches}


def _zero_counts():
    from mitsubaer_tpu_torch.integrators import boxwalk, megatrack
    from mitsubaer_tpu_torch.models import ermarch, medium

    for fn in (medium.trilinear_lookup, medium.trilinear_lookup_backward,
               boxwalk.walk, megatrack.run, ermarch.trace,
               ermarch.sens_march):
        fn.launches = 0


def _surface_render(scene, cfg, dev, card, what, seed=0):
    """render() on the card with every kernel count at 0 just before and
    read just after (the cbox roads launch none: no heterogeneous medium,
    no refractive one); returns (image, stats, wall s, peak device
    bytes)."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m

    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=seed, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all()) or not img.mean() > 0):
        raise AssertionError(f"{what}: a non-finite, black or misshapen "
                             "image")
    if any(counts.values()):
        raise AssertionError(f"{what} launched a kernel: {counts}")
    return img, stats, wall, peak


def _profile_pass(run, card, what):
    """run() (one spp chunk, ending in a synchronize) under torch.profiler,
    device activity only (host events of a wavefront pass number in the
    millions): its wall, the device time and count of the kernels and
    copies it launched, read from the raw trace (key_averages' aggregation
    took ~0.3 ms an event: 37 s over a bdpt pass), and the busy share of
    the wall. The profiler slows the host, so the share is a floor."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ns = launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev_ns += e.end_ns() - e.start_ns()
            launches += 1
    if not launches:
        raise AssertionError(f"{what}: the profiler saw no device work")
    return out, dict(wall_s=wall, device_s=dev_ns / 1e9, launches=launches,
                     busy=dev_ns / 1e9 / wall)


def _loop_pass_profile(scene, cfg, dev, card, what):
    """One loop-road pass (render_pass at the render's own sppc) profiled:
    returns its measures with launches a bounce."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m

    sppc = render_m._spp_per_pass(cfg)
    acc = torch.zeros((cfg.height, cfg.width, 4), device=dev)
    (_, counts), m = _profile_pass(
        lambda: render_m.render_pass(scene, acc, cfg, sppc, 0, 0), card,
        what)
    m["bounces"] = counts[0]
    m["launches_a_bounce"] = m["launches"] / max(counts[0], 1)
    print(f"{what}, one pass (sppc {sppc}) profiled: wall "
          f"{m['wall_s']:.3f} s, {counts[0]} bounces, {m['launches']} device "
          f"launches ({m['launches_a_bounce']:.1f} a bounce), device time "
          f"{m['device_s']:.3f} s, busy share {m['busy']:.3f} [{card}]",
          flush=True)
    return m


def _profile_wavefront(scene, cfg, card, what):
    """The wavefront engine's super-iterations WF_PROFILE_SUPERS + 1 to
    2 WF_PROFILE_SUPERS of a pass of sppc WF_PROFILE_SPPC (seed 7),
    profiled (render_wavefront's loop, stepped here): launches a
    super-iteration, device time, busy share."""
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.integrators import wavefront as wf_m

    het = render_m._any_het(scene)
    st, event_pass, tracking_mega, cond, _ = wf_m.make_engine(
        scene, cfg, WF_PROFILE_SPPC, 7, 0,
        has_direct=render_m._has_direct(scene), any_het=het)

    def supers(st, k):
        for _ in range(k):
            if not cond(st):
                raise AssertionError(f"{what}: the pass ended in the "
                                     "profiled window")
            st = event_pass(st)
            for _ in range(cfg.wf_mini_passes):
                st = event_pass(st, mini=True)
                if het:
                    st = tracking_mega(st)
            if cfg.wf_mini_passes == 0 and het:
                st = tracking_mega(st)
        return st

    st = supers(st, WF_PROFILE_SUPERS)
    _, m = _profile_pass(lambda: supers(st, WF_PROFILE_SUPERS), card, what)
    m["super_iterations"] = WF_PROFILE_SUPERS
    m["launches_a_super_iteration"] = m["launches"] / WF_PROFILE_SUPERS
    print(f"{what}, super-iterations {WF_PROFILE_SUPERS + 1}-"
          f"{2 * WF_PROFILE_SUPERS} of a pass of sppc {WF_PROFILE_SPPC} "
          f"profiled: wall {m['wall_s']:.3f} s, {m['launches']} device "
          f"launches ({m['launches_a_super_iteration']:.1f} a "
          f"super-iteration), busy share {m['busy']:.3f} [{card}]",
          flush=True)
    return m


def _bsdf_table():
    """tests/test_torch_bsdf.py's table, built by the port: every kind, a
    masked plastic, the wrappers over their children."""
    import numpy as np

    from mitsubaer_tpu_torch.scene import types as T
    from mitsubaer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    add = b.add_bsdf
    d = add(T.BSDF_DIFFUSE, reflectance=(0.7, 0.5, 0.3))
    add(T.BSDF_DIELECTRIC, eta=1.5)
    add(T.BSDF_CONDUCTOR, cond_eta=(0.2, 0.9, 1.1), cond_k=(3.9, 2.4, 2.2))
    add(T.BSDF_NULL)
    add(T.BSDF_PLASTIC, reflectance=(0.6, 0.4, 0.2), eta=1.49)
    rc = add(T.BSDF_ROUGHCONDUCTOR, alpha=0.3, cond_eta=(0.2, 0.9, 1.1),
             cond_k=(3.9, 2.4, 2.2))
    add(T.BSDF_THINDIELECTRIC, eta=1.33)
    add(T.BSDF_ROUGHDIELECTRIC, alpha=0.25, eta=1.5)
    add(T.BSDF_PHONG, reflectance=(0.4, 0.4, 0.4), specular_r=(0.3, 0.3, 0.3),
        exponent=20.0)
    add(T.BSDF_MIRROR, specular_r=(0.9, 0.8, 0.7))
    add(T.BSDF_HDIELECTRIC, eta=1.4)
    add(T.BSDF_ROUGHPLASTIC, reflectance=(0.5, 0.3, 0.6), alpha=0.2)
    add(T.BSDF_WARD, reflectance=(0.3, 0.3, 0.3), specular_r=(0.4, 0.4, 0.4),
        alpha=0.2, alpha_v=0.35)
    add(T.BSDF_DIFFTRANS, reflectance=(0.6, 0.6, 0.6))
    add(T.BSDF_HROUGHDIELECTRIC, alpha=0.3, eta=1.4)
    add(T.BSDF_MIXTURE, child0=d, child1=rc, mix_w=0.35)
    add(T.BSDF_TWOSIDED, child0=d)
    add(T.BSDF_HK, specular_r=(0.8, 0.5, 0.3), specular_t=(0.1, 0.2, 0.3),
        alpha=0.6, mix_w=0.4)
    add(T.BSDF_ROUGHDIFFUSE, reflectance=(0.7, 0.6, 0.5), alpha=0.5)
    add(T.BSDF_COATING, child0=d, eta=1.5, specular_t=(0.1, 0.1, 0.1))
    add(T.BSDF_ROUGHCOATING, child0=d, eta=1.5, alpha=0.2,
        specular_t=(0.05, 0.05, 0.05))
    add(T.BSDF_PLASTIC, reflectance=(0.6, 0.6, 0.6), opacity=0.6)
    b.add_mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
               np.array([[0, 1, 2]], np.int32), bsdf=0)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    return b.build().bsdfs


def _bsdf_inputs(nb, n):
    """Seeded inputs on n lanes: row indices (-1 the null surface), wi,
    wo, u2, u1, an h-dielectric eta_override and a texture's refl_scale."""
    import numpy as np
    import torch

    r = np.random.default_rng(0)

    def dirs():
        d = r.normal(size=(n, 3))
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)

    x = dict(idx=(np.arange(n) % (nb + 1) - 1), wi=dirs(), wo=dirs(),
             u2=r.uniform(0, 1, (n, 2)).astype(np.float32),
             u1=r.uniform(0, 1, n).astype(np.float32),
             eta_override=r.uniform(1.1, 1.6, n).astype(np.float32),
             refl_scale=r.uniform(0.5, 1.0, (n, 3)).astype(np.float32))
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _bsdf_all(bs, x):
    """(eval, pdf, sample fields) of every lane, all kinds on."""
    from mitsubaer_tpu_torch.models import bsdf as bsdf_m

    kw = dict(eta_override=x["eta_override"], refl_scale=x["refl_scale"])
    s = bsdf_m.sample(bs, x["idx"], x["wi"], x["u2"], x["u1"], **kw)
    return dict(eval=bsdf_m.eval(bs, x["idx"], x["wi"], x["wo"], **kw),
                pdf=bsdf_m.pdf(bs, x["idx"], x["wi"], x["wo"], **kw),
                wo=s.wo, weight=s.weight, spdf=s.pdf, delta=s.delta,
                eta=s.eta, null=s.null_passthrough)


def _bsdf_card_vs_cpu(dev, card):
    """Phase 27's BSDF half: every kind's eval, pdf and sample at 2^20
    lanes on the card and on the CPU."""
    import torch

    bs = _bsdf_table()
    n = 1 << 20
    x = _bsdf_inputs(bs.kind.shape[0], n)
    kinds = torch.where(x["idx"] >= 0, bs.kind[x["idx"].clamp_min(0)], -1)
    want = _bsdf_all(bs, x)
    bs_g = bs.to(dev)
    x_g = {k: v.to(dev) for k, v in x.items()}
    got = {k: v.cpu() for k, v in _bsdf_all(bs_g, x_g).items()}
    ms = _cuda_ms(lambda: _bsdf_all(bs_g, x_g), 3)
    worst = {}
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.bool:
            ok = g == w
        else:
            s = max(torch.quantile(w.abs().flatten()[::7].double(),
                                   0.99).item(), 1.0)
            ok = (g - w).abs() <= BSDF_RTOL * w.abs() + BSDF_ATOL_SCALE * s
            if ok.dim() > 1:
                ok = ok.all(-1)
        bad_all = (~ok).double().mean().item()
        bad_kind = max((~ok[kinds == k]).double().mean().item()
                       for k in range(-1, 21))
        worst[name] = (bad_all, bad_kind)
        if bad_all > 1e-3 or bad_kind > BSDF_MAX_BAD:
            raise AssertionError(f"BSDF {name} card against CPU: {bad_all} "
                                 f"of the lanes, {bad_kind} of a kind's "
                                 "disagree")
    print(f"BSDFs, all 21 kinds and the null surface at {n} lanes, card "
          f"against CPU: lanes that disagree (all, worst kind) {worst}; "
          f"eval + pdf + sample of every lane {ms:.3f} ms [{card}]",
          flush=True)
    return dict(lanes=n, disagree=worst, ms=ms)


def _icosphere(level, center, radius):
    """(verts, faces) of an icosahedron subdivided `level` times, projected
    on the sphere; 20 4^level triangles, vertices not shared."""
    import numpy as np

    t = (1.0 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]])
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    tri = v[f] / np.linalg.norm(v[f], axis=-1, keepdims=True)
    for _ in range(level):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = ((p + q) / np.linalg.norm(p + q, axis=-1, keepdims=True)
                      for p, q in ((a, b), (b, c), (c, a)))
        tri = np.concatenate([np.stack(s, 1) for s in
                              ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                               (ab, bc, ca))])
    verts = (tri.reshape(-1, 3) * radius + center).astype(np.float32)
    return verts, np.arange(len(verts), dtype=np.int32).reshape(-1, 3)


# phase 30: a hit on a triangle's border has a barycentric within
# BVH_BORDER of 0; two corners, or two planes, are one within BVH_CORNER
# (scene units; the icosphere's edges are ~10 long)
BVH_BORDER, BVH_CORNER = 1e-3, 1e-3


def _bvh_ties(geo, other, o, d, t, prim_b, prim_f):
    """Phase 30's exemption. Where a ray meets two triangles at one t,
    brute force keeps the lower id and the walk the first it visits. Of
    the `other` lanes (equal t, the ids differ), count as ties those whose
    ray, intersected anew with each of the two triangles of `geo`, meets
    both at t (within 1e-5 relative, barycentrics within BVH_BORDER of the
    triangle), where the two share an edge or a corner with both hits on
    their border, or lie in one plane (the cbox's ceiling and the patch
    over it); `other` counts the rest."""
    import torch

    idx = other.nonzero().squeeze(-1)
    o, d, t, p_b, p_f = (x[idx] for x in (o, d, t, prim_b, prim_f))

    def hit(prim):
        """(t, u, v) of each ray against its triangle (Moller-Trumbore)."""
        v0, e1, e2 = geo.v0[prim], geo.e1[prim], geo.e2[prim]
        pv = torch.cross(d, e2, dim=-1)
        inv = 1.0 / (e1 * pv).sum(-1)
        tv = o - v0
        u = (tv * pv).sum(-1) * inv
        qv = torch.cross(tv, e1, dim=-1)
        return (e2 * qv).sum(-1) * inv, u, (d * qv).sum(-1) * inv

    def corners(prim):
        v0 = geo.v0[prim]
        return torch.stack([v0, v0 + geo.e1[prim], v0 + geo.e2[prim]], 1)

    def unit_normal(prim):
        n = torch.cross(geo.e1[prim], geo.e2[prim], dim=-1)
        return n / n.norm(dim=-1, keepdim=True)

    meets, border = torch.ones_like(t, dtype=torch.bool), []
    for prim in (p_b, p_f):
        t_p, u, v = hit(prim)
        b = torch.minimum(torch.minimum(u, v), 1 - u - v)
        meets &= ((t_p - t).abs() <= 1e-5 * t.abs()) & (b >= -BVH_BORDER)
        border.append(b <= BVH_BORDER)
    shared = ((corners(p_b)[:, :, None] - corners(p_f)[:, None])
              .abs().amax(-1) <= BVH_CORNER).sum((1, 2))
    on_shared = border[0] & border[1] & (shared >= 1)
    n_b, n_f = unit_normal(p_b), unit_normal(p_f)
    coplanar = (((n_b * n_f).sum(-1).abs() >= 1 - 1e-6)
                & ((n_f * (geo.v0[p_b] - geo.v0[p_f])).sum(-1).abs()
                   <= BVH_CORNER))
    edge = meets & on_shared & (shared >= 2)
    corner = meets & on_shared & (shared == 1)
    plane = meets & ~on_shared & coplanar
    return dict(edge=int(edge.sum()), corner=int(corner.sum()),
                coplanar=int(plane.sum()),
                other=int((~(edge | corner | plane)).sum()))


def _bvh_scene(res, spp):
    """The cbox without its boxes and with a subdivided sphere of
    20 4^BVH_SUBDIV triangles in their place (BVH on: over 512)."""
    from dataclasses import replace

    from mitsubaer_tpu_torch.core import transform as tf
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T
    from mitsubaer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    white = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=presets.CBOX_WHITE)
    red = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=presets.CBOX_RED)
    green = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=presets.CBOX_GREEN)
    light = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=(0.78, 0.78, 0.78))
    for pts, mat in [(presets._FLOOR, white), (presets._CEIL, white),
                     (presets._CEIL_PATCH, white), (presets._BACK, white),
                     (presets._RED, red), (presets._GREEN, green)]:
        b.add_mesh(*presets._quad(pts), bsdf=mat)
    b.add_mesh(*presets._quad(presets._LIGHT), bsdf=light,
               emitter_radiance=presets.CBOX_LIGHT_RAD)
    b.add_mesh(*_icosphere(BVH_SUBDIV, (278.0, 160.0, 280.0), 150.0),
               bsdf=white)
    b.set_perspective_sensor(
        to_world=tf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
        fov_deg=39.3077, fov_axis="x", near=10.0)
    b.config = replace(b.config, width=res, height=res, spp=spp,
                       max_depth=40)
    return b.build(), b.config


def _surface_phases(dev, card, results):
    """Phases 26-31: the surface path (cornell_box, path, direct, the
    BSDFs, the wavefront road's cbox, the BVH, the area-lit refractive
    sphere)."""
    import dataclasses

    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import ermarch
    from mitsubaer_tpu_torch.scene import bvh as bvh_m
    from mitsubaer_tpu_torch.scene import intersect as isect
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T

    surf = {"phase_s": {}}
    lap = _lap_clock(surf["phase_s"])

    # ---- phase 26: BASELINE config 1, then "direct" ----
    scene, cfg = presets.cornell_box(res=256, spp=64, max_depth=40)
    scene = scene.to(dev)
    img, stats, wall, peak = _surface_render(scene, cfg, dev, card,
                                             "the cbox path render")
    path_mean = img.mean().item()
    IMAGES["config1_path"] = img.cpu()                # phases 44-45 read it
    print(f"cbox path (BASELINE config 1): 256x256 spp 64 depth 40 gaussian "
          f"filter in {len(stats['passes'])} passes, bounces a pass "
          f"{[p[0] for p in stats['passes']]}, wall {wall:.3f} s, "
          f"{256 * 256 * 64 / wall / 1e6:.4f} Msamples/s, peak device "
          f"memory {peak / 2**30:.3f} GiB, mean {path_mean:.6f} [{card}]",
          flush=True)
    prof = _loop_pass_profile(scene, cfg, dev, card, "cbox path")
    d_cfg = dataclasses.replace(cfg, integrator="direct")
    d_img, d_stats, d_wall, _ = _surface_render(scene, d_cfg, dev, card,
                                                "the cbox direct render")
    direct_mean = d_img.mean().item()
    print(f"cbox direct: wall {d_wall:.3f} s, mean {direct_mean:.6f} "
          f"(path {path_mean:.6f}) [{card}]", flush=True)
    if not direct_mean <= path_mean:
        raise AssertionError("direct lighting exceeds the path tracer")
    surf["config1"] = dict(wall_s=wall, passes=stats["passes"],
                           peak_bytes=peak, mean=path_mean, profile=prof,
                           direct_wall_s=d_wall, direct_mean=direct_mean)

    lap(26)

    # ---- phase 27: card against CPU, renders and BSDFs ----
    for integ in ("path", "direct"):
        s_scene, s_cfg = presets.cornell_box(res=16, spp=8, max_depth=40,
                                             integrator=integ)
        img_g = render_m.render(s_scene, s_cfg, seed=3, device=dev).cpu()
        img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
        surf[f"card_vs_cpu_{integ}"] = _card_vs_cpu(
            img_g, img_c, f"cbox {integ} render at 16x16 spp 8")
    surf["bsdf_card_vs_cpu"] = _bsdf_card_vs_cpu(dev, card)

    lap(27)

    # ---- phase 28: BASELINE config 2 on the loop engine ----
    scene2, cfg2 = presets.cornell_box(res=256, spp=64, max_depth=40,
                                       integrator="volpath",
                                       medium=CBOX_MEDIUM)
    scene2 = scene2.to(dev)
    img2, stats2, wall2, peak2 = _surface_render(
        scene2, cfg2, dev, card, "the cbox medium render")
    print(f"cbox with medium (BASELINE config 2, sigma_s 1e-3, sigma_a "
          f"1e-4, g 0.7): 256x256 spp 64 depth 40 gaussian filter, loop "
          f"engine, [bounces, Woodcock] a pass {stats2['passes']}, wall "
          f"{wall2:.3f} s, {256 * 256 * 64 / wall2 / 1e6:.4f} Msamples/s, "
          f"peak device memory {peak2 / 2**30:.3f} GiB, mean "
          f"{img2.mean().item():.6f} [{card}]", flush=True)
    prof2 = _loop_pass_profile(scene2, cfg2, dev, card, "cbox medium")
    s_scene, s_cfg = presets.cornell_box(res=16, spp=8, max_depth=40,
                                         integrator="volpath",
                                         medium=CBOX_MEDIUM)
    img_g = render_m.render(s_scene, s_cfg, seed=3, device=dev).cpu()
    img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
    surf["config2"] = dict(
        wall_s=wall2, passes=stats2["passes"], peak_bytes=peak2,
        mean=img2.mean().item(), profile=prof2,
        card_vs_cpu=_card_vs_cpu(img_g, img_c,
                                 "cbox medium render at 16x16 spp 8"))

    lap(28)

    # ---- phase 29: the box-filter cbox on the wavefront road, against
    # the loop road at the same seed ----
    for name, sc, base in (("path", scene, cfg), ("medium", scene2, cfg2)):
        w_cfg = dataclasses.replace(base, filter="box")
        w_img, w_stats, w_wall, w_peak = _surface_render(
            sc, w_cfg, dev, card, f"the wavefront cbox {name} render",
            seed=7)
        supers = sum(p[2] for p in w_stats["passes"])
        l_img = _surface_render(sc, dataclasses.replace(w_cfg, engine="loop"),
                                dev, card, f"the loop cbox {name} render",
                                seed=7)[0]
        lw, ll = w_img.mean(-1).flatten(), l_img.mean(-1).flatten()
        both = (lw > 0) & (ll > 0)
        ratio = (lw[both] / ll[both]).median().item()
        print(f"cbox {name} on the wavefront road (box filter): 256x256 spp "
              f"64, [segments, taps, super-iterations, unfinished] a pass "
              f"{w_stats['passes']}, wall {w_wall:.3f} s, peak device "
              f"memory {w_peak / 2**30:.3f} GiB, mean "
              f"{w_img.mean().item():.6f}; against the loop road at seed 7: "
              f"pixel-by-pixel median ratio {ratio:.6f}, mean ratio "
              f"{(lw.mean() / ll.mean()).item():.6f} [{card}]", flush=True)
        if w_stats["passes"][-1][3] != 0:
            raise AssertionError(f"the wavefront cbox {name} left samples "
                                 "unfinished")
        if not 0.95 <= ratio <= 1.05:
            raise AssertionError(f"the wavefront and loop roads disagree on "
                                 f"the cbox ({name})")
        wprof = _profile_wavefront(sc, w_cfg, card, f"wavefront cbox {name}")
        surf[f"wavefront_{name}"] = dict(
            wall_s=w_wall, passes=w_stats["passes"], super_iterations=supers,
            peak_bytes=w_peak, mean=w_img.mean().item(), ratio_loop=ratio,
            profile=wprof)

    lap(29)

    # ---- phase 30: the BVH ----
    b_scene, b_cfg = _bvh_scene(256, 4)
    b_scene = b_scene.to(dev)
    geo = b_scene.geo
    n_tri = geo.v0.shape[0]
    from mitsubaer_tpu_torch.integrators import common
    rays = common.camera_samples(b_scene, b_cfg, 1, 0, 0)[0]
    n = rays.o.shape[0]
    t_min = torch.full((n,), 1e-2, device=dev)
    t_max = torch.full((n,), isect.INF, device=dev)
    bstats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_b, packed, _, _ = bvh_m.intersect_bvh(geo.bvh, rays.o, rays.d, t_min,
                                            t_max, stats=bstats)
    torch.cuda.synchronize()
    bvh_s = time.perf_counter() - t0
    prim_b = geo.bvh.tri_id[packed].long()
    flat = dataclasses.replace(geo, bvh=T.empty_bvh().to(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_f, prim_f, _, _, ok_f = isect._triangles(flat, rays.o, rays.d, t_min,
                                               t_max)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    hit_b = t_b < isect.INF
    if not torch.equal(hit_b, ok_f):
        raise AssertionError("the BVH and brute force disagree on which rays "
                             "hit")
    other = (prim_b != prim_f) & hit_b
    ties = _bvh_ties(geo, other & (t_b == t_f), rays.o, rays.d, t_f, prim_b,
                     prim_f)
    rel = ((t_b - t_f).abs() / t_f.abs().clamp_min(1e-30))[hit_b]
    off = int((other & (t_b != t_f)).sum()) + ties["other"]
    if off or rel.max().item() > 1e-5:
        raise AssertionError(f"the BVH and brute force disagree: {off} "
                             f"triangle ids not tied, t rel "
                             f"{rel.max().item():.3e}")
    print(f"BVH: {n_tri} triangles ({geo.bvh.nodes.shape[0]} nodes), {n} "
          f"camera rays: traversal {bvh_s * 1e3:.2f} ms ({bstats['trips']} "
          f"trips, {bstats['lane_trips'] / n:.1f} node visits a ray), brute "
          f"force in chunks of {isect._CHUNK} {brute_s * 1e3:.2f} ms; "
          f"{int(hit_b.sum())} hits, ids equal but for ties at equal t "
          f"{ties}, t max rel diff {rel.max().item():.2e} [{card}]",
          flush=True)
    s_b_cfg = dataclasses.replace(b_cfg, width=64, height=64, spp=4,
                                  max_depth=BVH_DEPTH)
    b_img, b_stats, b_wall, _ = _surface_render(b_scene, s_b_cfg, dev, card,
                                                "the BVH path render")
    print(f"path render through the BVH: 64x64 spp 4 depth {BVH_DEPTH}, "
          f"bounces "
          f"{[p[0] for p in b_stats['passes']]}, wall {b_wall:.3f} s, mean "
          f"{b_img.mean().item():.6f} [{card}]", flush=True)
    surf["bvh"] = dict(triangles=n_tri, nodes=geo.bvh.nodes.shape[0],
                       rays=n, bvh_ms=bvh_s * 1e3, brute_ms=brute_s * 1e3,
                       trips=bstats["trips"], ties=ties,
                       visits_a_ray=bstats["lane_trips"] / n,
                       render_wall_s=b_wall, render_mean=b_img.mean().item())
    del b_scene, flat, t_f, prim_f, ok_f

    lap(30)

    # ---- phase 31: the area-lit refractive sphere (kernels D and E) ----
    a_scene, a_cfg = _er_variant(presets, 96, 2, 256, emitter="area_behind")
    d_row = results.setdefault("er_trace", {})
    e_row = results.setdefault("er_sens", {})
    trace, sens_march = ermarch.trace, ermarch.sens_march
    d_calls, e_calls = {}, {}
    ermarch.trace = _capture_calls(trace, d_calls, (0,))
    ermarch.sens_march = _capture_calls(sens_march, e_calls, (0,))
    try:
        a_img, a_wall, a_launches = _er_render(a_scene, a_cfg, dev)
    finally:
        ermarch.trace, ermarch.sens_march = trace, sens_march
    print(f"area-lit refractive sphere (96x96 spp 2 depth 6, linear RIF, "
          f"8 BVP restarts at 4x h): wall {a_wall:.3f} s, "
          f"{96 * 96 * 2 / a_wall / 1e6:.6f} Msamples/s, mean "
          f"{a_img.mean().item():.6f}, launches of D and E {a_launches} "
          f"[{card}]", flush=True)
    if min(a_launches) < 1:
        raise AssertionError(f"the area-lit sphere skipped a kernel: "
                             f"{a_launches}")
    d_row["area_light"] = dict(
        wall_s=a_wall, launches=a_launches[0], mean=a_img.mean().item(),
        calls=_check_d_calls(d_calls, card, "the area-lit sphere"))
    e_row["area_light"] = dict(
        launches=a_launches[1],
        calls=_check_e_calls(e_calls, card, "the area-lit sphere"))
    del d_calls, e_calls
    s_scene, s_cfg = _er_variant(presets, 16, 4, 128, emitter="area_behind")
    s_cfg = dataclasses.replace(s_cfg, bvp_restarts=0)
    img_g = _er_render(s_scene, s_cfg, dev, seed=3)[0].cpu()
    img_c = render_m.render(s_scene, s_cfg, seed=3, device="cpu")
    d_row["area_light"]["card_vs_cpu"] = _card_vs_cpu(
        img_g, img_c, "area-lit sphere, 16x16 spp 4, single solve")
    lap(31)
    print(json.dumps({"surface": surf}))


# phases 32-36: the rest of the model set and the sampler modes
MODEL_SKY_SUN = (0.4, 0.3, 0.7)      # toward the sun, z-up
# the sky's z-up frame turned to the cbox's y-up world (env z -> world y)
MODEL_Z_TO_Y = ((1, 0, 0), (0, 0, 1), (0, -1, 0))
MODEL_PHASE_LANES = 1 << 20
MODEL_PHASE_TOL = 1e-4     # card against CPU, phase functions (ulps of exp,
#   pow, sin and cos differ between torch's CPU and CUDA)
MODEL_STREAM_LANES, MODEL_STREAM_DIMS = 1 << 20, 16


def _oriented_box(res, spp, kind, **kw):
    """The heterogeneous bounded volume (density 64^3, depth 12) with its
    phase replaced by `kind` (microflake and Kajiya-Kay kappa 8 about the
    table's z axis, vMF kappa 6, the mixture 0.6 g 0.7 + 0.4 g -0.4) and,
    for microflake, a 64^3 orientation field swirling about the box's y
    axis."""
    import dataclasses

    import numpy as np
    import torch

    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T

    scene, cfg = presets.volumetric_box(res=res, spp=spp, max_depth=12,
                                        heterogeneous=True, **kw)
    media = scene.media
    full = torch.full_like
    phase = dataclasses.replace(
        media.phase, kind=full(media.phase.kind, kind),
        g2=full(media.phase.g, -0.4), mix=full(media.phase.g, 0.6),
        kappa=full(media.phase.g, 6.0 if kind == T.PH_VMF else 8.0))
    orient = kind == T.PH_MICROFLAKE
    if orient:
        zs = np.linspace(-1, 1, 64)
        Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
        field = np.stack([-Z, 0.3 + 0 * Y, X], -1).astype(np.float32)
        media = dataclasses.replace(media, orient=T.GridData(
            torch.from_numpy(field), media.density.aabb_min,
            media.density.aabb_max))
    scene = dataclasses.replace(scene, media=dataclasses.replace(
        media, phase=phase))
    return scene, dataclasses.replace(cfg, phase_kinds=(kind,),
                                      phase_orient=orient)


def _sky_scene(res, spp, max_depth=40, sky_res=128, **kw):
    """The sky-lit scene: make_sky_envmap(sky_res) over the cbox's floor
    (widened) and its two boxes, seen by the cbox's camera; the map's z-up
    frame turned to the cbox's y-up."""
    import dataclasses

    import numpy as np

    from mitsubaer_tpu_torch.core import transform as tf
    from mitsubaer_tpu_torch.models import emitter as emitter_m
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T
    from mitsubaer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    white = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=presets.CBOX_WHITE)
    floor = [[2500, 0, -1500], [-2000, 0, -1500], [-2000, 0, 3000],
             [2500, 0, 3000]]
    b.add_mesh(*presets._quad(floor), bsdf=white)
    b.add_mesh(*presets._box(presets._SHORT_BOX), bsdf=white)
    b.add_mesh(*presets._box(presets._TALL_BOX_TOP), bsdf=white)
    b.add_emitter(T.EM_ENVMAP, scale=0.05,
                  envmap=emitter_m.make_sky_envmap(MODEL_SKY_SUN, res=sky_res),
                  to_world=np.array(MODEL_Z_TO_Y, np.float32))
    b.set_perspective_sensor(
        to_world=tf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
        fov_deg=39.3077, fov_axis="x", near=10.0)
    b.config = dataclasses.replace(b.config, width=res, height=res, spp=spp,
                                   max_depth=max_depth, integrator="path",
                                   **kw)
    return b.build(), b.config


def _model_render(scene, cfg, dev, card, what, seed=0, kernels=()):
    """render() on the card, every kernel count at 0 just before and read
    just after: the kernels named in `kernels` must launch, no other may.
    Returns (image, stats, wall s, peak device bytes, counts)."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m

    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=seed, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if (tuple(img.shape[:2]) != (cfg.height, cfg.width)
            or not bool(torch.isfinite(img).all()) or not img.mean() > 0):
        raise AssertionError(f"{what}: a non-finite, black or misshapen "
                             "image")
    missing = [k for k in kernels if counts[k] < 1]
    extra = [k for k, v in counts.items() if v and k not in kernels]
    if missing or extra:
        raise AssertionError(f"{what}: kernels {missing} did not launch, "
                             f"{extra} launched: {counts}")
    print(f"{what}: wall {wall:.3f} s, peak device memory "
          f"{peak / 2**30:.3f} GiB, mean {img.mean().item():.6f}, launches "
          f"{ {k: counts[k] for k in kernels} } [{card}]", flush=True)
    return img, stats, wall, peak, counts


def _model_card_vs_cpu(scene, cfg, dev, what, seed=3):
    from mitsubaer_tpu_torch.integrators import render as render_m

    img_g = render_m.render(scene, cfg, seed=seed, device=dev).cpu()
    img_c = render_m.render(scene, cfg, seed=seed, device="cpu")
    return _card_vs_cpu(img_g, img_c, what)


def _phase_kinds_card_vs_cpu(dev, card):
    """Every phase kind's eval and sample at 2^20 seeded lanes (kinds
    mixed, a per-lane axis on half the calls), card against CPU."""
    import numpy as np
    import torch

    from mitsubaer_tpu_torch.models import phase as phase_m
    from mitsubaer_tpu_torch.scene import types as T

    n = MODEL_PHASE_LANES
    r = np.random.default_rng(32)

    def unit(k):
        v = r.normal(size=(k, 3))
        return torch.from_numpy(
            (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32))

    nk = 7
    table = T.PhaseTable(
        kind=torch.arange(nk, dtype=torch.int32),
        g=torch.linspace(-0.6, 0.8, nk), g2=torch.linspace(0.5, -0.7, nk),
        mix=torch.linspace(0.2, 0.9, nk),
        kappa=torch.tensor([4.0, 4, 4, 50, 4, 4, 8]), axis=unit(nk))
    idx = torch.from_numpy(r.integers(0, nk, n))
    wi, wo, ax = unit(n), unit(n), unit(n)
    u2 = torch.from_numpy(r.random((n, 2), dtype=np.float32))
    worst, ms = 0.0, 0.0
    for override in (None, ax):
        outs = []
        for d in (dev, "cpu"):
            args = [t.to(d) for t in (idx, wi, wo, u2)]
            ov = None if override is None else override.to(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = phase_m.eval(table.to(d), args[0], args[1], args[2],
                             axis_override=ov)
            ps = phase_m.sample(table.to(d), args[0], args[1], args[3],
                                axis_override=ov)
            torch.cuda.synchronize()
            if d == dev:
                ms = max(ms, (time.perf_counter() - t0) * 1e3)
            outs.append([t.cpu() for t in (v, ps.wo, ps.pdf, ps.weight)])
        for g, c in zip(*outs):
            worst = max(worst, ((g - c).abs() / c.abs().clamp_min(1.0))
                        .max().item())
    print(f"phase functions, 7 kinds at {n} lanes (eval + sample, table axis "
          f"and per-lane axes): card against CPU largest difference "
          f"{worst:.3e} (relative above 1), {ms:.2f} ms a call pair on the "
          f"card [{card}]", flush=True)
    if not worst <= MODEL_PHASE_TOL:
        raise AssertionError("the phase functions differ between the card "
                             "and the CPU")
    return dict(lanes=n, max_diff=worst, card_ms=ms)


def _stream_card_vs_cpu(dev, card):
    """Each sampler mode's stream at 2^20 lanes x 16 dimensions (2D draws),
    card against CPU bit for bit, with the card's time for the 16."""
    import numpy as np
    import torch

    from mitsubaer_tpu_torch.core import rng

    r = np.random.default_rng(35)
    lane = torch.from_numpy(r.integers(0, 2 ** 32, MODEL_STREAM_LANES,
                                       dtype=np.uint64).astype(np.int64))
    index = torch.from_numpy(r.integers(0, 64, MODEL_STREAM_LANES))
    out = {}
    for name in ("independent", "lds", "stratified", "halton",
                 "hammersley", "sobol"):
        draws = {}
        for d in (dev, "cpu"):
            s = rng.make_sampler(7, lane.to(d), index.to(d),
                                 mode=rng.MODES[name], n_samples=64)
            vals = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MODEL_STREAM_DIMS // 2):
                v, s = rng.next_2d(s)
                vals.append(v)
            torch.cuda.synchronize()
            draws[str(d)] = (torch.cat(vals, -1).cpu(),
                             (time.perf_counter() - t0) * 1e3)
        g, c = draws[str(dev)][0], draws["cpu"][0]
        equal = torch.equal(g, c)
        out[name] = dict(card_ms=draws[str(dev)][1], cpu_ms=draws["cpu"][1],
                         bit_exact=equal)
        print(f"sampler {name}: {MODEL_STREAM_LANES} lanes x "
              f"{MODEL_STREAM_DIMS} dims, card {draws[str(dev)][1]:.1f} ms, "
              f"CPU {draws['cpu'][1]:.1f} ms, card == CPU bit for bit "
              f"{equal} [{card}]", flush=True)
        if not equal:
            raise AssertionError(f"the {name} stream differs between the "
                                 "card and the CPU")
    return out


def _model_phases(dev, card, results):
    """Phases 32-36: every phase kind and the orientation field, every
    sensor, the environment map and sky, the sampler modes, ao / field /
    multichannel / adaptive and the light image's other emitters."""
    import dataclasses

    import numpy as np
    import torch

    from mitsubaer_tpu_torch.integrators import misc as misc_m
    from mitsubaer_tpu_torch.integrators import volpath_er as er_m
    from mitsubaer_tpu_torch.models import emitter as emitter_m
    from mitsubaer_tpu_torch.models import ermarch
    from mitsubaer_tpu_torch.scene import build as build_m
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T

    models = {"phase_s": {}}
    lap = _lap_clock(models["phase_s"])

    # ---- phase 32: the phase kinds and the orientation field ----
    scene, cfg = _oriented_box(512, 32, T.PH_MICROFLAKE)
    scene = scene.to(dev)
    img, stats, wall, peak, counts = _model_render(
        scene, cfg, dev, card,
        "microflake box with an orientation field, loop road, 512x512 spp "
        "32 depth 12", kernels=("trilinear_lookup",))
    models["microflake_loop"] = dict(
        wall_s=wall, peak_bytes=peak, mean=img.mean().item(),
        passes=stats["passes"], launches_a=counts["trilinear_lookup"],
        card_vs_cpu=_model_card_vs_cpu(
            *_oriented_box(24, 4, T.PH_MICROFLAKE), dev,
            "microflake box with an orientation field, 24x24 spp 4"))
    results.setdefault("trilinear_lookup", {})["launches_models"] = counts[
        "trilinear_lookup"]
    scene, cfg = _oriented_box(512, 32, T.PH_RAYLEIGH, filter="box")
    scene = scene.to(dev)
    img, stats, wall, peak, counts = _model_render(
        scene, cfg, dev, card,
        "Rayleigh beam box, box filter (wavefront road), 512x512 spp 32 "
        "depth 12", kernels=("trilinear_lookup", "megatrack"))
    if stats["passes"][-1][3] != 0:
        raise AssertionError("the Rayleigh wavefront render left samples "
                             "unfinished")
    models["rayleigh_wavefront"] = dict(
        wall_s=wall, peak_bytes=peak, mean=img.mean().item(),
        passes=stats["passes"], launches_c=counts["megatrack"],
        launches_a=counts["trilinear_lookup"],
        card_vs_cpu=_model_card_vs_cpu(
            *_oriented_box(24, 4, T.PH_RAYLEIGH, filter="box"), dev,
            "Rayleigh beam box on the wavefront road, 24x24 spp 4"))
    results.setdefault("megatrack", {})["launches_models"] = counts[
        "megatrack"]
    small = {}
    for kind, name in ((T.PH_VMF, "vmf"), (T.PH_MIXTURE, "mixture"),
                       (T.PH_KKAY, "kajiya_kay")):
        k_scene, k_cfg = _oriented_box(64, 8, kind)
        k_img, _, k_wall, _, _ = _model_render(
            k_scene.to(dev), k_cfg, dev, card,
            f"{name} box, loop road, 64x64 spp 8",
            kernels=("trilinear_lookup",))
        small[name] = dict(wall_s=k_wall, mean=k_img.mean().item(),
                           card_vs_cpu=_model_card_vs_cpu(
                               *_oriented_box(16, 4, kind), dev,
                               f"{name} box, 16x16 spp 4"))
    models["small_kinds"] = small
    models["phase_functions"] = _phase_kinds_card_vs_cpu(dev, card)
    lap(32)

    # ---- phase 33: every sensor kind on config 1 ----
    sensors = {}
    base, base_cfg = presets.cornell_box(res=64, spp=16, max_depth=40)
    for kind in range(9):
        sensor = dataclasses.replace(
            base.sensor, kind=torch.tensor(kind, dtype=torch.int32),
            aperture=torch.tensor(15.0), focus=torch.tensor(1000.0))
        s_scene = dataclasses.replace(base, sensor=sensor)
        s_cfg = dataclasses.replace(base_cfg, sensor_kind=kind)
        s_img, _, s_wall, _, _ = _model_render(
            s_scene.to(dev), s_cfg, dev, card,
            f"cbox path, sensor kind {kind}, 64x64 spp 16 depth 40")
        sensors[kind] = dict(wall_s=s_wall, mean=s_img.mean().item())
    thin = dataclasses.replace(
        base.sensor, kind=torch.tensor(T.SENSOR_THINLENS, dtype=torch.int32),
        aperture=torch.tensor(15.0), focus=torch.tensor(1000.0))
    # the builder sets sensor_kind from its own (perspective) sensor
    t_scene, t_cfg = presets.cornell_box(res=256, spp=64, max_depth=40)
    t_scene = dataclasses.replace(t_scene, sensor=thin).to(dev)
    t_cfg = dataclasses.replace(t_cfg, sensor_kind=T.SENSOR_THINLENS)
    t_img, t_stats, t_wall, t_peak, _ = _model_render(
        t_scene, t_cfg, dev, card,
        "cbox path with a thin lens (aperture 15, focus 1000; BASELINE "
        "config 1), 256x256 spp 64 depth 40")
    s_scene, s_cfg = presets.cornell_box(res=16, spp=8, max_depth=40)
    s_cfg = dataclasses.replace(s_cfg, sensor_kind=T.SENSOR_THINLENS)
    sensors["thinlens_full"] = dict(
        wall_s=t_wall, peak_bytes=t_peak, mean=t_img.mean().item(),
        msamples_s=256 * 256 * 64 / t_wall / 1e6,
        card_vs_cpu=_model_card_vs_cpu(
            dataclasses.replace(s_scene, sensor=thin), s_cfg, dev,
            "thin-lens cbox, 16x16 spp 8"))
    models["sensors"] = sensors
    lap(33)

    # ---- phase 34: the sky-lit scene ----
    sky, sky_cfg = _sky_scene(256, 64)
    sky = sky.to(dev)
    k_img, k_stats, k_wall, k_peak, _ = _model_render(
        sky, sky_cfg, dev, card,
        "sky-lit floor and boxes (make_sky_envmap 128), loop road, 256x256 "
        "spp 64 depth 40")
    rng_u = np.random.default_rng(34)
    img16 = (rng_u.random((16, 32, 3)) ** 2).astype(np.float32) * 3.0
    b = build_m.SceneBuilder()
    b.add_emitter(T.EM_ENVMAP, envmap=img16)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    env_scene = b.build().to(dev)
    u2 = torch.from_numpy(rng_u.random((1 << 20, 2)).astype(np.float32)
                          ).to(dev)
    d, pdf, val = emitter_m.sample_env_direction(env_scene, u2)
    lum = val @ torch.tensor([0.2126, 0.7152, 0.0722], device=dev)
    est = (lum / pdf.clamp_min(1e-9)).mean().item()
    th = (np.arange(16) + 0.5) / 16 * np.pi
    ref = float((img16 @ np.array([0.2126, 0.7152, 0.0722])
                 * np.sin(th)[:, None] * (np.pi / 16) * (2 * np.pi / 32)).sum())
    pdf2 = emitter_m.env_pdf_direction(env_scene, d)
    agree = ((pdf - pdf2).abs() / pdf.abs().clamp_min(1e-5) < 1e-3
             ).float().mean().item()
    print(f"envmap sampling on the card (2^20 samples of a 16x32 map): "
          f"E[lum / pdf] {est:.6f} against the integral {ref:.6f}, pdf of "
          f"the sampled directions equal to the sampler's on {agree:.6f} of "
          f"them [{card}]", flush=True)
    if abs(est / ref - 1) > 0.05 or agree <= 0.995:
        raise AssertionError("the envmap's sampling is off on the card")
    w_cfg = dataclasses.replace(sky_cfg, width=128, height=128, spp=16,
                                filter="box")
    w_img, w_stats, w_wall, _, _ = _model_render(
        sky, w_cfg, dev, card,
        "sky-lit scene, wavefront road, 128x128 spp 16 depth 40", seed=7)
    l_img = _model_render(sky, dataclasses.replace(w_cfg, engine="loop"),
                          dev, card, "sky-lit scene, loop road, 128x128 spp "
                          "16 depth 40", seed=7)[0]
    lw, ll = w_img.mean(-1).flatten(), l_img.mean(-1).flatten()
    both = (lw > 0) & (ll > 0)
    ratio = (lw[both] / ll[both]).median().item()
    print(f"sky-lit scene, wavefront against loop road at seed 7: median "
          f"pixel ratio {ratio:.6f} [{card}]", flush=True)
    if not 0.95 <= ratio <= 1.05 or w_stats["passes"][-1][3] != 0:
        raise AssertionError("the wavefront and loop roads disagree on the "
                             "sky-lit scene")
    s_sky, s_cfg = _sky_scene(16, 8, sky_res=32)
    models["sky"] = dict(
        wall_s=k_wall, peak_bytes=k_peak, mean=k_img.mean().item(),
        passes=k_stats["passes"], msamples_s=256 * 256 * 64 / k_wall / 1e6,
        sampling=dict(estimate=est, integral=ref, pdf_agree=agree),
        wavefront_wall_s=w_wall, wavefront_passes=w_stats["passes"],
        ratio_loop=ratio,
        card_vs_cpu=_model_card_vs_cpu(s_sky, s_cfg, dev,
                                       "sky-lit scene, 16x16 spp 8"))
    del sky
    lap(34)

    # ---- phase 35: the sampler modes ----
    streams = _stream_card_vs_cpu(dev, card)
    c1, c1_cfg = presets.cornell_box(res=256, spp=64, max_depth=40)
    c1 = c1.to(dev)
    walls = {}
    for name in ("independent", "ldsampler", "ldsampler", "independent"):
        img_s, _, wall_s, _, _ = _model_render(
            c1, dataclasses.replace(c1_cfg, sampler=name), dev, card,
            f"cbox path (BASELINE config 1), sampler {name}")
        walls.setdefault(name, []).append(wall_s)
    s_scene, s_cfg = presets.cornell_box(res=16, spp=8, max_depth=40,
                                         sampler="ldsampler")
    lw_cfg = dataclasses.replace(c1_cfg, width=64, height=64, spp=4,
                                 filter="box", sampler="ldsampler")
    lw_img, lw_stats, lw_wall, _, _ = _model_render(
        c1, lw_cfg, dev, card, "box-filter cbox, ldsampler, wavefront road, "
        "64x64 spp 4 depth 40")
    if lw_stats["passes"][-1][3] != 0:
        raise AssertionError("the ldsampler wavefront cbox left samples "
                             "unfinished")
    models["samplers"] = dict(
        streams=streams, config1_walls=walls,
        ldsampler_over_independent=(sum(walls["ldsampler"])
                                    / sum(walls["independent"])),
        wavefront_wall_s=lw_wall, wavefront_mean=lw_img.mean().item(),
        card_vs_cpu=_model_card_vs_cpu(s_scene, s_cfg, dev,
                                       "ldsampler cbox, 16x16 spp 8"))
    print(f"config 1 with the ldsampler against independent: walls {walls},"
          f" ratio {models['samplers']['ldsampler_over_independent']:.4f} "
          f"[{card}]", flush=True)
    del c1
    lap(35)

    # ---- phase 36: ao, field, multichannel, adaptive; the light image of
    # an area, a spot and a directional emitter ----
    misc = {}
    m_scene, m_cfg = presets.cornell_box(res=128, spp=64, max_depth=40)
    m_scene = m_scene.to(dev)
    for integ, field in [("ao", "shNormal")] + [
            ("field", f) for f in misc_m.FIELDS]:
        f_img, _, f_wall, _, _ = _model_render(
            m_scene, dataclasses.replace(m_cfg, integrator=integ,
                                         field=field), dev, card,
            f"cbox {integ} {field if integ == 'field' else ''}, 128x128 "
            f"spp 64")
        misc[f"{integ}_{field}"] = dict(wall_s=f_wall,
                                        mean=f_img.mean().item())
    s_scene, s_cfg = presets.cornell_box(res=16, spp=8, max_depth=40,
                                         integrator="ao")
    misc["ao_card_vs_cpu"] = _model_card_vs_cpu(s_scene, s_cfg, dev,
                                                "cbox ao, 16x16 spp 8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = misc_m.render_multichannel(m_scene, m_cfg, device=dev)
    torch.cuda.synchronize()
    mc_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ad = misc_m.render_adaptive(m_scene, m_cfg, base_spp=16,
                                max_sample_factor=4, device=dev)
    torch.cuda.synchronize()
    ad_wall = time.perf_counter() - t0
    if (tuple(mc.shape) != (m_cfg.height, m_cfg.width, 9)
            or not bool(torch.isfinite(mc).all())
            or not bool(torch.isfinite(ad).all()) or not ad.mean() > 0):
        raise AssertionError("multichannel or adaptive: a bad image")
    print(f"multichannel (radiance, shNormal, distance) 128x128 spp 64: wall "
          f"{mc_wall:.3f} s; adaptive (4 passes of spp 16 at most): wall "
          f"{ad_wall:.3f} s, mean {ad.mean().item():.6f} [{card}]",
          flush=True)
    misc.update(multichannel_wall_s=mc_wall, adaptive_wall_s=ad_wall,
                adaptive_mean=ad.mean().item())
    del m_scene
    d_row = results.setdefault("er_trace", {})
    e_row = results.setdefault("er_sens", {})
    lights = {}
    for kind in ("area", "spot", "directional"):
        l_scene, l_cfg = _light_scene(presets, 96, 0.5)
        if kind == "area":
            l_scene = presets.refractive_sphere(
                res=96, spp=1, max_depth=4, rif_kind=2,
                rif_params=(1.33, 0.5, 0.5, 0.0, 0.0, 0.0), er_stepsize=0.02,
                emitter="area_behind", backdrop=False, filter="box")[0]
        else:
            b = build_m.SceneBuilder()
            if kind == "spot":
                b.add_emitter(T.EM_SPOT, radiance=(400.0,) * 3,
                              position=(0, 3, 0), direction=(0, -1, 0),
                              cutoff_deg=30.0)
            else:
                b.add_emitter(T.EM_DIRECTIONAL, radiance=(20.0,) * 3,
                              direction=(0.2, -1, 0.1))
            l_scene = dataclasses.replace(l_scene,
                                          emitters=b.build().emitters)
        trace, sens_march = ermarch.trace, ermarch.sens_march
        d_calls, e_calls = {}, {}
        ermarch.trace = _capture_calls(trace, d_calls, (0,))
        ermarch.sens_march = _capture_calls(sens_march, e_calls, (0,))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            film = er_m.render_er_light_image(l_scene, l_cfg, seed=0,
                                              n_passes=2, device=dev)
            torch.cuda.synchronize()
            l_wall = time.perf_counter() - t0
            launches = (ermarch.trace.launches, ermarch.sens_march.launches)
        finally:
            ermarch.trace, ermarch.sens_march = trace, sens_march
        total = film.sum().item()
        print(f"light image, {kind} emitter (96x96, 2 passes, radial RIF a "
              f"0.5): wall {l_wall:.3f} s, film sum {total:.6f}, launches "
              f"of D and E {launches} [{card}]", flush=True)
        if not bool(torch.isfinite(film).all()) or not total > 0:
            raise AssertionError(f"the {kind}-lit light image is black")
        if min(launches) < 1:
            raise AssertionError(f"the {kind}-lit light image skipped a "
                                 f"kernel: {launches}")
        lights[kind] = dict(wall_s=l_wall, film_sum=total,
                            launches=launches)
        d_row[f"light_image_{kind}"] = dict(
            launches=launches[0], wall_s=l_wall,
            calls=_check_d_calls(d_calls, card, f"the {kind}-lit light "
                                 "image"))
        e_row[f"light_image_{kind}"] = dict(
            launches=launches[1],
            calls=_check_e_calls(e_calls, card, f"the {kind}-lit light "
                                 "image"))
        del d_calls, e_calls
    misc["light_image"] = lights
    models["misc"] = misc
    lap(36)
    print(json.dumps({"models": models}))


# phases 37-40: the transient main path's film (frames of 0.5 over [0, 64):
# every path length of the scene, PERF.md section 4), the frame-sum
# identity's tolerance (of the steady image's largest pixel: the order of
# the atomic adds), the CW-ToF wavelength of the full-width weights, and
# the refractive sphere's frames for bdpt
TRANSIENT = dict(decomposition="transient", min_bound=0.0, max_bound=64.0,
                 bin_width=0.5)
BOUNCE = dict(decomposition="bounce", min_bound=0.0, max_bound=14.0,
              bin_width=1.0)
FRAME_SUM_TOL = 1e-4
TOF_LAMBDA = 8.0
ER_FRAMES = dict(decomposition="transient", min_bound=2.0, max_bound=14.0,
                 bin_width=0.1875)


def _frames_render(scene, cfg, dev, card, what, seed=0, kernels=()):
    """render() on the card with every kernel count at 0 just before and
    read just after, for films whose mean may be 0 or negative (frames,
    CW-ToF): finite, of shape (H, W, 3F), not all zero; the kernels named
    must launch and no other. Returns (image, stats, wall s, peak device
    bytes, counts)."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m

    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=seed, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3 * cfg.n_frames)
            or not bool(torch.isfinite(img).all())
            or not bool((img != 0).any())):
        raise AssertionError(f"{what}: a non-finite, black or misshapen "
                             f"image {tuple(img.shape)}")
    missing = [k for k in kernels if counts[k] < 1]
    extra = [k for k, v in counts.items() if v and k not in kernels]
    if missing or extra:
        raise AssertionError(f"{what}: kernels {missing} did not launch, "
                             f"{extra} launched: {counts}")
    print(f"{what}: wall {wall:.3f} s, {len(stats['passes'])} passes "
          f"{stats['passes'] if len(stats['passes']) <= 8 else ''}, peak "
          f"device memory {peak / 2**30:.3f} GiB, sum "
          f"{img.sum().item():.6f}, launches "
          f"{ {k: counts[k] for k in kernels} } [{card}]", flush=True)
    return img, stats, wall, peak, counts


def _signed_card_vs_cpu(img_g, img_c, what, rel=0.02):
    """Phase 8's rule for images that may be negative (CW-ToF): the median
    ratio over the pixels where the CPU's luminance is at least 1e-3 of
    its largest magnitude within 1 +- rel, and the sum of the difference
    within rel of the sum of magnitudes."""
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c.abs() > 1e-3 * lum_c.abs().max()
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    diff = abs((img_g - img_c).sum().item()) / img_c.abs().sum().item()
    print(f"card vs CPU {what}: median pixel ratio {ratio:.6f}, summed "
          f"difference {diff:.2e} of the summed magnitude", flush=True)
    if not (1 - rel <= ratio <= 1 + rel and diff <= rel):
        raise AssertionError(f"card and CPU disagree: {what}")
    return ratio, diff


def _bdpt_first_pass(scene, cfg, dev, seed=0):
    """The first pass of render_bdpt(scene, cfg, seed) (bdpt._bdpt_pass,
    one sample a pixel, the same lanes) as a function of no argument, on
    films of its own."""
    import torch

    from mitsubaer_tpu_torch.integrators import bdpt as bdpt_m
    from mitsubaer_tpu_torch.scene import types as T

    npix = cfg.width * cfg.height
    nF = cfg.n_frames
    T_MAX = S_MAX = min(cfg.max_depth, 8) + 2
    kinds = scene.media.kind
    eye = torch.zeros((npix, 3 * nF), device=dev)
    splat = torch.zeros((npix, 3 * nF), device=dev)
    return lambda: bdpt_m._bdpt_pass(
        scene, eye, splat, cfg, T_MAX, S_MAX, seed, 0,
        any_het=bool((kinds == T.MED_HETEROGENEOUS).any()),
        any_er=bool((kinds == T.MED_REFRACTIVE).any()))


def _bdpt_pass_profile(scene, cfg, dev, card, what):
    """One bdpt pass under the profiler: its wall, launches, device time
    and busy share."""
    _, m = _profile_pass(_bdpt_first_pass(scene, cfg, dev), card, what)
    print(f"{what}, one pass profiled: wall {m['wall_s']:.3f} s, "
          f"{m['launches']} device launches, device time "
          f"{m['device_s']:.3f} s, busy share {m['busy']:.3f} [{card}]",
          flush=True)
    return m


def _bdpt_scenes(presets, res, spp, dev=None):
    """Phase 39's three bdpt paths at res^2: the refractive sphere
    (bench_er_forward's, depth 6, transient ER_FRAMES; spp 2 at full
    width), the heterogeneous box lit by a point emitter (density 64^3,
    depth 6) and BASELINE config 1's cbox (depth 8), at spp."""
    from dataclasses import replace

    sphere, s_cfg = _er_bench_scene(presets, res, 2, 256)
    s_cfg = replace(s_cfg, integrator="bdpt", **ER_FRAMES)
    box, b_cfg = presets.volumetric_box(
        res=res, spp=spp, heterogeneous=True, density_res=64, max_depth=6,
        emitter_kind="point", filter="box", integrator="bdpt")
    cbox, c_cfg = presets.cornell_box(res=res, spp=2 * spp, max_depth=8,
                                      integrator="bdpt")
    return dict(sphere=(sphere, s_cfg), box=(box, b_cfg),
                cbox=(cbox, c_cfg))


def _transient_phases(dev, card, results):
    """Phases 37-40: transient, bounce and CW-ToF films through the ported
    roads, bdpt and the particle tracer."""
    from dataclasses import replace

    import torch

    from mitsubaer_tpu_torch.integrators import common
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import ermarch, medium
    from mitsubaer_tpu_torch.scene import presets

    out = {"phase_s": {}}
    lap = _lap_clock(out["phase_s"])

    a_row = results.setdefault("trilinear_lookup", {})
    d_row = results.setdefault("er_trace", {})
    e_row = results.setdefault("er_sens", {})

    # ---- phase 37: the transient main path at full width ----
    scene, cfg = presets.volumetric_box(res=512, spp=32, heterogeneous=True,
                                        density_res=64, max_depth=12,
                                        **TRANSIENT)
    scene = scene.to(dev)
    img, stats, wall, peak, counts = _frames_render(
        scene, cfg, dev, card, f"transient loop road, 512x512 spp 32 depth "
        f"12, {cfg.n_frames} frames, gaussian filter",
        kernels=("trilinear_lookup",))
    a_row["launches_transient"] = counts["trilinear_lookup"]
    main = dict(wall_s=wall, passes=stats["passes"], peak_bytes=peak,
                frames=cfg.n_frames, launches_a=counts["trilinear_lookup"],
                sum=img.sum().item())
    del img
    # the frame-sum identity: box filter, loop engine, transient against
    # steady at one seed; the contributions the sink drops outside
    # [min_bound, max_bound) are counted as they pass
    b_cfg = replace(cfg, filter="box", engine="loop", spp=8)
    add, outside = common.add_contribution, [torch.zeros((), device=dev)]

    def counting_add(sink, cfg_, value, plen, depth, active, log_p=None):
        if cfg_.n_frames > 1:
            key = (depth.to(torch.float32)
                   if cfg_.decomposition == "bounce" else plen)
            off = active & ((key < cfg_.min_bound) | (key >= cfg_.max_bound))
            v = torch.where(torch.isfinite(value), value, 0.0)
            outside[0] += torch.where(off.unsqueeze(-1), v, 0.0).sum()
        return add(sink, cfg_, value, plen, depth, active, log_p)

    common.add_contribution = counting_add
    try:
        frames, f_stats, f_wall, _, _ = _frames_render(
            scene, b_cfg, dev, card, "transient loop road, box filter, "
            "512x512 spp 8", seed=5, kernels=("trilinear_lookup",))
    finally:
        common.add_contribution = add
    steady, _, s_wall, _, _ = _frames_render(
        scene, replace(b_cfg, decomposition="steadystate"), dev, card,
        "steady loop road, box filter, 512x512 spp 8", seed=5,
        kernels=("trilinear_lookup",))
    fsum = frames.view(cfg.height, cfg.width, cfg.n_frames, 3).sum(2)
    scale = steady.abs().max().item()
    err = (fsum - steady).abs().max().item() / scale
    lost = outside[0].item()
    print(f"frame-sum identity ({cfg.width}x{cfg.height} spp {b_cfg.spp}, "
          f"seed 5): max |sum of the "
          f"{cfg.n_frames} frames - steady| {err:.3e} of the largest pixel "
          f"{scale:.6f}; image sums {fsum.sum().item():.6f} / "
          f"{steady.sum().item():.6f}; energy outside [0, 64) {lost} "
          f"[{card}]", flush=True)
    if err > FRAME_SUM_TOL or lost != 0.0:
        raise AssertionError("the transient frames do not sum to the "
                             "steady image")
    main.update(identity_err=err, outside_energy=lost,
                identity_walls_s=(f_wall, s_wall))
    del frames, steady, fsum
    small = {}
    for name, kw in (("bounce", BOUNCE),
                     ("sine", dict(modulation="sine", lambda_=TOF_LAMBDA)),
                     ("depthselective", dict(modulation="depthselective",
                                             lambda_=TOF_LAMBDA))):
        k_scene, k_cfg = presets.volumetric_box(
            res=128, spp=8, heterogeneous=True, density_res=64,
            max_depth=12, **kw)
        k_img, k_stats, k_wall, _, _ = _frames_render(
            k_scene.to(dev), k_cfg, dev, card, f"{name} film, loop road, "
            "128x128 spp 8", kernels=("trilinear_lookup",))
        small[name] = dict(wall_s=k_wall, passes=k_stats["passes"],
                           sum=k_img.sum().item())
    for name in ("square", "hamiltonian", "mseq"):
        k_scene, k_cfg = presets.volumetric_box(
            res=64, spp=4, heterogeneous=True, density_res=64,
            max_depth=12, modulation=name, lambda_=TOF_LAMBDA)
        k_img, _, k_wall, _, _ = _frames_render(
            k_scene.to(dev), k_cfg, dev, card, f"{name} film, loop road, "
            "64x64 spp 4", kernels=("trilinear_lookup",))
        small[name] = dict(wall_s=k_wall, sum=k_img.sum().item())
    main["small"] = small
    out["transient_main"] = main
    del scene
    lap(37)

    # ---- phase 38: card against CPU ----
    cmp = {}
    for name, kw in (("transient", TRANSIENT), ("bounce", BOUNCE),
                     ("sine", dict(modulation="sine", lambda_=TOF_LAMBDA))):
        c_scene, c_cfg = presets.volumetric_box(
            res=16, spp=4, heterogeneous=True, density_res=64, max_depth=12,
            **kw)
        img_g = render_m.render(c_scene, c_cfg, seed=3, device=dev).cpu()
        img_c = render_m.render(c_scene, c_cfg, seed=3, device="cpu")
        cmp[name] = _signed_card_vs_cpu(img_g, img_c, f"{name} loop road, "
                                        "16x16 spp 4")
    p_scene, p_cfg = presets.cornell_box(res=16, spp=8, max_depth=40,
                                         decomposition="transient",
                                         min_bound=0.0, max_bound=4000.0,
                                         bin_width=250.0)
    cmp["path_transient"] = _card_vs_cpu(
        render_m.render(p_scene, p_cfg, seed=3, device=dev).cpu(),
        render_m.render(p_scene, p_cfg, seed=3, device="cpu"),
        "transient cbox path, 16x16 spp 8")
    e_scene, e_cfg = _er_bench_scene(presets, 16, 2, 128)
    e_cfg = replace(e_cfg, bvp_restarts=0, **ER_FRAMES)
    t0 = time.perf_counter()
    cmp["er_transient"] = _card_vs_cpu(
        render_m.render(e_scene, e_cfg, seed=3, device=dev).cpu(),
        render_m.render(e_scene, e_cfg, seed=3, device="cpu"),
        f"transient eikonal road, single solve, 16x16 spp 2 "
        f"({time.perf_counter() - t0:.1f} s)")
    out["card_vs_cpu"] = cmp
    lap(38)

    # ---- phase 39: bdpt on the refractive sphere (D, E), the
    # heterogeneous box (A) and the cbox ----
    bd = {}
    paths = _bdpt_scenes(presets, 256, 8)
    paths["sphere"] = _bdpt_scenes(presets, 96, 8)["sphere"]
    trace, sens_march = ermarch.trace, ermarch.sens_march
    d_calls, e_calls = {}, {}
    ermarch.trace = _capture_calls(trace, d_calls, (0,))
    ermarch.sens_march = _capture_calls(sens_march, e_calls, (0,))
    try:
        s_scene, s_cfg = paths["sphere"]
        img, stats, wall, peak, counts = _frames_render(
            s_scene.to(dev), s_cfg, dev, card, f"bdpt, refractive sphere "
            f"96x96 spp 2 depth 6, {s_cfg.n_frames} frames",
            kernels=("er_trace", "er_sens"))
        launches = (ermarch.trace.launches, ermarch.sens_march.launches)
    finally:
        ermarch.trace, ermarch.sens_march = trace, sens_march
    bd["sphere"] = dict(wall_s=wall, passes=len(stats["passes"]),
                        peak_bytes=peak, launches=launches,
                        sum=img.sum().item())
    d_row["bdpt"] = dict(launches=launches[0], wall_s=wall,
                         calls=_check_d_calls(d_calls, card, "bdpt"))
    e_row["bdpt"] = dict(launches=launches[1],
                         calls=_check_e_calls(e_calls, card, "bdpt"))
    del d_calls, e_calls
    for name, kernels in (("box", ("trilinear_lookup",)), ("cbox", ())):
        p_scene, p_cfg = paths[name]
        p_scene = p_scene.to(dev)
        img, stats, wall, peak, counts = _frames_render(
            p_scene, p_cfg, dev, card, f"bdpt, {name} {p_cfg.width}x"
            f"{p_cfg.height} spp {p_cfg.spp} depth {p_cfg.max_depth}",
            kernels=kernels)
        bd[name] = dict(wall_s=wall, passes=len(stats["passes"]),
                        peak_bytes=peak, mean=img.mean().item(),
                        launches_a=counts["trilinear_lookup"])
        if name == "box":
            # the first pass again with kernel A's calls captured: each
            # held against the plain version, the first and the largest
            # point counts timed
            a_row["launches_bdpt"] = counts["trilinear_lookup"]
            lookup, a_calls = medium.DensityGrid.lookup, {}
            medium.DensityGrid.lookup = _capture_lookups(a_calls)
            try:
                _bdpt_first_pass(p_scene, p_cfg, dev)()
            finally:
                medium.DensityGrid.lookup = lookup
            timed = {next(iter(a_calls), 0), max(a_calls, default=0)}
            a_row["bdpt_shapes"] = dict(
                counts=len(a_calls),
                calls=sum(c[0] for c in a_calls.values()),
                checked=sum(len(c[1]) for c in a_calls.values()),
                timed=_check_lookups(a_calls, card, "bdpt's box pass",
                                     timed))
            del a_calls
        else:
            t0 = time.perf_counter()
            bd[name]["profile"] = _bdpt_pass_profile(
                p_scene, p_cfg, dev, card, f"bdpt, {name}")
            print(f"(the profiled pass and its trace: "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
        del p_scene
    for name, (c_scene, c_cfg) in _bdpt_scenes(presets, 16, 1).items():
        if name == "sphere":
            c_scene, c_cfg = _bdpt_scenes(presets, 8, 2)["sphere"]
            c_cfg = replace(c_cfg, bvp_restarts=0, spp=1)
        t0 = time.perf_counter()
        bd[name]["card_vs_cpu"] = _card_vs_cpu(
            render_m.render(c_scene, c_cfg, seed=3, device=dev).cpu(),
            render_m.render(c_scene, c_cfg, seed=3, device="cpu"),
            f"bdpt, {name}, {c_cfg.width}x{c_cfg.height} spp {c_cfg.spp} "
            f"({time.perf_counter() - t0:.1f} s)")
    out["bdpt"] = bd
    lap(39)

    # ---- phase 40: the particle tracer on the cbox ----
    t_scene, t_cfg = presets.cornell_box(res=256, spp=4,
                                         integrator="ptracer")
    img, stats, wall, peak, _ = _frames_render(
        t_scene.to(dev), t_cfg, dev, card, "ptracer, cbox (BASELINE config "
        "1) 256x256 spp 4 depth 40")
    s_scene, s_cfg = presets.cornell_box(res=16, spp=4,
                                         integrator="ptracer")
    out["ptracer"] = dict(
        wall_s=wall, peak_bytes=peak, mean=img.mean().item(),
        card_vs_cpu=_card_vs_cpu(
            render_m.render(s_scene, s_cfg, seed=3, device=dev).cpu(),
            render_m.render(s_scene, s_cfg, seed=3, device="cpu"),
            "ptracer, cbox 16x16 spp 4"))
    lap(40)
    print(json.dumps({"transient": out}))


# ---------------------------------------------------------------------------
# Phases 41-43: the front door (XML, the CLI) and the render farm
# ---------------------------------------------------------------------------
# the main path's configuration as XML defines, and the sharded layout
MAIN_DEFINES = dict(res=512, spp=32, depth=12, filter="gaussian")
FARM_LAYOUT = (2, 2)
# phases 41-43's sizes: the main path's resolution, samples and density
# grid, the framed pair's resolution and samples (a rehearsal on the CPU
# shrinks them and sets the processes' device)
FRONT = dict(res=512, spp=32, density_res=64, framed_res=256, framed_spp=8,
             device="")
# phase 42: the sharded image's mean against the unsharded render's (the
# sample assignment differs, so only the mean is compared)
FARM_MEAN_TOL = 0.02
# images that a later phase compares with (phase 10's wavefront render)
IMAGES = {}


def main_path_xml(directory, density_res=64):
    """Write the main path, presets.volumetric_box(heterogeneous=True), as a
    Mitsuba XML scene into `directory`, its density grid (the preset's,
    density_res^3) as density.vol beside it; returns the XML's path. The
    cube has no BSDF (null-bounded, as the preset's), its medium by
    `interior`; the collimated beam, the perspective sensor and the
    independent sampler as the preset's. Defines: res, spp, depth and
    filter (MAIN_DEFINES)."""
    import os

    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.utils import io

    grid = presets.volumetric_box(res=8, spp=1, heterogeneous=True,
                                  density_res=density_res)[0].media.density
    io.write_vol(os.path.join(directory, "density.vol"), grid.data.numpy(),
                 grid.aabb_min.numpy(), grid.aabb_max.numpy())
    path = os.path.join(directory, "main.xml")
    with open(path, "w") as f:
        f.write("""<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="$depth"/></integrator>
  <medium type="heterogeneous" id="box">
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
    </volume>
    <rgb name="sigmaS" value="0.5, 3.5, 7.5"/>
    <rgb name="sigmaA" value="0.05, 0.05, 0.05"/>
    <phase type="hg"><float name="g" value="0.7"/></phase>
  </medium>
  <shape type="cube"><ref name="interior" id="box"/></shape>
  <emitter type="collimated">
    <transform name="toWorld">
      <lookat origin="-1.1, -1.1, -1.1" target="1.1, 1.1, 1.1" up="0, 1, 0"/>
    </transform>
    <rgb name="power" value="100"/>
  </emitter>
  <sensor type="perspective">
    <float name="fov" value="95.8402"/>
    <string name="fovAxis" value="x"/>
    <transform name="toWorld">
      <lookat origin="-3, 0, 0" target="-2, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="$res"/><integer name="height" value="$res"/>
      <rfilter type="$filter"/>
    </film>
  </sensor>
</scene>
""")
    return path


def _scene_diff(a, cfg_a, b, cfg_b):
    """The config fields and scene arrays in which (a, cfg_a) and (b,
    cfg_b) differ, by name (arrays with their largest difference)."""
    import dataclasses

    import torch

    def leaves(obj, prefix=""):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                yield from leaves(v, prefix + f.name + ".")
            else:
                yield prefix + f.name, v

    out = [f"cfg.{f.name}" for f in dataclasses.fields(cfg_a)
           if getattr(cfg_a, f.name) != getattr(cfg_b, f.name)]
    for (name, x), (_, y) in zip(leaves(a), leaves(b)):
        if x.shape != y.shape:
            out.append(f"{name} (shape)")
        elif not torch.equal(x.cpu(), y.cpu()):
            err = (x.cpu().double() - y.cpu().double()).abs().max().item()
            out.append(f"{name} (max abs diff {err:.3e})")
    return out


def _cli(xml, out, defines):
    """`python -m mitsubaer_tpu_torch.cli xml -o out -D k=v ...` from the
    repo root as a process of its own; returns (wall s, its stderr)."""
    import os

    cmd = [sys.executable, "-m", "mitsubaer_tpu_torch.cli", xml, "-o", out]
    if FRONT["device"] == "cpu":
        cmd.append("--cpu")
    for k, v in defines.items():
        cmd += ["-D", f"{k}={v}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return wall, proc.stderr


def _counted(fn, *args, **kwargs):
    """fn(*args, **kwargs) on the card with every kernel count at 0 just
    before and read just after; returns (its result, wall s, counts)."""
    import torch

    def sync():
        if torch.cuda.is_available():      # not in a rehearsal on the CPU
            torch.cuda.synchronize()

    sync()
    _zero_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync()
    return out, time.perf_counter() - t0, _kernel_counts()


def _require(counts, kernels, what):
    missing = [k for k in kernels if counts[k] < 1]
    extra = [k for k, v in counts.items() if v and k not in kernels]
    if missing or extra:
        raise AssertionError(f"{what}: kernels {missing} did not launch, "
                             f"{extra} launched: {counts}")


def _bits_equal(a, b, what):
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or a.tobytes() != b.tobytes():
        n = (a != b).sum() if a.shape == b.shape else "all"
        raise AssertionError(f"{what}: not bit-equal ({n} values differ)")


def _splat_times(scene, cfg, dev, card):
    """The beam splat's accumulation at one pass's rows (4 npix samples),
    captured from beam_splat_pass: the fixed-order add (render.add_rows)
    against the index_add_ / index_put_ it replaced; and the whole pass.
    Returns a dict of ms."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m

    add, got = render_m.add_rows, []

    def capture(flat, key, value):
        got.append((flat.clone(), key, value))
        return add(flat, key, value)

    H, W, F = cfg.height, cfg.width, cfg.n_frames
    n = 4 * H * W
    splat = torch.zeros((H, W, 3 * F), device=dev)
    render_m.add_rows = capture
    try:
        render_m.beam_splat_pass(scene, splat, cfg, n, 0, 0)
    finally:
        render_m.add_rows = add
    flat, key, value = got[0]
    if F == 1:
        def before():
            return flat.clone().index_add_(0, key, value)
    else:
        pix, b = key // F, key % F

        def before():
            return flat.clone().view(H * W, F, 3).index_put_(
                (pix, b), value, accumulate=True)
    out = dict(
        rows=n, frames=F,
        before_ms=_cuda_ms(before, 10),
        after_ms=_cuda_ms(lambda: add(flat.clone(), key, value), 10),
        clone_ms=_cuda_ms(lambda: flat.clone(), 10),
        pass_ms=_cuda_ms(lambda: render_m.beam_splat_pass(
            scene, torch.zeros_like(splat), cfg, n, 0, 0), 5))
    print(f"beam splat accumulation, {n} samples into {H}x{W}x{F} frames: "
          f"index_add_ / index_put_ (before) {out['before_ms']:.4f} ms, "
          f"sorted segment sums (after) {out['after_ms']:.4f} ms, each with "
          f"a {out['clone_ms']:.4f} ms copy of the film; a whole splat pass "
          f"{out['pass_ms']:.4f} ms [{card}]", flush=True)
    return out


def _train_scene(res, density_res):
    """Phase 17's scene (at res^2, density_res^3), and its target's
    parameters (sigma_s x 1.5)."""
    from mitsubaer_tpu_torch.diff import render as diff_m
    from mitsubaer_tpu_torch.scene import presets

    scene, cfg = presets.volumetric_box(res=res, spp=4, heterogeneous=True,
                                        density_res=density_res,
                                        max_depth=12)
    p = diff_m.get_params(scene)
    return scene, cfg, p, p._replace(sigma_s=p.sigma_s * 1.5)


def _sharded_step(dev, target, res, density_res, card=None):
    """One sharded Adam step (lr 5e-2) over FARM_LAYOUT on phase 17's scene
    at sppc 4, seed 7, from this process's place in its group: returns
    (loss, updated MediumParams and the density's gradient on the CPU,
    wall s, counts). Given `card`, kernel A's and A''s calls are captured
    (calls 0, 4, 16, 64, 256 and 1024 of each point count of A; those of
    A_BWD_STEP_CALLS and the busiest of A') and held against their plain
    versions after the step: A exactly, A' within A_BWD_TOL["step"] and
    A_BWD_TOL["float64"]; the wall then includes the captures."""
    import torch

    from mitsubaer_tpu_torch.diff import render as diff_m
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.parallel import driver

    scene, cfg, p0, _ = _train_scene(res, density_res)
    leaves = diff_m.MediumParams(*(t.detach().clone().to(dev)
                                   .requires_grad_() for t in p0))
    opt = torch.optim.Adam(leaves, lr=5e-2)
    step = driver.make_train_step(cfg, opt, FARM_LAYOUT, sppc=4, device=dev)
    if card is None:
        loss, wall, counts = _counted(step, scene, leaves, target, 7)
    else:
        lookup, a_calls = medium.DensityGrid.lookup, {}
        medium.DensityGrid.lookup = _capture_lookups(a_calls)
        try:
            with _a_bwd_capturing({}) as bwd_calls:
                loss, wall, counts = _counted(step, scene, leaves, target, 7)
        finally:
            medium.DensityGrid.lookup = lookup
        where = "the sharded training step"
        _check_lookups(a_calls, card, where, ())
        for n, (worst, worst64) in _check_a_bwd_calls(bwd_calls,
                                                      where).items():
            print(f"kernel A' in {where} at {n} points: {bwd_calls[n][0]} "
                  f"calls, {len(bwd_calls[n][1])} captured and the busiest, "
                  f"max |diff| / max |grad| against the plain version "
                  f"{worst:.3e} (against the float64 sums: kernel "
                  f"{worst64[0]:.3e}, plain {worst64[1]:.3e}) [{card}]",
                  flush=True)
        for n, (count, taken) in sorted(a_calls.items()):
            print(f"kernel A in {where} at {n} points: {count} calls, "
                  f"{len(taken)} captured and equal to the plain version "
                  f"[{card}]", flush=True)
    return (loss, diff_m.MediumParams(*(t.detach().cpu() for t in leaves)),
            leaves.density.grad.cpu(), wall, counts)


def _train_child(target_path, out_path, res, density_res, device=""):
    """One process of phase 43's world-2 step: rank 0 writes the loss,
    the updated parameters, the density's gradient, the wall and the
    launch counts to out_path (.npz)."""
    import numpy as np

    from mitsubaer_tpu_torch.parallel import driver

    dev = driver.init_distributed(device or None)
    loss, params, grad, wall, counts = _sharded_step(
        dev, np.load(target_path), int(res), int(density_res))
    if driver.world()[0] == 0:
        np.savez(out_path, loss=loss.numpy(), wall=wall,
                 grad_density=grad.numpy(),
                 launches=np.array([counts["trilinear_lookup"],
                                    counts["trilinear_lookup_backward"]]),
                 **{k: v.numpy() for k, v in params._asdict().items()})


def _front_door_phases(dev, card, results):
    """Phases 41-43: the XML scene through the CLI, the sharded renders and
    the sharded training step."""
    import concurrent.futures
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from mitsubaer_tpu_torch.integrators import megatrack
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.parallel import driver
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import xml as xml_m
    from mitsubaer_tpu_torch.utils import io

    out = {"phase_s": {}}
    lap = _lap_clock(out["phase_s"])
    a_row = results.setdefault("trilinear_lookup", {})
    pool = concurrent.futures.ThreadPoolExecutor(8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    res, spp, g_res = FRONT["res"], FRONT["spp"], FRONT["density_res"]
    main = dict(MAIN_DEFINES, res=res, spp=spp)
    kw = dict(res=res, spp=spp, heterogeneous=True, density_res=g_res,
              max_depth=12)
    cases = {"loop": (dict(kw), ("trilinear_lookup",)),
             "wavefront": (dict(kw, filter="box", emitter_kind="point",
                                engine="wavefront"), ("megatrack",))}
    layout = ",".join(map(str, FARM_LAYOUT))

    # ---- phase 41: the front door ----
    xml = main_path_xml(tmp, g_res)
    roads = {"gaussian": ("trilinear_lookup",),
             "box": ("boxwalk", "trilinear_lookup")}
    # the processes of their own (the CLI's two renders, phase 42's world-2
    # renders) run on the card beside this one's work, which the group's
    # time needs; their walls include the sharing
    cli = {f: pool.submit(_cli, xml, os.path.join(tmp, f"main_{f}.exr"),
                          dict(main, filter=f)) for f in roads}
    two = {name: pool.submit(
        driver.spawn, 2, "mitsubaer_tpu_torch.parallel.driver:render_child",
        json.dumps(c_kw), layout, "0", FRONT["device"],
        os.path.join(tmp, f"farm_{name}.npy"))
        for name, (c_kw, _) in cases.items()}
    p_scene, p_cfg = presets.volumetric_box(res=res, spp=spp,
                                            heterogeneous=True,
                                            density_res=g_res, max_depth=12)
    front = {}
    for filt, kernels in roads.items():
        scene, cfg = xml_m.load_scene(xml, dict(main, filter=filt))
        diff = _scene_diff(scene, cfg, p_scene,
                           dataclasses.replace(p_cfg, filter=filt))
        print(f"loaded main path ({filt} filter): fields that differ from "
              f"presets.volumetric_box's: {diff or 'none'}", flush=True)
        scene = scene.to(dev)
        img, wall, counts = _counted(render_m.render, scene, cfg, seed=0,
                                     device=dev)
        _require(counts, kernels, f"main path from XML, {filt} filter")
        cli_wall, log = cli[filt].result()
        exr, names = io.read_exr(os.path.join(tmp, f"main_{filt}.exr"))
        _bits_equal(exr, img.cpu(), f"the CLI's EXR ({filt}) against the "
                    "in-process render")
        print(f"main path from XML, {res}x{res} spp {spp} depth 12 {filt} "
              f"filter: "
              f"in-process wall {wall:.3f} s, launches "
              f"{ {k: counts[k] for k in kernels} }, mean "
              f"{img.mean().item():.6f}; the CLI's process {cli_wall:.3f} s "
              f"({[x for x in log.splitlines() if x.startswith('[render]')]}"
              f"), its EXR "
              f"{names} bit-equal to the in-process image [{card}]",
              flush=True)
        front[filt] = dict(wall_s=wall, cli_s=cli_wall, differs=diff,
                           launches={k: counts[k] for k in kernels},
                           mean=img.mean().item())
        if filt == "gaussian":
            a_row["launches_xml"] = counts["trilinear_lookup"]
            # kernel A at the loop road's point counts, as phase 13
            a_row["xml_shapes"] = _loop_lookups(scene, cfg, dev, card)
            steady = img
    # two renders with the beam and 128 frames, bit-equal (the splat's
    # fixed-order adds); the steady pair is the CLI's and this one
    f_res, f_spp = FRONT["framed_res"], FRONT["framed_spp"]
    f_scene, f_cfg = presets.volumetric_box(
        res=f_res, spp=f_spp, heterogeneous=True, density_res=g_res,
        max_depth=12, **TRANSIENT)
    f_scene = f_scene.to(dev)
    pair = [_counted(render_m.render, f_scene, f_cfg, seed=0, device=dev)
            for _ in range(2)]
    _bits_equal(pair[0][0].cpu(), pair[1][0].cpu(), "two framed renders")
    _require(pair[0][2], ("trilinear_lookup",), "framed main path")
    print(f"two renders of the main path with the beam, {f_res}x{f_res} "
          f"spp {f_spp}, {f_cfg.n_frames} frames: "
          f"bit-equal, walls {pair[0][1]:.3f} / {pair[1][1]:.3f} s, kernel A "
          f"launches {pair[0][2]['trilinear_lookup']} [{card}]", flush=True)
    front["framed"] = dict(walls_s=[pair[0][1], pair[1][1]],
                           frames=f_cfg.n_frames)
    del pair
    front["splat_steady"] = _splat_times(scene, cfg, dev, card)
    front["splat_framed"] = _splat_times(f_scene, f_cfg, dev, card)
    out["front_door"] = front
    lap(41)

    # ---- phase 42: the sharded renders at full width ----
    # phase 43's target first, so that its world-2 step and the dryrun
    # run beside this phase
    from mitsubaer_tpu_torch.diff import render as diff_m

    t_scene, t_cfg, _, p_target = _train_scene(res, g_res)
    with torch.no_grad():
        target = diff_m.render_diff(t_scene, p_target, t_cfg, 4, 123, 0,
                                    device=dev).cpu().numpy()
    np.save(os.path.join(tmp, "target.npy"), target)
    step2 = pool.submit(driver.spawn, 2, "chip_smoke:_train_child",
                        os.path.join(tmp, "target.npy"),
                        os.path.join(tmp, "step2.npz"), str(res),
                        str(g_res), FRONT["device"])
    dry = pool.submit(driver.dryrun_multiprocess, 2, FRONT["device"] or None)
    farm = {}
    for name, (c_kw, kernels) in cases.items():
        scene, cfg = presets.volumetric_box(**c_kw)
        scene = scene.to(dev)
        calls = []
        if name == "wavefront":
            # kernel C's first call of the sharded run, captured
            run = megatrack.run

            def capture(*args):
                if not calls:
                    calls.append(args)
                return run(*args)

            # run() counts its launches on whatever megatrack.run is
            capture.launches = 0
            megatrack.run = capture
        st = {}
        try:
            img, wall, counts = _counted(driver.render_sharded, scene, cfg,
                                         FARM_LAYOUT, seed=0, device=dev,
                                         stats=st)
        finally:
            if name == "wavefront":
                megatrack.run = run
                counts["megatrack"] = capture.launches
        _require(counts, kernels, f"sharded {name} render, world 1")
        if name == "wavefront":
            got = megatrack.run(*calls[0])
            _compare_mega("the sharded render's first tracking call", got,
                          megatrack.run_plain(*calls[0]))
        if name == "loop":
            ref = steady - render_m._add_beam_splat(
                scene, cfg, torch.zeros_like(steady), 0)
            ref_what = "phase 41's render less its beam splat"
            IMAGES["main_less_splat"] = ref.cpu()     # phase 44 reads it
        elif "wavefront" in IMAGES:
            ref = IMAGES["wavefront"].to(dev)
            ref_what = "phase 10's render()"
        else:
            ref, _, _ = _counted(render_m.render, scene, cfg, seed=0,
                                 device=dev)
            ref_what = "render()"
        rel = abs(img.mean().item() / ref.mean().item() - 1)
        # the two images' independent samples: the mean of their
        # per-pixel difference over its standard error
        d = (img - ref).mean(-1).double()
        z = (d.mean() / (d.std() / d.numel() ** 0.5)).item()
        passes = [x for shard in sorted(st["passes"])
                  for x in st["passes"][shard]]
        lines = two[name].result()
        world2 = json.loads(lines[0].strip().splitlines()[-1])
        _bits_equal(np.load(os.path.join(tmp, f"farm_{name}.npy")),
                    img.cpu(), f"the sharded {name} render at world 2 against "
                    "world 1")
        print(f"sharded {name} render, layout {FARM_LAYOUT}, {res}x{res} spp "
              f"{spp} depth 12: world 1 wall {wall:.3f} s, launches "
              f"{ {k: counts[k] for k in kernels} }, mean "
              f"{img.mean().item():.6f}; world 2 (two processes on this "
              f"card, gloo) wall {world2['wall_s']:.3f} s, bit-equal; "
              f"{ref_what}'s mean {ref.mean().item():.6f}, rel diff "
              f"{rel:.2e}, z {z:+.2f} (the mean of the per-pixel "
              f"difference over its standard error); each shard's passes "
              f"{passes} [{card}]", flush=True)
        if name == "wavefront" and any(x[3] != 0 for x in passes):
            raise AssertionError("the sharded wavefront render left samples "
                                 f"unfinished: {passes}")
        if not rel <= FARM_MEAN_TOL:
            raise AssertionError(f"the sharded {name} render's mean differs "
                                 f"from the unsharded one's by {rel:.3e}")
        farm[name] = dict(wall_1_s=wall, wall_2_s=world2["wall_s"],
                          launches={k: counts[k] for k in kernels},
                          mean=img.mean().item(), ref_mean=ref.mean().item(),
                          z=z, passes=passes)
        if name == "loop":
            a_row["launches_sharded"] = counts["trilinear_lookup"]
        else:
            results.setdefault("megatrack", {})["launches_sharded"] = \
                counts["megatrack"]
        del img, ref
    out["farm"] = farm
    lap(42)

    # ---- phase 43: the sharded training step ----
    loss, params, grad, wall, counts = _sharded_step(dev, target, res,
                                                     g_res, card)
    _require(counts, ("trilinear_lookup", "trilinear_lookup_backward"),
             "sharded training step, world 1")
    step2.result()
    w2 = np.load(os.path.join(tmp, "step2.npz"))
    _bits_equal(w2["loss"], loss.numpy(), "the sharded step's loss")
    _bits_equal(w2["grad_density"], grad.numpy(),
                "the sharded step's density gradient")
    for f in ("sigma_a", "sigma_s", "g", "density"):
        _bits_equal(w2[f], getattr(params, f).numpy(),
                    f"the sharded step's updated {f}")
    print(f"sharded training step, layout {FARM_LAYOUT}, {res}x{res} sppc 4, "
          f"Adam lr 5e-2: loss {loss.item():.6e}; world 1 wall {wall:.3f} s "
          f"(kernel calls captured), "
          f"A / A' launches {counts['trilinear_lookup']} / "
          f"{counts['trilinear_lookup_backward']}; world 2 wall "
          f"{float(w2['wall']):.3f} s, launches {w2['launches'].tolist()}; "
          f"the loss, the density's gradient and the updated sigma_a, "
          f"sigma_s, g and density bit-equal [{card}]", flush=True)
    t0 = time.perf_counter()
    print(f"{dry.result()} (its processes ran beside phases 42-43; "
          f"{time.perf_counter() - t0:.1f} s more)", flush=True)
    out["train"] = dict(loss=loss.item(), wall_1_s=wall,
                        wall_2_s=float(w2["wall"]),
                        launches=[counts["trilinear_lookup"],
                                  counts["trilinear_lookup_backward"]])
    a_row["launches_sharded_step"] = counts["trilinear_lookup"]
    results.setdefault("trilinear_lookup_backward", {})[
        "launches_sharded_step"] = counts["trilinear_lookup_backward"]
    pool.shutdown()
    lap(43)
    print(json.dumps({"front_door": out}))


# ---------------------------------------------------------------------------
# Phases 44-46: the Metropolis and photon estimators
# ---------------------------------------------------------------------------
# phases 44-46's sizes: config 1's and the volume's widths, the density
# grid, the caustic scene's width, the manifold's lanes, and the card
# against CPU runs' width and bootstrap (a rehearsal on the CPU shrinks
# them)
EST = dict(cbox_res=256, vol_res=512, density_res=64, caustic_res=256,
           chain_lanes=1 << 16, small_res=16, small_boot=1 << 12)
# the means' bars: pssmlt and ppm against config 1's path render (JAX's
# TestPSSMLT and TestPhotonMap), erpt against a path render at spp 64
# (tests/test_erpt.py); bre over phase 10's wavefront mean and
# pssmlt_volpath over the main path's loop-road render less its beam
# splat within tests/test_bre.py's bar for a biased volume estimator:
# pssmlt_volpath reads 0.56 of it on the card and 0.73-0.90 on the CPU at
# 32^2-64^2, as JAX's estimator does (scripts/mlt_bias_check.py, ROADMAP
# Queue 3), not within 15%
EST_MEAN_TOL = dict(pssmlt=0.15, erpt=0.25, ppm=0.15)
PPM_MIN_CORR = 0.95
BRE_RATIO = VOL_MLT_RATIO = (0.4, 2.2)
# phase 44(d): the glass-sphere chain card against CPU. The Newton walk's
# batched solve and its line search's choice among six scales amplify the
# devices' ulps (sin and cos, cuBLAS's and LAPACK's sums): 2.5% of the
# lanes converge on one device only (1,631 of 65,536 on the card, 1,389
# of them with the other residual beyond 4 tol; the port against JAX on
# the CPU 2-3%, tests/test_torch_erpt.py), so the flags are held equal
# but for CHAIN_MAX_APART of the lanes (the issue's 0.5% assumed FMA
# contraction alone), and the vertices within CHAIN_TOL where both
# converge but for CHAIN_MAX_ROOTS (another root: 0.6% measured)
CHAIN_TOL, CHAIN_MAX_APART, CHAIN_MAX_ROOTS = 1e-5, 0.04, 0.01
# the Metropolis estimators card against CPU: a chain diverges for good
# after one flipped acceptance, so the first round is held chain by chain
MLT_RTOL, MLT_MAX_APART, MLT_MEAN_TOL = 1e-5, 0.01, 0.05


def _caustic_scene(res, spp):
    """tests/test_erpt.py's caustic scene in the port: a glass sphere (IOR
    1.5) above a diffuse floor under a small area light, depth 5."""
    import dataclasses

    import numpy as np

    from mitsubaer_tpu_torch.core import transform as tf
    from mitsubaer_tpu_torch.scene import types as T
    from mitsubaer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    glass = b.add_bsdf(T.BSDF_DIELECTRIC, eta=1.5)
    floor = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=(0.7, 0.7, 0.7))
    v = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
                 np.float32)
    b.add_mesh(v, np.array([[0, 2, 1], [0, 3, 2]], np.int32), bsdf=floor)
    b.add_sphere([0.0, 0.7, 0.0], 0.35, bsdf=glass)
    lv = np.array([[-0.25, 2.0, -0.25], [0.25, 2.0, -0.25],
                   [0.25, 2.0, 0.25], [-0.25, 2.0, 0.25]], np.float32)
    lb = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=(0.0, 0.0, 0.0))
    b.add_mesh(lv, np.array([[0, 1, 2], [0, 2, 3]], np.int32), bsdf=lb,
               emitter_radiance=(40.0, 40.0, 40.0))
    b.set_perspective_sensor(
        to_world=tf.look_at([0, 2.2, -2.6], [0, 0.3, 0], [0, 1, 0]),
        fov_deg=40.0)
    scene = b.build()
    return scene, dataclasses.replace(b.config, width=res, height=res,
                                      spp=spp, max_depth=5,
                                      integrator="path")


def _glass_chain(n, seed=1):
    """tests/test_erpt.py:61's two-refraction glass sphere at n lanes:
    (params, a, b, etas, u0) as numpy arrays."""
    import numpy as np

    r = np.random.default_rng(seed)
    a = np.stack([np.full(n, -3.0), r.uniform(-0.3, 0.3, n),
                  r.uniform(-0.3, 0.3, n)], -1).astype(np.float32)
    b = np.stack([np.full(n, 3.0), r.uniform(-0.3, 0.3, n),
                  r.uniform(-0.3, 0.3, n)], -1).astype(np.float32)
    sp = np.tile(np.array([0, 0, 0, 1.0], np.float32), (n, 2, 1))
    u0 = np.zeros((n, 2, 2), np.float32)
    for i, end in ((0, a), (1, b)):
        d = end / np.linalg.norm(end, axis=-1, keepdims=True)
        u0[:, i, 0] = np.arccos(np.clip(d[:, 2], -1, 1))
        u0[:, i, 1] = np.arctan2(d[:, 1], d[:, 0])
    etas = np.tile(np.array([1.5, 1.0 / 1.5], np.float32), (n, 1))
    return sp, a, b, etas, u0


def _estimator_render(scene, cfg, dev, what, kernels=(), seed=0):
    """render() of an estimator with the counts set to 0 just before and
    read just after: (image, wall s, stats, counts); the image finite, of
    its shape and not black, and exactly `kernels` launched."""
    import torch

    from mitsubaer_tpu_torch.integrators import render as render_m

    stats = {}
    img, wall, counts = _counted(render_m.render, scene, cfg, seed=seed,
                                 device=dev, stats=stats)
    _require(counts, kernels, what)
    if (tuple(img.shape) != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all()) or not img.mean() > 0):
        raise AssertionError(f"{what}: a non-finite, black or misshapen "
                             "image")
    return img, wall, stats, counts


def _mean_within(img, ref, tol, what):
    rel = img.mean().item() / ref.mean().item() - 1
    print(f"{what}: mean {img.mean().item():.6f} against "
          f"{ref.mean().item():.6f}, rel {rel:+.4f} (bar {tol})", flush=True)
    if not abs(rel) <= tol:
        raise AssertionError(f"{what}: the mean is {rel:+.4f} off")
    return rel


def _mlt_card_vs_cpu(name, scene, cfg, dev):
    """A Metropolis estimator at EST["small_res"]^2 on the card and on the
    CPU. The CPU renders as render_pssmlt / render_erpt (seed 3, bootstrap
    EST["small_boot"]) step by step, keeping its rounds; the card runs the
    same rounds from the CPU's bootstrap states: the first round's
    proposals' pixels and rgb within MLT_RTOL (plus 1e-6 of the largest)
    and its accept flags equal on all but MLT_MAX_APART of the chains.
    Then the card's own whole render, its mean within MLT_MEAN_TOL of the
    CPU's."""
    import torch

    from mitsubaer_tpu_torch.integrators import erpt, pssmlt

    n_chains, D = pssmlt.chain_shape(cfg, None)
    npix = cfg.width * cfg.height
    n_mut = max((cfg.spp * npix) // n_chains, 1)
    b, u0 = pssmlt.bootstrap(scene.to("cpu"), cfg, EST["small_boot"], D,
                             n_chains, 3, "cpu")

    def run(d, rounds):
        if name == "erpt":
            e_d = torch.full((n_chains,), float(b) * npix / (n_chains * n_mut),
                             device=d)
            return erpt._erpt_run(scene.to(d), cfg, n_chains, n_mut, D, 3,
                                  e_d, u0.to(d), rounds=rounds)
        return pssmlt._pssmlt_run(
            scene.to(d), cfg, n_chains, n_mut, D, 3,
            torch.clamp_min(b, 1e-9).to(d), u0.to(d),
            rounds=rounds) * (npix / (n_chains * n_mut))

    first = []
    for d in (dev, "cpu"):
        rounds = []
        img = run(d, rounds)
        first.append([t.cpu() for t in rounds[0]])
    (_, pix_g, rgb_g, acc_g), (_, pix_c, rgb_c, acc_c) = first
    scale = max(rgb_c.abs().max().item(), 1e-6)
    apart = (pix_g != pix_c) | ~torch.isclose(
        rgb_g, rgb_c, rtol=MLT_RTOL, atol=1e-6 * scale).all(-1)
    flips = acc_g != acc_c
    entry = erpt.render_erpt if name == "erpt" else pssmlt.render_pssmlt
    means = [entry(scene.to(dev), cfg, seed=3,
                   n_bootstrap=EST["small_boot"]).mean().item(),
             img.mean().item()]
    rel = means[0] / means[1] - 1
    print(f"card vs CPU {name} at {cfg.width}x{cfg.height} ({n_chains} "
          f"chains): first round {int(apart.sum())} chains apart, "
          f"{int(flips.sum())} accept flags flipped; means {means[0]:.6f} / "
          f"{means[1]:.6f}, rel {rel:+.2e}", flush=True)
    if (apart.float().mean() > MLT_MAX_APART
            or flips.float().mean() > MLT_MAX_APART
            or abs(rel) > MLT_MEAN_TOL):
        raise AssertionError(f"card and CPU disagree: {name}")
    return dict(apart=int(apart.sum()), flips=int(flips.sum()),
                chains=n_chains, mean_rel=rel)


def _profile_round(scene, cfg, dev, card, what):
    """The device launches and time of one mutation round: _pssmlt_run of
    one round less one of none (the chains' first trace), both profiled,
    from the states of a bootstrap of 2^13 lanes."""
    from mitsubaer_tpu_torch.integrators import pssmlt

    n_chains, D = pssmlt.chain_shape(cfg, None)
    b, u0 = pssmlt.bootstrap(scene, cfg, 1 << 13, D, n_chains, 0, dev)
    runs = [_profile_pass(lambda k=k: pssmlt._pssmlt_run(
        scene, cfg, n_chains, k, D, 0, b, u0), card, what)[1]
        for k in (0, 1)]
    return {k: runs[1][k] - runs[0][k]
            for k in ("wall_s", "device_s", "launches")}


def _estimator_phases(dev, card, results):
    """Phases 44-46: pssmlt, pssmlt_volpath, erpt and the specular manifold;
    the photon mappers; the beam radiance estimate."""
    import dataclasses

    import numpy as np
    import torch

    from mitsubaer_tpu_torch.core import manifold
    from mitsubaer_tpu_torch.integrators import bre, path, pssmlt
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    out = {"phase_s": {}}
    lap = _lap_clock(out["phase_s"])
    a_row = results.setdefault("trilinear_lookup", {})
    c_res, v_res, g_res = EST["cbox_res"], EST["vol_res"], EST["density_res"]
    small = EST["small_res"]

    # ---- phase 44(a): pssmlt on BASELINE config 1 ----
    scene, cfg = presets.cornell_box(res=c_res, spp=4, max_depth=40,
                                     integrator="pssmlt")
    scene = scene.to(dev)
    if "config1_path" in IMAGES and c_res == 256:
        ref = IMAGES["config1_path"]
        ref_what = "phase 26's config 1 path render"
    else:
        ref = render_m.render(scene, dataclasses.replace(
            cfg, spp=64, integrator="path"), seed=0, device=dev).cpu()
        ref_what = "config 1's path render (spp 64)"
    li, li_calls = path.li, [0]

    def counted_li(*args, **kw):
        li_calls[0] += 1
        return li(*args, **kw)

    path.li = counted_li
    try:
        img, wall, stats, _ = _estimator_render(scene, cfg, dev,
                                                "pssmlt on config 1")
    finally:
        path.li = li
    rounds = stats["rounds"]
    n_chains, D = pssmlt.chain_shape(cfg, None)
    rel = _mean_within(img.cpu(), ref, EST_MEAN_TOL["pssmlt"],
                       f"pssmlt against {ref_what}")
    # "mlt" and a second "pssmlt" bit-equal to a first, at 32^2 (a repeat
    # at config 1's width is ~13 s of launch-bound path.li calls each)
    p_scene, p_cfg = presets.cornell_box(res=32, spp=4, max_depth=40,
                                         integrator="pssmlt")
    p_scene = p_scene.to(dev)
    first = _estimator_render(p_scene, p_cfg, dev, "pssmlt at 32^2")[0]
    for name in ("mlt", "pssmlt"):
        again = _estimator_render(
            p_scene, dataclasses.replace(p_cfg, integrator=name), dev,
            f"{name} at 32^2")[0]
        _bits_equal(again.cpu(), first.cpu(), f"{name} against pssmlt")
    round_prof = _profile_round(scene, cfg, dev, card, "a pssmlt round")
    print(f"pssmlt, config 1 ({c_res}x{c_res} spp 4 depth 40): {n_chains} "
          f"chains, {rounds} rounds, D {D}, 65536 bootstrap lanes: wall "
          f"{wall:.3f} s (bootstrap {stats['bootstrap_s']:.3f} s), "
          f"{li_calls[0]} path.li calls, no kernel; one round "
          f"{round_prof['wall_s']:.4f} s, {round_prof['launches']} device "
          f"launches, {round_prof['device_s']:.4f} s of device time; at "
          f"32x32 \"mlt\" and a second \"pssmlt\" bit-equal to a first "
          f"[{card}]", flush=True)
    out["pssmlt"] = dict(wall_s=wall, bootstrap_s=stats["bootstrap_s"],
                         chains=n_chains, rounds=rounds, li_calls=li_calls[0],
                         round=round_prof, mean=img.mean().item(),
                         mean_rel=rel)
    s_scene, s_cfg = presets.cornell_box(res=small, spp=4, max_depth=40,
                                         integrator="pssmlt")
    out["pssmlt"]["card_vs_cpu"] = _mlt_card_vs_cpu("pssmlt", s_scene,
                                                    s_cfg, dev)
    del img, ref

    # ---- phase 44(b): pssmlt_volpath on the main path's volume ----
    scene, cfg = presets.volumetric_box(res=v_res, spp=1,
                                        heterogeneous=True,
                                        density_res=g_res, max_depth=12,
                                        integrator="pssmlt_volpath")
    scene = scene.to(dev)
    # kernel A's calls captured during the render (calls 0, 4, 16, 64, 256
    # and 1024 of each point count: the bootstrap's and the first rounds')
    lookup, calls = medium.DensityGrid.lookup, {}
    medium.DensityGrid.lookup = _capture_lookups(calls)
    try:
        img, wall, stats, counts = _estimator_render(
            scene, cfg, dev, "pssmlt_volpath", ("trilinear_lookup",))
    finally:
        medium.DensityGrid.lookup = lookup
    n_chains, D = pssmlt.chain_shape(cfg, None)
    shapes = _check_lookups(calls, card, "pssmlt_volpath",
                            {next(iter(calls)), max(calls)})
    if "main_less_splat" in IMAGES and v_res == 512:
        ref = IMAGES["main_less_splat"]
        ref_what = "phase 42's main path less its beam splat"
    else:
        m_scene, m_cfg = presets.volumetric_box(
            res=v_res, spp=32, heterogeneous=True, density_res=g_res,
            max_depth=12)
        m_scene = m_scene.to(dev)
        full = render_m.render(m_scene, m_cfg, seed=0, device=dev)
        ref = (full - render_m._add_beam_splat(
            m_scene, m_cfg, torch.zeros_like(full), 0)).cpu()
        ref_what = "the main path's loop-road render less its beam splat"
    ratio = img.mean().item() / ref.mean().item()
    print(f"pssmlt_volpath against {ref_what}: mean "
          f"{img.mean().item():.6f} against {ref.mean().item():.6f}, ratio "
          f"{ratio:.4f} (bar {VOL_MLT_RATIO})", flush=True)
    if not VOL_MLT_RATIO[0] <= ratio <= VOL_MLT_RATIO[1]:
        raise AssertionError(f"pssmlt_volpath's mean is {ratio:.4f} of the "
                             "loop road's")
    print(f"pssmlt_volpath, the main path's volume ({v_res}x{v_res} spp 1 "
          f"depth 12, density {g_res}^3): {n_chains} chains, "
          f"{stats['rounds']} rounds, D {D}: wall {wall:.3f} s (bootstrap "
          f"{stats['bootstrap_s']:.3f} s), kernel A launches "
          f"{counts['trilinear_lookup']} [{card}]", flush=True)
    out["pssmlt_volpath"] = dict(
        wall_s=wall, bootstrap_s=stats["bootstrap_s"], chains=n_chains,
        rounds=stats["rounds"], launches=counts["trilinear_lookup"],
        mean=img.mean().item(), ratio=ratio)
    a_row["launches_pssmlt_volpath"] = counts["trilinear_lookup"]
    a_row["pssmlt_volpath_shapes"] = shapes
    s_scene, s_cfg = presets.volumetric_box(
        res=small, spp=1, heterogeneous=True, density_res=16, max_depth=12,
        integrator="pssmlt_volpath")
    out["pssmlt_volpath"]["card_vs_cpu"] = _mlt_card_vs_cpu(
        "pssmlt_volpath", s_scene, s_cfg, dev)
    del img, ref

    # ---- phase 44(c): erpt on tests/test_erpt.py's caustic scene ----
    e_res = EST["caustic_res"]
    scene, cfg = _caustic_scene(e_res, 4)
    scene = scene.to(dev)
    img, wall, stats, _ = _estimator_render(
        scene, dataclasses.replace(cfg, integrator="erpt"), dev, "erpt")
    ref, p_wall, _, _ = _estimator_render(
        scene, dataclasses.replace(cfg, spp=64), dev, "the caustic path")
    rel = _mean_within(img.cpu(), ref.cpu(), EST_MEAN_TOL["erpt"],
                       "erpt against the path render at spp 64")
    print(f"erpt, the caustic scene ({e_res}x{e_res} spp 4 depth 5): "
          f"{stats['rounds']} rounds, wall {wall:.3f} s (bootstrap "
          f"{stats['bootstrap_s']:.3f} s); the path render at spp 64 "
          f"{p_wall:.3f} s [{card}]", flush=True)
    out["erpt"] = dict(wall_s=wall, bootstrap_s=stats["bootstrap_s"],
                       rounds=stats["rounds"], path_wall_s=p_wall,
                       mean=img.mean().item(), mean_rel=rel)
    s_scene, s_cfg = _caustic_scene(small, 4)
    out["erpt"]["card_vs_cpu"] = _mlt_card_vs_cpu(
        "erpt", s_scene, dataclasses.replace(s_cfg, integrator="erpt"), dev)
    del img, ref

    # ---- phase 44(d): the specular manifold at 2^16 lanes ----
    n = EST["chain_lanes"]
    args = [torch.from_numpy(x) for x in _glass_chain(n)]
    kinds = (manifold.SURF_SPHERE, manifold.SURF_SPHERE)
    g_args = [x.to(dev) for x in args]
    solve = manifold.solve_specular_chain
    got = solve(kinds, *g_args)                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = solve(kinds, *g_args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = solve(kinds, *args)
    cpu_s = time.perf_counter() - t0
    conv_g, conv_c = got.converged.cpu(), want.converged
    both = conv_g & conv_c
    near = ((got.x.cpu() - want.x).abs().amax((1, 2)) <= CHAIN_TOL) \
        & ((got.n.cpu() - want.n).abs().amax((1, 2)) <= CHAIN_TOL)
    flags = int((conv_g != conv_c).sum())
    roots = int((both & ~near).sum())
    print(f"specular chain, the two-refraction glass sphere at {n} lanes: "
          f"card {card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms; converged "
          f"{conv_g.float().mean().item():.4f} (card) "
          f"{conv_c.float().mean().item():.4f} (CPU); {flags} flags apart, "
          f"{roots} lanes converged on both with vertices beyond "
          f"{CHAIN_TOL} [{card}]", flush=True)
    if flags > CHAIN_MAX_APART * n or roots > CHAIN_MAX_ROOTS * n:
        raise AssertionError("the specular chain's card and CPU solves "
                             "disagree")
    out["manifold"] = dict(lanes=n, card_ms=card_s * 1e3, cpu_ms=cpu_s * 1e3,
                           flags_apart=flags, roots_apart=roots)
    lap(44)

    # ---- phase 45: the photon mappers on config 1 ----
    scene, cfg = presets.cornell_box(res=c_res, spp=16, max_depth=40,
                                     integrator="ppm")
    scene = scene.to(dev)
    img, wall, stats, _ = _estimator_render(scene, cfg, dev, "ppm")
    for name in ("photonmapper", "sppm", "ppm"):
        again, _, _, _ = _estimator_render(
            scene, dataclasses.replace(cfg, integrator=name), dev, name)
        _bits_equal(again.cpu(), img.cpu(), f"{name} against ppm")
    if "config1_path" in IMAGES and c_res == 256:
        ref = IMAGES["config1_path"]
    else:
        ref = render_m.render(scene, dataclasses.replace(
            cfg, spp=64, integrator="path"), seed=0, device=dev).cpu()
    img = img.cpu()
    rel = _mean_within(img, ref, EST_MEAN_TOL["ppm"],
                       "ppm against config 1's path render")
    corr = float(np.corrcoef(ref.mean(-1).ravel().numpy(),
                             img.mean(-1).ravel().numpy())[0, 1])
    split = stats["photonmap_stage_s"]
    print(f"ppm, config 1 ({c_res}x{c_res} spp 16): 4 iterations of "
          f"{max(c_res * c_res, 1 << 16)} photons, 8 bounces: wall "
          f"{wall:.3f} s (photon tracing {split['trace']:.3f}, map build "
          f"{split['build']:.3f}, camera walk {split['camera']:.3f}, gather "
          f"{split['gather']:.3f}), pixel correlation with the path render "
          f"{corr:.4f}; \"photonmapper\", \"sppm\" and a second \"ppm\" "
          f"bit-equal, no kernel [{card}]", flush=True)
    if not corr >= PPM_MIN_CORR:
        raise AssertionError(f"ppm's pixels correlate {corr:.4f} with the "
                             "path render's")
    # card against CPU at one iteration (spp 4): the CPU's photon walks
    # and gathers cost ~3 s an iteration there
    s_scene, s_cfg = presets.cornell_box(res=small, spp=4, max_depth=40,
                                         integrator="ppm")
    out["ppm"] = dict(wall_s=wall, stages_s=split, mean=img.mean().item(),
                      mean_rel=rel, corr=corr, card_vs_cpu=_card_vs_cpu(
                          render_m.render(s_scene, s_cfg, seed=3,
                                          device=dev).cpu(),
                          render_m.render(s_scene, s_cfg, seed=3,
                                          device="cpu"),
                          f"ppm at {small}x{small} spp 4"))
    del img, ref
    lap(45)

    # ---- phase 46: the beam radiance estimate on phase 10's volume ----
    kw = dict(res=v_res, spp=8, heterogeneous=True, density_res=g_res,
              max_depth=12, emitter_kind="point")
    scene, cfg = presets.volumetric_box(**kw, integrator="bre")
    scene = scene.to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # kernel A's calls captured during the render: the first pass's
    # Woodcock lookups (calls 0-64 of 168) and segment quadratures (call
    # 0; call 4 is the second pass's first)
    lookup, calls = medium.DensityGrid.lookup, {}
    medium.DensityGrid.lookup = _capture_lookups(calls)
    try:
        img, wall, stats, counts = _estimator_render(
            scene, cfg, dev, "bre", ("trilinear_lookup",))
    finally:
        medium.DensityGrid.lookup = lookup
    peak = torch.cuda.max_memory_allocated(dev)
    n_photons = max(v_res * v_res, 1 << 16)
    tau_points = v_res * v_res * bre.TAU_STEPS
    if n_photons not in calls or tau_points not in calls:
        raise AssertionError(f"bre looked up no {n_photons} or "
                             f"{tau_points} points: {sorted(calls)}")
    shapes = _check_lookups(calls, card, "bre",
                            {next(iter(calls)), max(calls)})
    if "wavefront" in IMAGES and v_res == 512:
        ref = IMAGES["wavefront"]
        ref_what = "phase 10's render()"
    else:
        ref = render_m.render(*presets.volumetric_box(**kw, filter="box"),
                              seed=0, device=dev).cpu()
        ref_what = "the point-lit volume's wavefront render()"
    ratio = img.mean().item() / ref.mean().item()
    split = stats["bre_stage_s"]
    print(f"bre, the point-lit volume ({v_res}x{v_res} spp 8 depth 12, "
          f"density {g_res}^3): 2 iterations of {n_photons} volume and "
          f"{n_photons} surface photons: wall {wall:.3f} s (volume photons "
          f"{split['volume_photons']:.3f}, surface photons "
          f"{split['surface_photons']:.3f}, beam gathers "
          f"{split['beam']:.3f}, surface gather "
          f"{split['surface_gather']:.3f}), peak device memory "
          f"{peak / 2**30:.3f} GiB, kernel A launches "
          f"{counts['trilinear_lookup']}; mean {img.mean().item():.6f} over "
          f"{ref_what}'s {ref.mean().item():.6f}: {ratio:.4f} (bar "
          f"{BRE_RATIO}) [{card}]", flush=True)
    if not BRE_RATIO[0] <= ratio <= BRE_RATIO[1]:
        raise AssertionError(f"bre's mean is {ratio:.4f} of the wavefront "
                             "render's")
    s_scene, s_cfg = presets.volumetric_box(
        res=small, spp=4, heterogeneous=True, density_res=16, max_depth=12,
        emitter_kind="point", integrator="bre")
    out["bre"] = dict(wall_s=wall, stages_s=split, peak_bytes=peak,
                      launches=counts["trilinear_lookup"],
                      mean=img.mean().item(), ratio=ratio,
                      card_vs_cpu=_card_vs_cpu(
                          render_m.render(s_scene, s_cfg, seed=3,
                                          device=dev).cpu(),
                          render_m.render(s_scene, s_cfg, seed=3,
                                          device="cpu"),
                          f"bre at {small}x{small} spp 4"))
    a_row["launches_bre"] = counts["trilinear_lookup"]
    a_row["bre_shapes"] = shapes
    lap(46)
    print(json.dumps({"estimators": out}))


if __name__ == "__main__":
    sys.exit(main())
