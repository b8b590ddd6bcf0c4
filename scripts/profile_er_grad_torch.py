"""Where the time of the port's eikonal gradient goes, on one NVIDIA GPU.

    python3 scripts/profile_er_grad_torch.py [--scene radial|spline]
                                             [--res N] [--sppc K]
                                             [--depth D] [--repeat]
                                             [--no-profile]

One eikonal gradient (`integrators.volpath_er.li(differentiable=True)`,
mean(sink), autograd.grad) as chip_smoke.py phases 19 and 20 take it:
radial, bench.py::bench_er_grad's configuration (32^2 spp 2, gradient with
respect to rif_params); spline, tests/test_inverse.py's scene with a 32^3
grid (64^2 sppc 2, gradient with respect to the coefficients). With
--repeat it first runs the gradient twice at that size (seeds 0 and 1),
each timed with a synchronise, as chip_smoke.py phases 19 and 20 once
did: the first call's wall, and the second's in a warm process (phase
20's spline runs at --depth 3, chip_smoke.SPLINE_DEPTH; --depth replaces
the scene's own). After a
warm-up at 8^2 it runs:
- one gradient with its forward (the checkpointed bounces) and its
  backward (the recomputed bounces and the rest) timed apart, and inside
  every bounce the detached Levenberg solves of the BVP (kernel E for the
  radial RIF), the attached curved marches (trace and sensitivity loops)
  and the rest: host clock, with a device synchronise around each part;
- unless --no-profile, one gradient under torch.profiler, device
  activity only (host activity, a few million operators, is too slow to
  trace): device time of kernel E and of everything else, kernel
  launches, the device's busy share of the wall and the top kernels.
It imports the package of the tree it lies in.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import _er_grad_scene, _er_loss, _spline_scene  # noqa: E402

# (scene factory, default res, default sppc, the media field differentiated)
SCENES = {"radial": (_er_grad_scene, 32, 2, "rif_params"),
          "spline": (lambda res: _spline_scene(res, 32), 64, 2, "rif_coeff")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=sorted(SCENES), default="radial")
    ap.add_argument("--res", type=int)
    ap.add_argument("--sppc", type=int)
    ap.add_argument("--depth", type=int)
    ap.add_argument("--repeat", action="store_true")
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    make, res, sppc, field = SCENES[args.scene]
    res, sppc = args.res or res, args.sppc or sppc

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_er_grad_torch: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch.integrators import volpath_er
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.models import ermarch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    parts = (("body", volpath_er, "body"),
             ("solve", ek, "_levenberg_solve"),
             ("trace", ermarch, "trace_plain"),
             ("sens", ermarch, "sens_march_plain"))

    def timed(name, fn, spans, phase):
        def run(*a, **k):
            # a recomputed bounce ends early, by an exception, once the
            # backward has the tensors it needs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                # the detached solves' own marches count with the solves
                if name == "solve" or torch.is_grad_enabled():
                    spans[phase[0]][name] += time.perf_counter() - t0
        return run

    def gradient(res, seed, spans=None):
        """(forward s, backward s, loss) of one gradient; spans, where
        given, receives the host time of each part by phase."""
        scene, cfg = make(res)
        if args.depth:
            cfg = dataclasses.replace(cfg, max_depth=args.depth)
        scene = scene.to(dev)
        leaf = getattr(scene.media, field).detach().clone().requires_grad_()
        phase = ["forward"]
        saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in parts]
        if spans is not None:
            for (name, mod, attr), (_, _, fn) in zip(parts, saved):
                setattr(mod, attr, timed(name, fn, spans, phase))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = _er_loss(scene, cfg, sppc, seed, dev, **{field: leaf})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            phase[0] = "backward"
            torch.autograd.grad(loss, leaf)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        return t1 - t0, t2 - t1, loss.item()

    if args.repeat:
        walls = []
        for seed in (0, 1):
            t0 = time.perf_counter()
            fwd, bwd, loss = gradient(res, seed)
            walls.append(time.perf_counter() - t0)
        print(f"eikonal gradient ({args.scene}) {res}x{res} sppc {sppc}, "
              f"two calls: first (seed 0) {walls[0]:.3f} s, second (seed 1) "
              f"{walls[1]:.3f} s, {res * res * sppc / walls[1]:.1f} fwd+bwd "
              f"samples/s [{card}]", flush=True)
    gradient(8, 0)                                           # warm-up
    spans = {p: dict.fromkeys(("body", "solve", "trace", "sens"), 0.0)
             for p in ("forward", "backward")}
    torch.cuda.reset_peak_memory_stats(dev)
    ermarch.sens_march.launches = 0
    fwd, bwd, loss = gradient(res, 1, spans)
    peak = torch.cuda.max_memory_allocated(dev)
    f_, b_ = spans["forward"], spans["backward"]
    print(f"eikonal gradient ({args.scene}) {res}x{res} sppc {sppc}: "
          f"forward {fwd:.3f} s (bounces {f_['body']:.3f} s: detached "
          f"solves {f_['solve']:.3f} s, attached trace {f_['trace']:.3f} s, "
          f"attached sensitivity march {f_['sens']:.3f} s), backward "
          f"{bwd:.3f} s (recomputed bounces {b_['body']:.3f} s: detached "
          f"solves {b_['solve']:.3f} s, attached trace {b_['trace']:.3f} s, "
          f"attached sensitivity march {b_['sens']:.3f} s; the rest "
          f"{bwd - b_['body']:.3f} s), loss {loss:.6e}, peak device memory "
          f"{peak / 2**30:.3f} GiB, kernel E launches "
          f"{ermarch.sens_march.launches} (parts timed with a synchronise "
          f"each) [{card}]", flush=True)
    if args.no_profile:
        return 0

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd, bwd, _ = gradient(res, 1)
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = {"E": [0.0, 0], "other": [0.0, 0]}
    for e in events:
        t = dev_us(e)
        if t <= 0 or not str(e.device_type).endswith("CUDA"):
            continue
        name = "E" if "er_sens_kernel" in e.key else "other"
        kern[name][0] += t / 1e6
        kern[name][1] += e.count
    busy = sum(v[0] for v in kern.values())
    print(f"profiled gradient ({args.scene}) {res}x{res} sppc {sppc}: wall "
          f"{wall:.3f} s, forward {fwd:.3f} s, backward {bwd:.3f} s; device "
          f"time: E {kern['E'][0]:.4f} s in {kern['E'][1]} launches, other "
          f"{kern['other'][0]:.4f} s in {kern['other'][1]} launches; busy "
          f"share of wall {busy / wall:.4f}; E share of device time "
          f"{kern['E'][0] / max(busy, 1e-12):.4f} [{card}]", flush=True)
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(events.table(sort_by=key, row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
