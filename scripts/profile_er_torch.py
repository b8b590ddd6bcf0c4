"""Where the time of the port's eikonal render goes, on one NVIDIA GPU.

    python3 scripts/profile_er_torch.py [--res 96] [--spp 2] [--repeats 3]
                                        [--acoustic]

Renders bench.py::bench_er_forward's configuration (refractive_sphere,
linear RIF, depth 6, h 1e-2, 8 BVP restarts at 4x h, box filter) with the
PyTorch/CUDA port: once small to warm up, --repeats times at --res / --spp
for the spread of the wall time, then once more under torch.profiler.
With --acoustic it renders the acoustic RIF instead (mode 2, kr 6, depth
3, 256 steps: chip_smoke.py's phase 24 scene) through the plain loops
(kernels D and E have no acoustic field), --repeats times unprofiled,
and prints the walls.
Prints the wall times, the device time of kernels D and E
and of everything else, the device's busy share of the wall, the host time
inside the BVP solve, the Levenberg solves, the Jacobian evaluations and the
curved trace (host spans that include the device waits they cause), and the
number of host-device synchronisations.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPANS = ("solve_bvp", "_levenberg_solve", "integrate_with_sensitivities",
         "trace_curved")


def _scene(presets, res, spp, acoustic=False):
    from mitsubaer_tpu_torch.models import eikonal as ek

    kw = (dict(max_depth=3, rif_kind=ek.RIF_ACOUSTIC,
               rif_params=(1.3333, 0.03, 6.0, 2.0)) if acoustic else
          dict(max_depth=6, rif_kind=ek.RIF_LINEAR, rif_params=(1.3, 0.15)))
    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, er_stepsize=1e-2, filter="box", **kw)
    return scene, replace(cfg, er_maxsteps=256, bvp_restarts=8,
                          er_bvp_hscale=4.0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--acoustic", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_er_torch: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import eikonal as ek
    from mitsubaer_tpu_torch.scene import presets

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def spanned(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    for name in SPANS:
        setattr(ek, name, spanned(name, getattr(ek, name)))

    scene, cfg = _scene(presets, 24, 1, args.acoustic)
    render_m.render(scene, cfg, seed=0, device=dev)        # warm-up
    scene, cfg = _scene(presets, args.res, args.spp, args.acoustic)
    walls = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_m.render(scene, cfg, seed=1, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    what = "acoustic (mode 2, depth 3)" if args.acoustic else "eikonal"
    print(f"{what} render {args.res}x{args.res} spp {args.spp}, unprofiled "
          f"walls: {', '.join(f'{w:.3f}' for w in walls)} s, mean "
          f"{img.mean().item():.6f} [{card}]")
    if args.acoustic:
        return 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img = render_m.render(scene, cfg, seed=1, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = {"er_trace": 0.0, "er_sens": 0.0, "other": 0.0}
    n_kern = 0
    for e in events:
        t = dev_us(e)
        # device-side kernel events only: the host ops that launch them
        # carry the same time again, and the spans appear on both sides
        if (t <= 0 or e.key in SPANS
                or not str(e.device_type).endswith("CUDA")):
            continue
        n_kern += e.count
        if "er_trace_kernel" in e.key:
            kern["er_trace"] += t
        elif "er_sens_kernel" in e.key:
            kern["er_sens"] += t
        else:
            kern["other"] += t
    busy = sum(kern.values()) / 1e6
    host = {name: max((e.cpu_time_total / 1e6 for e in events
                       if e.key == name), default=0.0) for name in SPANS}
    calls = {name: max((e.count for e in events if e.key == name), default=0)
             for name in SPANS}
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    print(f"profiled render: wall {wall:.3f} s, mean {img.mean().item():.6f} [{card}]")
    print(f"device time: D {kern['er_trace'] / 1e6:.4f} s, E "
          f"{kern['er_sens'] / 1e6:.4f} s, other kernels "
          f"{kern['other'] / 1e6:.4f} s ({n_kern} kernel launches); busy "
          f"share of wall {busy / wall:.4f}")
    for name in SPANS:
        print(f"host span {name}: {host.get(name, 0.0):.3f} s in "
              f"{calls.get(name, 0)} calls")
    print(f"host-device synchronisations: {syncs}")
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(events.table(sort_by=key, row_limit=16))
    return 0


if __name__ == "__main__":
    sys.exit(main())
