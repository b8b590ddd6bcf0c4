"""Where the time of the port's loop-engine render goes, on one NVIDIA GPU.

    python3 scripts/profile_loop_torch.py [--res 512] [--spp 32]
                                          [--repeats 2] [--profile-spp 8]

Renders the bounded volume with its default gaussian film filter
(volumetric_box, heterogeneous, density 64^3, depth 12, collimated beam)
down the PyTorch/CUDA port's loop road: once small to warm up, --repeats
times at --res / --spp for the spread of the wall time (with bounces and
Woodcock iterations a pass and kernel A's launches), then once at
--profile-spp (one pass when it is at most 2^21 / res^2) under
torch.profiler. Prints the wall times, the device time of kernel A and of
everything else, the device's busy share of the wall, the host time inside
the bounce bodies, the Woodcock tracking calls, the batched shadow-ray
visibility calls, the film splats and the beam-splat passes (host spans
that include the device waits they cause), the kernel launches and the
host-device synchronisations.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPANS = ("bounce", "woodcock", "visibility", "film_splat", "beam_splat")


def _scene(presets, res, spp):
    return presets.volumetric_box(res=res, spp=spp, heterogeneous=True,
                                  density_res=64, max_depth=12)


def _spanned(module, attr, span):
    """Wrap module.attr in a torch.profiler span of the given name."""
    from torch.profiler import record_function

    fn = getattr(module, attr)

    def wrapped(*a, **k):
        with record_function(span):
            return fn(*a, **k)
    setattr(module, attr, wrapped)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--profile-spp", type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_loop_torch: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.integrators import volpath
    from mitsubaer_tpu_torch.models import film, medium
    from mitsubaer_tpu_torch.scene import presets

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for module, attr, span in (
            (volpath, "body", "bounce"),
            (medium, "sample_distance_woodcock", "woodcock"),
            (volpath, "attenuated_visibility", "visibility"),
            (film, "splat", "film_splat"),
            (render_m, "beam_splat_pass", "beam_splat")):
        _spanned(module, attr, span)

    scene, cfg = _scene(presets, 32, 2)
    render_m.render(scene, cfg, seed=0, device=dev)        # warm-up
    scene, cfg = _scene(presets, args.res, args.spp)
    scene = scene.to(dev)
    walls = []
    for _ in range(args.repeats):
        stats = {}
        medium.trilinear_lookup.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_m.render(scene, cfg, seed=1, device=dev, stats=stats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"loop render {args.res}x{args.res} spp {args.spp}, unprofiled "
          f"walls: {', '.join(f'{w:.3f}' for w in walls)} s; [bounces, "
          f"Woodcock iterations] a pass {stats['passes']}; loop passes "
          f"{stats['loop_s']:.3f} s; kernel A launches "
          f"{medium.trilinear_lookup.launches} [{card}]", flush=True)

    scene, cfg = _scene(presets, args.res, args.profile_spp)
    scene = scene.to(dev)
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

    kern = {"trilinear": 0.0, "other": 0.0}
    n_kern = n_a = 0
    for e in events:
        t = dev_us(e)
        # device-side kernel events only: the host ops that launch them
        # carry the same time again, and the spans appear on both sides
        if (t <= 0 or e.key in SPANS
                or not str(e.device_type).endswith("CUDA")):
            continue
        n_kern += e.count
        if "trilinear_kernel" in e.key:
            kern["trilinear"] += t
            n_a += e.count
        else:
            kern["other"] += t
    busy = sum(kern.values()) / 1e6
    host = {name: max((e.cpu_time_total / 1e6 for e in events
                       if e.key == name), default=0.0) for name in SPANS}
    calls = {name: max((e.count for e in events if e.key == name), default=0)
             for name in SPANS}
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    print(f"profiled render {args.res}x{args.res} spp {args.profile_spp}: "
          f"wall {wall:.3f} s, mean {img.mean().item():.6f} [{card}]")
    print(f"device time: kernel A {kern['trilinear'] / 1e6:.4f} s in {n_a} "
          f"launches, other kernels {kern['other'] / 1e6:.4f} s "
          f"({n_kern} kernel launches in all); busy share of wall "
          f"{busy / wall:.4f}; kernel A's share of device time "
          f"{kern['trilinear'] / 1e6 / max(busy, 1e-12):.4f}")
    for name in SPANS:
        print(f"host span {name}: {host[name]:.3f} s in {calls[name]} calls")
    print(f"host-device synchronisations: {syncs}")
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(events.table(sort_by=key, row_limit=16))
    return 0


if __name__ == "__main__":
    sys.exit(main())
