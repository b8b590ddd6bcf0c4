"""Where the time of the port's wavefront render goes, on one NVIDIA GPU.

    python3 scripts/profile_wavefront_torch.py [--res 512] [--spp 32]
                                               [--repeats 3]

Renders the point-lit heterogeneous bounded volume (volumetric_box,
heterogeneous, density 64^3, depth 12, point emitter, box filter) with the
PyTorch/CUDA port's wavefront road: once small to warm up, --repeats times
at --res / --spp for the spread of the wall time, then once more under
torch.profiler. Prints the wall times, the device time of kernel C and of
everything else, the device's busy share of the wall, the host time inside
the full event passes, the transition passes and the tracking calls (host
spans that include the device waits they cause), the kernel launches and
the host-device synchronisations.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPANS = ("event_pass", "transition_pass", "tracking_mega")


def _scene(presets, res, spp):
    return presets.volumetric_box(res=res, spp=spp, heterogeneous=True,
                                  density_res=64, max_depth=12, filter="box",
                                  emitter_kind="point")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_wavefront_torch: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.integrators import wavefront
    from mitsubaer_tpu_torch.scene import presets

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    make_engine = wavefront.make_engine

    def spanned_engine(*a, **k):
        st, event_pass, tracking_mega, cond, finalize = make_engine(*a, **k)

        def ev(s, mini=False):
            with record_function(SPANS[1] if mini else SPANS[0]):
                return event_pass(s, mini)

        def tr(s):
            with record_function(SPANS[2]):
                return tracking_mega(s)
        return st, ev, tr, cond, finalize

    wavefront.make_engine = spanned_engine

    scene, cfg = _scene(presets, 32, 2)
    render_m.render(scene, cfg, seed=0, device=dev)        # warm-up
    scene, cfg = _scene(presets, args.res, args.spp)
    walls = []
    for _ in range(args.repeats):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_m.render(scene, cfg, seed=1, device=dev, stats=stats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    segs = sum(p[0] for p in stats["passes"])
    print(f"wavefront render {args.res}x{args.res} spp {args.spp}, "
          f"unprofiled walls: {', '.join(f'{w:.3f}' for w in walls)} s; "
          f"passes {stats['passes']}; last {segs / stats['wavefront_s'] / 1e6:.3f}"
          f" Mrays/s [{card}]")
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

    kern = {"megatrack": 0.0, "other": 0.0}
    n_kern = 0
    for e in events:
        t = dev_us(e)
        # device-side kernel events only: the host ops that launch them
        # carry the same time again, and the spans appear on both sides
        if (t <= 0 or e.key in SPANS
                or not str(e.device_type).endswith("CUDA")):
            continue
        n_kern += e.count
        kern["megatrack" if "megatrack_kernel" in e.key else "other"] += t
    busy = sum(kern.values()) / 1e6
    host = {name: max((e.cpu_time_total / 1e6 for e in events
                       if e.key == name), default=0.0) for name in SPANS}
    calls = {name: max((e.count for e in events if e.key == name), default=0)
             for name in SPANS}
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    print(f"profiled render: wall {wall:.3f} s, mean {img.mean().item():.6f} "
          f"[{card}]")
    print(f"device time: kernel C {kern['megatrack'] / 1e6:.4f} s, other "
          f"kernels {kern['other'] / 1e6:.4f} s ({n_kern} kernel launches); "
          f"busy share of wall {busy / wall:.4f}")
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
