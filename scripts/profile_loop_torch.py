"""Where the time of the port's loop-engine render goes, on one NVIDIA GPU.

    python3 scripts/profile_loop_torch.py [--scene het_volume|cbox_medium]
        [--res N] [--spp N] [--repeats 3] [--profile-spp N]

Renders one of the benchmark's scenes (bench_port/configs: the bounded
volume with its beam, default 512^2 spp 32, or the Cornell box in fog,
256^2 spp 64) down the PyTorch/CUDA port's loop road: once small to warm
up; then --repeats pairs of the full image with tracing off and on
(`utils/stats.tracing()`, no profiler), in alternating order, for the
tracing's cost; then, from the last traced image's spans, the host reads
(count and wait a million samples, by site), the bounces' lane occupancy
by bounce, the beam splat and the film's develop; then one render at
--profile-spp (one pass when it is at most 2^21 / res^2) under
torch.profiler. Prints the wall times, the device time of kernel A and of
everything else, the device's busy share of the wall, the host time
inside the bounces, the Woodcock and shadow-ray crossing loops, the film
splats and the beam splat (the program's own spans, which include the
device waits they cause), the host reads, and the share of the device's
idle time that falls in the host-driven loops.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FOG = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)
SCENES = {"het_volume": (512, 32, 8), "cbox_medium": (256, 64, 32)}
# the program's spans behind each line of the profiled render's host times
HOST_LINES = {"bounce": ("volpath.bounce",), "woodcock": ("medium.track:woodcock",),
         "visibility": ("medium.track:crossing",),
         "film_splat": ("film.splat",), "beam_splat": ("render.beam_splat",)}


def _scene(presets, name, res, spp):
    if name == "het_volume":
        return presets.volumetric_box(res=res, spp=spp, heterogeneous=True,
                                      density_res=64, max_depth=12)
    return presets.cornell_box(res=res, spp=spp, max_depth=40,
                               integrator="volpath", medium=FOG)


def _ms(spans):
    return sum(s.end - s.start for s in spans) / 1e6


def _readings(spans, msamples):
    """Lines of the host reads by site, the occupancy by bounce and the
    beam splat and develop, from one traced render's spans."""
    by_site = defaultdict(list)
    for s in spans:
        if s.name.startswith("sync:"):
            by_site[s.name[5:]].append(s)
    n = sum(len(v) for v in by_site.values())
    wait = sum(_ms(v) for v in by_site.values())
    out = [f"host reads: {n / msamples:.1f} /Msample, wait "
           f"{wait / msamples:.1f} ms/Msample"]
    for site, v in sorted(by_site.items(), key=lambda kv: -_ms(kv[1])):
        out.append(f"  {site}: {len(v) / msamples:.1f} /Msample, "
                   f"{_ms(v) / msamples:.2f} ms/Msample")
    by_bounce = defaultdict(lambda: [0, 0])
    k = 0
    for s in spans:
        if s.name == "render.pass":
            k = 0
        elif s.name in ("volpath.bounce", "path.bounce"):
            by_bounce[k][0] += s.counts["active"]
            by_bounce[k][1] += s.counts["lanes"]
            k += 1
    active = sum(a for a, _ in by_bounce.values())
    lanes = sum(n for _, n in by_bounce.values())
    out.append(f"lane occupancy {100 * active / max(lanes, 1):.2f}%; by "
               "bounce: " + ", ".join(
                   f"{k}: {100 * a / n:.1f}"
                   for k, (a, n) in sorted(by_bounce.items())))
    for name in ("render.beam_splat", "film.develop", "render.pass"):
        v = [s for s in spans if s.name == name]
        if v:
            out.append(f"{name}: {_ms(v) / len(v):.2f} ms x {len(v)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=sorted(SCENES), default="het_volume")
    ap.add_argument("--res", type=int)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--profile-spp", type=int)
    args = ap.parse_args()
    res, spp, pspp = SCENES[args.scene]
    res, spp = args.res or res, args.spp or spp
    pspp = args.profile_spp or pspp

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_loop_torch: no CUDA device", file=sys.stderr)
        return 1
    from bench_port.program_spans import HOST_LOOPS, idle_share_in
    from bench_port.trace import busy_union
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.utils import stats as stats_m

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    scene, cfg = _scene(presets, args.scene, 32, 2)
    render_m.render(scene, cfg, seed=0, device=dev)        # warm-up
    scene, cfg = _scene(presets, args.scene, res, spp)
    msamples = res * res * spp / 1e6
    walls = {False: [], True: []}
    for i in range(args.repeats):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            stats = {}
            stats_m.reset()
            medium.trilinear_lookup.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if traced:
                with stats_m.tracing():
                    render_m.render(scene, cfg, seed=1, device=dev,
                                    stats=stats)
                spans = list(stats_m.spans())
            else:
                render_m.render(scene, cfg, seed=1, device=dev, stats=stats)
            torch.cuda.synchronize()
            walls[traced].append(time.perf_counter() - t0)
    off, on = (statistics.median(walls[k]) for k in (False, True))
    print(f"loop render {args.scene} {res}x{res} spp {spp}, walls untraced "
          f"{', '.join(f'{w:.4f}' for w in walls[False])} s, traced "
          f"{', '.join(f'{w:.4f}' for w in walls[True])} s; tracing costs "
          f"{100 * (on / off - 1):.2f}% of the median wall; [bounces, "
          f"Woodcock iterations] a pass {stats['passes']}; loop passes "
          f"{stats['loop_s']:.3f} s; kernel A launches "
          f"{medium.trilinear_lookup.launches} [{card}]", flush=True)
    for line in _readings(spans, msamples):
        print(line)

    scene, cfg = _scene(presets, args.scene, res, pspp)
    stats_m.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img = render_m.render(scene, cfg, seed=1, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = list(stats_m.spans())
    names, rows = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            names.append(e.name())
            rows.append((e.start_ns(), e.end_ns()))
    iv = np.asarray(rows, dtype=np.float64).reshape(-1, 2)
    t_a = sum(b - a for n, (a, b) in zip(names, iv)
              if "trilinear_kernel" in n) / 1e9
    n_a = sum("trilinear_kernel" in n for n in names)
    busy = busy_union(iv) / 1e9
    lo = stats_m.to_trace_ns(spans[0].start)
    hi = stats_m.to_trace_ns(spans[0].end)
    in_loops = idle_share_in(np.clip(iv, lo, hi), lo, hi, spans, HOST_LOOPS)
    print(f"profiled render {res}x{res} spp {pspp}: wall {wall:.3f} s, "
          f"mean {img.mean().item():.6f} [{card}]")
    print(f"device time: kernel A {t_a:.4f} s in {n_a} launches, everything "
          f"else {busy - t_a:.4f} s ({len(names)} device operations in "
          f"all); busy share of wall {busy / wall:.4f}; kernel A's share of "
          f"device time {t_a / max(busy, 1e-12):.4f}; idle inside the host "
          f"loops {in_loops:.2f}% of the idle time")
    for line, names_ in HOST_LINES.items():
        v = [s for s in spans if s.name in names_]
        print(f"host span {line} ({', '.join(names_)}): {_ms(v) / 1e3:.3f} s "
              f"in {len(v)} calls")
    reads = [s for s in spans if s.name.startswith("sync:")]
    print(f"host-device synchronisations (host reads): {len(reads)}, "
          f"{_ms(reads) / 1e3:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
