"""Runs one cell of the benchmark once on the CUDA card:

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, the scene, one warm pass at the
cell's own shapes) is `setup_s`: process start to the window's start. The
window is a closed loop of whole items of work (images, steps) that the
cell's traffic driver (traffic/<driver>.py) makes, each with a seed drawn
from --seed, started while less than --seconds has passed and closed when
the last one ends. --trace 0 reports the cell's end-to-end metrics,
--trace 1 profiles the whole window (CUDA activity) and reports its
per-layer metrics (metrics/<name>.py), with the device's busy and window
seconds and a breakdown. After the window the driver frees the program's
state and compares what the window made with the plain reference
(reference/): every number at or under its limit is `correct`. The
numbers compared and their limits are the last lines on standard error
and the result's last key; the result is the last line on standard
output.

What a driver gives (traffic/render_loop.py is one): Driver(cell, device)
with `span` (the name of an item's span), `span_targets` (the program's
functions a traced run times), warm(), timed_path(fault) (a context that
holds the window's hooks and plants a fault, None for a sound run),
step(seed, traced), end_to_end(window_s) -> {metric: value},
compare(seed) -> ({number: value}, {number: limit or None}); and, for
calibrate.py, FAULTS and control(cell, seed, items, device) -> {number:
value}.

A run that finds no CUDA card, fewer cards than the cell asks for, or a
JAX module loaded once the window has closed, prints no result and exits
with a code other than 0."""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "mitsubaer_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def derive_seed(seed: int, stream: int, i: int) -> int:
    """A 31-bit seed for item i of a stream, drawn from the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream, i])
    return int(ss.generate_state(1)[0]) & 0x7FFFFFFF


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m bench_port.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def window(drv, seed: int, seconds: float, traced: bool, spans,
           images: int | None = None):
    """The measured window: (seconds, items started). `images` fixes
    their count instead (the tests, whose CPU runs at any speed)."""
    i = 0
    t0 = time.perf_counter()
    while (i < images if images else time.perf_counter() - t0 < seconds):
        with spans.span(drv.span):
            drv.step(derive_seed(seed, 1, i), traced)
        i += 1
    return time.perf_counter() - t0, i


def verdict(values: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN fails); a limit of None
    leaves that number uncompared in the cell (PERF.md says why)."""
    return all(lim is None or (not math.isnan(values[k]) and values[k] <= lim)
               for k, lim in limits.items())


def run(argv=None, device=None, cell=None, fault=None, images=None):
    """One run; returns (exit code, result dict or None). device=None asks
    for the CUDA card; the tests pass the CPU, a shrunk cell and a count
    of items."""
    import torch

    from . import cell as cell_m
    from .trace import DeviceTrace, Spans

    args = parse(argv)
    cell = cell or cell_m.load(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA card: this benchmark measures the card only",
                  file=sys.stderr)
            return 2, None
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    drv = cell.driver().Driver(cell, device)
    drv.warm()
    setup_s = process_age_s()

    spans, prof = Spans(), None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
    with drv.timed_path(fault):
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            # the CPU's activity only where a test runs without a card
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
            with spans.patch(drv.span_targets), prof:
                perf0 = time.perf_counter_ns()
                clocks = {"perf": perf0, "wall": time.time_ns(),
                          "mono": time.monotonic_ns()}
                window_s, attempted = window(drv, args.seed, args.seconds,
                                             True, spans, images)
                perf1 = time.perf_counter_ns()
        else:
            window_s, attempted = window(drv, args.seed, args.seconds, False,
                                         spans, images)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1 if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power_limit"] = _power_limit()
    breakdown = None
    if args.trace:
        t_read = time.perf_counter()
        tr = DeviceTrace.from_profiler(prof, perf0, perf1)
        tr.align(clocks, perf0)
        ctx = Run(drv, tr, peak)
        for m in cell.per_layer:
            v = cell_m.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(),
                     "idle_gaps": tr.idle_gaps(spans.done)}
        print(f"trace: {tr.launches} device events read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    else:
        e2e = dict(drv.end_to_end(window_s), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    del prof
    t_ref = time.perf_counter()
    values, limits = drv.compare(derive_seed(args.seed, 2, 0))
    del drv
    print(f"window {window_s:.3f} s, {attempted} attempted; comparison "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct = verdict(values, limits)
    checked = {k: {"value": values[k], "limit": lim}
               for k, lim in limits.items() if lim is not None}

    bad_mods = forbidden_modules()
    if bad_mods:
        print(f"JAX or the JAX package is loaded: {bad_mods}",
              file=sys.stderr)
        return 3, None
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = checked
    return 0, result


class Run:
    """What a per-layer metric reads: the driver after the window, the
    device trace and the window's peak memory."""

    def __init__(self, drv, trace, peak_bytes):
        self.drv, self.trace, self.peak_bytes = drv, trace, peak_bytes


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def main(argv=None) -> int:
    code, result = run(argv)
    if result is None:
        return code or 1
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
