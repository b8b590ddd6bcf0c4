"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python3 scripts/profile_train_torch.py [--res 512] [--sppc 4]
                                           [--no-profile]

One step of the training path (`diff.render.loss_and_grad`) on the
beam-lit heterogeneous box (volumetric_box, density 64^3, depth 12), as
chip_smoke.py phase 17 takes it: the target rendered at sigma_s x 1.5,
then the loss and its gradients at the preset's parameters. After a
warm-up step at 32^2 it runs:
- one step with its forward (render_diff and the loss, building the
  graph), its backward (autograd.grad) and, inside the backward, the
  recomputed bounces timed apart: host clock with a device synchronise
  around each part and each bounce;
- unless --no-profile, one step under torch.profiler: device time of kernel A (forward lookups,
  in the forward and again in the recompute), of kernel A' (the backward
  lookups) and of everything else, kernel launches, the device's busy
  share of the wall, host-device synchronisations and the top operators.
It imports the package of the tree it lies in, so a copy of the tree
(scripts/ and mitsubaer_tpu_torch/) times that copy's package.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--sppc", type=int, default=4)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch.diff import render as diff_m
    from mitsubaer_tpu_torch.integrators import volpath
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def step_parts(res, sppc, seed, spans=None):
        """(forward s, backward s, loss) of one step; spans, where given,
        receives the host time of each bounce by phase."""
        scene, cfg = presets.volumetric_box(res=res, spp=sppc,
                                            heterogeneous=True,
                                            density_res=64, max_depth=12)
        scene = scene.to(dev)
        params = diff_m.get_params(scene)
        with torch.no_grad():
            target = diff_m.render_diff(
                scene, params._replace(sigma_s=params.sigma_s * 1.5), cfg,
                sppc, 123, 0, device=dev)
        leaves = diff_m.MediumParams(*(t.detach().clone().requires_grad_()
                                       for t in params))
        torch.cuda.synchronize()
        phase = ["forward"]
        body = volpath.body

        def timed_body(*a, **k):
            # a recomputed bounce ends early, by an exception, once the
            # backward has the tensors it needs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return body(*a, **k)
            finally:
                torch.cuda.synchronize()
                spans[phase[0]].append(time.perf_counter() - t0)

        if spans is not None:
            volpath.body = timed_body
        try:
            t0 = time.perf_counter()
            loss = diff_m.loss_fn(scene, leaves, cfg, sppc, seed, 0, target,
                                  device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            phase[0] = "recompute"
            torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            volpath.body = body
        return t1 - t0, t2 - t1, loss.item()

    step_parts(32, args.sppc, 0)                             # warm-up
    spans = {"forward": [], "recompute": []}
    torch.cuda.reset_peak_memory_stats(dev)
    fwd, bwd, loss = step_parts(args.res, args.sppc, 7, spans)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"training step {args.res}x{args.res} sppc {args.sppc}: forward "
          f"{fwd:.3f} s ({len(spans['forward'])} bounces, "
          f"{sum(spans['forward']):.3f} s in them), backward {bwd:.3f} s "
          f"(recomputed bounces {len(spans['recompute'])}, "
          f"{sum(spans['recompute']):.3f} s in them, the rest "
          f"{bwd - sum(spans['recompute']):.3f} s), loss {loss:.6e}, peak "
          f"device memory {peak / 2**30:.3f} GiB (bounces timed with a "
          f"synchronise each; package {Path(diff_m.__file__).parents[2]}) "
          f"[{card}]", flush=True)
    if args.no_profile:
        return 0

    medium.trilinear_lookup.launches = 0
    medium.trilinear_lookup_backward.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd, bwd, _ = step_parts(args.res, args.sppc, 7)
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = {"A": [0.0, 0], "A_bwd": [0.0, 0], "other": [0.0, 0]}
    for e in events:
        t = dev_us(e)
        if t <= 0 or not str(e.device_type).endswith("CUDA"):
            continue
        name = ("A_bwd" if "trilinear_backward_kernel" in e.key else
                "A" if "trilinear_kernel" in e.key else "other")
        kern[name][0] += t / 1e6
        kern[name][1] += e.count
    busy = sum(v[0] for v in kern.values())
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    print(f"profiled step (target render included) {args.res}x{args.res} "
          f"sppc {args.sppc}: wall {wall:.3f} s, forward {fwd:.3f} s, "
          f"backward {bwd:.3f} s; device time: A {kern['A'][0]:.4f} s in "
          f"{kern['A'][1]} launches, A' {kern['A_bwd'][0]:.4f} s "
          f"in {kern['A_bwd'][1]} launches, other "
          f"{kern['other'][0]:.4f} s in {kern['other'][1]} launches; busy "
          f"share of wall {busy / wall:.4f}; A' share of device time "
          f"{kern['A_bwd'][0] / max(busy, 1e-12):.4f}; "
          f"host-device synchronisations {syncs}; counters A "
          f"{medium.trilinear_lookup.launches} A' "
          f"{medium.trilinear_lookup_backward.launches} [{card}]",
          flush=True)
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(events.table(sort_by=key, row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
