"""The VPL estimator's mean against the path tracer's on BASELINE config 1
(the Cornell box), on the CPU: the JAX package's, and with --package
both the port's too.

    python3 scripts/vpl_ratio_check.py [--res 32] [--package jax|both]

Renders presets.cornell_box(res) with integrator "path" at spp 64 and
"vpl" at spp 4 (16 light paths of 3 bounces: 64 VPLs, the clamp 2% of
the diagonal) from seed 0 in each package, and prints each mean and the
ratio vpl / path. chip_smoke.py phase 50 holds the port's ratio on the
card at 256^2 spp 4 (the same 64 VPLs) within 10% of the JAX package's
ratio here. JAX's two renders take a few minutes to compile and run here.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--package", choices=("jax", "both"), default="jax")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from mitsubaer_tpu.integrators import render as jrender
    from mitsubaer_tpu.scene import presets as jpresets

    t0 = time.perf_counter()
    jscene, jcfg = jpresets.cornell_box(res=args.res)
    jpath = float(jrender.render(jscene, jcfg._replace(spp=64), seed=0).mean())
    jvpl = float(jrender.render(
        jscene, jcfg._replace(spp=4, integrator="vpl"), seed=0).mean())
    print(f"JAX, config 1 at {args.res}x{args.res}: path (spp 64) mean "
          f"{jpath:.6f}, vpl (spp 4) mean {jvpl:.6f}, ratio "
          f"{jvpl / jpath:.4f} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if args.package == "both":
        from mitsubaer_tpu_torch.integrators import render as render_m
        from mitsubaer_tpu_torch.scene import presets

        t0 = time.perf_counter()
        scene, cfg = presets.cornell_box(res=args.res)
        path = render_m.render(scene, dataclasses.replace(cfg, spp=64),
                               seed=0, device="cpu").mean().item()
        vpl = render_m.render(scene, dataclasses.replace(
            cfg, spp=4, integrator="vpl"), seed=0, device="cpu").mean().item()
        print(f"port, config 1 at {args.res}x{args.res}: path (spp 64) "
              f"mean {path:.6f}, vpl (spp 4) mean {vpl:.6f}, ratio "
              f"{vpl / path:.4f}; its vpl over JAX's path "
              f"{vpl / jpath:.4f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
