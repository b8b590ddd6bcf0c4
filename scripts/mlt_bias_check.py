"""pssmlt_volpath's mean against the loop road on the main path's volume,
in the port and (with --package both) in the JAX package, on the CPU.

    python3 scripts/mlt_bias_check.py [--res 32] [--spp 16] [--package both]

Renders presets.volumetric_box(res, heterogeneous=True, density_res=16,
max_depth=12) on the loop road at spp 32 (the port's image with and
without its beam splat; JAX's render() with it), then "pssmlt_volpath"
at --spp (rounds = spp npix / chains) from seed 1 in each package, and
prints each mean, the bootstrap's b against the loop road's mean
luminance less the splat, and the ratio of the MLT mean to that image's
(chip_smoke.py phase 44(b) reads it at 512^2 on the card). JAX's
references take ~1 min to compile here; the port's renders ~10-30 s.
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
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--package", choices=("torch", "both"), default="torch")
    args = ap.parse_args()

    import torch

    from mitsubaer_tpu_torch.integrators import pssmlt
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.scene import presets

    kw = dict(res=args.res, spp=32, heterogeneous=True, density_res=16,
              max_depth=12)
    scene, cfg = presets.volumetric_box(**kw)
    full = render_m.render(scene, cfg, seed=0, device="cpu")
    ref = full - render_m._add_beam_splat(scene, cfg, torch.zeros_like(full),
                                          0)
    mlt_cfg = dataclasses.replace(cfg, spp=args.spp,
                                  integrator="pssmlt_volpath")
    n_chains, D = pssmlt.chain_shape(mlt_cfg, None)
    b, _ = pssmlt.bootstrap(scene, mlt_cfg, 1 << 16, D, n_chains, 1, "cpu")
    lum = torch.tensor(pssmlt._LUM)
    t0 = time.perf_counter()
    stats = {}
    img = pssmlt.render_pssmlt(scene, mlt_cfg, seed=1, stats=stats)
    print(f"port, {args.res}x{args.res}: loop road (spp 32) mean "
          f"{full.mean().item():.6f}, less its beam splat "
          f"{ref.mean().item():.6f} (mean luminance "
          f"{(ref.reshape(-1, 3) @ lum).mean().item():.6f}); bootstrap b "
          f"{b.item():.6f}; pssmlt_volpath spp {args.spp} ({n_chains} chains, "
          f"{stats['rounds']} rounds) mean {img.mean().item():.6f}, ratio "
          f"{img.mean().item() / ref.mean().item():.4f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.package == "both":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from mitsubaer_tpu.integrators import pssmlt as jpssmlt
        from mitsubaer_tpu.integrators import render as jrender
        from mitsubaer_tpu.scene import presets as jpresets

        jscene, jcfg = jpresets.volumetric_box(**kw)
        jfull = jrender.render(jscene, jcfg, seed=0)
        jimg = jpssmlt.render_pssmlt(
            jscene, jcfg._replace(spp=args.spp, integrator="pssmlt_volpath"),
            seed=1)
        print(f"JAX, {args.res}x{args.res}: loop road (spp 32) mean "
              f"{float(jfull.mean()):.6f}; pssmlt_volpath spp {args.spp} "
              f"mean {float(jimg.mean()):.6f}, ratio to the port's loop "
              f"road less its splat "
              f"{float(jimg.mean()) / ref.mean().item():.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
