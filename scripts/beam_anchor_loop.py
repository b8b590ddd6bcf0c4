"""The loop engine against the double-scatter beam quadrature, on the CPU.

    python3 scripts/beam_anchor_loop.py [--passes 16] [--threads 4]

tests/test_boxwalk.py's configuration (volumetric_box at 12^2, density
16^3, depth 2, box filter, passes of 64 spp at seed p + 1 and pass index
p): the port's quadrature at its default resolution and at the reduced one
tests/test_torch_loop_render.py uses; the JAX loop engine's render_pass
over the first 4 passes; the port's over 4, 8, ... --passes passes. Prints
each pixel-by-pixel median ratio over the pixels above the truth's 30th
percentile (the test's statistic) and the ratio of the means.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=16)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mitsubaer_tpu.integrators import render as jrender
    from mitsubaer_tpu.scene import presets as jpresets
    from mitsubaer_tpu_torch.integrators import render as trender
    from mitsubaer_tpu_torch.scene import presets as tpresets
    from mitsubaer_tpu_torch.utils import validate as tvalidate

    torch.set_num_threads(args.threads)
    kw = dict(res=12, spp=64, heterogeneous=True, density_res=16,
              max_depth=2, filter="box", engine="loop")
    scene, cfg = tpresets.volumetric_box(**kw)
    t0 = time.perf_counter()
    truth = tvalidate.beam_double_scatter_quadrature(scene, cfg)
    print(f"quadrature (2x2 subpixels, 96 x 192 steps) in "
          f"{time.perf_counter() - t0:.1f} s on the CPU", flush=True)
    truth = truth.mean(-1).ravel()
    reduced = tvalidate.beam_double_scatter_quadrature(
        scene, cfg, nt=24, ns=64).mean(-1).ravel()
    sel = truth > np.percentile(truth, 30)

    def ratios(acc):
        return (np.median(acc[sel] / truth[sel]),
                acc[sel].mean() / truth[sel].mean())

    print(f"reduced quadrature (24 x 64 steps) / default: median "
          f"{np.median(reduced[sel] / truth[sel]):.6f}", flush=True)

    def developed(accum):
        accum = np.asarray(accum)
        return (accum[..., :3] / accum[..., 3:]).mean(-1).ravel()

    js, jc = jpresets.volumetric_box(**kw)
    acc = np.zeros(144)
    for p in range(4):
        acc += developed(jrender.render_pass(
            js, jnp.zeros((12, 12, 4)), jc, 64, jnp.uint32(p + 1),
            jnp.uint32(p)))
    med, mean = ratios(acc / 4)
    print(f"JAX loop engine, 4 passes: median ratio {med:.6f}, mean ratio "
          f"{mean:.6f}", flush=True)
    acc = np.zeros(144)
    for p in range(args.passes):
        accum, _ = trender.render_pass(scene, torch.zeros((12, 12, 4)), cfg,
                                       64, p + 1, p)
        acc += developed(accum.numpy())
        if (p + 1) % 4 == 0:
            med, mean = ratios(acc / (p + 1))
            print(f"port loop engine, {p + 1} passes: median ratio "
                  f"{med:.6f}, mean ratio {mean:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
