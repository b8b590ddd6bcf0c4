"""The sign of the JAX package's sigma_s gradient over seeds (CPU): the
reference for scripts/grad_sign_torch.py.

    python3 scripts/grad_sign_jax.py [--res 32] [--sppc 4] [--seeds 40]

The same scene and estimate as grad_sign_torch.py without --decorrelated:
on the beam-lit heterogeneous box (`volumetric_box(heterogeneous=True,
density_res=64, max_depth=12)`), a target rendered at sigma_s x 1.5
(render_diff, seed 123), then `loss_and_grad` at the preset's parameters
for each seed; prints the per-channel mean of the sigma_s gradient, its
standard error and the share of seeds with a positive sign.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mitsubaer_tpu.diff import render as diff_m  # noqa: E402
from mitsubaer_tpu.scene import presets  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--sppc", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=40)
    args = ap.parse_args()
    scene, cfg = presets.volumetric_box(res=args.res, spp=args.sppc,
                                        heterogeneous=True, density_res=64,
                                        max_depth=12)
    params = diff_m.get_params(scene)
    target = diff_m.render_diff(
        scene, params._replace(sigma_s=params.sigma_s * 1.5), cfg,
        args.sppc, jnp.uint32(123), jnp.uint32(0))
    grads = []
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        _, g = diff_m.loss_and_grad(scene, params, cfg, args.sppc,
                                    jnp.uint32(seed), jnp.uint32(0), target)
        grads.append(np.asarray(g.sigma_s).reshape(-1))
    g = np.asarray(grads)
    print(f"JAX loss_and_grad d loss / d sigma_s at {args.res}^2, sppc "
          f"{args.sppc}, {args.seeds} seeds "
          f"({time.perf_counter() - t0:.1f} s, CPU): mean "
          f"{g.mean(0).tolist()}, standard error "
          f"{(g.std(0) / np.sqrt(len(g))).tolist()}, share positive "
          f"{(g > 0).mean(0).tolist()}")


if __name__ == "__main__":
    main()
