"""The sign of the training path's sigma_s gradient over seeds (CPU).

    python3 scripts/grad_sign_torch.py [--res 32] [--sppc 4] [--seeds 40]
                                       [--decorrelated]

On the beam-lit heterogeneous box (`volumetric_box(heterogeneous=True,
density_res=64, max_depth=12)`), renders a target at sigma_s x 1.5
(render_diff, seed 123) and takes `loss_and_grad` at the preset's
parameters for each seed, then prints the per-channel mean of the sigma_s
gradient, its standard error and the share of seeds with a positive sign.
With --decorrelated the loss gradient is formed from two independent
renders instead, image_grad at the weight 2 (img_a - target) / img.size
with img_a from another seed, which removes the covariance of a pass's
image and its own derivative from the estimate.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mitsubaer_tpu_torch.diff import render as diff_m  # noqa: E402
from mitsubaer_tpu_torch.scene import presets  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--sppc", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--decorrelated", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(8)
    scene, cfg = presets.volumetric_box(res=args.res, spp=args.sppc,
                                        heterogeneous=True, density_res=64,
                                        max_depth=12)
    params = diff_m.get_params(scene)
    with torch.no_grad():
        target = diff_m.render_diff(
            scene, params._replace(sigma_s=params.sigma_s * 1.5), cfg,
            args.sppc, 123, 0, device="cpu")
    grads = []
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        if args.decorrelated:
            with torch.no_grad():
                img = diff_m.render_diff(scene, params, cfg, args.sppc,
                                         seed + 1000, 0, device="cpu")
            weight = 2.0 * (img - target) / img.numel()
            g = diff_m.image_grad(scene, cfg, args.sppc, seed=seed,
                                  weight_image=weight, device="cpu")
        else:
            _, g = diff_m.loss_and_grad(scene, params, cfg, args.sppc, seed,
                                        0, target, device="cpu")
        grads.append(g.sigma_s.numpy().reshape(-1))
    g = np.asarray(grads)
    print(f"{'decorrelated' if args.decorrelated else 'loss_and_grad'} "
          f"d loss / d sigma_s at {args.res}^2, sppc {args.sppc}, "
          f"{args.seeds} seeds ({time.perf_counter() - t0:.1f} s, CPU): "
          f"mean {g.mean(0).tolist()}, standard error "
          f"{(g.std(0) / np.sqrt(len(g))).tolist()}, share positive "
          f"{(g > 0).mean(0).tolist()}")


if __name__ == "__main__":
    main()
