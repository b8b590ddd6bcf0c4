"""Where the time of bdpt's and the particle tracer's full-width renders
goes, on one NVIDIA GPU.

    python3 scripts/profile_bdpt_torch.py

The paths of chip_smoke.py phases 39 and 40, each rendered once whole
(wall, passes), then one pass under torch.profiler (device activity only):
bdpt on the refractive sphere (96^2, depth 6, 64 transient frames, 8 BVP
restarts; kernels D and E), on the heterogeneous box lit by a point
emitter (256^2, depth 6; kernel A) and on the cbox (256^2, depth 8), and
the particle tracer on the cbox (256^2, depth 40). Prints for each its
wall, launches a pass, device time and busy share, with the card's name
and power limit, and one JSON line of them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_bdpt_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from mitsubaer_tpu_torch.integrators import ptracer
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.scene import presets

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    paths = c._bdpt_scenes(presets, 256, 8)
    paths["sphere"] = c._bdpt_scenes(presets, 96, 8)["sphere"]
    paths["ptracer"] = presets.cornell_box(res=256, spp=4,
                                           integrator="ptracer")
    out = {}
    for name, (scene, cfg) in paths.items():
        scene = scene.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_m.render(scene, cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "ptracer":
            H, W = cfg.height, cfg.width
            _, m = c._profile_pass(
                lambda: ptracer.trace_particles(scene, cfg, H * W, 0, 0),
                card, name)
        else:
            m = c._bdpt_pass_profile(scene, cfg, dev, card, f"bdpt, {name}")
        m.update(render_wall_s=wall, passes=cfg.spp)
        print(f"{name}: render {wall:.3f} s over {cfg.spp} passes, one pass "
              f"{m['launches']} launches, busy {m['busy']:.3f} [{card}]",
              flush=True)
        out[name] = m
        del scene
    print(json.dumps({"card": card, "profiles": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
