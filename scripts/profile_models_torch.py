"""Where the time of the model set's full-width renders goes, on one
NVIDIA GPU.

    python3 scripts/profile_models_torch.py

The renders of chip_smoke.py phases 32-35, each once to warm up, then one
pass under torch.profiler (device activity only): the 512^2 spp 32 volume
with an oriented microflake medium on the loop road; the Rayleigh beam
volume on the wavefront road (super-iterations 6-10 of a pass of sppc 4);
BASELINE config 1 with a thin lens; the sky-lit floor and boxes at 256^2
spp 64; config 1 with the ldsampler. Prints for each its wall, launches
(a bounce or a super-iteration), device time and busy share, with the
card's name and power limit, and one JSON line of them. Then config 1's
wall with the independent sampler and the ldsampler in turns
(independent, ldsampler, ldsampler, independent), which chip_smoke.py
phase 35 renders once each.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_models_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.scene import presets
    from mitsubaer_tpu_torch.scene import types as T

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    def thin_lens():
        scene, cfg = presets.cornell_box(res=256, spp=64, max_depth=40)
        sensor = dataclasses.replace(
            scene.sensor, kind=torch.tensor(T.SENSOR_THINLENS,
                                            dtype=torch.int32),
            aperture=torch.tensor(15.0), focus=torch.tensor(1000.0))
        return (dataclasses.replace(scene, sensor=sensor),
                dataclasses.replace(cfg, sensor_kind=T.SENSOR_THINLENS))

    def ldsampler():
        scene, cfg = presets.cornell_box(res=256, spp=64, max_depth=40)
        return scene, dataclasses.replace(cfg, sampler="ldsampler")

    cases = {
        "microflake_loop": lambda: c._oriented_box(512, 32,
                                                   T.PH_MICROFLAKE),
        "rayleigh_wavefront": lambda: c._oriented_box(512, 32,
                                                      T.PH_RAYLEIGH,
                                                      filter="box"),
        "thinlens_config1": thin_lens,
        "sky_loop": lambda: c._sky_scene(256, 64),
        "ldsampler_config1": ldsampler,
    }
    out = {}
    for name, make in cases.items():
        scene, cfg = make()
        scene = scene.to(dev)
        render_m.render(scene, cfg, seed=0, device=dev)    # warm
        torch.cuda.synchronize()
        if cfg.filter == "box":
            out[name] = c._profile_wavefront(scene, cfg, card, name)
        else:
            out[name] = c._loop_pass_profile(scene, cfg, dev, card, name)
        del scene
    c1, c1_cfg = presets.cornell_box(res=256, spp=64, max_depth=40)
    c1 = c1.to(dev)
    walls = {}
    for name in ("independent", "ldsampler", "ldsampler", "independent"):
        walls.setdefault(name, []).append(c._model_render(
            c1, dataclasses.replace(c1_cfg, sampler=name), dev, card,
            f"cbox path (BASELINE config 1), sampler {name}")[2])
    print(f"config 1 with the ldsampler against independent: walls {walls}, "
          f"ratio {sum(walls['ldsampler']) / sum(walls['independent']):.4f} "
          f"[{card}]", flush=True)
    print(json.dumps({"card": card, "profiles": out,
                      "config1_sampler_walls": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
