"""Command-line renderer (port of mitsubaer_tpu/cli.py) — the `mitsuba`
front end analogue (src/mitsuba/mitsuba.cpp:129): load a Mitsuba-format
XML scene, render it on the CUDA card (on the CPU only with --cpu), write
EXR/PNG/NPY output.

    python -m mitsubaer_tpu_torch.cli scene.xml -o out.exr -D samples=64
    torchrun --nproc_per_node=N -m mitsubaer_tpu_torch.cli scene.xml --sharded

With --sharded under torchrun (WORLD_SIZE > 1) the processes render the
image together through parallel.driver.render_sharded over a (world, 1)
layout, and only rank 0 writes the output.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="mitsubaer_tpu_torch renderer (Mitsuba XML scenes, "
                    "PyTorch/CUDA)")
    ap.add_argument("scene", help="scene XML file (or preset: cbox | volumetric | refractive)")
    ap.add_argument("-o", "--output", default=None, help="output file (.exr/.png/.npy)")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="scene parameter substitution ($key in the XML)")
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--res", type=int, default=None, help="override square resolution")
    ap.add_argument("--depth", type=int, default=None, help="override max path depth")
    ap.add_argument("--integrator", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the render across the torchrun processes")
    ap.add_argument("--exposure", type=float, default=1.0, help="PNG exposure scale")
    args = ap.parse_args(argv)

    import torch

    from .integrators import common
    from .integrators import render as render_m
    from .parallel import driver
    from .scene import presets, xml as xml_m
    from .utils import io

    defines = {}
    for d in args.D:
        k, _, v = d.partition("=")
        defines[k] = v

    t0 = time.time()
    if args.scene == "cbox":
        scene, cfg = presets.cornell_box()
    elif args.scene == "volumetric":
        scene, cfg = presets.volumetric_box()
    elif args.scene == "refractive":
        scene, cfg = presets.refractive_sphere()
    else:
        scene, cfg = xml_m.load_scene(args.scene, defines)
    print(f"[scene] loaded in {time.time() - t0:.2f}s "
          f"({scene.geo.v0.shape[0]} tris, {cfg.integrator}, "
          f"{cfg.width}x{cfg.height} @ {cfg.spp}spp)", file=sys.stderr)

    if args.spp:
        cfg = replace(cfg, spp=args.spp)
    if args.res:
        cfg = replace(cfg, width=args.res, height=args.res)
    if args.depth:
        cfg = replace(cfg, max_depth=args.depth)
    if args.integrator:
        cfg = replace(cfg, integrator=args.integrator)

    device = "cpu" if args.cpu else None
    sharded = args.sharded and int(os.environ.get("WORLD_SIZE", "1")) > 1
    rank = 0
    if sharded:
        dev = driver.init_distributed(device)
        rank, n_dev = driver.world()
    else:
        dev = common.render_device(device)
        n_dev = 1 if dev.type == "cpu" else torch.cuda.device_count()
    t0 = time.time()
    if sharded:
        img = driver.render_sharded(scene, cfg, (n_dev, 1), seed=args.seed,
                                    device=dev)
    else:
        img = render_m.render(scene, cfg, seed=args.seed, device=dev)
    img = img.cpu().numpy()
    dt = time.time() - t0
    rays = cfg.width * cfg.height * cfg.spp
    print(f"[render] {dt:.2f}s  ({rays / dt / 1e6:.2f} Mrays/s primary, "
          f"{n_dev} device(s))", file=sys.stderr)
    if rank != 0:
        return 0

    out = args.output or (os.path.splitext(os.path.basename(args.scene))[0] + ".exr")
    if out.endswith(".png"):
        io.write_png(out, img[..., :3] * args.exposure)
    elif out.endswith(".npy"):
        io.write_npy(out, img)
    else:
        # bake render metadata into the EXR (hdrfilm.cpp annotations)
        ann = {
            "renderTime": f"{dt:.3f}s",
            "sampleCount": str(cfg.spp),
            "integrator": cfg.integrator,
            "devices": str(n_dev),
            "generatedBy": "mitsubaer_tpu_torch",
        }
        if cfg.n_frames > 1:
            names = []
            for f in range(cfg.n_frames):
                names += [f"frame{f:03d}.{c}" for c in ("R", "G", "B")]
            io.write_exr(out, img, channel_names=names, annotations=ann)
        else:
            io.write_exr(out, img, annotations=ann)
    print(f"[output] {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
