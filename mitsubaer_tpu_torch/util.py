"""`mtsutil` analogue: image utility subcommands (port of
mitsubaer_tpu/util.py, on the port's utils/io.py).

Reference: src/mtsutil/mtsutil.cpp:73 front end with the utility plugins in
src/utils/: tonemap.cpp, addimages.cpp, joinrgb.cpp; bvhbench times the
BVH's ray intersection (kdbench.cpp analogue) on the card, or the CPU with
--cpu.

    python -m mitsubaer_tpu_torch.util tonemap in.exr -o out.png [--exposure 2]
    python -m mitsubaer_tpu_torch.util addimages a.exr b.exr -o sum.exr -w 0.5,0.5
    python -m mitsubaer_tpu_torch.util joinrgb r.exr g.exr b.exr -o rgb.exr
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(path):
    from .utils import io

    return np.asarray(io.read_image(path), np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description="mitsubaer_tpu_torch image utilities")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tonemap", help="EXR -> tonemapped PNG (tonemap.cpp)")
    t.add_argument("input")
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--exposure", type=float, default=1.0)
    t.add_argument("--gamma", type=float, default=-1.0,
                   help="-1 = sRGB curve, else pow(1/gamma)")

    a = sub.add_parser("addimages", help="weighted sum of images (addimages.cpp)")
    a.add_argument("inputs", nargs="+")
    a.add_argument("-o", "--output", required=True)
    a.add_argument("-w", "--weights", default=None,
                   help="comma-separated weights (default: all 1)")

    j = sub.add_parser("joinrgb", help="merge per-channel renders (joinrgb.cpp)")
    j.add_argument("r")
    j.add_argument("g")
    j.add_argument("b")
    j.add_argument("-o", "--output", required=True)

    k = sub.add_parser("bvhbench", help="ray-intersection benchmark over a "
                       "mesh (kdbench.cpp analogue; BVH vs brute force)")
    k.add_argument("mesh", help=".ply/.obj mesh path")
    k.add_argument("--rays", type=int, default=1 << 16)
    k.add_argument("--reps", type=int, default=5)
    k.add_argument("--cpu", action="store_true", help="run on the CPU")

    args = ap.parse_args(argv)
    from .utils import io

    if args.cmd == "tonemap":
        img = _load(args.input) * args.exposure
        if args.output.lower().endswith(".png"):
            io.write_png(args.output, img, gamma=args.gamma < 0)
        else:
            io.write_exr(args.output, img)
    elif args.cmd == "addimages":
        ws = ([float(x) for x in args.weights.split(",")]
              if args.weights else [1.0] * len(args.inputs))
        if len(ws) != len(args.inputs):
            sys.exit("weights count != images count")
        acc = None
        for path, w in zip(args.inputs, ws):
            img = _load(path) * w
            acc = img if acc is None else acc + img
        io.write_exr(args.output, acc)
    elif args.cmd == "bvhbench":
        import time

        import torch

        from .core import transform as tf
        from .integrators import common
        from .scene import intersect as isect
        from .scene.build import SceneBuilder

        if args.mesh.lower().endswith(".ply"):
            v, f = io.load_ply(args.mesh)
        else:
            v, f = io.load_obj(args.mesh)
        b = SceneBuilder()
        b.add_mesh(v, f, bsdf=b.add_bsdf())
        lo, hi = v.min(0), v.max(0)
        c = 0.5 * (lo + hi)
        b.set_perspective_sensor(
            to_world=tf.look_at(c + [0, 0, 2.5 * (hi - lo).max()], c,
                                [0, 1, 0]), fov_deg=40)
        dev = common.render_device("cpu" if args.cpu else None)
        scene = b.build().to(dev)
        rng_ = np.random.default_rng(0)
        N = args.rays
        eye = (c + [0, 0, 2.5 * (hi - lo).max()]).astype(np.float32)
        o = torch.as_tensor(np.tile(eye, (N, 1)), device=dev)
        tgt = c[None, :] + rng_.normal(0, 0.4 * (hi - lo).max(), (N, 3))
        d = tgt - eye
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = torch.as_tensor(d.astype(np.float32), device=dev)

        def fn():
            return isect.intersect(scene.geo, o, d, 1e-4, 1e9).t

        fn()
        common.sync(dev)
        t0 = time.perf_counter()
        for _i in range(args.reps):
            fn()
        common.sync(dev)
        dt = (time.perf_counter() - t0) / args.reps
        kind = "bvh" if scene.geo.bvh.nodes.shape[0] > 0 else "brute"
        print(f"{kind}: {v.shape[0]} verts {f.shape[0]} tris  "
              f"{N / dt / 1e6:.2f} Mrays/s  ({dt * 1e3:.2f} ms / {N} rays)")
        return
    elif args.cmd == "joinrgb":
        r = _load(args.r)[..., 0]
        g = _load(args.g)[..., 0]
        b = _load(args.b)[..., 0]
        io.write_exr(args.output, np.stack([r, g, b], axis=-1))
    print(f"wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
