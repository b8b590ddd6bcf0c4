"""Multi-process scaling harness of the PyTorch port (the analogue of
scripts/scaling_multiprocess.py, the reference's mtssrv render farm
bring-up).

    python3 scripts/scaling_multiprocess_torch.py [--cpu] [--procs 1,2,4]

Spawns N = 1, 2, 4 local processes that form one torch.distributed group
over gloo (parallel.driver.spawn, a torchrun environment on localhost) and
render the heterogeneous volumetric box (64^2, spp 8, depth 6, density
32^3, box filter, seed 3; the loop road, as the JAX script's
render_sharded takes it) over ONE (2, 2) layout of shards, on the CUDA
card (every process on cuda:LOCAL_RANK % cards) or on the CPU with --cpu.
It

  1. asserts the images bit-identical across N (crc32 of the float32
     bytes): the layout, not the process count, fixes every shard's
     samples, and the shards' films are summed in shard order;
  2. prints a same-work table: the wall of each N's second (warm) render.

Exits 1 if the images differ. On one card the processes share it, so the
table measures the overlap of their host work, not a speed-up of the
device work.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SCENE = dict(res=64, spp=8, heterogeneous=True, density_res=32, max_depth=6,
             filter="box")
LAYOUT = "2,2"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--procs", default="1,2,4")
    args = ap.parse_args()

    from mitsubaer_tpu_torch.parallel import driver

    where = "cpu"
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("scaling_multiprocess_torch: no CUDA device (--cpu for "
                  "the CPU)", file=sys.stderr)
            return 1
        from mitsubaer_tpu_torch import kernels

        kernels.build()             # once, before the processes load it
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    results = {}
    for n in (int(x) for x in args.procs.split(",")):
        out = driver.spawn(n, "mitsubaer_tpu_torch.parallel.driver:"
                           "render_child", json.dumps(SCENE), LAYOUT, "3",
                           "cpu" if args.cpu else "", "", "1")
        results[n] = json.loads(out[0].strip().splitlines()[-1])
        print(f"N={n}: {results[n]}", flush=True)
    t1 = results[min(results)]["wall_s"]
    print(f"\nsame-work table, layout ({LAYOUT}) [{where}]:")
    for n, r in results.items():
        print(f"  N={n}: wall {r['wall_s']:.3f} s  same-work speed-up "
              f"x{t1 / r['wall_s']:.2f}  shards of rank 0 {r['shards']}")
    same = len({r["crc32"] for r in results.values()}) == 1
    print(f"identical images across N (bitwise): {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
