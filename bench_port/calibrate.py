"""The readings that the limits of a cell's comparison are set from, many
seeds in one process:

    python3 -m bench_port.calibrate --workload <cell> --mode <mode> \
        --seeds 11,12,13 --seconds 40 [--images 5] [--out file.jsonl]

--mode program runs the benchmark's own run (run.py) once a seed and
prints the numbers it compares; a fault of the cell's traffic driver
(its FAULTS: render_loop's unchanged, half and altered) does the same
with that fault planted in the timed path; control puts the driver's
control in the program's place (render_loop: the reference computed in
bfloat16, --images images of the cell's samples a pixel) and compares it
as a run compares the program. Each line holds the verdict under the
cell's limits (`correct`). One JSON line a seed."""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    import torch

    from . import cell as cell_m
    from . import run

    ap = argparse.ArgumentParser(prog="python3 -m bench_port.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--images", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    drv_m = cell_m.load(args.workload).driver()
    if args.mode not in ("program", "control") + tuple(drv_m.FAULTS):
        print(f"unknown mode {args.mode}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = cell_m.load(args.workload)
        if args.mode == "control":
            row = drv_m.control(cell, seed, args.images,
                                torch.device("cuda", 0))
            row["correct"] = run.verdict(row, cell.workload["limits"])
        else:
            fault = None if args.mode == "program" else args.mode
            code, res = run.run(["--workload", args.workload, "--seed",
                                 str(seed), "--seconds", str(args.seconds)],
                                cell=cell, fault=fault)
            if res is None:
                return code
            row = {k: v["value"] for k, v in res["check"].items()}
            row.update({k: v["value"] for k, v in res["metrics"].items()})
            row.update(correct=res["correct"], attempted=res["attempted"],
                       kind=res["device"]["kind"],
                       power_limit=res["device"].get("power_limit"))
        row.update(workload=args.workload, mode=args.mode, seed=seed,
                   seconds=time.perf_counter() - t0)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
