"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile csrc/*.cu with nvcc (or load the cached library);
  3. kernel A (trilinear density lookup) against its plain version on 10^6
     points in and around the 64^3 grid, f32 and bf16-rounded grids;
  4. kernel B (boxwalk) against its plain version at sppc 8, depth 12,
     density 64^3, at res 64 and at the main path's 512^2;
  5. the main path: render() of the bounded-volume scene at 512^2, spp 32,
     depth 12, density 64^3, box filter, on the card; every kernel's launch
     counter must be non-zero. Then the same render at a small size on the
     card and on the CPU (plain versions), which must agree.
Prints one JSON line of per-kernel results, then the contract line
{"ok": true, "device": {...}} last.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mitsubaer_tpu_torch import kernels
    from mitsubaer_tpu_torch.integrators import boxwalk
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.models import medium
    from mitsubaer_tpu_torch.scene import presets

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    path, nvcc_s = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s) "
          f"-> {path.relative_to(path.parents[2])}", flush=True)
    log = path.parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    results = []

    # ---- phase 3: kernel A against its plain version ----
    scene, cfg = presets.volumetric_box(res=512, spp=32, heterogeneous=True,
                                        density_res=64, max_depth=12,
                                        filter="box")
    scene = scene.to(dev)
    gen = torch.Generator(device="cpu").manual_seed(1234)
    n = 1_000_000
    pts = torch.rand((n, 3), generator=gen) * 2.4 - 1.2    # in and around
    face = torch.randint(0, 3, (n // 10,), generator=gen)
    side = torch.randint(0, 2, (n // 10,), generator=gen).float() * 2 - 1
    pts[torch.arange(n // 10), face] = side                 # on the faces
    pts = pts.to(dev)
    errs, ms, plain_ms = [], [], []
    for dtype in (None, torch.bfloat16):
        grid = medium.DensityGrid(scene.media, dtype=dtype)
        got = grid.lookup(pts)
        ref = medium.trilinear_lookup_plain(grid.grid, grid.aabb6, pts)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * grid.grid.max().item()
        print(f"kernel A ({dtype or 'f32'}): max abs err {err:.3e} "
              f"(tol {tol:.3e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"trilinear_lookup disagrees: {err} > {tol}")
        errs.append(err)
        ms.append(_cuda_ms(lambda: grid.lookup(pts), 50))
        plain_ms.append(_cuda_ms(
            lambda: medium.trilinear_lookup_plain(grid.grid, grid.aabb6, pts),
            20))
    print(f"kernel A at N=1e6: {ms[0]:.4f} ms, plain {plain_ms[0]:.4f} ms "
          f"[{card}]", flush=True)
    results.append(dict(
        name="trilinear_lookup", route="cuda",
        source="mitsubaer_tpu_torch/csrc/trilinear.cu",
        replaces="mitsubaer_tpu/models/medium.py:118",
        max_abs_err=max(errs), ms=ms[0], plain_ms=plain_ms[0]))

    # ---- phase 4: kernel B against its plain version, at res 64 and at
    # the main path's pass shape (512^2, sppc 8) ----
    for res in (64, 512):
        b_scene, b_cfg = presets.volumetric_box(
            res=res, spp=8, heterogeneous=True, density_res=64, max_depth=12,
            filter="box")
        params, table, beam_tab, shape = boxwalk.walk_inputs(
            b_scene.to(dev), b_cfg, 8)
        seed = boxwalk.pass_seed(7, 0)
        out_k = boxwalk.walk(params, seed, table, beam_tab, shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = boxwalk.walk_plain(params, seed, table, beam_tab, shape)
        torch.cuda.synchronize()
        plain_b_ms = (time.perf_counter() - t0) * 1e3
        film_k, st_k = boxwalk.fold(out_k, shape)
        film_p, st_p = boxwalk.fold(out_p, shape)
        close = torch.isclose(film_k, film_p, rtol=1e-3, atol=1e-6).all(-1)
        frac = close.float().mean().item()
        st_k, st_p = st_k.tolist(), st_p.tolist()
        print(f"kernel B at res {res}: film pixels within rtol 1e-3: "
              f"{frac:.6f}; stats [segs, taps, iters, unfinished] kernel "
              f"{st_k} plain {st_p}", flush=True)
        if frac < 0.99:
            raise AssertionError(f"boxwalk film agrees on {frac:.4f} < 0.99")
        for i, name in ((0, "segments"), (1, "taps")):
            rel = abs(st_k[i] - st_p[i]) / max(st_p[i], 1)
            if rel > 0.005:
                raise AssertionError(f"boxwalk {name} differ by {rel:.4%}")
        if st_k[3] != 0 or st_p[3] != 0:
            raise AssertionError("boxwalk left samples unfinished")
        b_ms = _cuda_ms(lambda: boxwalk.walk(params, seed, table, beam_tab,
                                             shape), 5)
        b_err = (film_k - film_p).abs().max().item()
        print(f"kernel B at res {res} sppc 8: {b_ms:.4f} ms, plain "
              f"{plain_b_ms:.1f} ms [{card}]", flush=True)
    results.append(dict(
        name="boxwalk", route="cuda",
        source="mitsubaer_tpu_torch/csrc/boxwalk.cu",
        replaces="mitsubaer_tpu/integrators/boxwalk.py:153",
        max_abs_err=b_err, ms=b_ms, plain_ms=plain_b_ms))

    # ---- phase 5: the main path ----
    medium.trilinear_lookup.launches = 0
    boxwalk.walk.launches = 0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_m.render(scene, cfg, seed=0, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"trilinear_lookup": medium.trilinear_lookup.launches,
                "boxwalk": boxwalk.walk.launches}
    n_pass = len(stats["passes"])
    segs = sum(p[0] for p in stats["passes"])
    mrays = segs / stats["boxwalk_s"] / 1e6
    mean = img.mean().item()
    print(f"main path: 512x512 spp 32 depth 12 in {n_pass} passes, wall "
          f"{wall:.3f} s, boxwalk {stats['boxwalk_s']:.3f} s, {segs} "
          f"segments, {mrays:.3f} Mrays/s, mean {mean:.6f}, launches "
          f"{launches} [{card}]", flush=True)
    if tuple(img.shape) != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render produced a non-finite or misshapen image")
    if not mean > 0:
        raise AssertionError("render produced a black image")
    if any(p[3] != 0 for p in stats["passes"]):
        raise AssertionError("render left samples unfinished")
    if launches["boxwalk"] < n_pass or launches["trilinear_lookup"] < n_pass + 4:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    for r in results:
        r["launches"] = launches[r["name"]]

    # the same render small, on the card and on the CPU (plain versions)
    c_scene, c_cfg = presets.volumetric_box(res=32, spp=8, heterogeneous=True,
                                            density_res=32, max_depth=6,
                                            filter="box")
    img_g = render_m.render(c_scene, c_cfg, seed=3, device=dev).cpu()
    img_c = render_m.render(c_scene, c_cfg, seed=3, device="cpu")
    lum_g, lum_c = img_g.mean(-1), img_c.mean(-1)
    sel = lum_c > 0
    ratio = (lum_g[sel] / lum_c[sel]).median().item()
    mean_rel = abs(img_g.mean().item() / img_c.mean().item() - 1)
    print(f"card vs CPU render at 32x32 spp 8: median pixel ratio "
          f"{ratio:.6f}, mean rel diff {mean_rel:.2e}", flush=True)
    if not (0.99 <= ratio <= 1.01 and mean_rel <= 0.01):
        raise AssertionError("card and CPU renders disagree")

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
