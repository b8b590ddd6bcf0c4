"""render_loop: one client renders whole images back to back, each with a
seed of its own, through the program's entry
`mitsubaer_tpu_torch.integrators.render.render` (a closed loop: the next
image starts when the last has ended, with a device synchronize).

The workload file's "render" holds the image (res, spp, filter) and what
the program must do with it (road: the program's own choice of engine,
checked from its stats; sppc, its pass size); "reference" the plain
reference's sizes; "limits" the limit of each number compared. The driver
keeps, on the device, each image's block means and the running sums that
give the images' per-pixel variance, and counts the camera samples that
reach the film in the window: the rate is taken over them, and an image
made from fewer than res^2 spp samples is not correct (samples_off).

The comparison (check.py) runs once the window has closed and the
program's state is freed. The faults a test or calibrate.py plants in
the timed path:

- unchanged: a pass returns its accumulator as it came (the state left
  unchanged);
- half: a pass traces half of its samples and the image takes the mean
  over the rest (half of the batch left out);
- altered: a pass's radiance comes out doubled where it is made (an
  answer altered where it is produced, as a contribution counted twice).

Each wraps the loop road's pass function (`render.render_pass`)."""
from __future__ import annotations

import contextlib
import functools
import importlib
import math
import time

import torch

from .. import check

# the program's functions a traced run times as spans (skipped where the
# program no longer has one)
SPAN_TARGETS = (("integrators.render", "render_pass"),
                ("integrators.render", "beam_splat_pass"),
                ("integrators.boxwalk", "render_boxwalk"),
                ("integrators.volpath", "body"),
                ("models.film", "develop"))
ROAD_TIMERS = {"loop": "loop_s", "boxwalk": "boxwalk_s"}
# where each road's camera samples reach the film: the loop road splats
# every pass's (S, H, W, 3) samples through models/film.py's `splat`
SAMPLE_SINKS = {"loop": ("models.film", "splat")}
FAULTS = ("unchanged", "half", "altered")
ALTER = 2.0
MIN_IMAGES = 3          # the images' variance needs three of them
NUMBERS = check.NUMBERS + ("samples_off", "images_short")


def _program(module: str):
    return importlib.import_module(f"mitsubaer_tpu_torch.{module}")


@contextlib.contextmanager
def _wrapped(module: str, attr: str, make):
    """module.attr replaced by make(module.attr) inside the block."""
    mod = _program(module)
    fn = getattr(mod, attr)
    setattr(mod, attr, functools.wraps(fn)(make(fn)))
    try:
        yield
    finally:
        setattr(mod, attr, fn)


def _faulty_pass(fault: str):
    def make(fn):
        def wrapped(scene, accum, cfg, sppc, seed, pass_idx):
            if fault == "unchanged":
                return accum, []
            if fault == "half":
                return fn(scene, accum, cfg, max(sppc // 2, 1), seed,
                          pass_idx)
            out, counts = fn(scene, accum, cfg, sppc, seed, pass_idx)
            out = out.clone()
            out[..., :-1] = accum[..., :-1] + (out - accum)[..., :-1] * ALTER
            return out, counts
        return wrapped
    return make


class Driver:
    span = "render"

    def __init__(self, cell, device):
        from mitsubaer_tpu_torch import kernels
        from mitsubaer_tpu_torch.integrators import render as render_m
        from mitsubaer_tpu_torch.scene import presets

        self.cell, self.device = cell, device
        r = cell.workload["render"]
        self.road = r["road"]
        if self.road not in SAMPLE_SINKS:
            raise ValueError(f"no count of camera samples on the {self.road}"
                             " road")
        self.res, self.spp, self.filter = int(r["res"]), int(r["spp"]), r["filter"]
        p = cell.config["preset"]
        kw = dict(p["kwargs"], res=self.res, spp=self.spp, filter=self.filter)
        kw.update({k: r[k] for k in ("max_depth",) if k in r})
        self.scene, self.cfg = getattr(presets, p["call"])(**kw)
        self.render = render_m.render
        if device.type == "cuda":
            kernels.library()
        self.span_targets = [(_program(m), a) for m, a in SPAN_TARGETS]
        self.blocks, self.walls, self.stats, self.first = [], [], {}, []
        self.sum = self.sumsq = None
        self.splatted = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        """One pass at the cell's own pass size, and its beam splat; the
        program has to take the workload's road."""
        stats = {}
        self.render(self.scene, self.cfg,
                    spp=int(self.cell.workload["render"]["sppc"]), seed=1,
                    device=self.device, stats=stats)
        self._sync()
        self._check_road(stats)

    def _check_road(self, stats: dict):
        if not stats.get(ROAD_TIMERS[self.road]):
            raise RuntimeError(f"the program left the {self.road} road: "
                               f"stats {sorted(stats)}")

    @contextlib.contextmanager
    def timed_path(self, fault: str | None = None):
        """The window's hooks: the count of camera samples at the film,
        and the fault planted (None for a sound run)."""
        def count(fn):
            def splat(accum, values, *a, **k):
                self.splatted += values.numel() // values.shape[-1]
                return fn(accum, values, *a, **k)
            return splat

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault}")
        with contextlib.ExitStack() as stack:
            stack.enter_context(_wrapped(*SAMPLE_SINKS[self.road], count))
            if fault is not None:
                stack.enter_context(_wrapped("integrators.render",
                                             "render_pass",
                                             _faulty_pass(fault)))
            yield

    def step(self, seed: int, traced: bool):
        stats = {} if traced else None
        t0 = time.perf_counter()
        img = self.render(self.scene, self.cfg, seed=seed, device=self.device,
                          stats=stats)
        self._sync()
        self.walls.append(time.perf_counter() - t0)
        x = img.double()
        self.sum = x if self.sum is None else self.sum + x
        self.sumsq = x * x if self.sumsq is None else self.sumsq + x * x
        self.bad += (~torch.isfinite(img) | (img < 0)).sum()
        self.blocks.append(check.image_blocks(img))
        if len(self.first) < check.NOISE_IMAGES:
            self.first.append(img.cpu())
        if stats is not None:
            for k in ("loop_s", "boxwalk_s"):
                self.stats[k] = self.stats.get(k, 0.0) + stats.get(k, 0.0)
            self.stats["passes"] = (self.stats.get("passes", 0)
                                    + len(stats.get("passes", [])))
            self._check_road(stats)

    @property
    def images(self) -> int:
        return len(self.walls)

    @property
    def msamples(self) -> float:
        """The camera samples that reached the film, millions."""
        return self.splatted / 1e6

    def end_to_end(self, window_s: float) -> dict:
        n = len(self.walls)
        out = {"msamples_per_s": self.msamples / window_s}
        if n >= MIN_IMAGES:
            mean = self.sum / n
            var = (self.sumsq - self.sum * mean) / (n - 1)
            rel_mse = float(var.mean() / mean.mean() ** 2)
            out["s_to_1pct_rmse"] = window_s / n * rel_mse / 1e-4
        return out

    def compare(self, seed: int):
        """(the numbers compared, their limits): the window's images
        against the plain reference's estimate drawn from `seed`, once the
        program's state is freed."""
        n = len(self.blocks)
        off = abs(self.splatted - n * self.res * self.res * self.spp)
        readings = None
        if n >= 2:
            var = (self.sumsq - self.sum * self.sum / n) / (n - 1)
            readings = (torch.stack(self.blocks).cpu(), (self.sum / n).cpu(),
                        var.cpu(), check.variance(self.first), self.spp)
        bad = int(self.bad)
        self.close()
        if readings is None:
            values = dict.fromkeys(check.NUMBERS, math.nan)
        else:
            ref = check.reference(self.cell.config, self.cell.workload, seed,
                                  self.device)
            values = check.numbers(*readings, ref, bad)
        values.update(samples_off=off, images_short=max(0, MIN_IMAGES - n))
        return values, self.cell.workload["limits"]

    def close(self):
        self.scene = self.cfg = self.sum = self.sumsq = self.first = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def control(cell, seed: int, images: int, device) -> dict:
    """The numbers of `images` images of the reference in bfloat16, put in
    the program's place and compared with the float32 reference as a run
    compares the program's (it draws res^2 spp samples an image)."""
    from .. import run
    from ..reference import tracer

    spp = int(cell.workload["render"]["spp"])
    imgs = torch.stack([
        tracer.render_image(cell.config, cell.workload, spp,
                            run.derive_seed(seed, 3, i), device,
                            torch.bfloat16).cpu()
        for i in range(images)])
    bad = int((~torch.isfinite(imgs) | (imgs < 0)).sum())
    imgs = torch.nan_to_num(imgs)
    ref = check.reference(cell.config, cell.workload,
                          run.derive_seed(seed, 2, 0), device)
    values = check.numbers(torch.stack([check.image_blocks(i) for i in imgs]),
                           imgs.mean(0), imgs.var(0),
                           check.variance(imgs[:check.NOISE_IMAGES]), spp,
                           ref, bad)
    values.update(samples_off=0, images_short=max(0, MIN_IMAGES - images))
    return values
