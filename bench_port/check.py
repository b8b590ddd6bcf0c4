"""The comparison that decides `correct` in a render cell.

The program's window gives n developed images. The plain reference
(reference/tracer.py) makes its own estimate of the same image with its
own random numbers: replicas of the camera paths' image and, on a scene
with a beam, the beam's single scatter from many light-tracing samples.
Three numbers are compared:

- bias_chi2: the images cut into 8 x 8 blocks, each block's mean in each
  channel; the squared difference of the program's mean over its images
  and the reference's, over the variance both means should have, pooled
  over the blocks and channels that hold light (each relative to the
  reference's block mean). Near 1 where the two estimate one image; a
  bias of a few standard errors raises it.
- image_chi2: the same for the whole image's mean in each channel, the
  mean over channels of the squared difference over its variance: a bias
  of one sign everywhere adds up here over the blocks' noise.
- pixel_excess: the same ratio at each pixel of the lit blocks, against
  the reference's image of every pixel (its replicas' mean and, on a
  scene with a beam, its light-tracing image), less 1: the share by which
  the squared differences exceed what the noise explains. It sees an
  image that is right block by block but wrong at the pixel, as one drawn
  from film coordinates rounded to whole pixels.
- noise_ratio: the median over lit pixels and channels of the variance of
  one image of the program, read from the window's first NOISE_IMAGES
  images (a fixed count: the median of a variance from few images of a
  heavy-tailed estimator grows with their number), over the median of
  the variance one sample of the reference has divided by the program's
  samples a pixel (both relative to the block's mean). A constant of the
  two estimators; an image made from fewer samples than it claims raises
  it. Medians, so that rare bright samples do not set it.
- bad_values: pixels of the window's images that are not finite or are
  negative. Exact: the limit is 0.

Each limit lies between the readings of sound runs and those of the
control or a planted fault, measured on the chip (PERF.md); a cell whose
estimator leaves a number with no such gap leaves it uncompared (a limit
of null)."""
from __future__ import annotations

import math

import torch

BLOCKS = 8
NOISE_IMAGES = 5        # the images whose variance noise_ratio reads
NUMBERS = ("bias_chi2", "image_chi2", "pixel_excess", "noise_ratio",
           "bad_values")


def image_blocks(img, blocks: int = BLOCKS):
    """(blocks^2, 3) float64 block means of an (H, W, 3) image."""
    h, w, _ = img.shape
    b = img.double().reshape(blocks, h // blocks, blocks, w // blocks, 3)
    return b.mean((1, 3)).reshape(blocks * blocks, 3)


def _pixels(blocks, h: int, w: int):
    """(B^2, 3) block values spread over their (H, W, 3) pixels."""
    b = blocks.reshape(BLOCKS, BLOCKS, 3)
    return b.repeat_interleave(h // BLOCKS, 0).repeat_interleave(w // BLOCKS, 1)


def reference(config: dict, workload: dict, seed: int, device,
              dtype=torch.float32) -> dict:
    """The reference's estimate, from the workload's "reference" sizes:
    its replicas' block means (m, B^2, 3), the variance of one of its
    samples at each pixel (H, W, 3), its samples a pixel, and the
    single-scatter block means and their standard errors (zeros where the
    scene has no beam)."""
    from .reference import tracer

    ref = workload["reference"]
    res = int(workload["render"]["res"])
    model = tracer.build(config, device, dtype)
    cam = tracer.Camera(config["scene"]["camera"], res, res, device, dtype)
    filt = tracer.Filter(workload["render"]["filter"], device, dtype)
    rng = tracer.Rng(seed, device, dtype)
    m, spp = int(ref["replicas"]), int(ref["spp"])
    blocks, image, var = [], 0.0, 0.0
    for _ in range(m):
        mean, v = tracer.camera_image(model, cam, filt, spp, rng)
        mean = mean.cpu()
        blocks.append(image_blocks(mean))
        image, var = image + mean / m, var + v.cpu() / m
    ss_mean = torch.zeros(BLOCKS * BLOCKS, 3, dtype=torch.float64)
    ss_se = torch.zeros_like(ss_mean)
    image_var = var / (m * spp)
    if isinstance(model, tracer.Volume):
        parts = tracer.splat_parts(model, cam, int(ref["splat_samples"]),
                                   rng).cpu()
        k = parts.shape[0]
        pb = torch.stack([image_blocks(p) for p in parts])
        ss_mean, ss_se = pb.mean(0), pb.std(0) / math.sqrt(k)
        image = image + parts.mean(0)
        image_var = image_var + parts.var(0) / k
    return {"blocks": torch.stack(blocks), "var": var, "spp": spp,
            "ss_mean": ss_mean, "ss_se": ss_se, "image": image,
            "image_var": image_var}


def numbers(prog_blocks, prog_mean, prog_var, noise_var, prog_spp: int,
            ref: dict, bad_values: int) -> dict:
    """The compared numbers from the program's (n, B^2, 3) image blocks,
    the mean and the variance of its images at each pixel (H, W, 3), the
    variance of its first NOISE_IMAGES images at each pixel, its samples a
    pixel, and the reference's estimate (`reference`)."""
    prog = prog_blocks.double().cpu()
    reps = ref["blocks"]
    n, m = prog.shape[0], reps.shape[0]
    R = reps.mean(0) + ref["ss_mean"]
    se_ref2 = reps.var(0) / m + ref["ss_se"] ** 2
    P, s2 = prog.mean(0), prog.var(0)
    lit = R > 1e-3 * R.max()
    r2 = R[lit] ** 2
    bias = ((P - R)[lit] ** 2 / r2).sum() / ((s2 / n + se_ref2)[lit] / r2).sum()
    h, w, _ = ref["var"].shape
    rp2 = _pixels(R, h, w) ** 2
    seen = (ref["var"] > 0) & _pixels(lit, h, w)
    noise = (torch.median((noise_var.double().cpu() / rp2)[seen])
             / torch.median((ref["var"] / prog_spp / rp2)[seen]))
    lp = _pixels(lit, h, w)
    pixel = (((prog_mean.double().cpu() - ref["image"]) ** 2 / rp2)[lp].sum()
             / ((prog_var.double().cpu() / n + ref["image_var"])
                / rp2)[lp].sum())
    pm = prog.mean(1)                       # (n, 3): each image's mean
    se_rm2 = (reps.mean(1).var(0) / m
              + (ref["ss_se"] ** 2).sum(0) / R.shape[0] ** 2)
    image = ((pm.mean(0) - R.mean(0)) ** 2
             / (pm.var(0) / n + se_rm2)).mean()
    return {"bias_chi2": float(bias), "image_chi2": float(image),
            "pixel_excess": float(pixel) - 1.0,
            "noise_ratio": float(noise), "bad_values": int(bad_values)}


def variance(images):
    """Per-pixel sample variance over a list of (H, W, 3) images."""
    x = torch.stack([i.double() for i in images])
    return x.var(0) if x.shape[0] > 1 else torch.zeros_like(x[0])


def verdict(values: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN fails); a limit of None
    leaves that number uncompared in the cell (PERF.md says why)."""
    return all(limits[k] is None
               or (not math.isnan(values[k]) and values[k] <= limits[k])
               for k in NUMBERS)
