"""Render entry point (port of mitsubaer_tpu/integrators/render.py::render).

Four roads are ported, chosen as the JAX render() chooses them:
- loop: the loop engine (`volpath.li`), taken by integrator "volpath"
  with any film filter but box (the default is gaussian) or with
  engine="loop", and by "volpath_simple" unless engine="wavefront"; each
  spp chunk runs camera rays, the host-driven bounce loop and the
  filtered film splat (`render_pass`), then the collimated-beam splat
  where the scene has a beam.
- boxwalk: the bounded-volume scene class with a box filter
  (`boxwalk.supported`), plus the collimated-beam splat. The JAX package
  takes it only on a TPU backend; here on every device.
- wavefront: every other steady-state volpath scene with a box filter
  (point, collimated and constant-environment emitters, null and diffuse
  surfaces, homogeneous and heterogeneous media), through
  `wavefront.render_wavefront` and kernel C, plus the beam splat where the
  scene has a collimated emitter.
- volpath_er: the eikonal (refractive) integrator, forward and steady-state,
  with any film filter; each spp chunk runs camera rays, the host-driven
  bounce loop and the film splat, as the JAX render's host-stepped ER
  branch.

Renders run on the CUDA card unless the caller passes device="cpu", where
the plain PyTorch versions of the kernels run instead. Every other road
raises NotImplementedError with the ROADMAP Queue 1 step that will port it.
"""
from __future__ import annotations

import time
from dataclasses import replace

import torch

from .. import not_ported
from ..core import rng
from ..models import film as film_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene.types import EM_COLLIMATED, MED_HETEROGENEOUS, RenderConfig, Scene
from . import boxwalk, common
from . import volpath as volpath_m
from . import volpath_er as er_m
from . import wavefront as wf_m

_NOT_PORTED = {
    "path": 9, "direct": 9, "ao": 9, "field": 9,
    "ptracer": 12, "vpl": 12, "bdpt": 12, "pssmlt": 12, "pssmlt_volpath": 12,
    "mlt": 12, "erpt": 12, "singlescatter": 12, "singlescatter_mesh": 12,
    "dipole": 12, "photonmapper": 12, "ppm": 12, "sppm": 12, "bre": 12,
    "irrcache": 12,
}


def _use_wavefront(cfg: RenderConfig) -> bool:
    if cfg.engine == "wavefront2":
        raise ValueError("engine='wavefront2' was a measured negative result "
                         "of the JAX package; use engine='wavefront'")
    if cfg.engine == "wavefront":
        return True
    if cfg.engine == "loop":
        return False
    return (cfg.integrator in ("volpath", "path") and cfg.n_frames == 1
            and cfg.modulation == "none" and cfg.filter == "box")


def _has_beam(scene: Scene) -> bool:
    return bool((scene.emitters.kind == EM_COLLIMATED).any())


def _has_direct(scene: Scene) -> bool:
    """Some emitter other than a collimated beam (NEE toward emitters)."""
    kinds = scene.emitters.kind
    return kinds.numel() > 0 and bool((kinds != EM_COLLIMATED).any())


def _any_het(scene: Scene) -> bool:
    return bool((scene.media.kind == MED_HETEROGENEOUS).any())


def render_pass_wavefront(scene: Scene, accum_L, cfg: RenderConfig,
                          sppc: int, seed: int, pass_idx: int,
                          has_direct: bool = True, any_het: bool = True):
    """One spp chunk through the wavefront engine: returns (accum_L + the
    (npix, 3) radiance sum, int64 stats [segments, taps, super-iterations,
    unfinished]); divide by the total spp to develop."""
    L, stats = wf_m.render_wavefront(scene, cfg, sppc, seed, pass_idx,
                                     has_direct=has_direct, any_het=any_het)
    return accum_L + L, stats


def render_pass(scene: Scene, accum, cfg: RenderConfig, sppc: int,
                seed: int, pass_idx: int):
    """One spp chunk through the loop engine (render.py:106-148): camera
    samples, `volpath.li` and the splat with cfg.filter. Returns the
    accumulator and [bounces, Woodcock tracking iterations]."""
    rays, jitter, smp = common.camera_samples(scene, cfg, sppc, seed,
                                              pass_idx)
    sink, _, counts = volpath_m.li(scene, cfg, rays.o, rays.d, smp,
                                   simple=cfg.integrator == "volpath_simple")
    H, W = cfg.height, cfg.width
    accum = film_m.splat(accum, sink.reshape(sppc, H, W, 3),
                         jitter.reshape(sppc, H, W, 2), cfg.filter)
    return accum, counts


def beam_splat_pass(scene: Scene, splat, cfg: RenderConfig, n_samples: int,
                    seed: int, pass_idx: int):
    """Single-scatter light-tracing splat for a collimated beam: sample y
    on the beam equiangularly w.r.t. the camera, project it to the film and
    add power * Tr(o_b, y) * sigma_s(y) * rho * Tr(y, cam) / (d^2 pdf(s)).
    Accumulates into `splat` (H, W, 3) in place and returns it."""
    if cfg.n_frames != 1:
        raise not_ported("the transient beam splat", 10)
    H, W = cfg.height, cfg.width
    dev = splat.device
    beam = volpath_m.get_beam(scene)
    eps = common.scene_epsilon(scene)
    lane = torch.arange(n_samples, dtype=torch.int64, device=dev)
    smp = rng.make_sampler(seed ^ 0xBEA11, lane, pass_idx)
    u, smp = rng.next_1d(smp)

    cam = scene.sensor.to_world[:3, 3].expand(n_samples, 3)
    y, sdist, pdf_s, dist, d_yc = volpath_m.sample_beam_point(beam, cam, u)
    active = beam.exists.expand(n_samples)
    media = scene.media
    bmed = beam.medium.expand(n_samples)
    kind, _, ss, scale = medium_m.params(media, bmed)
    bricks = medium_m.DensityGrid(media)
    dens = torch.where(kind == MED_HETEROGENEOUS, bricks.lookup(y) * scale,
                       1.0)
    sigma_s_y = ss * dens.unsqueeze(-1)
    rho = phase_m.eval(media.phase, bmed, beam.d.expand(n_samples, 3), d_yc)

    tau = volpath_m.build_beam_tau(scene, beam, bricks)
    tr1 = volpath_m.beam_transmittance(beam, tau, sdist)
    tr2, smp = volpath_m.attenuated_visibility(
        scene, eps, y + d_yc * eps, d_yc, dist - 2 * eps, bmed, smp, active,
        bricks=bricks)
    value = (beam.power * tr1 * sigma_s_y * tr2
             * (rho / torch.clamp_min(pdf_s * dist * dist, 1e-12)
                ).unsqueeze(-1))

    fs = sensor_m.project(scene.sensor, y, W, H)
    value = value * fs.inv_pixel_omega.unsqueeze(-1)
    ok = active & fs.valid & torch.all(torch.isfinite(value), dim=-1)
    value = torch.where(ok.unsqueeze(-1), value, 0.0)
    px = torch.clamp(torch.nan_to_num(fs.px).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.nan_to_num(fs.py).to(torch.int64), 0, H - 1)
    # scatter-add: on CUDA the order of the adds, and so the rounding, varies
    splat.view(H * W, 3).index_add_(0, py * W + px, value)
    return splat


def _device(device) -> torch.device:
    """The device to render on: the CUDA card unless `device` names
    another. Never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return device


def render(scene: Scene, cfg: RenderConfig, spp: int | None = None,
           seed: int = 0, device=None, stats: dict | None = None):
    """Render to a developed (H, W, 3) image on `device`: the CUDA card by
    default (it raises where there is none), the CPU only when
    device="cpu" is passed.

    Roads: integrator "volpath_er" takes the eikonal road (steady state);
    "volpath" with a box filter takes boxwalk on a scene of the boxwalk
    class and the wavefront engine on any other; "volpath" with another
    filter or engine="loop", and "volpath_simple" unless
    engine="wavefront", take the loop engine.
    The others raise NotImplementedError naming their ROADMAP Queue 1
    step: the surface integrators (step 9), the transient sinks (step 10)
    and the other integrators (step 12).

    If `stats` is a dict it receives, per pass, "passes" ([segments, taps,
    iters, unfinished] on the boxwalk and wavefront roads, [bounces,
    Woodcock tracking iterations] on the loop road, [bounces] on the
    eikonal road) and the seconds of the passes, timed with a device
    synchronize around each, as "boxwalk_s", "wavefront_s", "loop_s" or
    "er_s"."""
    if spp is not None:
        cfg = replace(cfg, spp=spp)
    if cfg.integrator in _NOT_PORTED:
        raise not_ported(f"integrator {cfg.integrator!r}",
                          _NOT_PORTED[cfg.integrator])
    if cfg.integrator == "volpath_er":
        er_m.check_supported(cfg)
        return _render_film(scene.to(_device(device)), cfg, seed, stats,
                            "er_s", _er_pass)
    if not _use_wavefront(cfg):
        scene = scene.to(_device(device))
        img = _render_film(scene, cfg, seed, stats, "loop_s", render_pass)
        return _add_beam_splat(scene, cfg, img, seed)
    use_bw = boxwalk.supported(scene, cfg)
    if not use_bw:
        wf_m.check_supported(scene, cfg)
    scene = scene.to(_device(device))
    dev = scene.aabb_min.device
    npix = cfg.width * cfg.height
    spp_per_pass = _spp_per_pass(cfg)
    hd, het = _has_direct(scene), _any_het(scene)
    L = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    done = 0
    pass_idx = 0
    timer = "boxwalk_s" if use_bw else "wavefront_s"
    if stats is not None:
        stats.setdefault("passes", [])
        stats.setdefault(timer, 0.0)
    while done < cfg.spp:
        sppc = min(spp_per_pass, cfg.spp - done)
        if stats is not None:
            _sync(dev)
            t0 = time.perf_counter()
        if use_bw:
            Lb, st = boxwalk.render_boxwalk(scene, cfg, sppc, seed, pass_idx)
            L = L + Lb
        else:
            L, st = render_pass_wavefront(scene, L, cfg, sppc, seed,
                                          pass_idx, has_direct=hd,
                                          any_het=het)
        if stats is not None:
            _sync(dev)
            stats[timer] += time.perf_counter() - t0
            stats["passes"].append(st.tolist())
        done += sppc
        pass_idx += 1
    img = (L / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
    return _add_beam_splat(scene, cfg, img, seed)


def _add_beam_splat(scene: Scene, cfg: RenderConfig, img, seed: int):
    """img plus 4 beam-splat passes of 4 npix samples each, where the
    scene has a collimated emitter (render.py:380-389, 420-429)."""
    if not (cfg.integrator.startswith("volpath") and _has_beam(scene)):
        return img
    n_splat = 4 * cfg.width * cfg.height
    n_passes = 4
    splat = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=img.device)
    for i in range(n_passes):
        beam_splat_pass(scene, splat, cfg, n_splat, seed, i)
    return img + splat / float(n_splat * n_passes)


def _spp_per_pass(cfg: RenderConfig) -> int:
    """min(spp, 2^21 // npix), as the JAX render() fixes the per-pass
    budget before it picks the engine (so neither fast engine gets its
    own)."""
    return max(1, min(cfg.spp, (1 << 21) // max(cfg.width * cfg.height, 1)))


def _render_film(scene: Scene, cfg: RenderConfig, seed: int, stats,
                 timer: str, pass_fn):
    """spp chunks of pass_fn(scene, accum, cfg, sppc, seed, pass_idx) ->
    (accum, counts) into the filtered film, developed: the loop road
    (render.py:392-418) and the eikonal road's host-stepped branch
    (render.py:323-345)."""
    dev = scene.aabb_min.device
    accum = film_m.new_accumulator(cfg, dev)
    spp_per_pass = _spp_per_pass(cfg)
    if stats is not None:
        stats.setdefault("passes", [])
        stats.setdefault(timer, 0.0)
    done = pass_idx = 0
    while done < cfg.spp:
        sppc = min(spp_per_pass, cfg.spp - done)
        if stats is not None:
            _sync(dev)
            t0 = time.perf_counter()
        accum, counts = pass_fn(scene, accum, cfg, sppc, seed, pass_idx)
        if stats is not None:
            _sync(dev)
            stats[timer] += time.perf_counter() - t0
            stats["passes"].append(counts)
        done += sppc
        pass_idx += 1
    return film_m.develop(accum)


def _er_pass(scene: Scene, accum, cfg: RenderConfig, sppc: int, seed: int,
             pass_idx: int):
    """One spp chunk of the eikonal road into the film: returns the
    accumulator and [bounces]."""
    sink, jitter, bounces = er_m.render_er_pass(scene, cfg, sppc, seed,
                                                pass_idx)
    H, W = cfg.height, cfg.width
    accum = film_m.splat(accum, sink.reshape(sppc, H, W, 3),
                         jitter.reshape(sppc, H, W, 2), cfg.filter)
    return accum, [bounces]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
