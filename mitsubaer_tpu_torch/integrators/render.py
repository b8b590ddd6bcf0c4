"""Render entry point (port of mitsubaer_tpu/integrators/render.py::render).

The estimators with passes of their own go to their entries before any
film or engine is chosen, as in the JAX render(): "bdpt" and "ptracer"
(`bdpt.render_bdpt`, `ptracer.render_ptracer`), "pssmlt",
"pssmlt_volpath" and "mlt" (`pssmlt.render_pssmlt`), "erpt"
(`erpt.render_erpt`), "photonmapper", "ppm" and "sppm"
(`photonmap.render_photonmap`), "bre" (`bre.render_bre`), "vpl"
(`vpl.render_vpl`), "irrcache" (`irrcache.render_irrcache`),
"singlescatter" and "singlescatter_mesh"
(`singlescatter.render_singlescatter`, `render_singlescatter_mesh`) and
"dipole" (`dipole.render_dipole`); all but the first two return their
(H, W, 3) image with no film filter and no beam splat. Four roads are
ported for the others, chosen as the JAX render() chooses them:
- loop: the loop engines, taken by integrators "volpath" and "path" with
  any film filter but box (the default is gaussian) or with
  engine="loop", by "volpath_simple" unless engine="wavefront", and by
  "direct" (the path tracer at max_depth 2), and by "ao" and "field"
  (misc.py); each spp chunk runs camera
  rays, the host-driven bounce loop (`volpath.li` or `path.li`) and the
  filtered film splat (`render_pass`), then, for volpath, the
  collimated-beam splat where the scene has a beam.
- boxwalk: the bounded-volume scene class with a box filter
  (`boxwalk.supported`), plus the collimated-beam splat. The JAX package
  takes it only on a TPU backend; here on every device.
- wavefront: every other steady-state volpath or path scene with a box
  filter (area, point, spot, directional, collimated and constant
  emitters, every BSDF kind, homogeneous and heterogeneous media), through
  `wavefront.render_wavefront` and kernel C, plus the beam splat where the
  scene has a collimated emitter.
- volpath_er: the eikonal (refractive) integrator, forward, with any film
  filter; each spp chunk runs camera rays, the host-driven bounce loop and
  the film splat, as the JAX render's host-stepped ER branch.

The loop and eikonal roads render every film decomposition: steady state,
transient and bounce frames (an (H, W, 3F) image; the frames bypass the
film filter and are divided by the steady splat's weights, render.py:
137-148) and CW-ToF weights. The fast engines (boxwalk, wavefront) keep a
steady film: "auto" takes them only there, and engine="wavefront" with
frames or a modulation raises ValueError.

Renders run on the CUDA card unless the caller passes device="cpu", where
the plain PyTorch versions of the kernels run instead. The loop road
checkpoints and resumes (checkpoint_path / checkpoint_every, in the JAX
package's npz layout, utils/checkpoint.py). Every road adds its seconds
to utils/stats.py's "render.wall", and the loop, boxwalk and wavefront
roads count "render.passes" and "render.camera_rays", as the JAX render()
does. render() accepts every integrator name the JAX package's does.
"""
from __future__ import annotations

import functools
import importlib
import time
from dataclasses import replace

import torch

from ..core import rng
from ..models import film as film_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene.types import EM_COLLIMATED, MED_HETEROGENEOUS, RenderConfig, Scene
from ..utils import checkpoint as ckpt
from ..utils import stats as stats_m
from . import boxwalk, common
from . import misc as misc_m
from . import path as path_m
from . import volpath as volpath_m
from . import volpath_er as er_m
from . import wavefront as wf_m

# the estimators that render through their own passes, before any film
# (render.py:272-313): module and entry, imported at the call as in the
# JAX render() (pssmlt imports this module)
_ESTIMATORS = {
    "bdpt": ("bdpt", "render_bdpt"), "ptracer": ("ptracer", "render_ptracer"),
    "pssmlt": ("pssmlt", "render_pssmlt"),
    "pssmlt_volpath": ("pssmlt", "render_pssmlt"),
    "mlt": ("pssmlt", "render_pssmlt"), "erpt": ("erpt", "render_erpt"),
    "photonmapper": ("photonmap", "render_photonmap"),
    "ppm": ("photonmap", "render_photonmap"),
    "sppm": ("photonmap", "render_photonmap"), "bre": ("bre", "render_bre"),
    "vpl": ("vpl", "render_vpl"), "irrcache": ("irrcache", "render_irrcache"),
    "singlescatter": ("singlescatter", "render_singlescatter"),
    "singlescatter_mesh": ("singlescatter", "render_singlescatter_mesh"),
    "dipole": ("dipole", "render_dipole"),
}
_PORTED = ("volpath", "volpath_simple", "volpath_er", "path", "direct",
           "ao", "field") + tuple(_ESTIMATORS)


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
    return stats_m.host_read("render.has_beam", stats_m.any_of,
                             scene.emitters.kind == EM_COLLIMATED)


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
    """One spp chunk through a loop engine (render.py:106-148): camera
    samples from cfg.sampler's mode, `volpath.li`, `path.li` ("direct" is
    path at max_depth 2), `misc.ao_li` or `misc.field_li`, and the splat
    with cfg.filter. Returns the accumulator and [bounces, Woodcock
    tracking iterations] (volpath), [bounces] (path) or [] (ao, field)."""
    rays, jitter, smp = common.camera_samples(scene, cfg, sppc, seed,
                                              pass_idx,
                                              rng.mode_of(cfg.sampler))
    pixel = common.lane_pixels(cfg, sppc, rays.o.device)
    if cfg.integrator == "direct":
        cfg = replace(cfg, max_depth=2, integrator="path")
    if cfg.integrator in ("ao", "field"):
        sink, _ = (misc_m.ao_li(scene, cfg, rays.o, rays.d, smp, pixel)
                   if cfg.integrator == "ao" else
                   misc_m.field_li(scene, cfg, rays.o, rays.d, smp, pixel,
                                   field=cfg.field))
        counts = []
    elif cfg.integrator == "path":
        sink, _, counts = path_m.li(scene, cfg, rays.o, rays.d, smp, pixel)
    else:
        sink, _, counts = volpath_m.li(
            scene, cfg, rays.o, rays.d, smp, pixel,
            simple=cfg.integrator == "volpath_simple")
    return _splat_sink(accum, cfg, sink, jitter, sppc), counts


def _splat_sink(accum, cfg: RenderConfig, sink: common.Sink, jitter,
                sppc: int):
    """A pass's sink into the film (render.py:135-148): the steady values
    through the filter into frame 0 and the weight channel, then the
    frames, unfiltered, onto the 3F frame channels."""
    H, W = cfg.height, cfg.width
    accum = film_m.splat(accum, sink.steady.reshape(sppc, H, W, 3),
                         jitter.reshape(sppc, H, W, 2), cfg.filter)
    if sink.frames is not None:
        accum[..., :3 * cfg.n_frames] += sink.frames.reshape(
            H, W, 3 * cfg.n_frames)
    return accum


def beam_splat_pass(scene: Scene, splat, cfg: RenderConfig, n_samples: int,
                    seed: int, pass_idx: int):
    """Single-scatter light-tracing splat for a collimated beam: sample y
    on the beam equiangularly w.r.t. the camera, project it to the film and
    add power * Tr(o_b, y) * sigma_s(y) * rho * Tr(y, cam) / (d^2 pdf(s)).
    Accumulates into `splat` (H, W, 3F) in place and returns it: with
    frames, into the bin of the path length s + d (render.py:218-226; the
    constant 2.0 in bounce mode), nothing outside [min_bound, max_bound).
    Under CW-ToF the splat is not weighted, as in the JAX package."""
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
    if cfg.n_frames == 1:
        add_rows(splat.view(H * W, 3), py * W + px, value)
        return splat
    key = (sdist + dist if cfg.decomposition != "bounce"
           else torch.full_like(sdist, 2.0))
    b, inside = film_m.bin_index(cfg, key)
    value = torch.where((inside & ok).unsqueeze(-1), value, 0.0)
    add_rows(splat.view(H * W * cfg.n_frames, 3),
             (py * W + px) * cfg.n_frames + b, value)
    return splat


def add_rows(flat, key, value):
    """flat[key[i]] += value[i] for every i, in an order fixed by the data,
    so that the result is the same bits on every run (index_add_ on CUDA
    adds in the order its atomics land). The rows are sorted stably by key;
    a segmented inclusive scan of log2(n) doubling steps sums each key's
    rows in a fixed tree order; the last row of each key adds its sum to
    `flat`, one add a key. On the CPU the result equals index_add_'s within
    float rounding."""
    key_s, order = torch.sort(key, stable=True)
    v = value[order]
    n, step = v.shape[0], 1
    while step < n:
        same = (key_s[step:] == key_s[:-step]).unsqueeze(-1)
        v = torch.cat([v[:step], v[step:] + torch.where(same, v[:-step], 0.0)])
        step *= 2
    last = torch.ones_like(key_s, dtype=torch.bool)
    last[:-1] = key_s[1:] != key_s[:-1]
    rows = stats_m.host_read("render.add_rows", stats_m.indices_of, last)
    flat[key_s[rows]] += v[rows]
    return flat


_device = common.render_device     # the roads' device rule


def get_integrator(name: str):
    """The `li` of an integrator name (render.py:23-44): each takes
    (scene, cfg, o, d, sampler, pixel=...) and returns the sink and the
    sampler first (path and volpath then their counts).
    "direct" is plain path.li here, as in the JAX package (render_pass
    gives it max_depth 2); an unknown name raises ValueError."""
    if name in ("path", "direct"):
        return path_m.li
    if name in ("volpath", "volpath_simple"):
        return functools.partial(volpath_m.li,
                                 simple=name.endswith("simple"))
    if name == "volpath_er":
        return er_m.li
    if name == "ao":
        return misc_m.ao_li
    if name == "field":
        return misc_m.field_li
    raise ValueError(f"unknown integrator {name}")


def render(scene: Scene, cfg: RenderConfig, spp: int | None = None,
           seed: int = 0, device=None, stats: dict | None = None,
           spp_per_pass: int | None = None,
           checkpoint_path: str | None = None, checkpoint_every: int = 0):
    """Render to a developed (H, W, 3) image on `device`: the CUDA card by
    default (it raises where there is none), the CPU only when
    device="cpu" is passed.

    Roads: the estimators of _ESTIMATORS render through their own passes
    (bdpt, ptracer, pssmlt, erpt, photonmap, bre, vpl, irrcache,
    singlescatter, dipole); "volpath_er" takes
    the eikonal road; "volpath" or "path" with a box filter and a steady
    film takes boxwalk on a scene of the boxwalk class and the wavefront
    engine on any other; "volpath" or "path" with another filter, a film
    with frames or a CW-ToF modulation, or engine="loop",
    "volpath_simple" unless engine="wavefront", and "direct" take a loop
    engine. "ao" and "field" take the loop road's camera rays (misc.py).
    With frames the image is (H, W, 3F). engine="wavefront" with frames or
    a modulation raises ValueError. A name the JAX package does not know
    raises ValueError, as its get_integrator does.

    If `stats` is a dict it receives, per pass, "passes" ([segments, taps,
    iters, unfinished] on the boxwalk and wavefront roads, [bounces,
    Woodcock tracking iterations] on the volpath loop road, [bounces] on
    the path loop road and the eikonal road) and the seconds of the
    passes, timed with a device synchronize around each, as "boxwalk_s",
    "wavefront_s", "loop_s", "er_s", "bdpt_s" or "ptracer_s"; the other
    estimators add their wall as "pssmlt_s", "erpt_s", "photonmap_s",
    "bre_s", "vpl_s", "irrcache_s", "singlescatter_s",
    "singlescatter_mesh_s" or "dipole_s" and their stages' seconds (the
    entries' docstrings).

    spp_per_pass fixes the samples of a pass (default min(spp, 2^21 //
    npix), as in the JAX render()). checkpoint_path / checkpoint_every make
    a loop-road render resumable, as the JAX render() does: an existing
    state at checkpoint_path is loaded (accumulator, pass counter and seed;
    one the JAX package wrote too), and the state is saved there after
    every checkpoint_every-th pass. The counter-based sampler makes the
    resumed render equal to an uninterrupted one."""
    if spp is not None:
        cfg = replace(cfg, spp=spp)
    if cfg.integrator not in _PORTED:
        raise ValueError(f"unknown integrator {cfg.integrator}")
    with stats_m.span("render.image",
                      samples=cfg.width * cfg.height * cfg.spp):
        return _render(scene, cfg, seed, device, stats, spp_per_pass,
                       checkpoint_path, checkpoint_every)


def _render(scene: Scene, cfg: RenderConfig, seed: int, device, stats,
            spp_per_pass: int | None, checkpoint_path: str | None,
            checkpoint_every: int):
    """render() once cfg holds the samples: the choice of road."""
    if cfg.integrator in _ESTIMATORS:
        module, entry = _ESTIMATORS[cfg.integrator]
        fn = getattr(importlib.import_module(f".{module}", __package__),
                     entry)
        with stats_m.timed("render.wall"):
            return fn(scene.to(_device(device)), cfg, seed=seed, stats=stats)
    spp_per_pass = spp_per_pass or _spp_per_pass(cfg)
    if cfg.integrator == "volpath_er":
        return _render_film(scene.to(_device(device)), cfg, seed, stats,
                            "er_s", _er_pass, spp_per_pass, count=False)
    if not _use_wavefront(cfg):
        scene = _on_device(scene, _device(device))
        img = _render_film(scene, cfg, seed, stats, "loop_s", render_pass,
                           spp_per_pass, checkpoint_path, checkpoint_every)
        return _add_beam_splat(scene, cfg, img, seed)
    wf_m.check_supported(scene, cfg)
    use_bw = boxwalk.supported(scene, cfg)
    scene = scene.to(_device(device))
    dev = scene.aabb_min.device
    npix = cfg.width * cfg.height
    hd, het = _has_direct(scene), _any_het(scene)
    timer = "boxwalk_s" if use_bw else "wavefront_s"

    def fast_pass(L, sppc, pass_idx):
        if use_bw:
            Lb, st = boxwalk.render_boxwalk(scene, cfg, sppc, seed, pass_idx)
            return L + Lb, st.tolist()
        L, st = render_pass_wavefront(scene, L, cfg, sppc, seed, pass_idx,
                                      has_direct=hd, any_het=het)
        return L, st.tolist()

    L = _run_passes(dev, cfg, stats, timer, spp_per_pass, fast_pass,
                    torch.zeros((npix, 3), dtype=torch.float32, device=dev))
    img = (L / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
    return _add_beam_splat(scene, cfg, img, seed)


def _on_device(scene: Scene, dev) -> Scene:
    """scene.to(dev); the copies from host memory to a card are the host
    read "render.scene" (the loop road's, as one)."""
    if scene.aabb_min.device.type == "cpu" and dev.type != "cpu":
        return stats_m.host_read("render.scene", lambda s: s.to(dev), scene)
    return scene.to(dev)


def _add_beam_splat(scene: Scene, cfg: RenderConfig, img, seed: int):
    """img plus 4 beam-splat passes of 4 npix samples each, where the
    scene has a collimated emitter (render.py:380-389, 420-429); frame by
    frame where the film has frames."""
    if not (cfg.integrator.startswith("volpath") and _has_beam(scene)):
        return img
    n_splat = 4 * cfg.width * cfg.height
    n_passes = 4
    with stats_m.synced_span("render.beam_splat", img.device,
                             samples=n_splat * n_passes):
        splat = torch.zeros((cfg.height, cfg.width, 3 * cfg.n_frames),
                            dtype=torch.float32, device=img.device)
        for i in range(n_passes):
            beam_splat_pass(scene, splat, cfg, n_splat, seed, i)
        return img + splat / float(n_splat * n_passes)


def _spp_per_pass(cfg: RenderConfig) -> int:
    """min(spp, 2^21 // npix), as the JAX render() fixes the per-pass
    budget before it picks the engine (so neither fast engine gets its
    own)."""
    return max(1, min(cfg.spp, (1 << 21) // max(cfg.width * cfg.height, 1)))


def _run_passes(dev, cfg: RenderConfig, stats, timer: str,
                spp_per_pass: int, pass_fn, acc, pass_idx: int = 0,
                after=None, count: bool = True):
    """acc through pass_fn(acc, sppc, pass_idx) -> (acc, counts), chunk by
    chunk of spp_per_pass samples, from pass pass_idx (a resumed render's)
    to cfg.spp; after(acc, pass_idx) follows each pass where given. Feeds
    the `stats` dict (timer, "passes") and utils/stats.py ("render.wall";
    where `count`, "render.passes" and "render.camera_rays"). Each pass is
    the span "render.pass" (synchronised at its edges), with its lanes and
    the counts named by PASS_COUNTS[timer]."""
    if stats is not None:
        stats.setdefault("passes", [])
        stats.setdefault(timer, 0.0)
    npix = cfg.width * cfg.height
    done = min(pass_idx * spp_per_pass, cfg.spp)
    with stats_m.timed("render.wall"):
        while done < cfg.spp:
            sppc = min(spp_per_pass, cfg.spp - done)
            if stats is not None:
                common.sync(dev)
                t0 = time.perf_counter()
            with stats_m.synced_span("render.pass", dev,
                                     lanes=npix * sppc) as sp:
                acc, counts = pass_fn(acc, sppc, pass_idx)
                sp.add(**dict(zip(PASS_COUNTS[timer], counts)))
            if stats is not None:
                common.sync(dev)
                stats[timer] += time.perf_counter() - t0
                stats["passes"].append(counts)
            done += sppc
            pass_idx += 1
            if count:
                stats_m.counter_add("render.passes")
                stats_m.counter_add("render.camera_rays", npix * sppc)
            if after is not None:
                after(acc, pass_idx)
        common.sync(dev)
    return acc


# what each road's pass counts (render's `stats["passes"]` rows)
PASS_COUNTS = {"loop_s": ("bounces", "woodcock"), "er_s": ("bounces",),
               "boxwalk_s": ("segments", "taps", "iters", "unfinished"),
               "wavefront_s": ("segments", "taps", "iters", "unfinished")}


def _render_film(scene: Scene, cfg: RenderConfig, seed: int, stats,
                 timer: str, pass_fn, spp_per_pass: int,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, count: bool = True):
    """spp chunks of pass_fn(scene, accum, cfg, sppc, seed, pass_idx) ->
    (accum, counts) into the filtered film, developed: the loop road
    (render.py:392-418, with its checkpoints) and the eikonal road's
    host-stepped branch (render.py:323-345, which counts no passes)."""
    dev = scene.aabb_min.device
    accum = film_m.new_accumulator(cfg, dev)
    pass_idx = 0
    if checkpoint_path:
        st = ckpt.load_render_state(checkpoint_path)
        if st is not None:
            accum, pass_idx, seed, _ = st
            accum = torch.as_tensor(accum, device=dev)

    def save(acc, pass_idx):
        if checkpoint_every and pass_idx % checkpoint_every == 0:
            ckpt.save_render_state(checkpoint_path, acc, pass_idx, seed, cfg)

    accum = _run_passes(
        dev, cfg, stats, timer, spp_per_pass,
        lambda acc, sppc, i: pass_fn(scene, acc, cfg, sppc, seed, i), accum,
        pass_idx, save if checkpoint_path else None, count)
    return film_m.develop(accum)


def _er_pass(scene: Scene, accum, cfg: RenderConfig, sppc: int, seed: int,
             pass_idx: int):
    """One spp chunk of the eikonal road into the film: returns the
    accumulator and [bounces]."""
    sink, jitter, bounces = er_m.render_er_pass(scene, cfg, sppc, seed,
                                                pass_idx)
    return _splat_sink(accum, cfg, sink, jitter, sppc), [bounces]

