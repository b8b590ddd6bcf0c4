"""Multi-process rendering and training over torch.distributed (port of
mitsubaer_tpu/parallel/driver.py).

Replaces the reference's distributed render farm (Scheduler + RemoteWorker
over TCP/SSH, sched.cpp / sched_remote.cpp / mtssrv.cpp). The JAX package
runs one SPMD program over a (data, tile) device mesh; here a `Layout`
(n_data, n_tile) of shards takes the mesh's place:
  data — samples-per-pixel shards (the reference's per-worker sample split)
  tile — image row-block shards   (the reference's block decomposition)
Shard s is (data_idx, tile_idx) = divmod(s, n_tile), as the mesh's
row-major devices. The layout, not the number of processes, fixes each
shard's samples: global pixel ids, sample index (pass_idx * n_data +
data_idx) * sppc + k, the config's sampler mode (driver.py:56-86). Each
process renders the shards rank, rank + world, ... in turn, so one layout
gives the same image at every world size.

The partial films and the parameter gradients are small (a 512^2 film of 4
floats a pixel, a 64^3 grid): they are gathered over gloo as host copies,
on the card and on the CPU alike, and summed in shard order, never
all_reduced, so that the result does not depend on the world size or the
backend. (NCCL refuses two ranks on one card, and the machines this port
runs on have one; an NCCL path is later work, ROADMAP.)

Processes start under `torchrun` (or `spawn` below), which sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; `init_distributed`
forms the group from them.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import rng
from ..diff import render as diff_render
from ..integrators import common
from ..integrators import volpath as volpath_m
from ..integrators import wavefront as wf_m
from ..integrators.render import _any_het, _has_direct, get_integrator
from ..models import film as film_m
from ..models import sensor as sensor_m
from ..scene.types import RenderConfig, Scene


class Layout(NamedTuple):
    """The shards of a sharded run: n_data sample shards times n_tile
    row blocks (the JAX mesh's shape)."""

    n_data: int
    n_tile: int = 1

    @property
    def n_shards(self) -> int:
        return self.n_data * self.n_tile


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device=None) -> torch.device:
    """Join the process group that the torchrun environment names, over
    gloo, and return this process's device: the CPU where device="cpu" is
    asked (its threads the host's cores over LOCAL_WORLD_SIZE), else
    cuda:(LOCAL_RANK % the card count), which becomes the current CUDA
    device. Where the environment names one process (or
    none), no group is formed. Where it names more and the group cannot
    form, this raises (the JAX package's init_distributed swallows every
    error)."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    if size > 1 and not dist.is_initialized():
        dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                                world_size=size)
    if device is not None and torch.device(device).type == "cpu":
        # the processes of one host share its cores
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
        return torch.device("cpu")
    dev = common.render_device(device)
    if device is None:
        dev = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0"))
            % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _my_shards(layout: Layout) -> range:
    rank, size = world()
    return range(rank, layout.n_shards, size)


def _gather(mine: dict) -> dict:
    """The union over the processes of their {shard: host value} dicts
    (gloo; a dict's values are tensors or lists of tensors on the CPU)."""
    _, size = world()
    if size == 1:
        return dict(mine)
    parts = [None] * size
    dist.all_gather_object(parts, mine)
    out = {}
    for p in parts:
        out.update(p)
    return out


def _in_order(tensors):
    """The sum of `tensors` in their order."""
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t
    return total


def _shard_rays(scene: Scene, cfg: RenderConfig, sppc: int, rows: int,
                row0: int, seed: int, sample0: int, mode: int):
    """The camera prologue of one shard (driver.py:60-74): sppc samples of
    each pixel of rows [row0, row0 + rows); lane s * npix + p is pixel
    row0 * W + p, sample sample0 + s. One jitter draw, no aperture draw.
    Returns (rays, (N, 2) jitter, sampler, (N,) global pixel)."""
    W = cfg.width
    dev = scene.aabb_min.device
    npix = rows * W
    pixel = (torch.arange(npix, dtype=torch.int64, device=dev).repeat(sppc)
             + row0 * W)
    sample_index = torch.repeat_interleave(
        sample0 + torch.arange(sppc, dtype=torch.int64, device=dev), npix)
    smp = rng.make_sampler(seed, pixel, sample_index, mode=mode)
    jitter, smp = rng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jitter[:, 0]
    py = (pixel // W).to(torch.float32) + jitter[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, cfg.height)
    return rays, jitter, smp, pixel


def _pass_shard(scene: Scene, cfg: RenderConfig, sppc: int, rows: int,
                data_idx: int, tile_idx: int, n_data: int, seed: int,
                pass_idx: int):
    """One pass of one shard on the loop road: its (rows, W, 3F + 1) film
    block (driver.py:56-86), the filter's spill across the block's edges
    dropped as there, and the integrator's stats (none from ao and
    field)."""
    rays, jitter, smp, pixel = _shard_rays(
        scene, cfg, sppc, rows, tile_idx * rows, seed,
        (pass_idx * n_data + data_idx) * sppc, rng.mode_of(cfg.sampler))
    out = get_integrator(cfg.integrator)(scene, cfg, rays.o, rays.d, smp,
                                         pixel=pixel)
    sink, st = out[0], out[2] if len(out) > 2 else []
    W = cfg.width
    accum = film_m.new_accumulator(replace(cfg, height=rows), pixel.device)
    return film_m.splat(accum, sink.steady.reshape(sppc, rows, W, 3),
                        jitter.reshape(sppc, rows, W, 2), cfg.filter), st


def _pass_shard_wavefront(scene: Scene, cfg: RenderConfig, sppc: int,
                          rows: int, data_idx: int, tile_idx: int,
                          n_data: int, seed: int, pass_idx: int,
                          has_direct: bool, any_het: bool):
    """One pass of one shard through the wavefront engine on its row block
    with global pixel ids (driver.py:91-115): its (rows W, 3) radiance sum
    and the engine's stats [segments, taps, super-iterations,
    unfinished]."""
    return wf_m.render_wavefront(
        scene, replace(cfg, height=rows), sppc, seed,
        pass_idx * n_data + data_idx, has_direct=has_direct,
        any_het=any_het, row0=tile_idx * rows, full_height=cfg.height)


def render_sharded(scene: Scene, cfg: RenderConfig, layout=(1, 1),
                   seed: int = 0, spp_per_pass: int | None = None,
                   device=None, stats: dict | None = None):
    """The image of `cfg` rendered shard by shard over `layout` (n_data,
    n_tile) by the processes of the group (one process without one), as
    the JAX render_sharded renders it over an (n_data, n_tile) mesh:
    per_dev = max(1, spp // n_data) samples a pixel for each data shard in
    passes of spp_per_pass (default per_dev); the wavefront engine where
    cfg.engine == "wavefront" and the film is steady (its sums divided by
    per_dev * n_data), else the loop road with the config's filter; no beam
    splat on either (driver.py:149-196). Every process returns the whole
    (H, W, 3F) image on its device (the CUDA card unless device="cpu").
    `stats`, where a dict, receives the shards this process rendered
    ("shards") and each one's passes' stats ("passes": {shard: [a list a
    pass]}, as render()'s: [segments, taps, super-iterations, unfinished]
    on the wavefront road, the integrator's counts on the loop road)."""
    layout = Layout(*layout)
    n_data, n_tile = layout
    if cfg.height % n_tile:
        raise ValueError(f"height {cfg.height} is no multiple of the "
                         f"{n_tile} row blocks")
    dev = common.render_device(device)
    rows = cfg.height // n_tile
    per_dev = max(1, cfg.spp // n_data)
    sppc = spp_per_pass or per_dev
    use_wf = cfg.engine == "wavefront" and cfg.n_frames == 1
    if use_wf:
        wf_m.check_supported(scene, cfg)
    scene = scene.to(dev)
    hd, het = _has_direct(scene), _any_het(scene)
    mine, passes = {}, {}
    for shard in _my_shards(layout):
        data_idx, tile_idx = divmod(shard, n_tile)
        acc, done, pass_idx = None, 0, 0
        passes[shard] = []
        while done < per_dev:
            c = min(sppc, per_dev - done)
            if use_wf:
                a, st = _pass_shard_wavefront(scene, cfg, c, rows, data_idx,
                                              tile_idx, n_data, seed,
                                              pass_idx, hd, het)
            else:
                a, st = _pass_shard(scene, cfg, c, rows, data_idx,
                                    tile_idx, n_data, seed, pass_idx)
            passes[shard].append(st)
            acc = a if acc is None else acc + a
            done += c
            pass_idx += 1
        mine[shard] = acc.cpu()
    if stats is not None:
        stats["shards"] = list(mine)
        stats["passes"] = {s: [torch.as_tensor(x).tolist() for x in v]
                           for s, v in passes.items()}
    films = _gather(mine)
    tiles = [_in_order([films[d * n_tile + t] for d in range(n_data)])
             for t in range(n_tile)]
    if use_wf:
        img = (torch.cat(tiles) / float(per_dev * n_data)).reshape(
            cfg.height, cfg.width, 3)
    else:
        img = film_m.develop(torch.cat(tiles))
    return img.to(dev)


# ---------------------------------------------------------------------------
# Distributed inverse-rendering training step
# ---------------------------------------------------------------------------
def _shard_image(scene: Scene, cfg: RenderConfig, sppc: int, rows: int,
                 data_idx: int, tile_idx: int, seed: int):
    """One shard's differentiable (rows, W, 3) mean image over its sppc
    samples (driver.py:203-223): pixels of its row block, sample index
    data_idx * sppc + k, the independent sampler, volpath.li with
    differentiable=True."""
    rays, _, smp, pixel = _shard_rays(scene, cfg, sppc, rows,
                                      tile_idx * rows, seed,
                                      data_idx * sppc, rng.INDEPENDENT)
    sink = volpath_m.li(scene, cfg, rays.o, rays.d, smp, pixel=pixel,
                        differentiable=True)[0]
    return sink.steady.reshape(sppc, rows, cfg.width, 3).mean(dim=0)


def make_train_step(cfg: RenderConfig, optimizer, layout=(1, 1),
                    sppc: int = 4, device=None):
    """A training step over `layout`, as the JAX make_train_step
    (driver.py:226-241): step(scene, params, target, seed) -> loss, where
    `params` is the MediumParams of leaf tensors that the torch.optim
    `optimizer` updates. The loss is the JAX one: the data shards' images
    are averaged before the squared error against `target` (H, W, 3), and
    the row blocks' sums are added and divided by H W 3.

    torch.distributed's collectives carry no autograd, so the step runs in
    three parts: each process renders its shards with their graphs kept
    and gathers their images (host copies, gloo); every process computes
    the loss and each shard's image gradient from them, in shard order;
    each process backpropagates its shards' shares, and the parameter
    gradients are gathered and summed in shard order into each param's
    .grad before one optimizer.step() on every process. Every sum runs in
    the same order at every world size over one layout (kernel A' sums the
    density's gradient in fixed point), so one layout gives the same loss
    and update at every world size."""
    layout = Layout(*layout)
    n_data, n_tile = layout
    if cfg.height % n_tile:
        raise ValueError(f"height {cfg.height} is no multiple of the "
                         f"{n_tile} row blocks")
    rows = cfg.height // n_tile
    norm = float(cfg.height * cfg.width * 3)

    def step(scene: Scene, params, target, seed: int):
        dev = common.render_device(device)
        leaves = diff_render.MediumParams(
            *(p.detach().to(dev).requires_grad_() for p in params))
        sc = diff_render.put_params(scene.to(dev), leaves)
        imgs = {s: _shard_image(sc, cfg, sppc, rows, *divmod(s, n_tile),
                                seed)
                for s in _my_shards(layout)}
        host = _gather({s: im.detach().cpu() for s, im in imgs.items()})
        tgt = torch.as_tensor(target, dtype=torch.float32).cpu()
        sums, grad_img = [], {}
        for t in range(n_tile):
            mean = _in_order([host[d * n_tile + t]
                              for d in range(n_data)]) / float(n_data)
            diff = mean - tgt[t * rows:(t + 1) * rows]
            sums.append(torch.sum(diff * diff))
            for d in range(n_data):
                grad_img[d * n_tile + t] = diff * (2.0 / (n_data * norm))
        loss = _in_order(sums) / norm
        grads = {}
        for s, im in imgs.items():
            g = torch.autograd.grad(torch.sum(im * grad_img[s].to(dev)),
                                    leaves, allow_unused=True)
            grads[s] = [(torch.zeros_like(x) if gx is None else gx).cpu()
                        for x, gx in zip(leaves, g)]
        host_g = _gather(grads)
        for i, p in enumerate(params):
            p.grad = _in_order([host_g[s][i] for s in range(
                layout.n_shards)]).to(p.device)
        optimizer.step()
        return loss

    return step


# ---------------------------------------------------------------------------
# Local process groups
# ---------------------------------------------------------------------------
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world_size: int, target: str, *args: str, timeout: float = 900):
    """Run `target` ("module:function") with `args` in world_size local
    processes (python -c, from the repo root) that carry a torchrun
    environment for one group on localhost, as torchrun would start them;
    the function forms the group itself (init_distributed). Returns the
    processes' standard outputs by rank; raises RuntimeError with the
    failing process's output if any exits with another code than 0, and
    kills every process on a failure or after `timeout` seconds."""
    port = free_port()
    module, _, fn = target.partition(":")
    code = (f"import sys; from {module} import {fn} as f; "
            f"f(*sys.argv[1:])")
    procs = []
    try:
        for rank in range(world_size):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(world_size),
                       LOCAL_WORLD_SIZE=str(world_size),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, *args], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {world_size} running "
                               f"{target} exited with {p.returncode}:\n"
                               f"{out[-4000:]}\n{err[-4000:]}")
    return [out for out, _ in outs]


def render_child(preset_kw: str, layout: str, seed: str, device: str = "",
                 out: str = "", warm: str = "0") -> None:
    """One process of a sharded render of presets.volumetric_box(**kw)
    (`preset_kw` a JSON object, `layout` "n_data,n_tile"), for spawn or
    torchrun: rank 0 prints one JSON line (crc32 of the image's float32
    bytes, its mean, the wall seconds, this rank's shards) and writes the
    image to `out` (.npy) where given. With warm="1" the render runs twice
    and the second is timed."""
    import json
    import time
    import zlib

    from ..scene import presets

    dev = init_distributed(device or None)
    scene, cfg = presets.volumetric_box(**json.loads(preset_kw))
    stats = {}
    for _ in range(1 + (warm == "1")):
        common.sync(dev)
        t0 = time.perf_counter()
        img = render_sharded(scene, cfg,
                             tuple(int(x) for x in layout.split(",")),
                             seed=int(seed), device=dev, stats=stats)
        common.sync(dev)
        wall = time.perf_counter() - t0
    img = img.cpu().numpy().astype(np.float32)
    if world()[0] == 0:
        if out:
            np.save(out, img)
        print(json.dumps(dict(
            crc32=zlib.crc32(img.tobytes()), mean=float(img.mean()),
            wall_s=wall, shards=stats["shards"], world=world()[1])),
            flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def _dryrun_child(device: str = "") -> None:
    """One process of dryrun_multiprocess."""
    from ..scene import presets

    dev = init_distributed(device or None)
    rank, size = world()
    tile = 2 if size % 2 == 0 else 1
    layout = Layout(size // tile, tile)
    scene, cfg = presets.volumetric_box(res=8 * tile, spp=2,
                                        heterogeneous=True, density_res=8,
                                        max_depth=3)
    params = diff_render.MediumParams(
        *(t.detach().clone().to(dev).requires_grad_()
          for t in diff_render.get_params(scene)))
    before = params.sigma_s.detach().clone()
    opt = torch.optim.Adam(params, lr=1e-2)
    step = make_train_step(cfg, opt, layout, sppc=1, device=dev)
    loss = float(step(scene, params, np.zeros((cfg.height, cfg.width, 3),
                                              np.float32), 0))
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun: loss {loss}")
    delta = float((params.sigma_s.detach() - before).abs().max())
    if not delta > 0:
        raise AssertionError("dryrun: the optimizer produced no update")
    img = render_sharded(scene, replace(cfg, engine="wavefront",
                                        filter="box"), layout, device=dev)
    mean = float(img.mean())
    if not (np.isfinite(mean) and mean >= 0):
        raise AssertionError(f"dryrun: wavefront mean {mean}")
    if rank == 0:
        print(f"dryrun_multiprocess({size}): layout {tuple(layout)} "
              f"loss={loss:.6f} dsigma={delta:.2e} wf_mean={mean:.5f} OK",
              flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def dryrun_multiprocess(world_size: int, device=None) -> str:
    """The analogue of __graft_entry__.dryrun_multichip: world_size
    processes form one group and run one sharded training step (Adam, a
    (world_size / 2, 2) layout where world_size is even, else
    (world_size, 1)) and one sharded wavefront render on tiny shapes, on
    the card unless device="cpu". Returns rank 0's report line."""
    out = spawn(world_size, "mitsubaer_tpu_torch.parallel.driver:"
                "_dryrun_child", str(device or ""))
    return out[0].strip().splitlines()[-1]
