"""The two curved-ray march loops of the eikonal integrator: kernels D and E
(csrc/ermarch.cu) and their plain PyTorch versions.

* D, `trace`: march a fixed arc length through the RIF, stopping where the
  SDF reports an exit (the loop of eikonal.trace_curved). Replaces the
  Pallas `_trace_kernel` of mitsubaer_tpu/models/ermarch.py:122. It runs
  one thread a lane on the caller's tensors as they are.
* E, `sens_march`: march until the ray passes the plane through its target
  or leaves the medium, carrying dp/dv0 and dv/dv0 (the loop of
  eikonal.integrate_with_sensitivities). Replaces the Pallas `_sens_kernel`
  of mitsubaer_tpu/models/ermarch.py:194. It runs three threads a lane, one
  sensitivity column each, on the caller's tensors as they are.

Both take the JAX launchers' arguments and return what they return, plus
`steps` at the end of `sens_march`'s tuple too: the number of steps the
longest lane took, which is the trip count of the XLA loop. (The JAX kernel
reports the count of its first block; see ROADMAP Queue 3.)

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel and counts the launch; on anything else it raises. The
plain versions are also the marches of every call off the kernels' route
(eikonal.kernel_route: the differentiable marches, attached to the RIF,
every acoustic and spline march and the float64 core), on either device,
in the dtype of their inputs.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..core.math import dot
from . import eikonal as ek


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _side(p, v, p2):
    return dot(p - p2, v) < 0


def trace_plain(rif, sdf, p, v, distance, h, max_steps: int, active):
    """Plain PyTorch version of kernel D, step by step. Returns
    (p, v, opt, marched, exited, steps)."""
    n = p.shape[0]
    dist = ek._lanes(distance, n, p)
    hb = ek._lanes(h, n, p)
    opt = torch.zeros((n,), dtype=p.dtype, device=p.device)
    marched = torch.zeros_like(opt)
    running = active.clone()
    exited = torch.zeros_like(active)
    it = 0
    while it < max_steps and bool(running.any()):
        step = torch.minimum(hb, torch.clamp_min(dist - marched, 0.0))
        p1, v1, dopt = ek.er_step(rif, p, v, step)
        out = ~ek.inside_shape(sdf, p1)
        take = running & ~out
        p = torch.where(take.unsqueeze(-1), p1, p)
        v = torch.where(take.unsqueeze(-1), v1, v)
        opt = torch.where(take, opt + dopt, opt)
        marched = torch.where(take, marched + step, marched)
        done = take & (marched >= dist - 1e-7)
        exited = exited | (running & out)
        running = running & ~out & ~done
        it += 1
    return p, v, opt, marched, exited, torch.tensor(it, device=p.device)


def sens_march_plain(rif, sdf, p1, v, dpdv0, dvdv0, p2, h, max_steps: int,
                     active):
    """Plain PyTorch version of kernel E, step by step. Returns
    (p, v, dpdv0, dvdv0, opt, marched, crossed, steps). With dpdv0 None it
    carries no sensitivities (er_step moves p and v as er_derivative_step
    does, and gives the step's h n(p) with them) and returns None for
    both: the march of a caller that drops the Jacobian, which kernel E
    does not serve."""
    n = p1.shape[0]
    hb = ek._lanes(h, n, p1)
    p, dp, dv = p1, dpdv0, dvdv0
    opt = torch.zeros((n,), dtype=p1.dtype, device=p1.device)
    marched = torch.zeros_like(opt)
    running = active.clone()
    crossed = torch.zeros_like(active)
    it = 0
    while it < max_steps and bool(running.any()):
        if dp is None:
            pn, vn, dopt = ek.er_step(rif, p, v, hb)
        else:
            pn, vn, dpn, dvn = ek.er_derivative_step(rif, p, v, dp, dv, hb)
            dopt = hb * ek.rif_value(rif, p)
        out = ~ek.inside_shape(sdf, pn)
        stop = out | (_side(pn, vn, p2) != _side(p, v, p2))
        take = running & ~stop
        p = torch.where(take.unsqueeze(-1), pn, p)
        v = torch.where(take.unsqueeze(-1), vn, v)
        if dp is not None:
            dp = torch.where(take[..., None, None], dpn, dp)
            dv = torch.where(take[..., None, None], dvn, dv)
        opt = torch.where(take, opt + dopt, opt)
        marched = torch.where(take, marched + hb, marched)
        crossed = crossed | (running & out)
        running = running & ~stop
        it += 1
    return (p, v, dp, dv, opt, marched, crossed,
            torch.tensor(it, device=p1.device))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def _params(rif, sdf) -> kernels.ErParams:
    """The 16 floats the kernels take by value: RIF kind, RIF params[0:8],
    SDF kind, SDF params[0:6] (the JAX kernels' parameter layout)."""
    q = (float(rif.kind),) + rif.params + (float(sdf.kind),) + sdf.params[:6]
    return kernels.ErParams((ctypes.c_float * 16)(*q))


@functools.lru_cache(maxsize=64)
def sphere_threshold(radius: float) -> float:
    """T with `r2 < T` exactly where the sphere SDF reports the inside,
    `sqrt(max(r2, 1e-30)) - radius < 0` in float32: sqrt rounds correctly
    and never decreases, so that set is the floats below the smallest m
    whose root is at least the radius, found by bisection over the bit
    patterns of the floats in [0, inf]. -inf where nothing is inside (a
    radius that is NaN, or whose m is not above 1e-30)."""
    r = np.float32(radius)
    if np.isnan(r):
        return float("-inf")
    lo, hi = 0, 0x7F800000          # +0 and +inf as bit patterns

    def root(bits):
        return np.sqrt(np.array(bits, np.uint32).view(np.float32))

    if not root(hi) >= r:
        return float("-inf")
    while lo < hi:                  # the smallest bits whose root is >= r
        mid = (lo + hi) // 2
        if root(mid) >= r:
            hi = mid
        else:
            lo = mid + 1
    t = np.array(lo, np.uint32).view(np.float32)
    return float(t) if t > np.float32(1e-30) else float("-inf")


def _lanes_arg(name, x, n, like):
    """A float, or a () or (N,) tensor, as kernels D and E take it: (an (N,)
    float32 tensor or None, the float where there is none)."""
    if not isinstance(x, torch.Tensor):
        return None, float(x)
    if tuple(x.shape) not in ((), (n,)):
        raise ValueError(f"{name}: expected a float or a () or ({n},) "
                         f"tensor, got {tuple(x.shape)}")
    t = x.to(device=like.device, dtype=torch.float32).expand(n).contiguous()
    return t, 0.0


def trace_io(sdf, p, v, distance, h, active):
    """Check kernel D's CUDA inputs and allocate its outputs. distance and h
    are floats or (N,) tensors. Returns (kernels.TraceIO, outputs), the
    outputs being (p, v, opt, marched, exited, steps, per-lane trip counts):
    views of three allocations (the floats, the flags, the trip counts with
    the step count last)."""
    n = p.shape[0]
    for t in (p, v):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, 3):
            raise ValueError(f"mk_er_trace: expected float32 ({n}, 3), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if active.dtype != torch.bool or tuple(active.shape) != (n,):
        raise ValueError("mk_er_trace: expected a bool (N,) active mask")
    p, v, active = p.contiguous(), v.contiguous(), active.contiguous()
    dist_t, dist = _lanes_arg("mk_er_trace", distance, n, p)
    h_t, h = _lanes_arg("mk_er_trace", h, n, p)
    kernels.require_cuda("mk_er_trace", p, v, active,
                         *[t for t in (dist_t, h_t) if t is not None])
    t_in = (sphere_threshold(sdf.params[3]) if sdf.kind == ek.SDF_SPHERE
            else 0.0)
    flt = p.new_empty((8 * n,))
    ints = (torch.zeros if n == 0 else torch.empty)(
        (n + 1,), dtype=torch.int64, device=p.device)
    outs = (flt[:3 * n].view(n, 3), flt[3 * n:6 * n].view(n, 3),
            flt[6 * n:7 * n], flt[7 * n:],
            torch.empty((n,), dtype=torch.bool, device=p.device),
            ints[n], ints[:n])
    io = kernels.TraceIO(
        p.data_ptr(), v.data_ptr(), active.data_ptr(),
        None if dist_t is None else dist_t.data_ptr(),
        None if h_t is None else h_t.data_ptr(), dist, h, t_in,
        *[t.data_ptr() for t in outs[:5] + (outs[6], outs[5])])
    # the inputs must outlive the launch: keep them with the struct
    io.tensors = (p, v, active, dist_t, h_t)
    return io, outs


def _on_cpu(name, t) -> bool:
    if not (t.is_cpu or t.is_cuda):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.is_cpu


def trace(rif, sdf, p, v, distance, h, max_steps: int, active):
    """Kernel D on CUDA tensors, trace_plain on CPU ones. Returns
    (p, v, opt, marched, exited, steps)."""
    if _on_cpu("ermarch.trace", p):
        return trace_plain(rif, sdf, p, v, distance, h, max_steps, active)
    io, outs = trace_io(sdf, p, v, distance, h, active)
    if p.shape[0]:
        with kernels.on_device(p):
            rc = kernels.library().mk_er_trace(
                _params(rif, sdf), io, p.shape[0], int(max_steps),
                kernels.stream(p))
        kernels.check(rc, "mk_er_trace")
        trace.launches += 1
    return outs[:-1]


trace.launches = 0


def sens_io(p1, v, dpdv0, dvdv0, p2, h, active):
    """Check kernel E's CUDA inputs and allocate its outputs. h is a float
    or an (N,) tensor. Returns (kernels.SensIO, outputs), the outputs being
    (p, v, dpdv0, dvdv0, opt, marched, crossed, steps, per-lane trip
    counts). They are views of three allocations (the floats, the flags,
    the trip counts with the step count last), since each allocation costs
    host time on every call and the render makes hundreds."""
    n = p1.shape[0]
    p1, v, dpdv0, dvdv0, p2, active = (t.contiguous() for t in (
        p1, v, dpdv0, dvdv0, p2, active))
    ins = [p1, v, dpdv0, dvdv0, p2]
    shapes = [(n, 3), (n, 3), (n, 3, 3), (n, 3, 3), (n, 3)]
    h_lanes, h = _lanes_arg("mk_er_sens", h, n, p1)
    if h_lanes is not None:
        ins, shapes = ins + [h_lanes], shapes + [(n,)]
    kernels.require_cuda("mk_er_sens", *ins, active)
    for t, shape in zip(ins, shapes):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"mk_er_sens: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if active.dtype != torch.bool or tuple(active.shape) != (n,):
        raise ValueError("mk_er_sens: expected a bool (N,) active mask")
    flt = p1.new_empty((26 * n,))
    ints = (torch.zeros if n == 0 else torch.empty)(
        (n + 1,), dtype=torch.int64, device=p1.device)
    outs = (flt[:3 * n].view(n, 3), flt[3 * n:6 * n].view(n, 3),
            flt[6 * n:15 * n].view(n, 3, 3), flt[15 * n:24 * n].view(n, 3, 3),
            flt[24 * n:25 * n], flt[25 * n:],
            torch.empty((n,), dtype=torch.bool, device=p1.device),
            ints[n], ints[:n])
    io = kernels.SensIO(
        *[t.data_ptr() for t in (p1, v, dpdv0, dvdv0, p2, active)],
        None if h_lanes is None else h_lanes.data_ptr(), h,
        *[t.data_ptr() for t in outs[:7] + (outs[8], outs[7])])
    # the inputs must outlive the launch: keep them with the struct
    io.tensors = (p1, v, dpdv0, dvdv0, p2, active, h_lanes)
    return io, outs


def sens_march(rif, sdf, p1, v, dpdv0, dvdv0, p2, h, max_steps: int, active):
    """Kernel E on CUDA tensors, sens_march_plain on CPU ones. Returns
    (p, v, dpdv0, dvdv0, opt, marched, crossed, steps)."""
    if _on_cpu("ermarch.sens_march", p1):
        return sens_march_plain(rif, sdf, p1, v, dpdv0, dvdv0, p2, h,
                                max_steps, active)
    io, outs = sens_io(p1, v, dpdv0, dvdv0, p2, h, active)
    if p1.shape[0]:
        with kernels.on_device(p1):
            rc = kernels.library().mk_er_sens(
                _params(rif, sdf), io, p1.shape[0], int(max_steps),
                kernels.stream(p1))
        kernels.check(rc, "mk_er_sens")
        sens_march.launches += 1
    return outs[:-1]


sens_march.launches = 0
