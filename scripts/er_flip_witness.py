"""Why lanes of the eikonal gradient differ between the port and the JAX
package (the flipped lane of tests/test_torch_er_grad_li.py's spline case,
and those at tests/test_inverse.py's size): the BVP connections of each
such lane as every run solved them, on the CPU.

    python3 scripts/er_flip_witness.py [--family spline|radial]
                                       [--size test|inverse] [--lanes K]

It runs the test's loss (volpath_er.li(differentiable=True) on the test's
scene; --size test: res 4, sppc 2, max_depth 3, 2 BVP restarts, seed 0;
--size inverse: tests/test_inverse.py's finite-difference size, res 8,
sppc 4, max_depth 4, 8 restarts, seed 3) in the port and in two JAX
programs, with the acoustic Bessel functions zeroed as the test zeroes
them: the forward jitted alone, and the test's jitted value_and_grad. It
prints each run's loss and the gradient (the spline's along
test_inverse.py's smooth bump), and records in each, bounce by bounce of
the forward, every call of solve_bvp (its inputs and its accepted flags,
weights and directions) and of the Levenberg solve inside it (the solved
velocities and costs). For the first K lanes whose sinks differ from the
port's by more than 1e-4 of the largest in either program, it prints at
every bounce where that lane tries a connection: how far the three runs'
inputs are apart; each restart round's Levenberg cost against bvp_tol2
(rounds after the lane stopped looping are solved masked and mean
nothing); each converged round's re-find distance |d - d_first|^2
against the re-find tolerance; the final measurement's cost (recomputed
by each package's integrate_with_sensitivities at its accepted
direction); and what each run accepted.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_er_grad_li as L  # noqa: E402
from mitsubaer_tpu.core import rng as jrng  # noqa: E402
from mitsubaer_tpu.integrators import volpath_er as jer  # noqa: E402
from mitsubaer_tpu.models import eikonal as jek  # noqa: E402
from mitsubaer_tpu.models import sensor as jsensor  # noqa: E402
from mitsubaer_tpu_torch.core import rng as trng  # noqa: E402
from mitsubaer_tpu_torch.integrators import volpath_er as ter  # noqa: E402
from mitsubaer_tpu_torch.models import eikonal as tek  # noqa: E402
from mitsubaer_tpu_torch.models import sensor as tsensor  # noqa: E402

DIR_MATCH_TOL2 = 1e-4       # solve_bvp's default in both packages
# (res, sppc, max_depth, bvp_restarts, seed)
SIZES = {"test": (L.RES, L.SPPC, 3, 2, L.SEED), "inverse": (8, 4, 4, 8, 3)}


def _jax_forward(scene, cfg, sppc, seed, log, field, grad):
    """JAX's sink of the test's loss with solve_bvp and _levenberg_solve
    recorded in `log` (ordered host callbacks, one entry a call): jitted
    as a forward only, or (grad) as the test's jitted value_and_grad with
    respect to the media's `field`, whose backward recomputes each bounce
    and so records it twice. Returns (sink, gradient or None)."""
    real_bvp, real_lm = jek.solve_bvp, jek._levenberg_solve

    def lm(*a, **k):
        v, cost = real_lm(*a, **k)
        jax.debug.callback(lambda v, c: log.append(("lm", np.asarray(v),
                                                    np.asarray(c))),
                           v, cost, ordered=True)
        return v, cost

    def bvp(rif, sdf, p1, p2, init_dir, h, max_steps, active, **k):
        res = real_bvp(rif, sdf, p1, p2, init_dir, h, max_steps, active, **k)
        tag = "outer" if k.get("differentiable") else "inner"
        jax.debug.callback(
            lambda *t: log.append((tag,) + tuple(np.asarray(x) for x in t)),
            p1, p2, init_dir, active, res.converged, res.weight,
            res.dir_to_target, ordered=True)
        return res

    H, W = cfg.height, cfg.width
    npix = H * W

    def loss(x):
        sc = scene._replace(media=scene.media._replace(**{field: x}))
        pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (sppc,))
        sidx = jnp.repeat(jnp.arange(sppc, dtype=jnp.uint32), npix)
        smp = jrng.make_sampler(jnp.uint32(seed), pixel, sidx)
        jitter, smp = jrng.next_2d(smp)
        px = (pixel % W).astype(jnp.float32) + jitter[:, 0]
        py = (pixel // W).astype(jnp.float32) + jitter[:, 1]
        rays = jsensor.sample_rays(sc.sensor, px, py, W, H)
        sink, _ = jer.li(sc, cfg, rays.o, rays.d, smp, pixel=pixel,
                         differentiable=True)
        return jnp.mean(sink.steady), sink.steady

    x = getattr(scene.media, field)
    jek.solve_bvp, jek._levenberg_solve = bvp, lm
    try:
        g = None
        if grad:
            (_, sink), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(x)
            g = np.asarray(g)
        else:
            _, sink = jax.jit(loss)(x)
        sink = np.asarray(sink)
        jax.effects_barrier()
    finally:
        jek.solve_bvp, jek._levenberg_solve = real_bvp, real_lm
    return sink, g


def _port_forward(scene, cfg, sppc, seed, log, field):
    """The port's sink of the test's loss and its gradient with respect to
    the media's `field`, with solve_bvp and _levenberg_solve of the
    forward recorded in `log`."""
    real_bvp, real_lm = tek.solve_bvp, tek._levenberg_solve
    recording = [True]

    def lm(*a, **k):
        v, cost = real_lm(*a, **k)
        log.append(("lm", v.numpy().copy(), cost.numpy().copy()))
        return v, cost

    def bvp(rif, sdf, p1, p2, init_dir, h, max_steps, active, **k):
        res = real_bvp(rif, sdf, p1, p2, init_dir, h, max_steps, active, **k)
        tag = "outer" if k.get("differentiable") else "inner"
        if recording[0]:
            log.append((tag,) + tuple(t.detach().numpy().copy() for t in (
                p1, p2, init_dir, active, res.converged, res.weight,
                res.dir_to_target)))
        return res

    leaf = getattr(scene.media, field).detach().clone().requires_grad_()
    scene = dataclasses.replace(scene, media=dataclasses.replace(
        scene.media, **{field: leaf}))
    H, W = cfg.height, cfg.width
    npix = H * W
    pixel = torch.arange(npix).repeat(sppc)
    smp = trng.make_sampler(seed, pixel, torch.repeat_interleave(
        torch.arange(sppc), npix))
    jitter, smp = trng.next_2d(smp)
    px = (pixel % W).to(torch.float32) + jitter[:, 0]
    py = (pixel // W).to(torch.float32) + jitter[:, 1]
    rays = tsensor.sample_rays(scene.sensor, px, py, W, H)
    tek.solve_bvp, tek._levenberg_solve = bvp, lm
    try:
        sink, _, _ = ter.li(scene, cfg, rays.o, rays.d, smp,
                            differentiable=True)
        sink = sink.steady
        recording[0] = False
        (g,) = torch.autograd.grad(sink.mean(), leaf)
    finally:
        tek.solve_bvp, tek._levenberg_solve = real_bvp, real_lm
    return sink.detach().numpy(), g.numpy()


def _by_bounce(log):
    """[(inner, outer, [Levenberg calls])] a bounce, from a log in call
    order."""
    out, lm, inner = [], [], None
    for e in log:
        if e[0] == "lm":
            lm.append(e)
        elif e[0] == "inner":
            inner = e
        else:
            out.append((inner, e, lm))
            lm, inner = [], None
    return out


def _rounds(lm, n, lane):
    """[(cost, unit direction)] of each restart round of `lane`: the first
    Levenberg call solves rounds 0 and 1 as one batch of 2n lanes, each
    later call one round."""
    out = []
    for _, v, cost in lm:
        for r in range(len(cost) // n):
            vv = v[r * n + lane]
            out.append((float(cost[r * n + lane]), vv / np.linalg.norm(vv)))
    return out


def _final_cost(pkg, fields, p1, p2, d, h, max_steps):
    """|err|^2 of the final measurement at direction d, by the package's own
    integrate_with_sensitivities (eager, outside its jit)."""
    rif, sdf = fields
    if pkg == "jax":
        r0 = jek.rif_value(rif, jnp.asarray(p1))
        err = jek.integrate_with_sensitivities(
            rif, sdf, jnp.asarray(p1), jnp.asarray(d) * r0[..., None],
            jnp.asarray(p2), h, max_steps, jnp.ones(p1.shape[0], bool))[0]
        return np.asarray((err * err).sum(-1))
    p1t = torch.from_numpy(p1)
    r0 = tek.rif_value(rif, p1t)
    err = tek.integrate_with_sensitivities(
        rif, sdf, p1t, torch.from_numpy(d) * r0.unsqueeze(-1),
        torch.from_numpy(p2), h, max_steps, torch.ones(p1.shape[0],
                                                       dtype=torch.bool),
        jacobian=False)[0]
    return (err * err).sum(-1).numpy()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=sorted(L.FAMILIES), default="spline")
    ap.add_argument("--size", choices=sorted(SIZES), default="test")
    ap.add_argument("--lanes", type=int, default=4)
    args = ap.parse_args()
    jek.bessel_jm = lambda m, x: jnp.zeros_like(x)    # as the test does
    res, sppc, depth, restarts, seed = SIZES[args.size]
    (js, jc), (ts, tc) = L._scenes()
    kw = dict(width=res, height=res, max_depth=depth, bvp_restarts=restarts)
    jc, tc = jc._replace(**kw), dataclasses.replace(tc, **kw)
    kind, prm = L.FAMILIES[args.family]
    js = js._replace(media=js.media._replace(
        rif_kind=jnp.int32(kind), rif_params=jnp.asarray(prm)))
    ts = dataclasses.replace(ts, media=dataclasses.replace(
        ts.media, rif_kind=torch.tensor(kind, dtype=torch.int32),
        rif_params=torch.from_numpy(prm.copy())))
    field = "rif_params" if kind == tek.RIF_RADIAL else "rif_coeff"
    tlog = []
    sink_t, g_t = _port_forward(ts, tc, sppc, seed, tlog, field)
    runs = {"port": (sink_t, _by_bounce(tlog))}
    grads = {"port": g_t}
    for name, grad in (("JAX forward jit", False),
                       ("JAX value_and_grad jit", True)):
        log = []
        sink, grads[name] = _jax_forward(js, jc, sppc, seed, log, field,
                                         grad)
        # the first max_iters bounces: the forward's (a backward's
        # recompute records them again)
        runs[name] = (sink, _by_bounce(log)[:ter.max_iters(tc)])
    for name, g in grads.items():
        if g is None:
            continue
        if field == "rif_coeff":
            n = g.shape[0]
            zs = np.linspace(-1, 1, n)
            Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
            bump = np.exp(-(X**2 + Y**2 + Z**2) / 0.5).astype(np.float32)
            what = f"along test_inverse.py's bump {(g * bump).sum():.6e}"
        else:
            what = f"{g.tolist()}"
        print(f"{args.family} at size {args.size}, {name}: gradient {what}")
    scale = np.abs(runs["JAX forward jit"][0]).max()
    flipped = set()
    for name, (sink, _) in runs.items():
        diff = np.abs(sink - sink_t).max(-1)
        lanes = np.nonzero(diff > 1e-4 * scale)[0].tolist()
        flipped.update(lanes)
        if lanes:
            moved = sink[lanes].mean(-1) - sink_t[lanes].mean(-1)
            print(f"  {name}: the differing lanes' sinks minus the port's "
                  f"{[f'{x:.4e}' for x in moved]}, their share of the loss "
                  f"gap {moved.sum() / len(sink):.6e}")
        print(f"{args.family} at size {args.size}, {name}: loss "
              f"{sink.mean():.8e}; lanes whose "
              f"sinks differ from the port's by more than 1e-4 of the "
              f"largest: {lanes}")
    tol2 = tc.bvp_tol2
    h = tc.er_stepsize * tc.er_bvp_hscale
    max_steps = max(int(tc.er_maxsteps / tc.er_bvp_hscale), 16)
    fields = {"jax": (jek.rif_from_media(js.media),
                      jek.sdf_from_media(js.media)),
              "port": (tek.rif_from_media(ts.media),
                       tek.sdf_from_media(ts.media))}
    for lane in sorted(flipped)[:args.lanes]:
        print(f"lane {lane}: sinks " + "; ".join(
            f"{name} {sink[lane].tolist()}" for name, (sink, _) in
            runs.items()))
        for k, bounces in enumerate(zip(*[b for _, b in runs.values()])):
            if not any(b[1][4][lane] for b in bounces):
                continue        # the lane tries no connection here
            n = bounces[0][1][1].shape[0]
            gap = max(np.abs(b[1][i][lane] - bounces[0][1][i][lane]).max()
                      for b in bounces for i in (1, 2, 3))
            print(f"  bounce {k}: inputs p1, p2, chord apart by at most "
                  f"{gap:.3e}")
            for name, (inner, outer, lm) in zip(runs, bounces):
                rounds = _rounds(lm, n, lane)
                c = [x for x, _ in rounds]
                # each converged round's |d - d_first|^2 to the first
                # converged round's direction
                first = next((d for x, d in rounds if x < tol2), None)
                dd = [float(((d - first) ** 2).sum()) if x < tol2 else None
                      for x, d in rounds] if first is not None else []
                ddr = [None if x is None else f"{x / DIR_MATCH_TOL2:.4f}"
                       for x in dd]
                key = "port" if name == "port" else "jax"
                fc = _final_cost(key, fields[key], outer[1][lane:lane + 1],
                                 outer[2][lane:lane + 1],
                                 inner[7][lane:lane + 1], h, max_steps)[0]
                print(f"    {name}: Levenberg cost by round "
                      f"{[f'{x:.6e}' for x in c]} (cost / tol2 "
                      f"{[f'{x / tol2:.6f}' for x in c]}), re-find "
                      f"|d - d_first|^2 / {DIR_MATCH_TOL2:g} of each "
                      f"converged round {ddr}, final cost {fc:.6e} "
                      f"(/ tol2 = {fc / tol2:.6f}); solve accepted "
                      f"{bool(inner[5][lane])} weight "
                      f"{float(inner[6][lane]):g}, connection accepted "
                      f"{bool(outer[5][lane])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
