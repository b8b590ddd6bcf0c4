"""Whole-path renderer for bounded-scattering-volume scenes (port of
mitsubaer_tpu/integrators/boxwalk.py).

One lane walks sppc camera samples of one pixel rotation through the whole
per-sample state machine: camera regeneration -> box entry -> Woodcock
tracking with stochastic-trilinear one-voxel taps -> HG or isotropic scatter
with equiangular collimated-beam NEE -> shadow ratio tracking -> Russian
roulette -> film row of the sample's epoch -> next sample.

Kernel B, `walk`, is csrc/boxwalk.cu: persistent threads that take lanes
from a counter, state in registers, each warp running the regeneration and
collision stages of a trip deferred for the lanes that wait on them.
`walk_plain` is the same
state machine over all lanes at once with torch.where, one Python loop over
trips. A finished lane is inert (mode 3 draws no random numbers), so neither
result depends on how lanes are grouped, and both match the JAX kernel lane
by lane. They keep the JAX kernel's own formulas (the minimax atan and
tan = sin/cos) so that a comparison measures the port and not a formula.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import kernels
from ..core.rng import M32, _hash_u32, mul32
from ..models import medium as medium_m
from ..scene.types import (EM_COLLIMATED, MED_HETEROGENEOUS, PH_HG,
                           PH_ISOTROPIC, SENSOR_PERSPECTIVE, RenderConfig,
                           Scene)
from . import common, megatrack
from .volpath import build_beam_tau, get_beam

BEAM_N = 256          # beam-tau table rows (volpath.build_beam_tau)

# params vector layout (float32), as in the JAX kernel
_P_CAMR = 0           # 0:9   camera rotation, row major
_P_CAMO = 9           # 9:12  camera origin
_P_TANX = 12
_P_TANY = 13
_P_BMIN = 14          # 14:17 box aabb min
_P_BMAX = 17          # 17:20 box aabb max
_P_BEAMO = 20         # beam origin
_P_BEAMD = 23         # beam direction
_P_BEAMP = 26         # beam power
_P_BS0 = 29
_P_BS1 = 30
_P_G = 31             # HG g (0 => isotropic)
_P_SSU = 32           # 32:35 sigma_s (unscaled)
_P_STCS = 35          # 35:38 sigma_t color * scale
_P_STMS = 38          # sigma_t mean * scale
_P_MAJ = 39           # majorant (world units)
_P_DMIN = 40          # 40:43 density aabb min
_P_INVH = 43          # 43:46 (res-1)/extent per axis
_P_WR = 46            # 46:49 w_real = sigma_s / sigma_t_mean
_P_EPS = 49
_P_NP = 50

_INV4PI = 0.07957747154594767


@dataclass(frozen=True)
class WalkShape:
    """Static sizes of one walk."""

    npix: int
    sppc: int
    max_depth: int
    rr_depth: int
    width: int
    height: int
    stride: int          # lane rotation over pixels per epoch
    res: tuple           # (nx, ny, nz) density grid
    nb: tuple            # (nbx, nby, nbz) bricks of the voxel table
    max_trips: int


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Host-side gate: one heterogeneous medium with an iso/HG phase, only
    null geometry, one collimated emitter, a perspective camera outside any
    medium, a box filter and a steady-state film."""
    if cfg.engine not in ("wavefront", "auto"):
        return False
    if cfg.integrator not in ("volpath", "volpath_simple"):
        return False
    if cfg.filter != "box" or cfg.n_frames != 1:
        return False
    if cfg.decomposition != "steadystate":
        return False
    if scene.emitters.kind.tolist() != [EM_COLLIMATED]:
        return False
    if int(scene.sensor.kind) != SENSOR_PERSPECTIVE:
        return False
    if scene.media.kind.tolist() != [MED_HETEROGENEOUS]:
        return False
    if int(scene.media.phase.kind[0]) not in (PH_HG, PH_ISOTROPIC):
        return False
    if bool((scene.shapes.bsdf >= 0).any()):
        return False
    if not megatrack.MegaTable.fits(scene.media):
        return False
    return int(scene.camera_medium) == -1


def _unif(bits):
    return (bits >> 8).to(torch.int32).to(torch.float32) \
        * 5.9604644775390625e-08


def _atan(x):
    """Minimax atan (max error ~1e-5 rad), the JAX kernel's formula."""
    ax = torch.abs(x)
    inv = ax > 1.0
    z = torch.where(inv, 1.0 / torch.clamp_min(ax, 1.0), ax)
    z2 = z * z
    at = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410
              + z2 * (-0.0851330 + z2 * 0.0208351))))
    at = torch.where(inv, 1.5707963267948966 - at, at)
    return torch.where(x < 0, -at, at)


def _sum3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def walk_plain(params, seed: int, table, beam_tab, s: WalkShape):
    """Plain PyTorch version of kernel B. params (50,) f32, table (512, R)
    bf16, beam_tab (8, 256) f32 -> (sppc*3 + 4, npix) f32: per-epoch
    radiance rows, then per-lane segments, taps, trips and last sample."""
    dev = params.device
    n, sppc = s.npix, s.sppc
    nx, ny, nz = s.res
    nbx, nby, _ = s.nb
    R = table.shape[1]
    tab = table.to(torch.float32).reshape(-1)
    f32 = dict(dtype=torch.float32, device=dev)
    P = [params[i] for i in range(_P_NP)]

    def P3(i):
        return P[i:i + 3]

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    camR = P[_P_CAMR:_P_CAMR + 9]
    g = P[_P_G]
    g_iso = torch.abs(g) < 1e-4
    g_safe = torch.where(g_iso, 1.0, g)
    stm_s = P[_P_STMS]
    maj = torch.clamp_min(P[_P_MAJ], 1e-12)
    stc_s, ssu, w_real = P3(_P_STCS), P3(_P_SSU), P3(_P_WR)
    eps = P[_P_EPS]
    bmin, bmax, dmin, invh = P3(_P_BMIN), P3(_P_BMAX), P3(_P_DMIN), P3(_P_INVH)
    beam_o, beam_d, beam_pw = P3(_P_BEAMO), P3(_P_BEAMD), P3(_P_BEAMP)
    bs0, bs1 = P[_P_BS0], P[_P_BS1]
    hi = (float(nx - 1), float(ny - 1), float(nz - 1))

    def where3(c, a, b):
        return [torch.where(c, x, y) for x, y in zip(a, b)]

    def hg_eval(cos_fwd):
        temp = torch.clamp_min(1.0 + g * g - 2.0 * g * cos_fwd, 1e-12)
        v = _INV4PI * (1.0 - g * g) / (temp * torch.sqrt(temp))
        return torch.where(g_iso, _INV4PI, v)

    def ray_aabb(o, d):
        t0 = t1 = None
        for k in range(3):
            tiny = torch.where(d[k] < 0, -1e-12, 1e-12)
            inv = 1.0 / torch.where(torch.abs(d[k]) < 1e-12, tiny, d[k])
            ta = (bmin[k] - o[k]) * inv
            tb = (bmax[k] - o[k]) * inv
            lo, up = torch.minimum(ta, tb), torch.maximum(ta, tb)
            t0 = lo if t0 is None else torch.maximum(t0, lo)
            t1 = up if t1 is None else torch.minimum(t1, up)
        return t0, t1

    def tap(pos, u3):
        inside = torch.ones((n,), dtype=torch.bool, device=dev)
        c = []
        for k in range(3):
            v = (pos[k] - dmin[k]) * invh[k]
            inside = inside & (v >= 0.0) & (v <= hi[k])
            v = torch.clamp(v, 0.0, hi[k])
            base = torch.floor(v)
            ck = base + (u3[k] < v - base).to(torch.float32)
            c.append(torch.clamp_max(ck, hi[k]).to(torch.int64))
        cx, cy, cz = c
        r_idx = ((cz >> 3) * nby + (cy >> 3)) * nbx + (cx >> 3)
        j_idx = (((cz & 7) * 8) + (cy & 7)) * 8 + (cx & 7)
        S = tab[j_idx * R + r_idx]
        return torch.where(inside, S, 0.0)

    zero = torch.zeros((n,), **f32)
    m = zero.clone()
    t, t_end, depth, sh_seg, sh_t, cont_ok = (zero.clone() for _ in range(6))
    segs, taps, ctrf, trips = (zero.clone() for _ in range(4))
    idx = torch.full((n,), -1.0, **f32)
    p = [zero] * 3
    d = [zero + 1.0] * 3
    tp, L, sh_o, sh_d, sh_tr, sh_val, cont_p, cont_d = \
        ([zero] * 3 for _ in range(8))
    pend = torch.zeros((sppc * 3, n), **f32)
    laneu = (lane ^ 0x9E3779B9) & M32

    for _ in range(s.max_trips):
        if not bool((m < 2.5).any()):
            break
        m0 = m
        trips = trips + torch.where(m0 < 2.5, 1.0, 0.0)
        ctr = ctrf.to(torch.int64) & M32
        b = (laneu + mul32(ctr, 0x85EBCA6B) + seed) & M32
        u = []
        for k in range(9):
            b = _hash_u32((b + ((0x68E31DA4 + 0x3504F333 * k) & M32)) & M32)
            u.append(_unif(b))
        ctrf = ctrf + torch.where(m < 2.5, 9.0, 0.0)

        # ---- mode 0: regenerate ----
        regen = m == 0.0
        has_more = idx + 1.0 < float(sppc)
        start = regen & has_more
        m = torch.where(regen & ~has_more, 3.0, m)
        idx = idx + torch.where(start, 1.0, 0.0)
        idxi = idx.to(torch.int64)
        pix = (lane + idxi * s.stride) % n
        fx = (pix % s.width).to(torch.float32) + u[0]
        fy = (pix // s.width).to(torch.float32) + u[1]
        # divide elementwise: torch on CUDA divides by a Python scalar as a
        # product with its rounded reciprocal (exact only for powers of 2),
        # on the CPU and in the kernel it divides
        ndc_x = 2.0 * fx / torch.full_like(fx, float(s.width)) - 1.0
        ndc_y = 2.0 * fy / torch.full_like(fy, float(s.height)) - 1.0
        dc_x = -ndc_x * P[_P_TANX]
        dc_y = -ndc_y * P[_P_TANY]
        dw = [camR[3 * k] * dc_x + camR[3 * k + 1] * dc_y + camR[3 * k + 2]
              for k in range(3)]
        nrm = torch.sqrt(_sum3(dw, dw))
        dw = [x / nrm for x in dw]
        ow = [P[_P_CAMO + k] * torch.ones_like(dc_x) for k in range(3)]
        t0c, t1c = ray_aabb(ow, dw)
        t0c = torch.clamp_min(t0c, 0.0)
        hitbox = (t1c > t0c + 2.0 * eps) & start
        p = where3(start, [ow[k] + (t0c + eps) * dw[k] for k in range(3)], p)
        d = where3(start, dw, d)
        t = torch.where(start, 0.0, t)
        t_end = torch.where(start, t1c - t0c - 2.0 * eps, t_end)
        tp = where3(start, [zero + 1.0] * 3, tp)
        depth = torch.where(start, 1.0, depth)
        L = where3(start, [zero] * 3, L)
        m = torch.where(hitbox, 1.0, m)
        segs = segs + torch.where(start, 1.0, 0.0) \
            + torch.where(hitbox, 1.0, 0.0)

        # ---- one density tap serves the extension or the shadow ray ----
        trk = m == 1.0
        shd = m0 == 2.0
        lg = torch.log(torch.clamp_min(1.0 - u[2], 1e-12))
        t_new = t - lg / maj
        sh_new = sh_t - lg / maj
        x_ext = [p[k] + t_new * d[k] for k in range(3)]
        x_sh = [sh_o[k] + sh_new * sh_d[k] for k in range(3)]
        S = tap(where3(shd, x_sh, x_ext), u[3:6])
        taps = taps + torch.where(trk | shd, 1.0, 0.0)

        # ---- mode 1: extension ----
        esc = t_new >= t_end
        p_real = S * stm_s / maj
        real = trk & (u[6] < p_real) & ~esc
        nullc = trk & ~esc & ~real
        factor = [torch.clamp_min(1.0 - S * stc_s[k] / maj, 0.0)
                  for k in range(3)]
        pnull = torch.clamp_min(1.0 - p_real, 1e-12)
        tp = where3(nullc, [tp[k] * (factor[k] / pnull) for k in range(3)], tp)
        t = torch.where(trk, torch.minimum(t_new, t_end), t)
        fin_esc = trk & esc
        segs = segs + torch.where(fin_esc, 1.0, 0.0)

        x = [p[k] + t * d[k] for k in range(3)]
        tp = where3(real, [tp[k] * w_real[k] for k in range(3)], tp)
        depth_ok = depth < float(s.max_depth)
        die_depth = real & ~depth_ok

        # ---- beam NEE (equiangular) ----
        delta = _sum3([x[k] - beam_o[k] for k in range(3)], beam_d)
        closest = [beam_o[k] + delta * beam_d[k] for k in range(3)]
        dc = [x[k] - closest[k] for k in range(3)]
        hdist = torch.sqrt(torch.clamp_min(_sum3(dc, dc), 1e-12))
        th_a = _atan((bs0 - delta) / hdist)
        th_b = _atan((bs1 - delta) / hdist)
        th = th_a + u[7] * (th_b - th_a)
        cth_b = torch.cos(th)
        s_rel = hdist * torch.sin(th) / torch.clamp_min(torch.abs(cth_b), 1e-9) \
            * torch.where(cth_b < 0, -1.0, 1.0)
        s_b = delta + s_rel
        pdf_sb = hdist / torch.clamp_min(
            (th_b - th_a) * (hdist * hdist + s_rel * s_rel), 1e-12)
        y = [beam_o[k] + s_b * beam_d[k] for k in range(3)]
        to_x = [x[k] - y[k] for k in range(3)]
        dist_b = torch.sqrt(torch.clamp_min(_sum3(to_x, to_x), 1e-12))
        d_yp = [v / dist_b for v in to_x]
        fb = (s_b - bs0) / torch.clamp_min(bs1 - bs0, 1e-9) * float(BEAM_N) \
            - 0.5
        fb = torch.clamp(fb, 0.0, float(BEAM_N - 1))
        ib = torch.floor(fb)
        frb = fb - ib
        brow = beam_tab[:, ib.to(torch.int64)]
        before = s_b < bs0
        tr_beam = [torch.exp(-torch.where(before, 0.0,
                                          brow[k] + brow[3 + k] * frb))
                   for k in range(3)]
        rho_y = hg_eval(_sum3(beam_d, d_yp))
        denom = torch.clamp_min(pdf_sb * dist_b * dist_b, 1e-12)
        f_x = hg_eval(_sum3(d, [-v for v in d_yp]))
        val = [tp[k] * f_x * (beam_pw[k] * tr_beam[k] * (ssu[k] * brow[6])
                              * rho_y / denom) for k in range(3)]
        vmax = torch.maximum(torch.maximum(val[0], val[1]), val[2])
        nee_ok = real & depth_ok & (vmax > 0.0)

        # ---- HG / isotropic continuation direction ----
        sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[0])
        cth = torch.where(g_iso, 1.0 - 2.0 * u[0],
                          (1.0 + g * g - sqr * sqr) / (2.0 * g_safe))
        sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, 0.0))
        phi = 6.283185307179586 * u[1]
        lx = sth * torch.cos(phi)
        ly = sth * torch.sin(phi)
        sgn = torch.where(d[2] >= 0.0, 1.0, -1.0)
        a_f = -1.0 / (sgn + d[2])
        b_f = d[0] * d[1] * a_f
        new_d = [
            lx * (1.0 + sgn * d[0] * d[0] * a_f) + ly * b_f + cth * d[0],
            lx * (sgn * b_f) + ly * (sgn + d[1] * d[1] * a_f) + cth * d[1],
            lx * (-sgn * d[0]) + ly * (-d[1]) + cth * d[2],
        ]

        # ---- Russian roulette ----
        q = torch.clamp_max(torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]),
                            0.95)
        do_rr = depth >= float(s.rr_depth)
        survive = ~do_rr | (u[8] < q)
        qd = torch.clamp_min(q, 1e-6)
        tp = where3(real & do_rr, [v / qd for v in tp], tp)
        cont_after = real & depth_ok & survive
        depth = torch.where(real & depth_ok, depth + 1.0, depth)

        cont_p = where3(real, x, cont_p)
        cont_d = where3(real, new_d, cont_d)
        cont_ok = torch.where(real, torch.where(cont_after, 1.0, 0.0), cont_ok)
        go = nee_ok
        m = torch.where(go, 2.0, m)
        sh_o = where3(go, [y[k] + d_yp[k] * eps for k in range(3)], sh_o)
        sh_d = where3(go, d_yp, sh_d)
        sh_seg = torch.where(go, dist_b - 2.0 * eps, sh_seg)
        sh_t = torch.where(go, 0.0, sh_t)
        sh_tr = where3(go, [zero + 1.0] * 3, sh_tr)
        sh_val = where3(go, val, sh_val)
        segs = segs + torch.where(go, 1.0, 0.0)
        resume_now = real & ~nee_ok & cont_after
        die_now = (real & ~nee_ok & ~cont_after) | die_depth

        # ---- mode 2: shadow (lanes that started the trip in it) ----
        sh_esc = sh_new >= sh_seg
        upd = shd & ~sh_esc
        sh_tr = where3(upd, [sh_tr[k] * factor[k] for k in range(3)], sh_tr)
        sh_t = torch.where(shd, torch.minimum(sh_new, sh_seg), sh_t)
        tr_dead = torch.maximum(torch.maximum(sh_tr[0], sh_tr[1]),
                                sh_tr[2]) <= 0.0
        sh_done = shd & (sh_esc | tr_dead)
        add = sh_done & ~tr_dead
        L = [L[k] + torch.where(add, sh_val[k] * sh_tr[k], 0.0)
             for k in range(3)]
        res_sh = sh_done & (cont_ok > 0.5)
        die_sh = sh_done & ~(cont_ok > 0.5)

        # ---- resume the stashed continuation ----
        res_any = resume_now | res_sh
        p = where3(res_any, [cont_p[k] + cont_d[k] * eps for k in range(3)], p)
        d = where3(res_any, cont_d, d)
        _, t1r = ray_aabb(p, d)
        t = torch.where(res_any, 0.0, t)
        t_end = torch.where(res_any, torch.clamp_min(t1r - eps, 0.0), t_end)
        m = torch.where(res_any, 1.0, m)
        segs = segs + torch.where(res_any, 1.0, 0.0)

        # ---- flush finished samples into their epoch's rows ----
        fin = fin_esc | die_now | die_sh
        rows = (idxi * 3).clamp_min(0)
        for k in range(3):
            pend.index_put_((rows + k, lane), torch.where(fin, L[k], 0.0),
                            accumulate=True)
        m = torch.where(fin, 0.0, m)
        L = where3(fin, [zero] * 3, L)

    return torch.cat([pend, segs[None], taps[None], trips[None], idx[None]])


def check_shape(s: WalkShape) -> None:
    """Raise unless the walk's sizes are ones both versions can index: a
    film of npix = width * height >= 1 pixels, a lane rotation stride in
    [0, npix), sppc >= 1 samples with sppc * npix and every output offset
    inside int32, and max_trips >= 0."""
    if (s.npix < 1 or s.width * s.height != s.npix or s.sppc < 1
            or not 0 <= s.stride < s.npix or s.max_trips < 0
            or (s.sppc * 3 + 4) * s.npix >= 1 << 31):
        raise ValueError(f"boxwalk.walk: unsupported walk shape {s}")


def walk(params, seed: int, table, beam_tab, s: WalkShape):
    """Kernel B (csrc/boxwalk.cu) on CUDA tensors, walk_plain on CPU ones."""
    check_shape(s)
    if params.device.type == "cpu":
        return walk_plain(params, seed, table, beam_tab, s)
    if params.device.type != "cuda":
        raise ValueError(f"boxwalk.walk: unsupported device {params.device}")
    params, table, beam_tab = (t.contiguous()
                               for t in (params, table, beam_tab))
    kernels.require_cuda("boxwalk.walk", params, table, beam_tab)
    if (params.dtype != torch.float32 or params.shape != (_P_NP,)
            or table.dtype != torch.bfloat16
            or table.shape[0] != megatrack.W
            or beam_tab.dtype != torch.float32
            or beam_tab.shape != (8, BEAM_N)):
        raise ValueError("boxwalk.walk: expected params (50,) f32, table "
                         "(512, R) bf16 and beam_tab (8, 256) f32")
    out = torch.empty((s.sppc * 3 + 4, s.npix), dtype=torch.float32,
                      device=params.device)
    # the kernel's next-lane counter (zeroed on the stream by mk_boxwalk)
    next_lane = torch.empty((1,), dtype=torch.int32, device=params.device)
    with kernels.on_device(params):
        rc = kernels.library().mk_boxwalk(
            params.data_ptr(), seed & M32, table.data_ptr(),
            beam_tab.data_ptr(), out.data_ptr(), s.npix, s.sppc, s.max_depth,
            s.rr_depth, s.width, s.height, s.stride, *s.res, *s.nb,
            s.max_trips, next_lane.data_ptr(), kernels.stream(params))
    kernels.check(rc, "boxwalk.walk")
    walk.launches += 1
    return out


walk.launches = 0


def blocks_per_sm() -> int:
    """Resident blocks of kernel B a multiprocessor on the current CUDA
    device: the persistent grid is this many blocks times the
    multiprocessors."""
    blocks = ctypes.c_int(0)
    kernels.check(kernels.library().mk_boxwalk_blocks_per_sm(
        ctypes.addressof(blocks)), "boxwalk.blocks_per_sm")
    return blocks.value


def pass_seed(seed: int, pass_idx: int) -> int:
    """The per-pass seed mix of the JAX render_boxwalk."""
    return (seed ^ ((pass_idx * 0x9E3779B9 + 0x7F4A7C15) & M32)) & M32


def walk_inputs(scene: Scene, cfg: RenderConfig, sppc: int):
    """(params, table, beam_tab, WalkShape) of one pass."""
    H, W_img = cfg.height, cfg.width
    npix = H * W_img
    mega = megatrack.MegaTable(scene.media)
    bricks = medium_m.DensityGrid(scene.media, dtype=torch.bfloat16)
    beam = get_beam(scene)
    beam_tab = build_beam_tau(scene, beam, bricks, n=BEAM_N).t().contiguous()
    zero = torch.zeros((1,), dtype=torch.int64, device=beam.o.device)
    _, sa, ss, scale = medium_m.params(scene.media, zero)
    sa, ss, scale = sa[0], ss[0], scale[0]
    stc_u = sa + ss
    stm_u = torch.mean(stc_u)
    majorant = torch.clamp_min(scene.media.majorant * torch.amax(stc_u), 1e-6)
    w_real = ss / torch.clamp_min(stm_u, 1e-12)
    eps = common.scene_epsilon(scene)
    ph = scene.media.phase
    g = ph.g[0] * (ph.kind[0] == PH_HG).to(torch.float32)
    to_world = scene.sensor.to_world
    params = torch.cat([
        to_world[:3, :3].reshape(-1), to_world[:3, 3],
        scene.sensor.tan_x.reshape(1), scene.sensor.tan_y.reshape(1),
        scene.aabb_min, scene.aabb_max,
        beam.o, beam.d, beam.power, beam.s0.reshape(1), beam.s1.reshape(1),
        g.reshape(1), ss, stc_u * scale, (stm_u * scale).reshape(1),
        majorant.reshape(1), scene.media.density.aabb_min, mega.inv_h,
        w_real, eps.reshape(1),
    ]).to(torch.float32)
    shape = WalkShape(npix=npix, sppc=sppc, max_depth=cfg.max_depth,
                      rr_depth=cfg.rr_depth, width=W_img, height=H,
                      stride=104729 % npix, res=mega.res, nb=mega.nb,
                      max_trips=sppc * (8 * cfg.max_depth + 48) + 256)
    return params, mega.table, beam_tab, shape


def fold(out, s: WalkShape):
    """Film and stats of a walk's output: the epoch rows rolled back to
    their pixels, and (segments, taps, iters, unfinished)."""
    sppc, npix = s.sppc, s.npix
    pend = out[:sppc * 3].reshape(sppc, 3, npix)
    film = torch.zeros((npix, 3), dtype=torch.float32, device=out.device)
    for j in range(sppc):
        film = film + torch.roll(pend[j].t(), j * s.stride, dims=0)
    stats = torch.stack([
        out[sppc * 3].to(torch.float64).sum(),
        out[sppc * 3 + 1].to(torch.float64).sum(),
        out[sppc * 3 + 2].to(torch.float64).amax(),
        (out[sppc * 3 + 3] < sppc - 1).to(torch.float64).sum(),
    ]).to(torch.int64)
    return film, stats


def render_boxwalk(scene: Scene, cfg: RenderConfig, sppc: int, seed: int,
                   pass_idx: int):
    """One sppc-sample pass; returns ((npix, 3) radiance sum, stats) with
    stats = int64 tensor [segments, taps, iters, unfinished]. `iters` is the
    largest per-lane trip count."""
    params, table, beam_tab, shape = walk_inputs(scene, cfg, sppc)
    out = walk(params, pass_seed(seed, pass_idx), table, beam_tab, shape)
    return fold(out, shape)
