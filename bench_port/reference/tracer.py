"""The benchmark's plain reference: a volumetric path tracer in plain
PyTorch, written from the scene descriptions in bench_port/configs/ and
sharing no code, weights or tables with the program under test.

It estimates what a developed image of the program holds, pixel by pixel
in each colour channel, and how far one sample of each pixel strays. An
image of the program is

- the camera paths' radiance, filtered by the film's reconstruction filter
  (gaussian: exp(-2 x^2) - exp(-8) on |x| < 2 pixels, separable, each
  pixel divided by the weights of the samples that reach it; box: the
  pixel's own samples), and
- where the scene has a collimated beam, the light scattered once by the
  beam straight into the camera, added per pixel (light tracing).

The camera paths make every other contribution: on the bounded volume
they scatter in the medium and, at each scatter vertex, join a point of
the beam (the light that reached the vertex after one scatter on the
beam); in the Cornell box they hit diffuse walls or scatter in the fog
and join the area light by next-event estimation, weighted against
emitter hits by the power heuristic, as the program weighs them. The
definitions the estimates hold the program to:

- depth: every scatter vertex and every non-null surface hit counts one;
  next-event connections leave vertices 1 to max_depth - 1, and a path
  may hit an emitter at vertex max_depth at most; null boundaries count
  nothing;
- the diffuse reflectance of a surface evaluates rho / pi max(cos, 0)
  against the triangle's winding normal toward the light, and samples a
  cosine lobe on the side the ray came from with weight rho (so a face
  wound away from the room gets no next-event light; the Cornell box's
  two blocks are wound so);
- Henyey-Greenstein phase, the angle between the directions of travel;
- the fog of the Cornell box fills the space along every ray up to its
  surface, and up to the scene box's exit along a ray that hits nothing.

Every lane carries one colour channel: the estimates are monochromatic,
and three lanes make a pixel sample. Distances come from delta tracking
against the grid's maximum, transmittance along a connection from a
midpoint quadrature of 128 steps (of the beam, 8,192), so the reference
shares no random stream and no estimator with the program. The paths run
in float32, as the configurations state, and sum into float64; the
control runs and sums all of it in bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INV_4PI = 1.0 / (4.0 * math.pi)
QUAD_STEPS = 128               # midpoints along a connection
BEAM_STEPS = 8192              # midpoints of the beam's transmittance table
CHUNK = 1 << 21                # lanes traced together


class Rng:
    """Uniform numbers in [0, 1) from a seeded torch.Generator on the
    device, in the reference's dtype (clamped below 1 so that log(1 - u)
    stays finite in bfloat16)."""

    def __init__(self, seed: int, device, dtype):
        self.g = torch.Generator(device=device)
        self.g.manual_seed(int(seed) % (1 << 63))
        self.device, self.dtype = device, dtype
        self.top = 1.0 - float(torch.finfo(dtype).eps)

    def __call__(self, *shape):
        u = torch.rand(*shape, generator=self.g, device=self.device,
                       dtype=self.dtype)
        return torch.clamp(u, max=self.top)


def _norm(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _dot(a, b):
    return (a * b).sum(-1)


def _slab(o, d, lo, hi):
    """(t_near, t_far) of an axis-aligned box; empty where t_near > t_far."""
    inv = 1.0 / torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    return torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)


def hg(g: float, cos):
    """Henyey-Greenstein density for the cosine between the directions of
    travel before and after the scatter."""
    t = 1.0 + g * g - 2.0 * g * cos
    return INV_4PI * (1.0 - g * g) / (t * torch.sqrt(t))


def _frame(n):
    """Two unit vectors orthogonal to the unit vectors n (Duff et al.)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    s = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b,
                     -sign * n[:, 0]], -1)
    t = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return s, t


def _around(n, cos, phi):
    s, t = _frame(n)
    sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 0.0))
    return (s * (sin * torch.cos(phi))[:, None] + t * (sin * torch.sin(phi))[:, None]
            + n * cos[:, None])


def sample_hg(g: float, d, rng: Rng):
    u1, u2 = rng(d.shape[0]), rng(d.shape[0])
    if abs(g) < 1e-3:
        cos = 1.0 - 2.0 * u1
    else:
        sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
        cos = torch.clamp((1.0 + g * g - sq * sq) / (2.0 * g), -1.0, 1.0)
    return _norm(_around(d, cos, 2.0 * math.pi * u2))


class Camera:
    """A pinhole camera as the scene files give it: origin, target, up and
    the field of view across x. Film x runs to the camera's right, film y
    down; pixel coordinates are continuous, [0, W] x [0, H]."""

    def __init__(self, spec: dict, width: int, height: int, device, dtype):
        o = np.asarray(spec["origin"], np.float64)
        fwd = np.asarray(spec["target"], np.float64) - o
        fwd /= np.linalg.norm(fwd)
        up = np.asarray(spec["up"], np.float64)
        left = np.cross(up / np.linalg.norm(up), fwd)
        left /= np.linalg.norm(left)
        up = np.cross(fwd, left)
        tan_x = math.tan(math.radians(spec["fov_deg"]) / 2.0)
        self.tan_x, self.tan_y = tan_x, tan_x * height / width
        self.w, self.h = width, height
        self.near = float(spec.get("near", 1e-2))
        t = lambda v: torch.tensor(v, device=device, dtype=dtype)  # noqa: E731
        self.o, self.fwd, self.left, self.up = t(o), t(fwd), t(left), t(up)

    def rays(self, px, py):
        nx = 2.0 * px / self.w - 1.0
        ny = 2.0 * py / self.h - 1.0
        d = (self.left * (-nx * self.tan_x)[:, None]
             + self.up * (-ny * self.tan_y)[:, None] + self.fwd)
        return self.o.expand(px.shape[0], 3), _norm(d)

    def project(self, p):
        """Film coordinates of world points, whether they land on the
        film, and one over the solid angle of a pixel in their direction."""
        q = p - self.o
        z = _dot(q, self.fwd)
        valid = z > self.near
        zs = torch.where(valid, z, torch.ones_like(z))
        px = (-_dot(q, self.left) / (zs * self.tan_x) + 1.0) * 0.5 * self.w
        py = (-_dot(q, self.up) / (zs * self.tan_y) + 1.0) * 0.5 * self.h
        valid = valid & (px >= 0) & (px < self.w) & (py >= 0) & (py < self.h)
        cos = zs / torch.linalg.vector_norm(q, dim=-1)
        inv_omega = (self.w * self.h) / (4.0 * self.tan_x * self.tan_y
                                         * cos ** 3)
        return px, py, valid, inv_omega


class Grid:
    """Density on the nodes of an (n, n, n) lattice spanning [lo, hi]^3,
    trilinear between them and zero outside."""

    def __init__(self, values: np.ndarray, lo, hi, device, dtype):
        self.v = torch.tensor(values, device=device, dtype=dtype).reshape(-1)
        self.n = values.shape[0]
        self.lo = torch.tensor(lo, device=device, dtype=dtype)
        self.hi = torch.tensor(hi, device=device, dtype=dtype)
        self.max = float(values.max())

    def __call__(self, p):
        n = self.n
        f = (p - self.lo) / (self.hi - self.lo) * (n - 1)
        inside = ((f >= 0) & (f <= n - 1)).all(-1)
        # a NaN point (of a bfloat16 control) reads zero, as outside
        f = torch.nan_to_num(f, nan=0.0).clamp(0, n - 1)
        i = torch.clamp(f.floor(), max=n - 2)
        t = f - i
        i = i.long()
        base = (i[..., 2] * n + i[..., 1]) * n + i[..., 0]
        tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
        v = self.v

        def lx(off):
            return v[base + off] * (1 - tx) + v[base + off + 1] * tx

        yz0 = lx(0) * (1 - ty) + lx(n) * ty
        yz1 = lx(n * n) * (1 - ty) + lx(n * n + n) * ty
        return torch.where(inside, yz0 * (1 - tz) + yz1 * tz, 0.0)

    def integral(self, a, b):
        """The density integrated along the segments a -> b (midpoints)."""
        seg = b - a
        acc = torch.zeros(a.shape[0], device=a.device, dtype=a.dtype)
        step = 16
        for j0 in range(0, QUAD_STEPS, step):
            t = (torch.arange(j0, j0 + step, device=a.device, dtype=a.dtype)
                 + 0.5) / QUAD_STEPS
            pts = a[:, None, :] + t[None, :, None] * seg[:, None, :]
            acc = acc + self(pts).sum(-1)
        return acc * torch.linalg.vector_norm(seg, dim=-1) / QUAD_STEPS


# ---------------------------------------------------------------------------
# The bounded volume lit by a collimated beam
# ---------------------------------------------------------------------------
class Volume:
    def __init__(self, spec: dict, device, dtype):
        m = spec["medium"]
        self.lo = torch.tensor(m["box_min"], device=device, dtype=dtype)
        self.hi = torch.tensor(m["box_max"], device=device, dtype=dtype)
        dens = m["density"]
        n = int(dens["res"])
        zs = np.linspace(dens["lo"], dens["hi"], n)
        z, y, x = np.meshgrid(zs, zs, zs, indexing="ij")
        values = np.exp(-float(dens["falloff"]) * (x * x + y * y + z * z))
        self.grid = Grid(values.astype(np.float32), [dens["lo"]] * 3,
                         [dens["hi"]] * 3, device, dtype)
        ss = np.asarray(m["sigma_s"], np.float64)
        st = ss + np.asarray(m["sigma_a"], np.float64)
        self.sigma_s = torch.tensor(ss, device=device, dtype=dtype)
        self.sigma_t = torch.tensor(st, device=device, dtype=dtype)
        self.g = float(m["g"])
        b = spec["beam"]
        bo = np.asarray(b["origin"], np.float64)
        bd = np.asarray(b["target"], np.float64) - bo
        bd /= np.linalg.norm(bd)
        self.b_o = torch.tensor(bo, device=device, dtype=dtype)
        self.b_d = torch.tensor(bd, device=device, dtype=dtype)
        self.power = torch.tensor(b["power"], device=device, dtype=dtype)
        # where the beam crosses the medium's box, and the density
        # integrated from its entry, by a fine midpoint rule in float64
        lo64, hi64 = np.asarray(m["box_min"]), np.asarray(m["box_max"])
        with np.errstate(divide="ignore"):
            t0, t1 = (lo64 - bo) / bd, (hi64 - bo) / bd
        s0 = max(np.minimum(t0, t1).max(), 0.0)
        s1 = max(np.maximum(t0, t1).min(), s0)
        g64 = Grid(values, [dens["lo"]] * 3, [dens["hi"]] * 3, "cpu",
                   torch.float64)
        mid = s0 + (np.arange(BEAM_STEPS) + 0.5) / BEAM_STEPS * (s1 - s0)
        pts = torch.tensor(bo[None] + mid[:, None] * bd[None])
        dtau = g64(pts).numpy() * (s1 - s0) / BEAM_STEPS
        tau = np.concatenate([[0.0], np.cumsum(dtau)])
        self.s0, self.s1 = float(s0), float(s1)
        self.tau_tab = torch.tensor(tau, device=device, dtype=dtype)
        self.rr_depth = int(spec["rr_depth"])
        self.max_depth = int(spec["max_depth"])

    def beam_tau(self, s):
        """The density integrated along the beam from its entry to s."""
        f = torch.nan_to_num((s - self.s0) / (self.s1 - self.s0)
                             * BEAM_STEPS).clamp(0, BEAM_STEPS)
        i = f.floor().long().clamp(0, BEAM_STEPS - 1)
        w = f - i
        return self.tau_tab[i] * (1 - w) + self.tau_tab[i + 1] * w

    def _beam_point(self, x, u):
        """A point on the beam, equiangular as seen from x: (s, y, pdf)."""
        dl = _dot(x - self.b_o, self.b_d)
        h = torch.clamp_min(torch.linalg.vector_norm(
            x - (self.b_o + dl[:, None] * self.b_d), dim=-1), 1e-6)
        ta = torch.atan2(self.s0 - dl, h)
        tb = torch.atan2(self.s1 - dl, h)
        rel = h * torch.tan(ta + u * (tb - ta))
        pdf = h / ((tb - ta) * (h * h + rel * rel))
        s = dl + rel
        return s, self.b_o + s[:, None] * self.b_d, pdf

    def beam_light(self, x, d, c, rng: Rng):
        """One sample of the radiance in channel c that scatter vertices x
        send toward -d from light scattered once on the beam (the phase
        function at x included)."""
        s, y, pdf = self._beam_point(x, rng(x.shape[0]))
        v = x - y
        r = torch.linalg.vector_norm(v, dim=-1)
        w = v / r[:, None]
        st = self.sigma_t[c]
        tau = self.beam_tau(s) + self.grid.integral(y, x)
        return (self.power[c] * torch.exp(-st * tau) * self.sigma_s[c]
                * self.grid(y) * hg(self.g, _dot(self.b_d, w))
                * hg(self.g, -_dot(w, d)) / (pdf * r * r))

    def track(self, o, d, t_max, c, rng: Rng):
        """Delta tracking to the first real collision before t_max:
        (t, collided)."""
        mu = self.sigma_t[c] * self.grid.max
        t = torch.zeros_like(t_max)
        hit = torch.zeros_like(t_max, dtype=torch.bool)
        idx = torch.arange(t.shape[0], device=t.device)
        while idx.numel():
            ti = t[idx] - torch.log1p(-rng(idx.numel())) / mu[idx]
            out = ti >= t_max[idx]
            dens = self.grid(o[idx] + ti[:, None] * d[idx])
            real = ~out & (rng(idx.numel()) * self.grid.max < dens)
            t[idx] = ti
            hit[idx] = real
            idx = idx[~out & ~real]
        return t, hit

    def radiance(self, o, d, c, rng: Rng):
        """Radiance of the camera rays (o, d) in channels c from two or
        more scatters (the camera paths)."""
        L = torch.zeros(o.shape[0], device=o.device, dtype=o.dtype)
        tn, tf = _slab(o, d, self.lo, self.hi)
        idx = torch.nonzero(tf > torch.clamp_min(tn, 0)).squeeze(-1)
        o = o[idx] + torch.clamp_min(tn[idx], 0)[:, None] * d[idx]
        d, c = d[idx], c[idx]
        thr = torch.ones_like(L[idx])
        depth = 1
        while idx.numel():
            _, t_exit = _slab(o, d, self.lo, self.hi)
            t, hit = self.track(o, d, torch.clamp_min(t_exit, 0), c, rng)
            keep = hit if depth < self.max_depth else hit & False
            idx, o, d, c, t, thr = (a[keep] for a in (idx, o, d, c, t, thr))
            x = o + t[:, None] * d
            thr = thr * self.sigma_s[c] / self.sigma_t[c]
            L.index_add_(0, idx, thr * self.beam_light(x, d, c, rng))
            d = sample_hg(self.g, d, rng)
            if depth >= self.rr_depth:
                q = torch.clamp(thr, max=0.95)
                live = rng(q.shape[0]) < q
                thr = thr / q
                idx, x, d, c, thr = (a[live] for a in (idx, x, d, c, thr))
            o = x
            depth += 1
        return L

    def single_scatter(self, cam: Camera, n: int, rng: Rng):
        """n light-tracing samples of the beam's single scatter into the
        camera, all three channels: (pixel x, pixel y, on film, (n, 3)
        values); a pixel's radiance is the sum of its values over n."""
        s, y, pdf = self._beam_point(cam.o.expand(n, 3), rng(n))
        v = cam.o - y
        r = torch.linalg.vector_norm(v, dim=-1)
        w = v / r[:, None]
        _, t_exit = _slab(y, w, self.lo, self.hi)
        end = y + torch.clamp(t_exit, 0)[:, None].minimum(r[:, None]) * w
        tau = (self.beam_tau(s) + self.grid.integral(y, end))[:, None]
        px, py, on, inv_omega = cam.project(y)
        val = (self.power * torch.exp(-self.sigma_t * tau) * self.sigma_s
               * (self.grid(y) * hg(self.g, _dot(self.b_d, w))
                  / (pdf * r * r) * inv_omega)[:, None])
        return px, py, on, val


# ---------------------------------------------------------------------------
# The Cornell box in homogeneous fog
# ---------------------------------------------------------------------------
def _triangles(spec: dict):
    """(vertices (T, 3, 3), material of each, emitter flags) in float64
    from the quads and prisms of the scene file: a quad abcd is the
    triangles abc, acd; a prism is its top quad and the four sides down to
    y = 0 (top i, top j, bottom j and top i, bottom j, bottom i)."""
    tris, mats = [], []
    for q in spec["quads"]:
        p = np.asarray(q["points"], np.float64)
        tris += [p[[0, 1, 2]], p[[0, 2, 3]]]
        mats += [q["material"]] * 2
    for pr in spec["prisms"]:
        top = np.asarray(pr["top"], np.float64)
        bot = top.copy()
        bot[:, 1] = 0.0
        v = np.concatenate([top, bot])
        faces = [[0, 1, 2], [0, 2, 3]]
        for i in range(4):
            j = (i + 1) % 4
            faces += [[i, j, 4 + j], [i, 4 + j, 4 + i]]
        tris += [v[f] for f in faces]
        mats += [pr["material"]] * len(faces)
    return np.stack(tris), mats


class Box:
    def __init__(self, spec: dict, device, dtype):
        tris, mats = _triangles(spec)
        names = sorted(spec["materials"])
        refl = np.array([spec["materials"][k]["reflectance"] for k in names])
        emit = np.array([spec["materials"][k].get("radiance", [0, 0, 0])
                         for k in names], np.float64)
        mid = np.array([names.index(m) for m in mats])
        e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
        cr = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cr, axis=-1)
        t = lambda v: torch.tensor(v, device=device, dtype=dtype)  # noqa: E731
        self.v0, self.e1, self.e2 = t(tris[:, 0]), t(e1), t(e2)
        self.ng = t(cr / np.linalg.norm(cr, axis=-1, keepdims=True))
        self.refl = t(refl[mid])                       # (T, 3)
        self.emit = t(emit[mid])                       # (T, 3)
        lights = np.nonzero(emit[mid].max(-1) > 0)[0]
        self.light_tri = torch.tensor(lights, device=device)
        cdf = np.cumsum(area[lights]) / area[lights].sum()
        self.light_cdf = t(cdf)
        self.light_area = float(area[lights].sum())
        lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
        self.lo, self.hi = t(lo), t(hi)
        self.eps = 1e-4 * float(np.linalg.norm(hi - lo))
        m = spec["medium"]
        ss = float(np.mean(m["sigma_s"]))
        self.sigma_t = ss + float(np.mean(m["sigma_a"]))
        self.albedo = ss / self.sigma_t
        self.g = float(m["g"])
        self.rr_depth = int(spec["rr_depth"])
        self.max_depth = int(spec["max_depth"])

    def intersect(self, o, d, t_max):
        """Closest triangle hit beyond eps and before t_max: (t, triangle
        or -1)."""
        best_t = torch.full_like(t_max, float("inf"))
        best_i = torch.full(t_max.shape, -1, device=o.device)
        step = 1 << 18
        for a in range(0, o.shape[0], step):
            oo, dd = o[a:a + step, None, :], d[a:a + step, None, :]
            p = torch.linalg.cross(dd.expand(-1, self.e2.shape[0], -1),
                                   self.e2[None].expand(dd.shape[0], -1, -1))
            det = _dot(self.e1[None], p)
            inv = 1.0 / torch.where(det.abs() < 1e-12,
                                    torch.full_like(det, 1e-12), det)
            tv = oo - self.v0[None]
            u = _dot(tv, p) * inv
            q = torch.linalg.cross(tv, self.e1[None].expand_as(tv))
            v = _dot(dd, q) * inv
            t = _dot(self.e2[None], q) * inv
            ok = ((det.abs() >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
                  & (t > self.eps) & (t < t_max[a:a + step, None]))
            t = torch.where(ok, t, float("inf"))
            tb, ib = t.min(-1)
            best_t[a:a + step] = tb
            best_i[a:a + step] = torch.where(torch.isfinite(tb), ib, -1)
        return best_t, best_i

    def _light_pdf(self, dist, cos_l):
        return dist * dist / (torch.clamp_min(cos_l, 1e-12) * self.light_area)

    def radiance(self, o, d, c, rng: Rng):
        """Radiance of the camera rays (o, d) in channels c."""
        n = o.shape[0]
        L = torch.zeros(n, device=o.device, dtype=o.dtype)
        idx = torch.arange(n, device=o.device)
        thr = torch.ones_like(L)
        last_pdf = torch.zeros_like(L)
        first = True
        depth = 1
        while idx.numel():
            t_hit, tri = self.intersect(o, d, torch.full_like(thr, 3e38))
            hit = tri >= 0
            _, t_box = _slab(o, d, self.lo, self.hi)
            t_far = torch.where(hit, t_hit, torch.clamp_min(t_box, 0))
            t = -torch.log1p(-rng(idx.numel())) / self.sigma_t
            med = t < t_far
            srf = ~med & hit
            trs = torch.clamp_min(tri, 0)
            ng = self.ng[trs]
            x = torch.where(med[:, None], o + t[:, None] * d,
                            o + t_hit.clamp(max=3e38)[:, None] * d)
            # emitter hits, weighed against next-event estimation
            le = self.emit[trs, c] * (srf & (_dot(-d, ng) > 0))
            if first:
                w_hit = torch.ones_like(le)
            else:
                lp = self._light_pdf(t_hit, _dot(-d, ng))
                w_hit = last_pdf ** 2 / (last_pdf ** 2 + lp ** 2)
            L.index_add_(0, idx, thr * le * torch.where(le > 0, w_hit, 0.0))
            keep = (med | srf) if depth < self.max_depth else med & False
            idx, x, d, c, thr, ng, med, trs = (
                a[keep] for a in (idx, x, d, c, thr, ng, med, trs))
            thr = thr * torch.where(med, self.albedo, 1.0).to(thr.dtype)
            m = idx.numel()
            # next-event estimation toward the area light
            k = torch.searchsorted(self.light_cdf, rng(m).contiguous())
            lt = self.light_tri[torch.clamp(k, max=self.light_tri.numel() - 1)]
            u1, u2 = rng(m), rng(m)
            su = torch.sqrt(u1)
            b1, b2 = 1 - su, u2 * su
            y = self.v0[lt] + b1[:, None] * self.e1[lt] + b2[:, None] * self.e2[lt]
            to = y - x
            dist = torch.linalg.vector_norm(to, dim=-1)
            wl = to / dist[:, None]
            cos_l = -_dot(wl, self.ng[lt])
            cos_s = _dot(wl, ng)
            pv = torch.where(med, hg(self.g, _dot(d, wl)),
                             torch.clamp_min(cos_s, 0) / math.pi)
            f = torch.where(med, pv, self.refl[trs, c] * pv)
            pl = self._light_pdf(dist, cos_l)
            live = (cos_l > 1e-6) & (f > 0)
            tb, _ = self.intersect(x + wl * self.eps, wl,
                                   torch.where(live, dist - 2 * self.eps, 0.0))
            live = live & ~torch.isfinite(tb)
            nee = (self.emit[lt, c] * f * torch.exp(-self.sigma_t * dist)
                   * pl / (pl * pl + pv * pv))
            L.index_add_(0, idx, thr * torch.where(live, nee, 0.0))
            # the next direction: the phase function, or a cosine lobe on
            # the side of the surface the ray came from
            u1, u2 = rng(m), rng(m)
            side = torch.where(_dot(-d, ng) >= 0, 1.0, -1.0).to(d.dtype)
            cz = torch.sqrt(u1)
            wd = _norm(_around(ng * side[:, None], cz, 2 * math.pi * u2))
            wp = sample_hg(self.g, d, rng)
            new_d = torch.where(med[:, None], wp, wd)
            thr = thr * torch.where(med, 1.0, self.refl[trs, c])
            last_pdf = torch.where(med, hg(self.g, _dot(d, wp)), cz / math.pi)
            if depth >= self.rr_depth:
                q = torch.clamp(thr, max=0.95)
                live = (rng(m) < q) & (q > 0)
                thr = thr / torch.clamp_min(q, 1e-12)
                idx, x, new_d, c, thr, last_pdf = (
                    a[live] for a in (idx, x, new_d, c, thr, last_pdf))
            o, d = x + new_d * self.eps, new_d
            first = False
            depth += 1
        return L


# ---------------------------------------------------------------------------
# Block estimates
# ---------------------------------------------------------------------------
class Filter:
    """The film's reconstruction filter as a density of sample offsets
    from a pixel's centre: gaussian exp(-2 x^2) - exp(-8) on |x| < 2, or
    box, uniform on |x| < 1/2; sampled by its inverse CDF (a table of
    4,097 points)."""

    def __init__(self, name: str, device, dtype):
        self.name = name
        if name == "box":
            self.r = 0.5
            x = np.linspace(-0.5, 0.5, 4097)
            cdf = np.linspace(0.0, 1.0, 4097)
        elif name == "gaussian":
            self.r = 2.0
            x = np.linspace(-2.0, 2.0, 4097)
            f = np.clip(np.exp(-2 * x * x) - math.exp(-8.0), 0, None)
            cdf = np.concatenate([[0.0], np.cumsum(0.5 * (f[1:] + f[:-1]))])
            cdf /= cdf[-1]
        else:
            raise ValueError(f"no reference for the {name} filter")
        self.x64, self.cdf64 = x, cdf
        self.x = torch.tensor(x, device=device, dtype=dtype)
        self.cdf = torch.tensor(cdf, device=device, dtype=dtype)

    def sample(self, u):
        k = torch.clamp(torch.searchsorted(self.cdf, u.contiguous()), 1,
                        self.x.numel() - 1)
        c0, c1 = self.cdf[k - 1], self.cdf[k]
        w = (u - c0) / torch.clamp_min(c1 - c0, 1e-12)
        return self.x[k - 1] + w * (self.x[k] - self.x[k - 1])

    def inside(self, centre: np.ndarray, size: int) -> np.ndarray:
        """The filter's mass over [0, size] about pixel centres."""
        hi = np.interp(size - centre, self.x64, self.cdf64)
        lo = np.interp(-centre, self.x64, self.cdf64)
        return hi - lo


def build(config: dict, device, dtype):
    """The reference model of a configuration's scene: "volume" and "box"
    here, any other kind from reference/<kind>.py's build(scene, device,
    dtype)."""
    scene = config["scene"]
    if scene["kind"] == "volume":
        return Volume(scene, device, dtype)
    if scene["kind"] == "box":
        return Box(scene, device, dtype)
    import importlib

    mod = importlib.import_module(f"{__package__}.{scene['kind']}")
    return mod.build(scene, device, dtype)


def _acc(dtype):
    """The accumulators' dtype: float64 under float32 paths, the paths' own
    dtype under a lower one (the control computes all of it in bfloat16)."""
    return torch.float64 if dtype == torch.float32 else dtype


def camera_image(model, cam: Camera, filt: Filter, spp: int, rng: Rng):
    """One estimate of the camera paths' filtered image, (H, W, 3) float64,
    from spp samples a pixel in each channel, each offset from its pixel's
    centre by the filter; and the variance of one sample of each pixel and
    channel about that estimate."""
    w, h = cam.w, cam.h
    dev, dt = cam.o.device, cam.o.dtype
    npix = w * h
    inside = (filt.inside(np.arange(w) + 0.5, w)[None, :]
              * filt.inside(np.arange(h) + 0.5, h)[:, None]).reshape(-1)
    inside = torch.tensor(inside, device=dev, dtype=torch.float64)
    s1 = torch.zeros(npix * 3, device=dev, dtype=_acc(dt))
    s2 = torch.zeros_like(s1)
    total = npix * spp * 3
    for a in range(0, total, CHUNK):
        lane = torch.arange(a, min(a + CHUNK, total), device=dev)
        pix = lane % npix
        c = (lane // npix) % 3
        px = (pix % w).to(dt) + 0.5 + filt.sample(rng(lane.numel()))
        py = (pix // w).to(dt) + 0.5 + filt.sample(rng(lane.numel()))
        on = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        o, d = cam.rays(px, py)
        est = torch.where(on, model.radiance(o, d, c, rng), 0.0)
        est = torch.nan_to_num(est.to(s1.dtype) / inside[pix].to(s1.dtype),
                               nan=0.0, posinf=0.0)
        s1.index_add_(0, pix * 3 + c, est)
        s2.index_add_(0, pix * 3 + c, est * est)
    mean = s1 / spp
    var = (s2 - s1 * mean) / max(spp - 1, 1)
    return mean.double().reshape(h, w, 3), var.double().reshape(h, w, 3)


def splat_parts(model, cam: Camera, n: int, rng: Rng, parts: int = 8):
    """The beam's single-scatter image, (k, H, W, 3) float64: k >= parts
    estimates from n light-tracing samples in all, at most CHUNK a part."""
    dev = cam.o.device
    step = min(CHUNK, -(-n // parts))
    out = []
    for a in range(0, n, step):
        m = min(step, n - a)
        px, py, on, val = model.single_scatter(cam, m, rng)
        pix = (torch.clamp(torch.nan_to_num(py), 0, cam.h - 1).long() * cam.w
               + torch.clamp(torch.nan_to_num(px), 0, cam.w - 1).long())
        one = torch.zeros(cam.h * cam.w, 3, device=dev, dtype=_acc(val.dtype))
        val = torch.nan_to_num(torch.where(on[:, None], val, 0.0).to(
            one.dtype), nan=0.0, posinf=0.0)
        one.index_add_(0, pix, val / m)
        out.append(one.double().reshape(cam.h, cam.w, 3))
    return torch.stack(out)


def render_image(config: dict, workload: dict, spp: int, seed: int,
                 device, dtype, splat_samples: int | None = None):
    """An image as the reference makes one, (H, W, 3) float64: the camera
    paths at spp samples a pixel and channel plus, on a scene with a beam,
    its single scatter from splat_samples light-tracing samples (16 a
    pixel, as the program's splat, where None)."""
    rng = Rng(seed, device, dtype)
    res = int(workload["render"]["res"])
    model = build(config, device, dtype)
    cam = Camera(config["scene"]["camera"], res, res, device, dtype)
    filt = Filter(workload["render"]["filter"], device, dtype)
    out = camera_image(model, cam, filt, spp, rng)[0]
    if isinstance(model, Volume):
        out = out + splat_parts(model, cam, splat_samples or 16 * res * res,
                                rng).mean(0)
    return out
