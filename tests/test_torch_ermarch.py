"""Kernel D's wrapper and design on the CPU: `ermarch.trace` dispatches to
`trace_plain`; the kernel's trip order (the field carried from the step's
end point, the next candidate formed before the SDF test, the sphere tested
against a threshold on r2 instead of its root) gives trace_plain's results
bit for bit; the threshold is exact; the wrapper checks its inputs.

This file imports neither jax nor the JAX package (the JAX comparison of
trace_plain is tests/test_torch_eikonal.py's).
"""
import numpy as np
import pytest
import torch

from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.models import ermarch as tem

torch.set_num_threads(1)

RIFS = {"linear": (tek.RIF_LINEAR, (1.3, 0.15, 0.05, -0.1)),
        "radial": (tek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0)),
        "const": (tek.RIF_CONST, (1.33,))}
SDFS = {"sphere": (tek.SDF_SPHERE, (0.05, -0.02, 0.0, 0.9)),
        "box": (tek.SDF_BOX, (0.0, 0.05, -0.05, 0.6, 0.7, 0.8)),
        "none": (tek.SDF_NONE, ())}
COMBOS = [(r, s) for r in RIFS for s in SDFS]


def _fields(rif, sdf):
    return tek.RifField(*RIFS[rif]), tek.SdfField(*SDFS[sdf])


def _inputs(rif, n, seed, lanes):
    """Lanes inside the media with directions scaled by n(p); a tenth march
    until they leave (arc length 1e6). With `lanes`, distance and h are
    (n,) tensors, else floats."""
    r = np.random.default_rng(seed)
    p = torch.from_numpy(r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    v = d / d.norm(dim=-1, keepdim=True) * tek.rif_value(rif, p)[:, None]
    act = torch.from_numpy(r.uniform(size=n) < 0.9)
    if not lanes:
        return p, v, 0.7, 0.02, act
    dist = np.where(r.uniform(size=n) < 0.1, 1e6, r.uniform(0.05, 2.0, n))
    h = r.uniform(0.01, 0.03, n)
    return (p, v, torch.from_numpy(dist.astype(np.float32)),
            torch.from_numpy(h.astype(np.float32)), act)


def _kernel_order(rif, sdf, p, v, distance, h, max_steps, active):
    """Kernel D's trip (csrc/ermarch.cu, trace_lane) in PyTorch, all lanes
    at once: the field at p carried from the end point where the previous
    step evaluated it, each trip's next candidate formed before the SDF test
    at its end point decides the step, the sphere tested as r2 < T. Returns
    trace_plain's outputs and the per-lane trip counts."""
    n = p.shape[0]
    dist, hb = tek._lanes(distance, n, p), tek._lanes(h, n, p)

    def outside(q):
        if sdf.kind != tek.SDF_SPHERE:
            return ~tek.inside_shape(sdf, q)
        d = [q[:, k] - sdf.params[k] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        return ~(r2 < tem.sphere_threshold(sdf.params[3]))

    def candidate(q, w, nq, g, step, hs):
        w1 = w + hs[:, None] * g
        return w1, q + step[:, None] * w1 / nq[:, None]

    opt = torch.zeros((n,), dtype=torch.float32)
    marched = torch.zeros_like(opt)
    exited = torch.zeros_like(active)
    trips = torch.zeros((n,), dtype=torch.int64)
    running = active & (max_steps > 0)
    nv, g = tek.rif_value_grad(rif, p)
    step = torch.minimum(hb, torch.clamp_min(dist - marched, 0.0))
    hs = 0.5 * step
    v1, p1 = candidate(p, v, nv, g, step, hs)
    while bool(running.any()):
        trips += running
        out = outside(p1)
        n1, g1 = tek.rif_value_grad(rif, p1)
        v2 = v1 + hs[:, None] * g1
        marched1 = marched + step
        step1 = torch.minimum(hb, torch.clamp_min(dist - marched1, 0.0))
        hs1 = 0.5 * step1
        v1n, p1n = candidate(p1, v2, n1, g1, step1, hs1)
        take = running & ~out
        exited = exited | (running & out)
        p = torch.where(take[:, None], p1, p)
        v = torch.where(take[:, None], v2, v)
        opt = torch.where(take, opt + step * nv, opt)
        marched = torch.where(take, marched1, marched)
        running = take & ~(marched >= dist - 1e-7) & (trips < max_steps)
        v1, p1, nv, step, hs = v1n, p1n, n1, step1, hs1
    return p, v, opt, marched, exited, trips


@pytest.mark.parametrize("lanes", [False, True], ids=["floats", "lanes"])
@pytest.mark.parametrize("rif_name,sdf_name", COMBOS)
def test_trace_on_cpu_equals_plain(rif_name, sdf_name, lanes):
    rif, sdf = _fields(rif_name, sdf_name)
    p, v, dist, h, act = _inputs(rif, 128, 3, lanes)
    before = tem.trace.launches
    got = tem.trace(rif, sdf, p, v, dist, h, 200, act)
    want = tem.trace_plain(rif, sdf, p, v, dist, h, 200, act)
    assert tem.trace.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_steps", [0, 30, 300], ids=lambda m: f"max{m}")
@pytest.mark.parametrize("rif_name,sdf_name", COMBOS)
def test_kernel_trip_order_equals_plain(rif_name, sdf_name, max_steps):
    """The kernel's reordered trip gives trace_plain's p, v, opt, marched
    and exited bit for bit, and its largest trip count is plain's step
    count (per-lane distance and h; a cut at 30 steps; no steps at all)."""
    rif, sdf = _fields(rif_name, sdf_name)
    p, v, dist, h, act = _inputs(rif, 256, 5, True)
    want = tem.trace_plain(rif, sdf, p, v, dist, h, max_steps, act)
    got = _kernel_order(rif, sdf, p, v, dist, h, max_steps, act)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    assert int(got[5].max()) == int(want[5])
    if max_steps == 300 and sdf_name != "none":
        # the cases reach both ends: lanes that leave and lanes that finish
        assert bool(want[4].any()) and bool((~want[4] & act).any())
        assert int(want[5]) > 30


@pytest.mark.parametrize("radius", [1.0, 0.9, 0.5, 0.37, 2.5, 1e-3, 1e4,
                                    3e-16, 0.0, -1.0, np.inf, np.nan])
def test_sphere_threshold_is_exact(radius):
    """r2 < sphere_threshold(R) exactly where sdf_value's sphere formula
    is negative: on every float within 4096 ulps of R^2 (of 1 where R^2 is
    not finite) and at random points around the sphere."""
    t = tem.sphere_threshold(radius)
    r = np.float32(radius)
    with np.errstate(over="ignore", invalid="ignore"):
        c = np.float32(r * r)
    if not np.isfinite(c):
        c = np.float32(1.0)
    bits = int(np.array(c, np.float32).view(np.int32))
    near = np.arange(max(bits - 4096, 0), bits + 4097).astype(np.uint32)
    r2 = torch.from_numpy(near.view(np.float32))
    want = torch.sqrt(torch.clamp_min(r2, 1e-30)) - float(r) < 0.0
    assert torch.equal(r2 < t, want)
    if 1e-14 < r < 1e30:          # both sides of the surface are there
        assert 0 < int(want.sum()) < near.size
    sdf = tek.SdfField(tek.SDF_SPHERE, (0.1, -0.2, 0.3, float(r)))
    g = np.random.default_rng(7)
    d = g.normal(size=(20_000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    scale = np.float32(r) if np.isfinite(r) and r > 0 else np.float32(1.0)
    rad = scale * (1 + g.normal(size=(20_000, 1)) * 1e-6)
    rad[:5000] = scale * g.uniform(0, 2, (5000, 1))
    p = torch.from_numpy((d * rad + [0.1, -0.2, 0.3]).astype(np.float32))
    q = [p[:, k] - sdf.params[k] for k in range(3)]
    r2p = q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
    assert torch.equal(r2p < t, tek.inside_shape(sdf, p))


def test_sphere_threshold_of_a_nan_radius_holds_nothing_inside():
    assert tem.sphere_threshold(float("nan")) == float("-inf")
    assert tem.sphere_threshold(0.0) == float("-inf")
    assert tem.sphere_threshold(float("inf")) == float("inf")


def _bad(case, p, v, dist, act):
    n = p.shape[0]
    return {"float64 p": (p.double(), v, dist, 0.01, act),
            "(n, 2) v": (p, v[:, :2], dist, 0.01, act),
            "int active": (p, v, dist, 0.01, act.int()),
            "short active": (p, v, dist, 0.01, act[1:]),
            "(n + 1,) distance": (p, v, torch.ones(n + 1), 0.01, act),
            "(n, 1) h": (p, v, dist, torch.ones(n, 1), act),
            "cpu tensors": (p, v, dist, 0.01, act)}[case]


@pytest.mark.parametrize("case,match", [
    ("float64 p", "float32"), ("(n, 2) v", "float32"),
    ("int active", "bool"), ("short active", "bool"),
    ("(n + 1,) distance", "tensor"), ("(n, 1) h", "tensor"),
    ("cpu tensors", "CUDA")])
def test_trace_io_rejects_bad_inputs(case, match):
    """Kernel D's wrapper checks types and shapes, then that every tensor
    is a CUDA one, before it allocates or launches anything."""
    rif, sdf = _fields("linear", "sphere")
    p, v, dist, _, act = _inputs(rif, 16, 0, True)
    args = _bad(case, p, v, dist, act)
    with pytest.raises(ValueError, match=match):
        tem.trace_io(sdf, *args)


def test_trace_rejects_other_devices():
    rif, sdf = _fields("linear", "sphere")
    p, v, dist, _, act = (t.to("meta") if isinstance(t, torch.Tensor) else t
                          for t in _inputs(rif, 8, 0, True))
    with pytest.raises(ValueError, match="unsupported device"):
        tem.trace(rif, sdf, p, v, dist, 0.01, 8, act)
