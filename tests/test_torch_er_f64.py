"""The float64 eikonal core (cfg.er_f64; the reference runs its eikonal
math in double, FLOATDEBUG, fwd.h:174-184) in the port: the port's
versions of tests/test_eikonal.py::TestF64Core, the float64 marches and
BVP solves against the JAX package's under x64, and the eikonal road with
er_f64.

JAX's x64 switch is process-global, so its side runs in a subprocess with
JAX_ENABLE_X64=1 (as tests/test_reference_oracle.py runs it) and writes
its results to an .npz; this process and its worker stay float32. Its
acoustic Bessel functions are zeros there (as
tests/test_torch_er_grad.py::_acoustic_stub makes them): the acoustic
branch of JAX's RIF is selected away for the radial and spline kinds, and
with it each solve took ~60 s to compile. The
port needs no switch: a float64 march follows its inputs' dtype, with the
float32 parameters promoted as JAX promotes them.

Tolerances: the analytic (radial) RIF's marches within 1e-9 of their
largest magnitude and its solves within 1e-7, the spline RIF's marches
within 1e-7 and its solves within 1e-5 (the port and JAX contract the 4^3 coefficient neighbourhood
in different orders, ~1e-16 a lookup, and the sensitivity march's exited
lanes extrapolate to the target: measured 2.8e-8); float32 would be
~1e-4 off. The converged flags equal.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mitsubaer_tpu_torch.core import spline as tspline
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import eikonal as tek
from mitsubaer_tpu_torch.models import ermarch as term
from mitsubaer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIAL = (1.33, 0.2, 0.6, 0.05, -0.05, 0.0, 0.0, 0.0)


def _n_field(res, lo=-1.0, hi=1.0):
    zs = np.linspace(lo, hi, res)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    return (1.33 + 0.15 * np.exp(-2.0 * (X**2 + Y**2 + Z**2))).astype(
        np.float32)


def _spline_fields(res=48, radius=0.95):
    """tests/test_eikonal.py::TestF64Core::_spline_fields on the port."""
    coeff = torch.from_numpy(tspline.prefilter(_n_field(res)))
    grid = tspline.SplineGrid3D(coeff, torch.full((3,), -1.0),
                                torch.full((3,), 1.0))
    return (tek.RifField(tek.RIF_SPLINE, (0.0,), grid=grid),
            tek.SdfField(tek.SDF_SPHERE, (0.0, 0.0, 0.0, radius)))


# ---------------------------------------------------------------------------
# TestF64Core on the port
# ---------------------------------------------------------------------------
def test_f64_marching_convergence_and_f32_error():
    """Through a spline RIF at the reference step h = 1e-3 the float64
    march is step-converged (against h / 4), float32 drifts more, and
    float64 is at least as close to the fine march."""
    rif, sdf = _spline_fields()
    n = 8
    th = np.linspace(0, 1.5, n, dtype=np.float32)
    p0 = np.stack([-0.8 * np.ones(n), 0.2 * np.sin(th), 0.2 * np.cos(th)],
                  -1)
    v0 = np.tile(np.array([[1.0, 0.05, -0.02]], np.float32), (n, 1))
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
    act = torch.ones(n, dtype=torch.bool)

    def march(h, steps, dtype):
        p = torch.tensor(p0, dtype=dtype)
        v = torch.tensor(v0, dtype=dtype) * tek.rif_value(rif, p)[:, None]
        out = tek.trace_curved(rif, sdf, p, v,
                               torch.full((n,), 1.4, dtype=dtype), h, steps,
                               act)
        assert out[2].dtype == dtype
        return out[2].double().numpy()

    o64 = march(1e-3, 2000, torch.float64)
    o64_fine = march(2.5e-4, 8000, torch.float64)
    o32 = march(1e-3, 2000, torch.float32)
    assert np.max(np.abs(o64 - o64_fine) / np.abs(o64_fine)) < 2e-5
    assert np.max(np.abs(o32 - o64) / np.abs(o64)) < 5e-3
    assert np.max(np.abs(o64 - o64_fine)) <= np.max(
        np.abs(o32 - o64_fine)) + 1e-9


def test_f64_bvp_convergence_rate():
    """The float64 BVP reaches tol2 1e-6 through the spline RIF on > 90% of
    the connections, and float32 within 0.15 of that rate."""
    rif, sdf = _spline_fields()
    n = 24
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    p1 = np.stack([-0.6 * np.ones(n), 0.25 * np.sin(th),
                   0.25 * np.cos(th)], -1).astype(np.float32)
    p2 = np.stack([0.6 * np.ones(n), -0.15 * np.sin(th),
                   0.2 * np.cos(th)], -1).astype(np.float32)
    chord = p2 - p1
    chord /= np.linalg.norm(chord, axis=-1, keepdims=True)
    act = torch.ones(n, dtype=torch.bool)
    rates = {}
    for dtype in (torch.float64, torch.float32):
        r = tek.solve_bvp(rif, sdf, *(torch.tensor(a, dtype=dtype)
                                      for a in (p1, p2, chord)),
                          2e-3, 1500, act, tol2=1e-6)
        assert r.dir_to_target.dtype == r.weight.dtype == dtype
        rates[dtype] = r.converged.float().mean().item()
    assert rates[torch.float64] > 0.9, rates
    assert rates[torch.float32] >= rates[torch.float64] - 0.15, rates


# ---------------------------------------------------------------------------
# against the JAX package under x64
# ---------------------------------------------------------------------------
N_LANES = 32
SPLINE_RES = 16

_JAX_SIDE = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    from mitsubaer_tpu.models import eikonal as ek
    # the acoustic branch is selected away for these kinds; as zeros it
    # leaves every program here a fraction of its compile time
    ek.bessel_jm = lambda m, x: jnp.zeros_like(x)
    x = dict(np.load(sys.argv[2]))
    one = jnp.ones((1, 1, 1), jnp.float32)
    sdf = ek.SdfField(kind=jnp.int32(ek.SDF_SPHERE),
                      params=jnp.asarray(x["sdf"], jnp.float32), coeff=one,
                      aabb_min=jnp.zeros(3), aabb_max=jnp.ones(3))
    fields = {
        "radial": ek.RifField(kind=jnp.int32(ek.RIF_RADIAL),
                              params=jnp.asarray(x["radial"], jnp.float32),
                              coeff=one, aabb_min=jnp.zeros(3),
                              aabb_max=jnp.ones(3)),
        "spline": ek.RifField(kind=jnp.int32(ek.RIF_SPLINE),
                              params=jnp.zeros(8, jnp.float32),
                              coeff=jnp.asarray(x["coeff"], jnp.float32),
                              aabb_min=jnp.full(3, -1.0, jnp.float32),
                              aabb_max=jnp.full(3, 1.0, jnp.float32))}
    f64 = lambda k: jnp.asarray(x[k], jnp.float64)
    act = jnp.asarray(x["act"])
    out = {}
    for name, rif in fields.items():
        r = ek.trace_curved(rif, sdf, f64("p"), f64("v"), f64("dist"), 0.02,
                            128, act)
        for i, k in enumerate(("p", "v", "opt", "marched", "exited")):
            out[f"{name}/trace/{k}"] = np.asarray(r[i])
        r = ek.integrate_with_sensitivities(rif, sdf, f64("p"), f64("v0"),
                                            f64("p2"), 0.04, 64, act)
        for i, k in enumerate(("err", "J", "exited", "opt", "geo_inside",
                               "geo_total", "v_end")):
            out[f"{name}/sens/{k}"] = np.asarray(r[i])
        for restarts in (0, 2) if name == "radial" else (0,):
            r = ek.solve_bvp(rif, sdf, f64("p"), f64("p2"), f64("chord"),
                             0.04, 64, act, tol2=1e-6, rr_weight=0.5,
                             seed_bits=jnp.asarray(x["seed_bits"]),
                             max_restarts=restarts)
            for k, a in r._asdict().items():
                out[f"{name}/bvp{restarts}/{k}"] = np.asarray(a)
    np.savez(sys.argv[3], **out)
""")


def _inputs():
    r = np.random.default_rng(5)
    n = N_LANES
    p = r.uniform(-0.5, 0.5, (n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p2 = r.uniform(-0.7, 0.7, (n, 3))
    p2[: n // 2] = (2.0, 2.0, -2.0)
    chord = p2 - p
    chord /= np.linalg.norm(chord, axis=-1, keepdims=True)
    return dict(p=p, v=d * 1.35, v0=p2 - p, p2=p2, chord=chord,
                dist=r.uniform(0.2, 2.5, n), act=r.uniform(size=n) < 0.9,
                seed_bits=r.integers(0, 2**32, n, dtype=np.uint32),
                sdf=np.array([0, 0, 0, 1.0, 0, 0, 0, 0], np.float32),
                radial=np.array(RADIAL, np.float32),
                coeff=tspline.prefilter(_n_field(SPLINE_RES, -1.0, 1.0)))


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """The JAX package's float64 marches and solves (one subprocess)."""
    d = tmp_path_factory.mktemp("x64")
    x = _inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, ROOT,
                           str(d / "in.npz"), str(d / "out.npz")],
                          capture_output=True, text=True, env=env,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


def _port_fields(x):
    sdf = tek.SdfField(tek.SDF_SPHERE, tuple(x["sdf"].tolist()))
    grid = tspline.SplineGrid3D(torch.from_numpy(x["coeff"]),
                                torch.full((3,), -1.0), torch.full((3,), 1.0))
    return sdf, {"radial": tek.RifField(tek.RIF_RADIAL, RADIAL),
                 "spline": tek.RifField(tek.RIF_SPLINE, (0.0,), grid=grid)}


TOL = {"radial": 1e-9, "spline": 1e-7}


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == np.float64, (what, got.dtype)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("name", ["radial", "spline"])
def test_f64_trace_matches_jax_x64(jax_x64, name):
    x, want = jax_x64
    sdf, rifs = _port_fields(x)
    t = {k: torch.from_numpy(np.asarray(x[k])) for k in x}
    got = tek.trace_curved(rifs[name], sdf, t["p"], t["v"], t["dist"], 0.02,
                           128, t["act"])
    for i, k in enumerate(("p", "v", "opt", "marched", "exited")):
        _close(got[i], want[f"{name}/trace/{k}"], TOL[name], f"trace {k}")
    assert got[4].any() and not got[4].all()


@pytest.mark.parametrize("name", ["radial", "spline"])
def test_f64_sensitivity_march_matches_jax_x64(jax_x64, name):
    x, want = jax_x64
    sdf, rifs = _port_fields(x)
    t = {k: torch.from_numpy(np.asarray(x[k])) for k in x}
    got = tek.integrate_with_sensitivities(rifs[name], sdf, t["p"], t["v0"],
                                           t["p2"], 0.04, 64, t["act"])
    for i, k in enumerate(("err", "J", "exited", "opt", "geo_inside",
                           "geo_total", "v_end")):
        _close(got[i], want[f"{name}/sens/{k}"], TOL[name], f"sens {k}")


@pytest.mark.parametrize("name,restarts", [("radial", 0), ("radial", 2),
                                          ("spline", 0)])
def test_f64_bvp_matches_jax_x64(jax_x64, name, restarts):
    """solve_bvp in float64, single solve and (radial) two restart rounds:
    the converged flags equal, the directions, weights and lengths
    close."""
    x, want = jax_x64
    sdf, rifs = _port_fields(x)
    t = {k: torch.from_numpy(np.asarray(x[k])) for k in x}
    got = tek.solve_bvp(rifs[name], sdf, t["p"], t["p2"], t["chord"], 0.04,
                        64, t["act"], tol2=1e-6, rr_weight=0.5,
                        seed_bits=t["seed_bits"].to(torch.int64),
                        max_restarts=restarts)
    conv = got.converged.numpy()
    np.testing.assert_array_equal(conv, want[f"{name}/bvp{restarts}/"
                                             f"converged"])
    assert conv.sum() >= N_LANES // 4
    for f in dataclasses.fields(got):
        if f.name == "converged":
            continue
        _close(getattr(got, f.name), want[f"{name}/bvp{restarts}/{f.name}"],
               TOL[name] * 100, f"bvp {f.name}")


# ---------------------------------------------------------------------------
# the eikonal road with er_f64
# ---------------------------------------------------------------------------
def test_er_f64_render_takes_the_plain_loops(monkeypatch):
    """render() with er_f64 marches in float64 through the plain loops
    (never the float32 kernels' wrappers), hands float32 back to the path
    state, and lands within the float32 render's ulps-driven spread."""
    kw = dict(res=8, spp=2, max_depth=3, rif_kind=1,
              rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=1e-2,
              filter="box")
    scene, cfg = tpresets.refractive_sphere(**kw)
    cfg = dataclasses.replace(cfg, er_maxsteps=64, er_bvp_hscale=4.0)
    img32 = trender.render(scene, cfg, seed=0, device="cpu")
    seen = []
    for name in ("trace_plain", "sens_march_plain"):
        fn = getattr(term, name)

        def spy(rif, sdf, p, *a, _fn=fn):
            seen.append(p.dtype)
            return _fn(rif, sdf, p, *a)
        monkeypatch.setattr(term, name, spy)
    for name in ("trace", "sens_march"):
        monkeypatch.setattr(term, name, lambda *a: pytest.fail(
            "a float64 march reached a kernel's wrapper"))
    img64 = trender.render(scene, dataclasses.replace(cfg, er_f64=True),
                           seed=0, device="cpu")
    assert seen and set(seen) == {torch.float64}
    assert img64.dtype == torch.float32 and torch.isfinite(img64).all()
    assert not torch.equal(img32, img64)
    lit = img32.mean(-1) > 0
    close = torch.isclose(img64, img32, rtol=1e-3, atol=0).all(-1)
    assert close[lit].float().mean() >= 0.95
    assert torch.get_default_dtype() == torch.float32
