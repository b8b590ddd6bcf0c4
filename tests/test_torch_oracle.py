"""The port's float64 eikonal core against the standalone C++ oracle
(tests/oracle/er_oracle.cpp: the reference renderer's er_step, trace,
er_derivativestep and boundaryVelocity re-implemented in IEEE double), on
the cases of tests/test_reference_oracle.py and at its tolerances.

The oracle is compiled with g++ into this test's own temporary directory
(tests/test_reference_oracle.py rebuilds tests/oracle/er_oracle.bin, which
another worker may be writing). The port runs in this process in
torch.float64, with the oracle's double parameters as an attached (8,)
float64 parameter tensor (the RIF is then computed in the JAX package's
order, as tests/oracle/jax_side.py feeds JAX float64 parameters); nothing
global is switched. The cases are a copy of that file's, kept here.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mitsubaer_tpu_torch.models import eikonal as tek

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "oracle", "er_oracle.cpp")

LINEAR = [1, 1.2, 0.3, 0.1, -0.05]
RADIAL = [2, 1.3, 0.25, 0.7, 0.1, -0.05, 0.2]
START = [0.1, -0.2, 0.05, 0.6, 0.5, 0.5]

CASES = {}
for _name, _rif in (("linear", LINEAR), ("radial", RADIAL)):
    for _n in (1, 37, 400):
        CASES[f"step-{_name}-{_n}"] = ["step"] + _rif + START + [0.01, _n]
    CASES[f"trace-{_name}"] = ["trace"] + _rif + START + [0.01, 0] \
        + [0, 0, 0, 4.0, 0.7371]
    for _n in (1, 60):
        CASES[f"deriv-{_name}-{_n}"] = ["deriv"] + _rif + START + [0.01, _n]
CASES["trace-exit"] = ["trace"] + LINEAR + START + [0.01, 0] \
    + [0, 0, 0, 1.0, 5.0]
for _i, _c in enumerate([
    [0.2, 0.3, 1.2, 0, 0, 1, 1.3, 1.0],      # exit into vacuum
    [0.1, -0.2, -1.1, 0, 0, -1, 1.0, 1.45],  # entry into glass-ish
    [0.05, 0.02, 0.4, 0, 0, 1, 1.5, 1.0],    # shallow: near-TIR refraction
]):
    CASES[f"refract-{_i}"] = ["refract"] + _c
CASES["refract-tir"] = ["refract", 1.0, 0.0, 0.05, 0, 0, 1, 1.5, 1.0]


def _f64(x):
    return torch.tensor(x, dtype=torch.float64).reshape(1, -1)


def port_case(argv):
    """The port's float64 answer to one oracle case, laid out as the
    oracle prints it."""
    mode = argv[0]
    if mode == "refract":
        v, N = _f64(argv[1:4]), _f64(argv[4:7])
        ni, ne = torch.tensor([argv[7]], dtype=torch.float64), \
            torch.tensor([argv[8]], dtype=torch.float64)
        v2, tir = tek.boundary_velocity(v, N, ni, ne)
        return np.concatenate([[float(tir[0])], v2[0].numpy()])
    kind = int(argv[1])
    nprm = 4 if kind == 1 else 6
    prm = list(argv[2:2 + nprm]) + [0.0] * (8 - nprm)
    a = 2 + nprm
    rif = tek.RifField(kind, tuple(prm),
                       torch.tensor(prm, dtype=torch.float64))
    p, d = _f64(argv[a:a + 3]), _f64(argv[a + 3:a + 6])
    h, nsteps = float(argv[a + 6]), int(argv[a + 7])
    v = d / d.norm(dim=-1, keepdim=True) * tek.rif_value(rif, p)[:, None]
    hs = torch.full((1,), h, dtype=torch.float64)
    if mode == "step":
        opt = torch.zeros(1, dtype=torch.float64)
        for _ in range(nsteps):
            p, v, dopt = tek.er_step(rif, p, v, hs)
            opt = opt + dopt
        return np.concatenate([p[0].numpy(), v[0].numpy(), opt.numpy()])
    if mode == "trace":
        sdf = tek.SdfField(tek.SDF_SPHERE, tuple(argv[a + 8:a + 12]))
        dist = torch.tensor([argv[a + 12]], dtype=torch.float64)
        pp, vv, opt, marched, exited, _ = tek.trace_curved(
            rif, sdf, p, v, dist, h, 200000, torch.ones(1, dtype=torch.bool))
        return np.concatenate([[float(~exited[0])], pp[0].numpy(),
                               vv[0].numpy(), marched.numpy(), opt.numpy()])
    dp = torch.zeros((1, 3, 3), dtype=torch.float64)
    dv = torch.eye(3, dtype=torch.float64)[None]
    for _ in range(nsteps):
        p, v, dp, dv = tek.er_derivative_step(rif, p, v, dp, dv, hs)
    return np.concatenate([p[0].numpy(), v[0].numpy(), dp[0].numpy().ravel(),
                           dv[0].numpy().ravel()])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the oracle")
    binary = str(tmp_path_factory.mktemp("oracle") / "er_oracle.bin")
    subprocess.run(["g++", "-O2", "-o", binary, SRC], check=True)
    cpp, port = {}, {}
    for k, argv in CASES.items():
        out = subprocess.run([binary] + [str(a) for a in argv],
                             capture_output=True, text=True, check=True)
        cpp[k] = np.array([float(x) for x in out.stdout.split()])
        port[k] = port_case([argv[0]] + [float(a) for a in argv[1:]])
    return cpp, port


@pytest.mark.parametrize("key", [k for k in CASES if k.startswith("step-")])
def test_er_step_trajectory(results, key):
    """er_step (heterogeneousrefractive.cpp:653-661): p, v, optical len."""
    cpp, port = results
    np.testing.assert_allclose(port[key], cpp[key], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("key", ["trace-linear", "trace-radial"])
def test_trace_no_exit(results, key):
    """trace (:671-691) through trace_plain, inside case."""
    cpp, port = results
    assert cpp[key][0] == 1 and port[key][0] == 1
    np.testing.assert_allclose(port[key], cpp[key], rtol=1e-9, atol=1e-9)


def test_trace_boundary_exit(results):
    """Boundary exit: the reference steps back one leapfrog step (:684),
    the port keeps the last inside state, as the JAX package does: O(h^2)
    in the state, O(h) in marched."""
    cpp, port = results
    a, b = cpp["trace-exit"], port["trace-exit"]
    assert a[0] == 0 and b[0] == 0
    np.testing.assert_allclose(b[1:7], a[1:7], atol=5e-4)
    np.testing.assert_allclose(b[7], a[7], atol=0.011)
    np.testing.assert_allclose(b[8], a[8], atol=0.02)


@pytest.mark.parametrize("key", [k for k in CASES if k.startswith("deriv-")])
def test_derivative_step(results, key):
    """er_derivativestep (:798-814)."""
    cpp, port = results
    np.testing.assert_allclose(port[key], cpp[key], rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("key", ["refract-0", "refract-1", "refract-2"])
def test_boundary_velocity(results, key):
    """boundaryVelocity (:1036-1051), the refraction branch."""
    cpp, port = results
    assert cpp[key][0] == 0 and port[key][0] == 0
    np.testing.assert_allclose(port[key][1:], cpp[key][1:], rtol=1e-12,
                               atol=1e-12)


def test_boundary_velocity_tir_flag(results):
    cpp, port = results
    assert cpp["refract-tir"][0] == 1 and port["refract-tir"][0] == 1


def test_float64_stays_local():
    """The float64 core leaves torch's default dtype as it was."""
    assert torch.get_default_dtype() == torch.float32
