"""The finite-difference check of the spline RIF's voxel gradient,
tests/test_inverse.py::TestRifGradients::test_rif_gradient_finite_difference
(12^3 grid, 8^2, sppc 4, seed 3, a smooth bump, eps 0.01, the BVP
connections solved anew at each point), in either package.

    python3 scripts/er_fd_check.py --package jax
    python3 scripts/er_fd_check.py --package torch [--device cpu|cuda]

jax: runs that test under pytest on the CPU, as the JAX package's tests
run, and prints the directional derivative and the central difference it
compares, and the test's verdict. The test is marked slow; it takes tens
of minutes and several GiB on a CPU.

torch: the port's check at the test's settings: the directional derivative
of the port's gradient (volpath_er.li(differentiable=True), the loss of
test_inverse.py::render_er_diff) and the central difference with the
connections solved anew at each point at eps 0.01 and 1e-3, then with the
gradient's connections held (chip_smoke.py phase 20's check) at the same
eps; each against the test's tolerance (rtol 0.5, atol 5e-3, same sign).
It imports the package of the tree it lies in.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TEST = ("tests/test_inverse.py::TestRifGradients::"
        "test_rif_gradient_finite_difference")


def run_jax() -> int:
    import numpy as np
    import pytest

    seen = []

    class Witness:
        """Records what the test hands numpy's assert_allclose."""

        @pytest.hookimpl(hookwrapper=True)
        def pytest_runtest_call(self, item):
            real = np.testing.assert_allclose

            def spy(actual, desired, *a, **k):
                seen.append((float(actual), float(desired)))
                return real(actual, desired, *a, **k)

            np.testing.assert_allclose = spy
            try:
                yield
            finally:
                np.testing.assert_allclose = real

    rc = pytest.main([str(ROOT / TEST), "-m", "slow", "-q", "-s",
                      "-p", "no:cacheprovider", "-p", "no:randomly"],
                     plugins=[Witness()])
    for directional, fd in seen:
        print(f"JAX {TEST}: directional derivative {directional:.6e}, "
              f"central difference solved anew {fd:.6e} (eps 0.01)")
    print(f"JAX {TEST}: {'passed' if rc == 0 else 'failed'} (pytest exit "
          f"code {int(rc)})", flush=True)
    return 0


def run_torch(device: str) -> int:
    import numpy as np
    import torch

    from chip_smoke import ER_FD_ATOL, ER_FD_RTOL, _er_loss, _spline_scene

    scene, cfg = _spline_scene(8, 12)
    scene = scene.to(device)
    zs = np.linspace(-1, 1, 12)
    Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
    bump = torch.from_numpy(np.exp(-(X**2 + Y**2 + Z**2) / 0.5).astype(
        np.float32)).to(device)
    base = scene.media.rif_coeff
    leaf = base.detach().clone().requires_grad_()
    held = {}
    loss = _er_loss(scene, cfg, 4, 3, device, held, rif_coeff=leaf)
    (grad,) = torch.autograd.grad(loss, leaf)
    directional = (grad * bump).sum().item()
    print(f"port on {device}: loss {loss.item():.6e}, directional "
          f"derivative {directional:.6e}", flush=True)
    for how, solves in (("solved anew", None), ("held", held)):
        for eps in (0.01, 1e-3):
            with torch.no_grad():
                f = [_er_loss(scene, cfg, 4, 3, device, solves,
                              rif_coeff=base + s * eps * bump).item()
                     for s in (1, -1)]
            fd = (f[0] - f[1]) / (2 * eps)
            ok = (np.isfinite(fd) and (np.sign(fd) == np.sign(directional)
                                       or abs(fd) < 1e-4)
                  and abs(directional - fd)
                  <= ER_FD_ATOL + ER_FD_RTOL * abs(fd))
            print(f"port on {device}: central difference, connections "
                  f"{how}, eps {eps}: {fd:.6e} (f+ {f[0]:.8e}, f- "
                  f"{f[1]:.8e}); test_inverse.py's tolerance "
                  f"{'met' if ok else 'not met'}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    return run_jax() if args.package == "jax" else run_torch(args.device)


if __name__ == "__main__":
    sys.exit(main())
