"""The image means that chip_smoke.py phases 47 and 50 hold, at widths
the CPU can render: singlescatter's mesh boundary over its sphere, and
vpl over path on BASELINE config 1, in the port and (with --package both)
in the JAX package.

    python3 scripts/step12b_means_check.py [--res 32 64] [--package both]

For each width: tests/test_singlescatter.py's sphere and its
subdivision-3 octahedron sphere (512 triangles) at eta 1.33, spp 2,
n_dist 4 (the mesh's mean over the sphere's; phase 47 holds it within
15% at 256^2), then config 1 under "vpl" at spp 4 (the same 64 VPLs at
every width) over "path" at spp 64 (phase 50 holds it within 10% of
JAX's ratio at 32^2, scripts/vpl_ratio_check.py). JAX's renders run
jitted, one compile a width (~1 min and a few GiB at 64^2 for the mesh).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--package", choices=("torch", "both"), default="torch")
    args = ap.parse_args()

    import numpy as np

    import chip_smoke as c
    from mitsubaer_tpu_torch.integrators import render as render_m
    from mitsubaer_tpu_torch.scene import presets

    for res in args.res:
        t0 = time.perf_counter()
        means = {}
        for name, subdiv, integrator in (("sphere", None, "singlescatter"),
                                         ("mesh", 3, "singlescatter_mesh")):
            scene, cfg = c._ss_scene(res, 2, 1.33, subdiv=subdiv,
                                     integrator=integrator)
            means[name] = render_m.render(scene, cfg, seed=0,
                                          device="cpu").mean().item()
        scene, cfg = presets.cornell_box(res=res)
        path = render_m.render(scene, dataclasses.replace(cfg, spp=64),
                               seed=0, device="cpu").mean().item()
        vpl = render_m.render(scene, dataclasses.replace(
            cfg, spp=4, integrator="vpl"), seed=0, device="cpu").mean().item()
        print(f"port, {res}x{res}: singlescatter sphere {means['sphere']:.6f}"
              f", mesh {means['mesh']:.6f}, mesh over sphere "
              f"{means['mesh'] / means['sphere'] - 1:+.4f}; config 1 vpl "
              f"{vpl:.6f} over path {path:.6f}: {vpl / path:.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if args.package == "both":
            import jax

            jax.config.update("jax_platforms", "cpu")
            from mitsubaer_tpu.integrators import singlescatter as jss

            t0 = time.perf_counter()
            jm = {}
            for name, subdiv in (("sphere", None), ("mesh", 3)):
                jscene, jcfg = _jax_ss_scene(res, subdiv)
                fn = (jss.render_singlescatter if subdiv is None
                      else jss.render_singlescatter_mesh)
                jm[name] = float(np.asarray(fn(jscene, jcfg, seed=0)).mean())
            print(f"JAX, {res}x{res}: singlescatter sphere {jm['sphere']:.6f}"
                  f", mesh {jm['mesh']:.6f}, mesh over sphere "
                  f"{jm['mesh'] / jm['sphere'] - 1:+.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


def _jax_ss_scene(res, subdiv):
    """chip_smoke._ss_scene(res, 2, 1.33, subdiv=subdiv) built by the JAX
    package's SceneBuilder."""
    from mitsubaer_tpu.core import transform as jtf
    from mitsubaer_tpu.scene import types as JT
    from mitsubaer_tpu.scene.build import SceneBuilder

    import chip_smoke as c

    b = SceneBuilder()
    med = b.add_medium(kind=JT.MED_HOMOGENEOUS, sigma_a=(0.05,) * 3,
                       sigma_s=(0.4,) * 3, phase_kind=JT.PH_ISOTROPIC)
    bs = b.add_bsdf(kind=JT.BSDF_DIELECTRIC, eta=1.33)
    if subdiv is None:
        b.add_sphere((0.0, 0.0, 0.0), 1.0, bsdf=bs, interior=med)
    else:
        b.add_mesh(*c._octasphere(subdiv), bsdf=bs, interior=med)
    b.add_emitter(JT.EM_POINT, radiance=(10.0, 10.0, 10.0),
                  position=(2.5, 1.5, 0.0))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), fov_deg=35)
    b.config = b.config._replace(width=res, height=res, spp=2,
                                 filter="box")
    return b.build(), b.config


if __name__ == "__main__":
    sys.exit(main())
