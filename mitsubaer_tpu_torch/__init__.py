"""mitsubaer_tpu_torch: the PyTorch/CUDA port of mitsubaer_tpu.

Four forward-render roads are ported, all through
`integrators.render.render(scene, cfg, seed=..., device=...)`, which runs
on the CUDA card unless device="cpu" is passed, and picks the road as the
JAX render() does:
- the loop engine (`integrators.volpath.li`) for a "volpath" render with
  any film filter but box (the default filter is "gaussian") or with
  engine="loop", and for "volpath_simple" unless engine="wavefront"
  (`scene.presets.volumetric_box(...)`);
- the bounded scattering volume on the boxwalk road
  (`volumetric_box(..., filter="box")`);
- every other steady-state volpath scene with a box filter on the
  wavefront road (e.g. `volumetric_box(..., filter="box",
  emitter_kind="point")`);
- the eikonal (refractive) road, `integrator="volpath_er"`
  (`scene.presets.refractive_sphere(...)`);
- bidirectional path tracing and the particle tracer,
  `integrator="bdpt"` and `"ptracer"`;
- the estimators with passes of their own: pssmlt, mlt and erpt, the
  photon mappers and bre, vpl, irrcache, singlescatter (sphere and mesh)
  and dipole, each returning its own image.
`render()` accepts every integrator name the JAX package's does.
The loop and eikonal roads and bdpt render every film decomposition:
transient and bounce frames ((H, W, 3F) images) and CW-ToF weights.
The training path, `diff.render` (`render_diff`, `loss_and_grad`,
`image_grad`), differentiates the loop engine with respect to the medium
parameters (sigma_a, sigma_s, the density grid, the HG g) and runs on the
card unless device="cpu" is passed. The eikonal road's gradients, with
respect to the RIF's parameters or its B-spline coefficient grid, come
from `integrators.volpath_er.li(differentiable=True)`.
Their hand-written CUDA kernels live in csrc/ and are built by kernels.py
at first use; on CPU tensors each kernel's plain PyTorch version runs
instead.
The front door: `scene.xml.load_scene` reads Mitsuba XML scenes, `utils.io`
images, meshes and grids (OBJ and VOL3 through the native library in
native/, built with g++ at first use), and `python -m
mitsubaer_tpu_torch.cli scene.xml` renders one (on the card; `--cpu` for
the CPU; `--sharded` under torchrun). `parallel.driver` renders and trains
over torch.distributed, bit-identically at every world size for one
layout of shards.
"""

