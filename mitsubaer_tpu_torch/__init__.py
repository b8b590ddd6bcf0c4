"""mitsubaer_tpu_torch: the PyTorch/CUDA port of mitsubaer_tpu.

The first slice is the forward render of the bounded scattering volume on the
boxwalk road: `integrators.render.render(scene, cfg, seed=..., device=...)`
with a scene from `scene.presets.volumetric_box(..., filter="box")`. Its two
hand-written CUDA kernels live in csrc/ and are built by kernels.py at first
use; on CPU tensors each kernel's plain PyTorch version runs instead.
"""
