"""The tracer on the card (tests marked cuda; they skip without one): a
span's times on the profiler's clock, and every wait for the card on the
loop road of both benchmark scenes counted as a host read. No JAX, so
that the card's machine runs them:

    python -m pytest --noconftest tests/test_torch_stats_cuda.py -m cuda
"""
from __future__ import annotations

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mitsubaer_tpu_torch.integrators import common
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.scene import presets
from mitsubaer_tpu_torch.utils import stats

FOG = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)
# the benchmark's two scenes (bench_port/configs) at 64x64, one pass each
CELLS = {
    "het_volume": lambda: presets.volumetric_box(
        res=64, spp=8, heterogeneous=True, density_res=64, max_depth=12),
    "cbox_medium": lambda: presets.cornell_box(
        res=64, spp=8, max_depth=40, integrator="volpath", medium=FOG),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    stats.reset()
    yield torch.device("cuda", 0)
    stats.reset()


@pytest.mark.cuda
def test_kernel_lies_inside_its_span_on_the_trace_clock(cuda):
    """A matrix product of a few milliseconds, launched and synchronised
    inside a span under the profiler: its device interval lies within the
    span put on the profiler's clock by `stats.to_trace_ns`, to 50 us at
    each edge."""
    from torch.autograd import DeviceType

    a = torch.randn(4096, 4096, device=cuda)
    (a @ a).sum().item()                   # the library's set-up, untraced
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with stats.span("matmul") as sp:
            b = a @ a
            torch.cuda.synchronize(cuda)
    kernels = [(e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    assert kernels and b.shape == a.shape
    lo, hi = stats.to_trace_ns(sp.start), stats.to_trace_ns(sp.end)
    k0, k1 = min(k[0] for k in kernels), max(k[1] for k in kernels)
    print(f"span {(hi - lo) / 1e3:.1f} us; kernel from {(k0 - lo) / 1e3:.1f} "
          f"us after its start to {(hi - k1) / 1e3:.1f} us before its end")
    assert k1 - k0 > 1_000_000
    assert k0 >= lo - 50_000 and k1 <= hi + 50_000


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_every_sync_on_the_loop_road_is_a_host_read(cuda, name,
                                                    monkeypatch):
    """One traced render of one pass of the cell's scene, from the host's
    copy of the scene as the benchmark passes it, under
    torch.cuda.set_sync_debug_mode("warn"): every synchronising operation
    warns inside a host read (or in the timers' synchronize at a synced
    span's edges, which only tracing adds). The image is the same bits
    with tracing off."""
    scene, cfg = CELLS[name]()
    trender.render(scene, cfg, seed=1, device=cuda)        # builds, warms
    torch.cuda.synchronize(cuda)
    off = trender.render(scene, cfg, seed=2, device=cuda)
    depth, outside, inside_reads = [0], [], [0]

    def inside(fn):
        def wrapped(*a, **k):
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return wrapped

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        if depth[0]:
            inside_reads[0] += 1
        else:
            outside.append(f"{filename}:{lineno}: {message}")

    monkeypatch.setattr(stats, "host_read", inside(stats.host_read))
    monkeypatch.setattr(stats, "_sync", inside(stats._sync))
    monkeypatch.setattr(common, "sync", inside(common.sync))
    torch.cuda.synchronize(cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with stats.tracing():
                on = trender.render(scene, cfg, seed=2, device=cuda,
                                    stats={})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert outside == [], "\n".join(outside[:20])
    reads = [s for s in stats.spans() if s.name.startswith("sync:")]
    passes = [s for s in stats.spans() if s.name == "render.pass"]
    # the debug mode did see syncs, inside the reads
    assert len(passes) == 1 and reads and inside_reads[0] > 0
    assert torch.equal(on, off)
