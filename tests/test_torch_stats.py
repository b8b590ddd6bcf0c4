"""The port's tracer (mitsubaer_tpu_torch/utils/stats.py) on the CPU: span
nesting, parents and request ids, the shared no-op while tracing is off,
tracing under torch.profiler and under `stats.tracing()`, the host reads'
counts, and the loop road's spans and counters on 16x16 renders of both
benchmark scenes (the same bits with tracing on and off). No JAX."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import medium as tmedium
from mitsubaer_tpu_torch.scene import bvh as tbvh
from mitsubaer_tpu_torch.scene import presets
from mitsubaer_tpu_torch.utils import stats

RES, SPP = 16, 2
FOG = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)


@pytest.fixture(autouse=True)
def _clean():
    stats.reset()
    yield
    stats.reset()


def _names(spans):
    return [s.name for s in spans]


def test_spans_nest_with_parents_and_request_ids():
    with stats.tracing():
        with stats.span("a", n=1) as a:
            with stats.span("b") as b:
                b.add(k=2)
                b.add(k=3)
            assert stats.host_read("site", int, torch.tensor(7)) == 7
        with stats.span("c"):
            pass
    rec = stats.spans()
    assert _names(rec) == ["a", "b", "sync:site", "c"]
    assert [s.parent for s in rec] == [None, 0, 0, None]
    assert rec[0].request == rec[1].request == rec[2].request
    assert rec[3].request == rec[0].request + 1
    assert a.counts == {"n": 1} and b.counts == {"k": 5}
    assert all(s.start <= s.end for s in rec)
    assert rec[0].start <= rec[1].start and rec[1].end <= rec[0].end
    assert rec[3].start >= rec[0].end


def test_off_records_nothing_and_shares_one_noop():
    assert not stats.on()
    first, second = stats.span("a", n=1), stats.synced_span("b", "cpu")
    assert first is second
    with first as sp:
        sp.add(n=2)
        assert stats.host_read("site", bool, torch.tensor(True))
    assert stats.spans() == []
    assert stats.snapshot() == {"reads.site": 1}


def test_profiler_turns_tracing_on():
    with profile(activities=[ProfilerActivity.CPU]):
        assert stats.on()
        with stats.span("inside"):
            pass
    assert not stats.on()
    with stats.span("outside"):
        pass
    assert _names(stats.spans()) == ["inside"]


def test_to_trace_ns_is_the_unix_clock():
    with stats.tracing():
        with stats.span("a") as a:
            wall = time.time_ns()
    # the span's start on the unix clock lies just before the wall reading
    assert -1_000_000 < wall - stats.to_trace_ns(a.start) < 50_000_000


def test_host_read_counts_each_site():
    t = torch.arange(4)
    for _ in range(3):
        stats.host_read("x", int, t.sum())
    with stats.tracing():
        stats.host_read("y", bool, t.any())
    snap = stats.snapshot()
    assert snap["reads.x"] == 3 and snap["reads.y"] == 1
    assert _names(stats.spans()) == ["sync:y"]


def test_timed_is_a_span_and_a_timer():
    with stats.tracing():
        with stats.timed("t"):
            pass
    assert _names(stats.spans()) == ["t"]
    assert stats.snapshot()["t.seconds"] >= 0


def _scenes():
    vol = presets.volumetric_box(res=RES, spp=SPP, heterogeneous=True,
                                 density_res=16, max_depth=4)
    box = presets.cornell_box(res=RES, spp=SPP, max_depth=6,
                              integrator="volpath", medium=FOG)
    return {"het_volume": vol, "cbox_medium": box}


SCENES = _scenes()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_loop_render_spans_and_counts(name):
    """Both cells' road at 16x16 spp 2 in passes of 1 sample: the image
    is the same bits with tracing on and off; each pass's bounce spans
    and Woodcock trips are its `passes` counts, the film's samples are
    res^2 spp, the bounces' occupancy lies in (0, 100], and every span
    carries the render's request id."""
    scene, cfg = SCENES[name]
    off = trender.render(scene, cfg, seed=3, device="cpu", spp_per_pass=1)
    assert stats.spans() == []
    stats.reset()
    counts = {}
    with stats.tracing():
        on = trender.render(scene, cfg, seed=3, device="cpu", stats=counts,
                            spp_per_pass=1)
    assert torch.equal(on, off)
    rec = stats.spans()
    assert rec[0].name == "render.image" and rec[0].parent is None
    assert rec[0].counts == {"samples": RES * RES * SPP}
    assert {s.request for s in rec} == {rec[0].request}
    passes = [i for i, s in enumerate(rec) if s.name == "render.pass"]
    assert len(passes) == len(counts["passes"]) == SPP
    for i, (bounces, wood) in zip(passes, counts["passes"]):
        assert rec[i].counts == {"lanes": RES * RES, "bounces": bounces,
                                 "woodcock": wood}
        inside = [s for s in rec if _under(rec, s, i)]
        b = [s for s in inside if s.name == "volpath.bounce"]
        assert len(b) == bounces
        assert b[0].counts == {"lanes": RES * RES, "active": RES * RES}
        assert sum(s.counts["trips"] for s in inside
                   if s.name == "medium.track:woodcock") == wood
    splat = [s.counts["samples"] for s in rec if s.name == "film.splat"]
    assert sum(splat) == RES * RES * SPP
    b = [s for s in rec if s.name == "volpath.bounce"]
    occ = 100 * sum(s.counts["active"] for s in b) / sum(
        s.counts["lanes"] for s in b)
    assert 0 < occ <= 100
    # every host read of the render is a "sync:" span, a child of a span
    reads = sum(v for k, v in stats.snapshot().items()
                if k.startswith("reads."))
    syncs = [s for s in rec if s.name.startswith("sync:")]
    assert len(syncs) == reads and all(s.parent is not None for s in syncs)
    beam = [s for s in rec if s.name == "render.beam_splat"]
    assert len(beam) == (name == "het_volume")


def _under(rec, s, i) -> bool:
    """Whether span s lies under span index i."""
    while s.parent is not None:
        if s.parent == i:
            return True
        s = rec[s.parent]
    return False


# a soup of 600 triangles and 1,000 rays (tests/test_torch_surface.py's
# _soup(600, 5) and _soup_rays(1000, 6)), and the counts that
# intersect_bvh(stats=...) gave on it before the tracer took them over:
# (trips, lane_trips)
SOUP_COUNTS = (91, 13652)


def test_bvh_walk_counts_trips_as_before():
    r = np.random.default_rng(5)
    c = r.uniform(-1, 1, (600, 3)).astype(np.float32)
    v0 = c + r.normal(0, 0.02, (600, 3)).astype(np.float32)
    e1 = r.normal(0, 0.06, (600, 3)).astype(np.float32)
    e2 = r.normal(0, 0.06, (600, 3)).astype(np.float32)
    r = np.random.default_rng(6)
    o = r.uniform(-2, 2, (1000, 3)).astype(np.float32)
    d = r.normal(0, 1, (1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = tbvh.build_bvh(v0, e1, e2)
    args = (torch.from_numpy(o), torch.from_numpy(d),
            torch.full((1000,), 1e-4), torch.full((1000,), 1e9))
    off = tbvh.intersect_bvh(b, *args)
    with stats.tracing():
        on = tbvh.intersect_bvh(b, *args)
    assert all(torch.equal(x, y) for x, y in zip(on, off))
    walk = [s for s in stats.spans() if s.name == "bvh.walk"]
    assert len(walk) == 1
    assert (walk[0].counts["trips"], walk[0].counts["lane_trips"]) \
        == SOUP_COUNTS
    n = stats.snapshot()
    assert n["reads.bvh.walk"] == 2 * SOUP_COUNTS[0]
    assert n["reads.bvh.compact"] % 2 == 0 and n["reads.bvh.compact"] > 0


# aten operations that wait for a CUDA card's queue (a value or a size
# read back to the host), and the indexing ops that read a boolean mask's
# size
_WAITS = {"_local_scalar_dense", "nonzero", "masked_select", "is_nonzero",
          "equal", "_unique2", "unique_dim", "unique_consecutive",
          "bincount", "masked_scatter_"}
_INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


class _Waits(TorchDispatchMode):
    """Records each operation that would wait for the card outside a
    host read."""

    def __init__(self):
        super().__init__()
        self.depth, self.outside = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        waits = name in _WAITS or (name in _INDEXING and any(
            i is not None and i.dtype == torch.bool for i in args[1]))
        if waits and not self.depth:
            self.outside.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_every_wait_on_the_loop_road_is_a_host_read(name, monkeypatch):
    """Every operation of a render that would wait for the card runs
    inside a host read (the CPU's plain version of kernel A aside: the
    card runs the kernel there). Copies from host memory to the card are
    held by the test marked cuda."""
    scene, cfg = SCENES[name]
    mode = _Waits()

    def counted(fn):
        def inside(*a, **k):
            mode.depth += 1
            try:
                return fn(*a, **k)
            finally:
                mode.depth -= 1
        return inside

    monkeypatch.setattr(stats, "host_read", counted(stats.host_read))
    monkeypatch.setattr(tmedium, "trilinear_lookup_plain",
                        counted(tmedium.trilinear_lookup_plain))
    with mode:
        trender.render(scene, cfg, seed=1, device="cpu")
    assert mode.outside == []
