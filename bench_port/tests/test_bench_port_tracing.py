"""The per-layer metrics that read the program's own spans
(bench_port/program_spans.py and the five readers in metrics/): on
synthetic spans with known answers, on a program without the tracer
(every reader gives None), and in a CPU --trace 1 run of each cell at
16x16, which reports each of them that applies there (the idle share
inside the host loops needs the card's device trace)."""
from __future__ import annotations

import numpy as np
import pytest

from bench_port import cell as cell_m, program_spans, run, trace
from mitsubaer_tpu_torch.utils import stats

MS = 1_000_000
NEW = ("host_syncs_per_msample", "sync_wait_ms_per_msample",
       "lane_occupancy.render", "beam_splat_ms_per_image",
       "idle_in_host_loops.render")


def _span(name, start_ms, end_ms, **counts):
    s = stats.Span(name, counts)
    s.start, s.end = start_ms * MS, end_ms * MS
    return s


class _Run:
    def __init__(self, tr):
        self.trace = tr


@pytest.fixture
def synthetic(monkeypatch):
    """A window of 100 ms with the device busy in [0, 10), [20, 60) and
    [70, 100): two idle gaps of 10 ms, the first inside a Woodcock loop.
    2 Msamples splatted, 4 host reads of 1 ms, bounces of 100 lanes with
    100 and 50 active, beam splats of 3 and 5 ms; a span after the
    window is not read."""
    spans = [_span("render.image", 0, 100, samples=2_000_000),
             _span("film.splat", 1, 2, samples=2_000_000),
             _span("volpath.bounce", 2, 30, lanes=100, active=100),
             _span("medium.track:woodcock", 5, 25, trips=3),
             _span("volpath.bounce", 30, 60, lanes=100, active=50),
             _span("render.beam_splat", 60, 63),
             _span("render.beam_splat", 63, 68)]
    spans += [_span("sync:volpath.bounce", 80 + i, 81 + i) for i in range(4)]
    spans.append(_span("sync:volpath.bounce", 150, 160))
    monkeypatch.setattr(stats, "spans", lambda: spans)
    monkeypatch.setattr(stats, "to_trace_ns", lambda t: t)
    iv = np.array([[0, 10], [20, 60], [70, 100]], np.float64) * MS
    return _Run(trace.DeviceTrace(["k"] * 3, iv, (0, 100 * MS), 0))


@pytest.mark.parametrize("metric, value", [
    ("host_syncs_per_msample", 2.0), ("sync_wait_ms_per_msample", 2.0),
    ("lane_occupancy.render", 75.0), ("beam_splat_ms_per_image", 4.0),
    ("idle_in_host_loops.render", 50.0)])
def test_reader_on_synthetic_spans(synthetic, metric, value):
    assert cell_m.reader(metric)(synthetic) == pytest.approx(value)


def test_gap_outside_every_loop_reads_zero(monkeypatch):
    monkeypatch.setattr(stats, "to_trace_ns", lambda t: t)
    spans = [_span("medium.track:ratio", 0, 5)]
    iv = np.array([[0, 10], [20, 30]], np.float64) * MS
    assert program_spans.idle_share_in(iv, 0, 30 * MS, spans,
                                       program_spans.HOST_LOOPS) == 0.0


def test_no_tracer_no_reading(synthetic, monkeypatch):
    """The parent of the tracer: its stats module has no `spans`, and
    every reader gives None without raising."""
    monkeypatch.delattr(stats, "spans")
    for metric in NEW:
        assert cell_m.reader(metric)(synthetic) is None


def _small(name: str):
    """The cell at 16^2 and 8 samples a pixel (the beam scene at depth 3),
    its reference small."""
    cell = cell_m.load(name)
    r = cell.workload["render"]
    r.update(res=16, spp=8, sppc=8)
    if cell.config["scene"]["kind"] == "volume":
        r["max_depth"] = cell.config["scene"]["max_depth"] = 3
    cell.workload["reference"].update(replicas=4, spp=8,
                                      splat_samples=1 << 14)
    return cell


@pytest.mark.parametrize("name", cell_m.names())
def test_cpu_traced_run_reports_the_new_metrics(name):
    code, res = run.run(["--workload", name, "--seed", "3000000123",
                         "--seconds", "0", "--trace", "1"], device="cpu",
                        cell=_small(name), images=2)
    assert code == 0
    listed = {m["name"] for m in cell_m.load(name).per_layer} & set(NEW)
    # a CPU run has no device trace to find the idle gaps in
    want = listed - {"idle_in_host_loops.render"}
    assert want <= set(res["metrics"])
    got = {k: res["metrics"][k]["value"] for k in want}
    assert got["host_syncs_per_msample"] > 0
    assert got["sync_wait_ms_per_msample"] > 0
    assert 0 < got["lane_occupancy.render"] <= 100
    if "beam_splat_ms_per_image" in want:
        assert got["beam_splat_ms_per_image"] > 0
