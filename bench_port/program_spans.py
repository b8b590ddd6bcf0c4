"""The program's own spans in a traced run: what
mitsubaer_tpu_torch/utils/stats.py's tracer records while the profiler
runs. The per-layer metrics of host syncs, lane occupancy, the beam splat
and the idle share inside the host loops read them here. A program
without that tracer gives None to every reader, and the metric is left
out of the line."""
from __future__ import annotations

import numpy as np

from .trace import gaps

# the program's host-driven loops: the tracking loops and the BVH walk
HOST_LOOPS = ("medium.track", "bvh.walk")


def _stats():
    try:
        from mitsubaer_tpu_torch.utils import stats
    except ImportError:
        return None
    return stats if hasattr(stats, "spans") else None


def in_window(run) -> list | None:
    """The spans that started inside the traced window (the window's bounds
    in perf_counter_ns are the trace's less its offset), or None where the
    program records none."""
    stats = _stats()
    if stats is None:
        return None
    t0 = run.trace.t0 - run.trace.offset
    t1 = run.trace.t1 - run.trace.offset
    spans = [s for s in stats.spans() if t0 <= s.start < t1]
    return spans or None


def msamples(spans) -> float:
    """The camera samples the program splatted (film.splat), millions."""
    return sum(s.counts.get("samples", 0) for s in spans
               if s.name == "film.splat") / 1e6


def syncs(spans) -> list:
    """The host reads' waits ("sync:<site>")."""
    return [s for s in spans if s.name.startswith("sync:")]


def ms(spans) -> float:
    return sum(s.end - s.start for s in spans) / 1e6


def idle_share_in(iv, t0, t1, spans, prefixes) -> float | None:
    """Percent of the idle time of [t0, t1) outside the device intervals
    iv (the trace's clock, ns) that lies in gaps whose midpoint falls
    inside a span named with one of `prefixes`, the spans put on the
    trace's clock by the program's own clock pair (None where the program
    has no tracer or the device never idled)."""
    stats = _stats()
    if stats is None:
        return None
    g = gaps(iv, t0, t1)
    idle = float((g[:, 1] - g[:, 0]).sum())
    if idle <= 0:
        return None
    sp = np.array([(stats.to_trace_ns(s.start), stats.to_trace_ns(s.end))
                   for s in spans if s.name.startswith(prefixes)],
                  dtype=np.float64).reshape(-1, 2)
    if not len(sp):
        return 0.0
    # the union of the spans, then the gaps whose midpoint lies in it
    sp = sp[np.argsort(sp[:, 0], kind="stable")]
    ends = np.maximum.accumulate(sp[:, 1])
    first = np.flatnonzero(np.concatenate([[True], sp[1:, 0] > ends[:-1]]))
    lo, hi = sp[first, 0], np.maximum.reduceat(sp[:, 1], first)
    mid = 0.5 * (g[:, 0] + g[:, 1])
    k = np.searchsorted(lo, mid, side="right") - 1
    inside = (k >= 0) & (mid < hi[np.clip(k, 0, None)])
    return 100.0 * float((g[inside, 1] - g[inside, 0]).sum()) / idle
