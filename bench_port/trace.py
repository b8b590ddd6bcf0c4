"""The traced run's readings: host spans recorded by the benchmark, the
profiler's device events, and what the per-layer metrics read from them.

The busy share is the union of the device intervals over the window, so
work that overlaps on two streams counts once (chip_smoke.py's
_profile_pass sums the durations, which holds only on one stream). The
profiler runs with CUDA activity alone and its raw kineto events are read
directly: key_averages() aggregates at ~0.3 ms an event."""
from __future__ import annotations

import contextlib
import functools
import time

import numpy as np


class Spans:
    """Host spans (name, start, end, depth) in perf_counter_ns, nested by
    the order they open; `patch` wraps a function of the program so that
    each call is a span, and restores it afterwards."""

    def __init__(self):
        self.done: list[tuple[str, int, int, int]] = []
        self._open = 0

    @contextlib.contextmanager
    def span(self, name: str):
        depth = self._open
        self._open += 1
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._open -= 1
            self.done.append((name, t0, time.perf_counter_ns(), depth))

    @contextlib.contextmanager
    def patch(self, targets):
        """Wrap module.attr for each (module, attr) of targets that
        exists; a span a call, named by attr."""
        saved = []
        for mod, attr in targets:
            fn = getattr(mod, attr, None)
            if fn is None:
                continue

            @functools.wraps(fn)
            def wrapped(*a, __fn=fn, __name=attr, **k):
                with self.span(__name):
                    return __fn(*a, **k)

            setattr(mod, attr, wrapped)
            saved.append((mod, attr, fn))
        try:
            yield
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)


def busy_union(intervals: np.ndarray) -> float:
    """Length of the union of the [start, end) rows of an (n, 2) array."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a run of overlapping intervals starts where one begins after every
    # earlier one has ended
    first = np.flatnonzero(np.concatenate([[True], iv[1:, 0] > ends[:-1]]))
    return float((np.maximum.reduceat(iv[:, 1], first) - iv[first, 0]).sum())


def gaps(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The idle (start, end) gaps of [lo, hi) outside the union."""
    if len(intervals) == 0:
        return np.array([[lo, hi]])
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    g0 = np.concatenate([[lo], ends])
    g1 = np.concatenate([iv[:, 0], [hi]])
    keep = g1 > g0
    return np.stack([g0[keep], g1[keep]], -1)


class DeviceTrace:
    """The device events of a profiled window: kernels, copies and sets."""

    def __init__(self, names, intervals_ns, window_ns, span_offset_ns):
        self.names = names
        self.iv = intervals_ns.astype(np.float64)
        self.t0, self.t1 = window_ns
        self.offset = span_offset_ns

    @classmethod
    def from_profiler(cls, prof, t0_ns: int, t1_ns: int):
        """Read a torch.profiler.profile's raw events; (t0, t1) are the
        window's perf_counter_ns bounds, aligned to the profiler's clock
        by whichever of the host clocks sits nearest its first event."""
        from torch.autograd import DeviceType

        names, rows = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                names.append(e.name())
                rows.append((e.start_ns(), e.end_ns()))
        iv = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
        return cls(names, iv, (t0_ns, t1_ns), 0)

    def align(self, clocks: dict[str, int], perf0: int):
        """Set the offset from perf_counter_ns to the profiler's clock:
        clocks holds each host clock's reading taken with perf0."""
        if not len(self.iv):
            return
        first = self.iv[:, 0].min()
        best = min(clocks.values(), key=lambda c: abs(first - c))
        self.offset = best - perf0
        self.t0 += self.offset
        self.t1 += self.offset
        self.iv = np.clip(self.iv, self.t0, self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return busy_union(self.iv) / 1e9

    @property
    def launches(self) -> int:
        return len(self.names)

    @functools.cached_property
    def by_name(self) -> dict[str, float]:
        """Summed device seconds of each event name."""
        acc: dict[str, float] = {}
        for name, (a, b) in zip(self.names, self.iv):
            acc[name] = acc.get(name, 0.0) + (b - a) / 1e9
        return acc

    def device_s(self, substring: str) -> float:
        """Summed device seconds of the events whose name holds substring."""
        return sum(s for n, s in self.by_name.items() if substring in n)

    def top_ops(self, k: int = 10):
        """The k operations by summed device seconds, names cut before
        their argument lists."""
        acc: dict[str, float] = {}
        for name, s in self.by_name.items():
            short = name.split("(")[0][:120]
            acc[short] = acc.get(short, 0.0) + s
        return sorted(([n, s] for n, s in acc.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, spans: list, k: int = 10):
        """The k longest idle gaps, each named by the innermost host span
        around its middle ("window" outside every span)."""
        g = gaps(self.iv, self.t0, self.t1)
        order = np.argsort(g[:, 0] - g[:, 1])[:k]
        out = []
        for a, b in g[order]:
            mid = 0.5 * (a + b) - self.offset
            inner = [s for s in spans if s[1] <= mid < s[2]]
            name = max(inner, key=lambda s: s[3])[0] if inner else "window"
            out.append([name, (b - a) / 1e9])
        return out
