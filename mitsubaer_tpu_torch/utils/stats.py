"""Render statistics and the port's tracer (port of
mitsubaer_tpu/utils/stats.py, extended).

Reference: libcore's StatsCounter registry (statistics.h:55-94). Counters
and timers track work submitted to the device: render() of
integrators/render.py feeds "render.wall" (seconds), "render.passes" and
"render.camera_rays", and every `host_read` counts its site ("reads.<site>"
in `snapshot`).

The tracer records spans in memory while tracing is on: inside
`with tracing():`, or whenever a torch profiler is recording (the
benchmark's traced run turns it on so). A span holds its name, its start
and end in perf_counter_ns, the index of its parent span, the request id
of the outermost span it lies in (one render() call: every child carries
it) and a dict of counts that its body may add to. While tracing is off,
`span` returns one shared no-op context: one flag check, no clock read,
no record. `host_read` is the one way the loop road turns a device value
into a Python value, or waits for the device in any other way (a blocking
copy from host memory: `to_device`): it always counts the read under its
site, and while tracing is on it records the wait as a child span
"sync:<site>".
`to_trace_ns` puts a span's times on the clock that the profiler's device
events carry (the unix clock), from one pair of clock readings taken when
tracing turned on; `reset` clears it with the records.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

_COUNTERS: Dict[str, float] = defaultdict(float)
_TIMERS: Dict[str, float] = defaultdict(float)
_READS: Dict[str, int] = defaultdict(int)

_RECORDS: list = []     # every span recorded, in the order they opened
_OPEN: list = []        # the open spans, innermost last
_TRACING = 0            # depth of `tracing()` blocks
_REQUESTS = 0           # request ids handed out
_CLOCK: tuple | None = None     # (perf_counter_ns, time_ns) read together


def counter_add(name: str, value: float = 1.0):
    _COUNTERS[name] += value


def on() -> bool:
    """Whether spans are recorded now."""
    return bool(_TRACING or _profiler._is_profiler_enabled)


class Span:
    """A recorded span; `add` adds to its counts."""

    __slots__ = ("name", "start", "end", "parent", "request", "counts",
                 "device")

    def __init__(self, name: str, counts: dict, device=None):
        self.name, self.counts, self.device = name, counts, device
        self.start = self.end = 0
        self.parent = self.request = None

    def add(self, **counts):
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        global _CLOCK, _REQUESTS
        if _CLOCK is None:
            _CLOCK = (time.perf_counter_ns(), time.time_ns())
        if _OPEN:
            parent = _OPEN[-1]
            self.parent, self.request = parent, _RECORDS[parent].request
        else:
            _REQUESTS += 1
            self.request = _REQUESTS
        _OPEN.append(len(_RECORDS))
        _RECORDS.append(self)
        if self.device is not None:
            _sync(self.device)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            _sync(self.device)
        self.end = time.perf_counter_ns()
        if _OPEN:           # empty where reset() ran inside the span
            _OPEN.pop()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start}, {self.end}, "
                f"parent={self.parent}, request={self.request}, "
                f"{self.counts})")


class _NoSpan:
    """The shared context that `span` returns while tracing is off."""

    __slots__ = ()

    def add(self, **counts):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str, **counts):
    """A context recording `name` while tracing is on (`with span(...) as
    sp: ... sp.add(k=n)`); the shared no-op otherwise."""
    if not (_TRACING or _profiler._is_profiler_enabled):
        return _NOOP
    return Span(name, counts)


def synced_span(name: str, device, **counts):
    """`span` that, while tracing, waits for `device`'s queued work at both
    edges, so that it times the work its body launched."""
    if not (_TRACING or _profiler._is_profiler_enabled):
        return _NOOP
    return Span(name, counts, device)


def host_read(site: str, fn, tensor):
    """fn(tensor), a device value turned into a Python value (or a size
    learnt by the host), counted under `site`; while tracing, the wait is
    the span "sync:<site>"."""
    _READS[site] += 1
    if not (_TRACING or _profiler._is_profiler_enabled):
        return fn(tensor)
    with Span("sync:" + site, {}):
        return fn(tensor)


# the reads of a mask that the loop road makes through `host_read`
def any_of(mask) -> bool:
    return bool(mask.any())


def all_of(mask) -> bool:
    return bool(mask.all())


def count_of(mask) -> int:
    return int(mask.sum())


def indices_of(mask):
    """The indices where mask is set (the host learns their count)."""
    return torch.nonzero(mask).squeeze(1)


def to_device(site: str, value, device, dtype=None):
    """torch.as_tensor(value, dtype, device) for a host value: a blocking
    copy from host memory, which waits for the device's queue as a read
    does, so it is the host read `site` (on the CPU too, so that a CPU run
    counts what the card's would)."""
    return host_read(site, lambda v: torch.as_tensor(v, dtype=dtype,
                                                     device=device), value)


@contextmanager
def tracing():
    """Record spans inside the block (nestable); the clock pair of
    `to_trace_ns` is read anew at the outermost entry."""
    global _TRACING, _CLOCK
    if not _TRACING:
        _CLOCK = (time.perf_counter_ns(), time.time_ns())
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


def spans() -> list:
    """The spans recorded since the last `reset`, in the order they
    opened (a span's `parent` indexes this list)."""
    return _RECORDS


def to_trace_ns(t: int) -> int:
    """A perf_counter_ns reading on the unix clock in ns, the clock of the
    profiler's events, from the pair read when tracing turned on."""
    if _CLOCK is None:
        raise RuntimeError("to_trace_ns: nothing was traced since reset()")
    return t - _CLOCK[0] + _CLOCK[1]


@contextmanager
def timed(name: str):
    """A span that also adds its seconds to the timer `name`."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _TIMERS[name] += time.perf_counter() - t0


def reset():
    """Clear the counters, timers, read counts and the spans recorded
    (spans still open are dropped), and the trace clock's pair."""
    global _CLOCK
    _COUNTERS.clear()
    _TIMERS.clear()
    _READS.clear()
    _RECORDS.clear()
    _OPEN.clear()
    _CLOCK = None


def snapshot() -> dict:
    out = {k: v for k, v in _COUNTERS.items()}
    out.update({f"{k}.seconds": v for k, v in _TIMERS.items()})
    out.update({f"reads.{k}": v for k, v in _READS.items()})
    return out
