"""Render statistics + logging (port of mitsubaer_tpu/utils/stats.py).

Reference: libcore's StatsCounter registry (statistics.h:55-94, printed by
Statistics::printStats at job end) and the per-thread Logger/Appender stack
(logger.h:116). Host-side and lightweight: counters track work submitted to
the device (the device itself is profiled with torch.profiler). The
render() of integrators/render.py feeds "render.wall" (seconds),
"render.passes" and "render.camera_rays"."""
from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

_COUNTERS: Dict[str, float] = defaultdict(float)
_MINMAX: Dict[str, list] = {}
_TIMERS: Dict[str, float] = defaultdict(float)


def counter_add(name: str, value: float = 1.0):
    _COUNTERS[name] += value


def counter_minmax(name: str, value: float):
    lo, hi = _MINMAX.get(name, (value, value))
    _MINMAX[name] = [min(lo, value), max(hi, value)]


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMERS[name] += time.perf_counter() - t0


def reset():
    _COUNTERS.clear()
    _MINMAX.clear()
    _TIMERS.clear()


def snapshot() -> dict:
    out = {k: v for k, v in _COUNTERS.items()}
    out.update({f"{k}.min": v[0] for k, v in _MINMAX.items()})
    out.update({f"{k}.max": v[1] for k, v in _MINMAX.items()})
    out.update({f"{k}.seconds": v for k, v in _TIMERS.items()})
    return out


def print_stats(file=None):
    """Statistics::printStats analogue (statistics.h:351)."""
    file = file or sys.stderr
    snap = snapshot()
    if not snap:
        return
    print("  ------------ render statistics ------------", file=file)
    for k in sorted(snap):
        v = snap[k]
        if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
            print(f"  {k:<40s} {int(v)}", file=file)
        else:
            print(f"  {k:<40s} {v:.4g}", file=file)
    print("  -------------------------------------------", file=file)


def get_logger(name: str = "mitsubaer_tpu_torch") -> logging.Logger:
    """Per-module logger with the reference's console format."""
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"
        ))
        log.addHandler(h)
        log.setLevel(logging.INFO)
    return log
