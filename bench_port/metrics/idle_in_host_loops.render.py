"""Percent of the window's device-idle time that lies in the host-driven
loops: in gaps whose midpoint falls inside one of the program's tracking
loops ("medium.track:<loop>") or BVH walks ("bvh.walk"). It sizes what
device-side loops could win."""
from bench_port import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    tr = run.trace
    if not spans or not tr.launches:
        return None
    return ps.idle_share_in(tr.iv, tr.t0, tr.t1, spans, ps.HOST_LOOPS)
