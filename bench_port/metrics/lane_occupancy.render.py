"""Percent of the lanes that were active at the entry of the bounces run:
100 x the summed active lanes at bounce entry over the summed lanes of
the bounces (the program's "volpath.bounce" and "path.bounce" spans in
the traced window)."""
from bench_port import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    if not spans:
        return None
    b = [s for s in spans if s.name in ("volpath.bounce", "path.bounce")]
    lanes = sum(s.counts.get("lanes", 0) for s in b)
    if not lanes:
        return None
    return 100.0 * sum(s.counts.get("active", 0) for s in b) / lanes
