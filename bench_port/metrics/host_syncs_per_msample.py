"""Host syncs a million camera samples: the program's host reads (its
"sync:<site>" spans) in the traced window over the samples it splatted
(film.splat)."""
from bench_port import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    if not spans or not ps.msamples(spans):
        return None
    return len(ps.syncs(spans)) / ps.msamples(spans)
