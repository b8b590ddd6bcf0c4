"""Milliseconds the host waits in its host reads a million camera
samples: the summed length of the program's "sync:<site>" spans in the
traced window over the samples it splatted (film.splat)."""
from bench_port import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    if not spans or not ps.msamples(spans):
        return None
    return ps.ms(ps.syncs(spans)) / ps.msamples(spans)
