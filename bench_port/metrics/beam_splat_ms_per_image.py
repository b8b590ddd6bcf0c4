"""Milliseconds an image of the collimated beam's splat: the mean length
of the program's "render.beam_splat" spans in the traced window (four
beam-splat passes and the division, synchronised at both edges)."""
from bench_port import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    if not spans:
        return None
    b = [s for s in spans if s.name == "render.beam_splat"]
    return ps.ms(b) / len(b) if b else None
