"""Milliseconds of the loop road's passes a million camera samples: the
program's own synchronised pass seconds (render(stats=...)["loop_s"])
over the window's samples."""


def read(run):
    s = run.drv.stats.get("loop_s")
    return s * 1e3 / run.drv.msamples if s else None
