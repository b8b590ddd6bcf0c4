"""Device operations (kernels, copies, sets) a million camera samples,
counted in the profiler's trace: the host's launches."""


def read(run):
    n = run.trace.launches
    return n / run.drv.msamples if n else None
