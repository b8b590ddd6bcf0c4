"""Device milliseconds of kernel A (csrc/trilinear.cu trilinear_kernel)
a million camera samples, from the profiler's trace."""


def read(run):
    s = run.trace.device_s("trilinear_kernel")
    return s * 1e3 / run.drv.msamples if s > 0 else None
