"""Percent of the window in which no operation ran on the device: 100
less the union of the trace's device intervals over the window."""


def read(run):
    if not run.trace.launches:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
