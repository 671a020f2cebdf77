"""The device's idle share of the traced window, %: one less the union
of its kernels, copies and sets over the window's length."""

from bench import devtrace


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(run.trace) / run.trace.window_s)
