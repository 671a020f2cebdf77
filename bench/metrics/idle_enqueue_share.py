"""The traced window's share, %, in which the device runs nothing while
the host is inside one of the program's ``repro.step.enqueue`` ranges
(a forward's enqueue, admission or decode; `bench.progtrace`).  It
carries the profiler's host cost, as ``device_idle_share`` does."""

from bench import progtrace


def read(run):
    return progtrace.idle_enqueue_share(run)
