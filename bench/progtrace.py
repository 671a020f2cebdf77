"""Reading the program's own spans: the `repro_torch.runtime.trace`
buffer of a run, and the ``repro.*`` ranges its spans open in a traced
window, tied to the device work they launched.

A run carries them as two fields beside `bench.harness.Run`'s:
``run.program``, the tracer's records (`trace.records()`, on the host
clock of the window), and ``run.host``, the `Host` that `read` takes from
the profiler (on the trace's clock).  Where a run carries neither, every
reading here is None.

`read` keeps, from the profiler's raw events: the ``repro.*`` ranges the
program opened on the host; each host call that puts work on the device
(a kernel launch, copy, set or graph launch of the CUDA runtime,
``cuda*``, or of its lower level, ``cu*``, known by its name) with the
correlation id the profiler gives it; and the device activity, by the
correlation id of the call that launched it.  Events are told apart by
name and device alone: the profiler's events carry no activity type in
every torch release.  A launch is counted by its host call, whether or
not the profiler kept the device record it made.

The profiler mirrors each ``repro.*`` range onto the device, and without
an activity type `bench.devtrace.read` would count the copy as device
work; `strip` is the view of a profiler without those copies that it
reads in a run with the program's tracer on (`bench.progrun`).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import types

from bench import devtrace

PREFIX = "repro."
# calls of the CUDA runtime (cuda*) and its lower level (cu*) that may put
# work on a stream
HOST_CALL = re.compile(r"cu(da)?\w*(Launch|Memcpy|Memset)")


@dataclasses.dataclass
class Host:
    ranges: list        # (name, start_ns, end_ns): the program's repro.*
    launches: list      # (start_ns, correlation id), sorted: host calls
    #                     that put work on the device
    ops: dict           # correlation id: [(start_ns, end_ns)] device work

    def __post_init__(self):
        self._starts = [s for s, _ in self.launches]

    def launched(self, s: int, e: int) -> list:
        """The launches made from ``s`` to ``e``."""
        return self.launches[bisect.bisect_left(self._starts, s):
                             bisect.bisect_right(self._starts, e)]


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def strip(prof):
    """A stopped profiler's events, as `bench.devtrace.read` takes them,
    less the device copies of the program's ``repro.*`` ranges."""
    events = [e for e in prof.profiler.kineto_results.events()
              if not (e.name().startswith(PREFIX) and _on_device(e))]
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def read(prof) -> Host:
    """The `Host` of a stopped profiler."""
    ranges, calls = [], []
    ops = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = devtrace._start_end(e)
        if _on_device(e):
            # the host's ranges are mirrored onto the device: left out
            if not (name.startswith("bench.") or name.startswith(PREFIX)):
                ops[e.correlation_id()].append((start, end))
        elif name.startswith(PREFIX):
            ranges.append((name, start, end))
        elif HOST_CALL.match(name):
            calls.append((start, e.correlation_id()))
    return Host(sorted(ranges, key=lambda r: r[1]), sorted(calls), dict(ops))


def _of(run):
    """``(trace, host)`` of a traced run that carries device work, else
    None."""
    host = getattr(run, "host", None)
    if run.trace is None or host is None or not host.ops:
        return None
    return run.trace, host


def _whole(host: Host, name: str, window: tuple) -> list:
    """``(start, end)`` of each ``repro.<name>`` range wholly inside
    ``window``."""
    return [(s, e) for n, s, e in host.ranges if n == PREFIX + name
            and window[0] <= s and e <= window[1]]


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _overlap_ns(a: list, b: list) -> int:
    """The length of the overlap of two sorted lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def decode_enqueue_ms(run) -> float | None:
    """Mean, over the program's ``serve.decode`` spans that ended in the
    host clock's window, of the ``step.enqueue`` time inside each, ms."""
    spans = getattr(run, "program", None)
    if not spans:
        return None
    enqueue = collections.Counter()
    for sp in spans:
        if sp.name == "step.enqueue":
            enqueue[sp.parent] += sp.end_ns - sp.start_ns
    decodes = [sp for sp in spans if sp.name == "serve.decode"
               and run.in_window(sp.end_ns * 1e-9)]
    if not decodes:
        return None
    return 1e-6 * sum(enqueue[sp.id] for sp in decodes) / len(decodes)


def decode_launches(run) -> float | None:
    """Mean, over the ``repro.serve.decode`` ranges wholly in the traced
    window, of the host calls inside each that put work on the device (a
    graph launch is one)."""
    got = _of(run)
    if got is None:
        return None
    trace, host = got
    decodes = _whole(host, "serve.decode", trace.window)
    if not decodes:
        return None
    return sum(len(host.launched(s, e)) for s, e in decodes) / len(decodes)


def idle_enqueue_share(run) -> float | None:
    """Share of the traced window, %, in which nothing runs on the device
    while the host is inside a ``repro.step.enqueue`` range."""
    got = _of(run)
    if got is None:
        return None
    trace, host = got
    w0, w1 = trace.window
    enqueue = [(max(s, w0), min(e, w1)) for n, s, e in host.ranges
               if n == PREFIX + "step.enqueue" and e > w0 and s < w1]
    idle = _overlap_ns(devtrace.idle_gaps(trace), enqueue)
    return 100.0 * idle / (w1 - w0)


def admit_attn_ms(run) -> float | None:
    """Mean, over the ``repro.serve.admit`` ranges wholly in the traced
    window, of the union of the device intervals of the work launched
    inside their ``repro.model.attn`` ranges, ms."""
    got = _of(run)
    if got is None:
        return None
    trace, host = got
    admits = _whole(host, "serve.admit", trace.window)
    if not admits:
        return None
    attn = [(s, e) for n, s, e in host.ranges if n == PREFIX + "model.attn"]
    starts = [s for s, _ in attn]
    total = 0
    for a0, a1 in admits:
        work = []
        for s, e in attn[bisect.bisect_left(starts, a0):
                         bisect.bisect_right(starts, a1)]:
            for _, corr in host.launched(s, e):
                work += host.ops.get(corr, [])
        total += _union_ns(work)
    return 1e-6 * total / len(admits)


def _innermost(ranges: list) -> list:
    """Sorted disjoint ``(start, end, name)``: at each moment the
    innermost of the nested ``ranges`` open then."""
    segs, stack, at = [], [], 0

    def close(until):
        nonlocal at
        while stack and stack[-1][1] <= until:
            name, end = stack.pop()
            if end > at:
                segs.append((at, end, name))
            at = max(at, end)

    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        close(s)
        if stack and s > at:
            segs.append((at, s, stack[-1][0]))
        stack.append((name, e))
        at = s
    close(float("inf"))
    return segs


def idle_by_range(run) -> dict | None:
    """The traced window's idle time, s, by the program's innermost range
    open on the host while it lasted (``repro.`` left off; a span's own
    name stands for its self time), ``loop`` where none was."""
    got = _of(run)
    if got is None:
        return None
    trace, host = got
    segs = _innermost(host.ranges)
    ends = [e for _, e, _ in segs]
    idle = collections.Counter()
    for g0, g1 in devtrace.idle_gaps(trace):
        covered = 0
        for s, e, name in segs[bisect.bisect_right(ends, g0):]:
            if s >= g1:
                break
            part = min(e, g1) - max(s, g0)
            if part > 0:
                idle[name.removeprefix(PREFIX)] += part
                covered += part
        idle["loop"] += g1 - g0 - covered
    return {n: v * 1e-9 for n, v in idle.most_common() if v > 0}
