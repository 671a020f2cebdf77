"""Reading a traced run: the device's activity and the harness's spans
from `torch.profiler`'s raw events, in the trace's own clock (ns).

The traced window is the harness's ``bench.window`` range.  Device
activity is every kernel, copy and set the card ran (annotation ranges
that the profiler mirrors onto the device are left out), clipped to the
window.  Busy time is the union of those intervals; an idle gap is a
stretch of the window with none, charged to the harness span that was
open on the host while it lasted (``bench.admit``, ``bench.decode``,
``bench.source``; ``loop`` where none was: the serve loop's own work).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"
_MIRRORED = ("gpu_user_annotation",)


@dataclasses.dataclass
class Trace:
    window: tuple                      # (start_ns, end_ns)
    device: list                       # (name, start_ns, end_ns), clipped
    spans: list                        # (name, start_ns, end_ns) bench.*

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def _start_end(e):
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = (e.duration_ns() if hasattr(e, "duration_ns")
           else e.duration_us() * 1000)
    return int(start), int(start) + int(dur)


def read(prof) -> Trace:
    """The `Trace` of a profiler stopped after its ``bench.window``
    range closed."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if str(e.device_type()).endswith("CUDA"):
            if kind in _MIRRORED or name.startswith("bench."):
                continue
            device.append((name, *_start_end(e)))
        elif name.startswith("bench."):
            spans.append((name, *_start_end(e)))
    window = next(((s, t) for n, s, t in spans if n == WINDOW), None)
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    clipped = [(n, max(s, window[0]), min(t, window[1]))
               for n, s, t in device if t > window[0] and s < window[1]]
    return Trace(window, clipped,
                 [x for x in spans if x[0] != WINDOW])


def busy_intervals(trace: Trace) -> list:
    """The union of the device's activity, as sorted disjoint intervals."""
    out = []
    for _, s, t in sorted(trace.device, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(trace: Trace) -> float:
    return sum(t - s for s, t in busy_intervals(trace)) * 1e-9


def idle_gaps(trace: Trace) -> list:
    """Every stretch of the window with nothing on the device:
    ``(start_ns, end_ns)``."""
    gaps, at = [], trace.window[0]
    for s, t in busy_intervals(trace):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < trace.window[1]:
        gaps.append((at, trace.window[1]))
    return gaps


def short_name(name: str, most: int = 240) -> str:
    """A kernel's name without its leading ``void`` and its parameter
    list, at most ``most`` characters."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    return name[:most]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each as ``[[name, seconds], ...]``.  An idle
    gap is split over the harness spans it overlaps; what no span covers
    is ``loop``."""
    ops = collections.Counter()
    for name, s, t in trace.device:
        ops[short_name(name)] += t - s
    idle = collections.Counter()
    spans = sorted(trace.spans, key=lambda x: x[1])
    ends = [x[2] for x in spans]
    for g0, g1 in idle_gaps(trace):
        covered = 0
        for name, s, e in spans[bisect.bisect_right(ends, g0):]:
            if s >= g1:
                break
            part = min(e, g1) - max(s, g0)
            if part > 0:
                idle[name.removeprefix("bench.").split("#")[0]] += part
                covered += part
        idle["loop"] += g1 - g0 - covered
    return {"device_ops": [[n, v * 1e-9] for n, v in ops.most_common(top)],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle.most_common(top)
                          if v > 0]}
