"""Spans of the serving path, in memory, off by default.

A span is a named interval on `time.monotonic_ns` (the clock of
`runtime.lifecycle` and of the serve loop), with the id of the span that
encloses it and a few attributes.  The serving path opens one span at
each layer boundary:

* ``serve.admit`` around each admission of `launch.serve.Server`, one-slot
  or chunked (attributes: the admitted request ids, the forward's width
  and the positions it carried), ``serve.decode`` around each decode call
  of `launch.serve.serve_loop` (the loop step and the occupied slots);
* ``step.prepare``, ``step.enqueue`` and ``step.wait`` inside every
  `Server._step`: host arrays to device tensors (and a paged cache's table),
  the forward's enqueue up to its return, the copies of its results to the
  host;
* ``model.attn`` around each layer's attention in
  `models.layers.attention_apply`, after the cache write, up to its output.

`enable` and `disable` are the caller's.  While off, `span` returns one
shared object that does nothing; `measure` is the one span that always
stamps its own start and end (the serve loop's watchdog reads
``serve.decode``'s length), and records like the others only while on.
Records go into a buffer of `CAPACITY` spans; the ones past it are
counted in `dropped`.

While `torch.profiler` records, every span of an enabled tracer also
opens a ``repro.<name>`` range (`torch.profiler.record_function`), so the
spans sit in the profiler's trace beside the device work they launched,
on the profiler's clock.
"""

from __future__ import annotations

import time

import torch

CAPACITY = 1 << 19


class Span:
    """One span: a record once closed.  ``parent`` is the id of the
    enclosing span recorded by the same tracer, None at the top."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns",
                 "_tracer", "_range")

    def __init__(self, name: str, attrs: dict, tracer: Tracer | None):
        self.name, self.attrs, self._tracer = name, attrs, tracer
        self.id = self.parent = self._range = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        self.start_ns = time.monotonic_ns()
        tr = self._tracer
        if tr is not None:
            self.id = tr._next_id
            tr._next_id += 1
            self.parent = tr._stack[-1] if tr._stack else None
            tr._stack.append(self.id)
            if torch.autograd._profiler_enabled():
                self._range = torch.profiler.record_function(
                    "repro." + self.name)
                self._range.__enter__()
        return self

    def __exit__(self, *exc):
        tr, self._tracer = self._tracer, None
        if tr is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            tr._stack.pop()
            tr._keep(self)
        self.end_ns = time.monotonic_ns()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NO_SPAN = _NoSpan()


class Tracer:
    """A buffer of spans; off until `enable`."""

    def __init__(self):
        self.on = False
        self.clear()

    def clear(self) -> None:
        self._records: list[Span] = []
        self._stack: list[int] = []
        self._next_id = 0
        self.dropped = 0

    def _keep(self, span: Span) -> None:
        if len(self._records) < CAPACITY:
            self._records.append(span)
        else:
            self.dropped += 1

    def span(self, name: str, **attrs):
        return Span(name, attrs, self) if self.on else NO_SPAN

    def measure(self, name: str, **attrs) -> Span:
        return Span(name, attrs, self if self.on else None)

    def records(self) -> list[Span]:
        return list(self._records)


_TRACER = Tracer()


def enable() -> None:
    _TRACER.on = True


def disable() -> None:
    _TRACER.on = False


def clear() -> None:
    """Drop every record (the on/off state stays)."""
    _TRACER.clear()


def span(name: str, **attrs):
    """A span named ``name``, recorded while the tracer is on."""
    return _TRACER.span(name, **attrs)


def measure(name: str, **attrs) -> Span:
    """A span that stamps its start and end even while the tracer is off
    (read its ``seconds``), recorded only while on."""
    return _TRACER.measure(name, **attrs)


def records() -> list[Span]:
    return _TRACER.records()


def dropped() -> int:
    return _TRACER.dropped
