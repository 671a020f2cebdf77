"""Seeded, traffic-shaped load generation for the serving loop (numpy
and the standard library only).  Counterpart of `repro.runtime.loadgen`:
the same traces, samples and metrics, bit for bit, for the same seeds.

* :func:`make_trace`: a seeded request trace, Poisson arrivals at a
  given rate, prompt and output lengths from declarative distributions
  (``fixed``, ``uniform``, ``choice``, ``staggered``, ``lognormal``), and
  think times for closed-loop sessions.
* :class:`VirtualClock`: a clock driven by the serve loop's step
  counter; one loop step advances it by ``step_time_s`` (the tuner's
  predicted decode step), so latencies are model milliseconds and
  byte-reproducible.
* :class:`TraceSource` and :class:`SessionSource`: the open-loop and
  closed-loop arrival pumps the serve loop drains, each recording its
  queue-depth timeline.
* :func:`collect_metrics`: a mix's report row: TTFT and per-token
  percentiles, tokens/s on the virtual clock, the queue-depth timeline
  and per-request predicted-against-measured step times.

Wall-clock fields are volatile and listed in :data:`VOLATILE_FIELDS`;
:func:`strip_volatile` drops them, leaving the reproducible part.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import numpy as np

from repro_torch.runtime.lifecycle import Lifecycle, State

# Report fields allowed to vary run-to-run (wall-clock derived).  Every
# other field of a mix report is covered by the determinism contract:
# same trace seed + same fault seed => byte-identical values.
VOLATILE_FIELDS = frozenset({
    "wall",                   # the whole wall-clock block of a mix report
    "wall_s", "wall_tok_per_s",
    "measured_step_us",       # per-request measured decode-step time
    "step_time_ratio",        # measured / predicted, per request
    "measured_step_us_p50",   # mix-level watchdog median
    "divergence",             # measured / predicted, mix level
    "stragglers",             # wall-clock watchdog reports
})


def strip_volatile(obj):
    """Recursively drop every VOLATILE_FIELDS key — the deterministic
    projection of a report, the thing regression tests compare."""
    if isinstance(obj, dict):
        return {k: strip_volatile(v) for k, v in obj.items()
                if k not in VOLATILE_FIELDS}
    if isinstance(obj, (list, tuple)):
        return [strip_volatile(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# virtual clock
# ---------------------------------------------------------------------------

# Floor for the virtual clock's per-step time: smoke-sized configs predict
# sub-microsecond decode steps, and every latency row is rounded to
# 1e-3 ms — without a floor the whole report would collapse to zeros.
# One model-millisecond per step keeps virtual latencies readable (TTFT in
# ms == steps waited) and never binds for a real config, whose predicted
# step is always far above 1 ms.
MIN_VIRTUAL_STEP_US = 1000.0


def virtual_step_us(predicted_us: float) -> float:
    """The step time a VirtualClock should run at for a given predicted
    decode-step time (the floor above applied)."""
    return max(float(predicted_us), MIN_VIRTUAL_STEP_US)


class VirtualClock:
    """A lifecycle clock driven by the serve loop's decode-step counter.

    `serve_loop` calls ``on_step(step)`` at the top of every iteration
    (including virtual-clock jumps over retry backoff or idle arrival
    gaps), so time is a pure function of loop progress: deadlines, TTFT,
    and per-token latencies all become deterministic.  ``step_time_s`` is
    the cost charged per loop step — use the tuner's predicted
    decode-step time to get latencies in model-milliseconds.
    """

    def __init__(self, step_time_s: float, start_s: float = 0.0):
        if step_time_s <= 0:
            raise ValueError(f"step_time_s must be positive, got "
                             f"{step_time_s}")
        self.step_time_s = float(step_time_s)
        self.start_s = float(start_s)
        self.step = 0

    def on_step(self, step: int) -> None:
        self.step = int(step)

    def step_for(self, t_s: float) -> int:
        """First step index at which the clock reads >= ``t_s`` — how an
        idle serve loop jumps straight to the next arrival."""
        if t_s <= self.start_s:
            return 0
        return int(math.ceil((t_s - self.start_s) / self.step_time_s))

    def __call__(self) -> float:
        return self.start_s + self.step * self.step_time_s


# ---------------------------------------------------------------------------
# trace generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request of a load trace (lengths only — prompt *tokens* are
    derived deterministically from the trace seed + rid at submit time,
    keeping trace files compact and replayable)."""

    rid: int
    arrival_s: float          # open-loop arrival time on the trace clock
    prompt_len: int
    gen_len: int
    think_s: float = 0.0      # closed-loop: wait after the previous
                              # request of the session terminates
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None

    def record(self) -> dict:
        return dataclasses.asdict(self)


def sample_lengths(rng: np.random.Generator, n: int, dist: dict) -> list[int]:
    """Draw ``n`` integer lengths from a declarative distribution spec:

    ``{"kind": "fixed", "value": v}``
    ``{"kind": "uniform", "lo": a, "hi": b}``           (inclusive)
    ``{"kind": "choice", "values": [...], "weights": [...]?}``
    ``{"kind": "staggered", "base": p, "spread": g}`` — the deterministic
    ramp ``p + (2i+1)*g // 2n`` over the request index: the steady-state
    slot-depth mix `launch.serve` builds for its batch sweep, as an
    arrival-order length pattern.
    ``{"kind": "lognormal", "mean": m, "sigma": s, "lo": a, "hi": b}`` —
    the heavy-tail production shape: most requests are short, a few are
    very long (``exp(N(ln m, s))``, rounded and clamped to [a, b]).
    This is the mix where a paged KV cache beats per-slot worst-case
    allocation — the tail sets the contiguous reservation, the body
    wastes it (the JAX package's docs/PAGING.md).
    """
    kind = dist["kind"]
    if kind == "fixed":
        return [int(dist["value"])] * n
    if kind == "uniform":
        return [int(x) for x in
                rng.integers(int(dist["lo"]), int(dist["hi"]) + 1, size=n)]
    if kind == "choice":
        return [int(x) for x in rng.choice(dist["values"], size=n,
                                           p=dist.get("weights"))]
    if kind == "staggered":
        base, spread = int(dist["base"]), int(dist["spread"])
        return [base + ((2 * i + 1) * spread) // (2 * n) for i in range(n)]
    if kind == "lognormal":
        lo = int(dist.get("lo", 1))
        hi = int(dist["hi"])
        draws = rng.lognormal(mean=np.log(float(dist["mean"])),
                              sigma=float(dist["sigma"]), size=n)
        return [int(np.clip(round(x), lo, hi)) for x in draws]
    raise ValueError(f"unknown length distribution kind {kind!r}")


def sample_times(rng: np.random.Generator, n: int, dist: dict) -> list[float]:
    """Float-valued sibling of :func:`sample_lengths` for think times:
    ``fixed`` / ``uniform`` / ``exponential`` (``{"mean": m}``)."""
    kind = dist["kind"]
    if kind == "fixed":
        return [float(dist["value"])] * n
    if kind == "uniform":
        return [float(x) for x in
                rng.uniform(float(dist["lo"]), float(dist["hi"]), size=n)]
    if kind == "exponential":
        return [float(x) for x in rng.exponential(float(dist["mean"]),
                                                  size=n)]
    raise ValueError(f"unknown time distribution kind {kind!r}")


def make_trace(*, seed: int, n: int, rate_rps: float, prompt_dist: dict,
               gen_dist: dict, think_dist: dict | None = None,
               start_s: float = 0.0,
               ttft_deadline_s: float | None = None,
               deadline_s: float | None = None) -> list[TraceRequest]:
    """A seeded Poisson request trace: inter-arrival gaps are exponential
    at ``rate_rps`` (``rate_rps <= 0`` = everything arrives at
    ``start_s``), lengths drawn per the distribution specs.  Same seed,
    same trace — the determinism the whole harness gates on."""
    rng = np.random.default_rng(seed)
    if rate_rps > 0:
        gaps = rng.exponential(1.0 / rate_rps, size=n)
        arrivals = start_s + np.cumsum(gaps)
    else:
        arrivals = np.full(n, start_s)
    prompts = sample_lengths(rng, n, prompt_dist)
    gens = sample_lengths(rng, n, gen_dist)
    thinks = (sample_times(rng, n, think_dist) if think_dist is not None
              else [0.0] * n)
    return [TraceRequest(rid=i, arrival_s=float(arrivals[i]),
                         prompt_len=max(1, prompts[i]),
                         gen_len=max(1, gens[i]), think_s=thinks[i],
                         ttft_deadline_s=ttft_deadline_s,
                         deadline_s=deadline_s)
            for i in range(n)]


def save_trace(path, trace: list[TraceRequest]) -> None:
    """One JSON object per line: the JAX package's trace format
    (its docs/SERVING_BENCH.md)."""
    with open(path, "w") as f:
        for t in trace:
            f.write(json.dumps(t.record()) + "\n")


class TraceError(ValueError):
    """A corrupt trace file — raised with the line number and payload so
    a bad trace fails loudly instead of silently serving a subset."""


def load_trace(path) -> list[TraceRequest]:
    """Load a JSONL trace, failing loudly on corruption.

    Every malformed line raises :class:`TraceError` with its line number
    and (truncated) payload.  A malformed **final** line with no trailing
    newline is reported distinctly — it is the torn-write signature of a
    producer killed mid-append, which calls for regenerating the trace,
    not for debugging the generator."""
    path = pathlib.Path(path)
    raw = path.read_text()
    lines = raw.split("\n")
    # split() leaves a trailing "" when the file ends in a newline; a
    # non-empty last element means the final line was never terminated.
    unterminated = bool(lines) and lines[-1] != ""
    if not unterminated and lines:
        lines.pop()
    trace = []
    for ln, line in enumerate(lines, start=1):
        if not line.strip():
            continue
        torn = unterminated and ln == len(lines)
        try:
            trace.append(TraceRequest(**json.loads(line)))
        except (ValueError, TypeError) as e:
            if torn:
                raise TraceError(
                    f"{path}:{ln}: partial final line (producer killed "
                    f"mid-write? regenerate the trace): {e}; payload: "
                    f"{line[:200]!r}") from None
            raise TraceError(
                f"{path}:{ln}: corrupt trace line: {e}; payload: "
                f"{line[:200]!r}") from None
    return trace


def sessions_from_trace(trace: list[TraceRequest],
                        n_sessions: int) -> list[list[TraceRequest]]:
    """Round-robin a trace into ``n_sessions`` closed-loop sessions
    (order within a session preserved)."""
    sessions: list[list[TraceRequest]] = [[] for _ in range(n_sessions)]
    for i, t in enumerate(trace):
        sessions[i % n_sessions].append(t)
    return [s for s in sessions if s]


def prompt_tokens(seed: int, rid: int, prompt_len: int,
                  vocab_size: int) -> np.ndarray:
    """Deterministic prompt tokens for a trace request — a pure function
    of (trace seed, rid), so a replay regenerates the same prompts."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, rid]))
    return rng.integers(0, vocab_size, size=prompt_len, dtype=np.int64)


# ---------------------------------------------------------------------------
# arrival sources (what serve_loop pumps)
# ---------------------------------------------------------------------------

class _SourceBase:
    """Queue-depth sampling shared by both sources: one (step, queued,
    open) row whenever the counts change, capped so a runaway trace can't
    bloat the report."""

    MAX_SAMPLES = 4096

    def __init__(self, vocab_size: int, seed: int):
        self.vocab_size = vocab_size
        self.seed = seed
        self.queue_depth: list[tuple[int, int, int]] = []
        self.submitted = 0

    def _submit(self, lc: Lifecycle, t: TraceRequest) -> None:
        lc.submit(t.rid,
                  prompt_tokens(self.seed, t.rid, t.prompt_len,
                                self.vocab_size),
                  t.gen_len, ttft_deadline_s=t.ttft_deadline_s,
                  deadline_s=t.deadline_s)
        self.submitted += 1

    def _sample(self, lc: Lifecycle, step: int) -> None:
        row = (int(step), len(lc._queue), lc.open_count())
        if ((not self.queue_depth or self.queue_depth[-1][1:] != row[1:])
                and len(self.queue_depth) < self.MAX_SAMPLES):
            self.queue_depth.append(row)


class TraceSource(_SourceBase):
    """Open-loop arrivals: each trace request is submitted at the first
    loop step whose clock reading reaches its ``arrival_s`` — the classic
    Poisson load test (arrivals don't wait for completions)."""

    def __init__(self, trace: list[TraceRequest], vocab_size: int, *,
                 seed: int = 0):
        super().__init__(vocab_size, seed)
        self.trace = sorted(trace, key=lambda t: (t.arrival_s, t.rid))
        self._i = 0

    def pump(self, lc: Lifecycle, step: int) -> None:
        now = lc.clock()
        while self._i < len(self.trace) and \
                self.trace[self._i].arrival_s <= now:
            self._submit(lc, self.trace[self._i])
            self._i += 1
        self._sample(lc, step)

    def exhausted(self) -> bool:
        return self._i >= len(self.trace)

    def skip_submitted(self, lc: Lifecycle) -> int:
        """Re-cursor for `serve --resume`: advance past every trace
        request the restored lifecycle already knows.  Arrival cursors are
        not persisted — the journal is — so a resumed source must simply
        never re-submit a journaled rid.  Returns the skip count."""
        skipped = 0
        while self._i < len(self.trace) and \
                self.trace[self._i].rid in lc.requests:
            self._i += 1
            skipped += 1
        self.submitted += skipped
        return skipped

    def next_arrival_step(self, lc: Lifecycle, step: int) -> int | None:
        """Step to jump an idle loop to (None once exhausted).  Without a
        step-addressable clock the loop can only step forward one at a
        time and let the wall clock catch up."""
        if self.exhausted():
            return None
        step_for = getattr(lc.clock, "step_for", None)
        if step_for is None:
            return step + 1
        return max(step + 1, step_for(self.trace[self._i].arrival_s))


class SessionSource(_SourceBase):
    """Closed-loop think-time sessions: within a session, request ``i+1``
    becomes eligible ``think_s`` after request ``i`` reached a terminal
    state (its ``finish_t`` on the lifecycle clock).  The first request
    of each session uses its open-loop ``arrival_s``.  This is the
    interactive-user model: a slow server *slows its own offered load*,
    which an open-loop trace cannot express."""

    def __init__(self, sessions: list[list[TraceRequest]], vocab_size: int,
                 *, seed: int = 0):
        super().__init__(vocab_size, seed)
        self.sessions = [list(s) for s in sessions if s]
        self._idx = [0] * len(self.sessions)

    def _arrival(self, lc: Lifecycle, si: int) -> float | None:
        """Eligibility time of session si's next request; None when the
        session is done or its predecessor hasn't terminated yet."""
        i = self._idx[si]
        sess = self.sessions[si]
        if i >= len(sess):
            return None
        if i == 0:
            return sess[0].arrival_s
        prev = lc.requests.get(sess[i - 1].rid)
        if prev is None or prev.finish_t is None:
            return None
        return prev.finish_t + sess[i].think_s

    def pump(self, lc: Lifecycle, step: int) -> None:
        now = lc.clock()
        progress = True
        while progress:   # a submit can unblock nothing mid-pump, but a
            progress = False   # REJECTED terminates instantly — resweep
            for si in range(len(self.sessions)):
                t_arr = self._arrival(lc, si)
                if t_arr is not None and t_arr <= now:
                    self._submit(lc, self.sessions[si][self._idx[si]])
                    self._idx[si] += 1
                    progress = True
        self._sample(lc, step)

    def exhausted(self) -> bool:
        return all(i >= len(s) for i, s in zip(self._idx, self.sessions))

    def skip_submitted(self, lc: Lifecycle) -> int:
        """Per-session sibling of `TraceSource.skip_submitted` (resume
        re-cursor): advance each session past its journaled requests."""
        skipped = 0
        for si, sess in enumerate(self.sessions):
            while self._idx[si] < len(sess) and \
                    sess[self._idx[si]].rid in lc.requests:
                self._idx[si] += 1
                skipped += 1
        self.submitted += skipped
        return skipped

    def next_arrival_step(self, lc: Lifecycle, step: int) -> int | None:
        arrivals = [a for si in range(len(self.sessions))
                    if (a := self._arrival(lc, si)) is not None]
        if not arrivals:
            return None
        step_for = getattr(lc.clock, "step_for", None)
        if step_for is None:
            return step + 1
        return max(step + 1, step_for(min(arrivals)))


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

class StepTimeRecorder:
    """Watchdog shim recording *every* decode step's wall time (the
    rolling-median watchdog only keeps a window) so per-request
    predicted-vs-measured rows can be built after the run.  Forwards to a
    wrapped DecodeWatchdog when given one."""

    def __init__(self, watchdog=None):
        self.watchdog = watchdog
        self.times: dict[int, float] = {}

    def observe(self, step: int, step_time_s: float):
        self.times[int(step)] = float(step_time_s)
        if self.watchdog is not None:
            return self.watchdog.observe(step, step_time_s)
        return None

    def summary(self) -> dict:
        if self.watchdog is not None:
            return self.watchdog.summary()
        return {"predicted_step_us": None, "measured_step_us_p50": None,
                "divergence": None, "stragglers": []}


def _decode_span(req) -> tuple[int, int] | None:
    """(first decode step, terminal step) of a request's *final* attempt
    (retries restart the span), for attributing wall step times."""
    start = None
    for state, step in req.history:
        if state is State.DECODING:
            start = step
    if start is None or not req.history:
        return None
    end = req.history[-1][1]
    return (start, end) if end >= start else None


def collect_metrics(lc: Lifecycle, *, predicted_step_us: float | None = None,
                    step_times: dict[int, float] | None = None,
                    queue_depth: list | None = None) -> dict:
    """The per-mix measurement block of BENCH_serving.json: latency
    percentiles and throughput on the lifecycle clock (deterministic
    under a VirtualClock), queue-depth timeline, and per-request rows
    with predicted-vs-measured decode-step time (wall-derived fields are
    VOLATILE_FIELDS)."""
    rows = []
    for rid in sorted(lc.requests):
        r = lc.requests[rid]
        row = r.outcome()
        row["per_token_ms"] = (None if r.per_token_ms is None
                               else round(r.per_token_ms, 3))
        if step_times:
            span = _decode_span(r)
            vals = ([step_times[s] for s in range(span[0], span[1] + 1)
                     if s in step_times] if span else [])
            if vals:
                measured_us = float(np.mean(vals)) * 1e6
                row["measured_step_us"] = round(measured_us, 1)
                if predicted_step_us:
                    row["step_time_ratio"] = round(
                        measured_us / predicted_step_us, 3)
        rows.append(row)

    tokens_total = sum(len(r.tokens) for r in lc.requests.values())
    starts = [r.submit_t for r in lc.requests.values()]
    finishes = [r.finish_t for r in lc.requests.values()
                if r.finish_t is not None]
    span_s = (max(finishes) - min(starts)) if starts and finishes else None
    tok_per_s = (tokens_total / span_s if span_s else None)

    pvm = {"predicted_step_us": (None if predicted_step_us is None
                                 else round(predicted_step_us, 3))}
    if step_times:
        med_us = float(np.median(list(step_times.values()))) * 1e6
        pvm["measured_step_us_p50"] = round(med_us, 1)
        if predicted_step_us:
            pvm["divergence"] = round(med_us / predicted_step_us, 3)

    queue_depth = list(queue_depth or [])
    return {
        "submitted": lc.submitted,
        "outcomes": lc.counters(),
        "conserved": lc.conserved(),
        "tokens_total": tokens_total,
        "ttft_ms": lc.ttft_percentiles(),
        "per_token_ms": lc.per_token_percentiles(),
        "span_s": None if span_s is None else round(span_s, 6),
        "tok_per_s": None if tok_per_s is None else round(tok_per_s, 3),
        "queue_depth": [list(q) for q in queue_depth],
        "queue_depth_max": max((q[1] for q in queue_depth), default=0),
        "predicted_vs_measured": pvm,
        "requests": rows,
    }
