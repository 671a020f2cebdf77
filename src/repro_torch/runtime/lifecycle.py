"""Request lifecycle for fault-tolerant serving: a state machine with
deadlines, bounded admission, and retry-with-backoff.

Every request a server ever sees moves through

    QUEUED -> PREFILLING -> DECODING -> COMPLETED
       |           |            |
       |           +---- EVICTED ----> QUEUED (retry, backoff)  or  FAILED
       |           |            |
       +-------- TIMED_OUT <----+          (deadline sweep, any open state)

    submit() when the admission queue is full -> REJECTED (backpressure)

and the tracker enforces the edges: an illegal transition is a bug in the
serve loop, not a condition to paper over, so it raises.  Terminal states
are {COMPLETED, TIMED_OUT, FAILED, REJECTED}; EVICTED is transient — the
fault-handling states (slot quarantined after a NaN, kernel fault,
interrupted prefill) resolve to a retry or, once ``max_retries`` is spent,
to FAILED.  The invariant the whole layer exists for is **conservation**:
at drain time every submitted request is in exactly one terminal state,
``submitted == completed + timed_out + failed + rejected`` — a request can
be slow, evicted, or refused, but never silently lost (the failure mode of
the old ``while completed < requests`` loop, which span forever the moment
one request fell out of a slot).

Time enters twice, deliberately separated so chaos runs stay
deterministic: *deadlines* (time-to-first-token and total) are checked
against an injectable wall ``clock``, while *retry backoff* is priced in
decode **steps** (``backoff_steps * 2**(retries-1)``) — the virtual clock
every fault-injection schedule is keyed on.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np


class State(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    COMPLETED = "completed"
    TIMED_OUT = "timed_out"
    EVICTED = "evicted"
    FAILED = "failed"
    REJECTED = "rejected"


TERMINAL = frozenset({State.COMPLETED, State.TIMED_OUT, State.FAILED,
                      State.REJECTED})

# The legal edges.  Initial states (QUEUED / REJECTED) are set by submit();
# terminal states have no exits.
_ALLOWED: dict[State, frozenset[State]] = {
    # QUEUED -> REJECTED is scheduler backpressure: a paged-pool
    # admission policy refuses a request whose KV footprint can never
    # fit the pool (launch/scheduler.py) — loud, terminal, conserved.
    State.QUEUED: frozenset({State.PREFILLING, State.TIMED_OUT,
                             State.REJECTED}),
    State.PREFILLING: frozenset({State.DECODING, State.EVICTED,
                                 State.TIMED_OUT}),
    State.DECODING: frozenset({State.COMPLETED, State.EVICTED,
                               State.TIMED_OUT}),
    State.EVICTED: frozenset({State.QUEUED, State.FAILED}),
}


class TransitionError(RuntimeError):
    """An edge the state machine does not allow — a serve-loop bug."""


@dataclasses.dataclass
class Request:
    """One request's full lifecycle record."""

    rid: int
    prompt: np.ndarray
    gen_len: int
    submit_t: float
    ttft_deadline_s: float | None = None     # seconds after submit_t
    deadline_s: float | None = None          # seconds after submit_t
    state: State = State.QUEUED
    retries: int = 0
    not_before_step: int = 0                 # retry-backoff eligibility
    first_token_t: float | None = None
    finish_t: float | None = None            # clock time of terminal entry
    tokens: list = dataclasses.field(default_factory=list)
    history: list = dataclasses.field(default_factory=list)  # (state, step)

    @property
    def ttft_ms(self) -> float | None:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.submit_t) * 1e3

    @property
    def per_token_ms(self) -> float | None:
        """Mean decode latency per post-first token, on the lifecycle
        clock (virtual-deterministic when a virtual clock is injected)."""
        if self.first_token_t is None or self.finish_t is None:
            return None
        extra = len(self.tokens) - 1
        if extra < 1:
            return None
        return (self.finish_t - self.first_token_t) * 1e3 / extra

    def outcome(self) -> dict:
        """The JSON-able per-request row of the serving summary (and the
        chaos determinism trace: final state + retry count)."""
        return {"rid": self.rid, "state": self.state.value,
                "retries": self.retries, "tokens": len(self.tokens),
                "ttft_ms": (None if self.ttft_ms is None
                            else round(self.ttft_ms, 3))}


class Lifecycle:
    """Tracker + bounded admission queue for every request of a serve run.

    ``queue_limit`` bounds the number of requests *waiting* in the
    admission queue: a submit that would exceed it is REJECTED outright
    (backpressure — the caller hears "no" immediately instead of holding a
    doomed deadline).  Retries re-enter the queue past the bound: an
    admitted request is owed a terminal answer and eviction must not turn
    into silent loss.
    """

    def __init__(self, *, queue_limit: int = 0, max_retries: int = 2,
                 backoff_steps: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 journal=None):
        self.queue_limit = queue_limit
        self.max_retries = max_retries
        self.backoff_steps = backoff_steps
        self.clock = clock
        # Optional write-ahead log (`runtime.journal.Journal`): every
        # submit and state transition is journaled *before* it takes
        # effect, so a crashed serve loop can be replayed deterministically
        # (docs/ROBUSTNESS.md, "Crash recovery").
        self.journal = journal
        self.requests: dict[int, Request] = {}
        self._queue: deque[Request] = deque()
        self.evicted_events = 0
        self.retried_events = 0

    # -- admission ----------------------------------------------------------

    def submit(self, rid: int, prompt, gen_len: int, *,
               ttft_deadline_s: float | None = None,
               deadline_s: float | None = None) -> Request:
        if rid in self.requests:
            raise ValueError(f"duplicate request id {rid}")
        req = Request(rid, np.asarray(prompt), gen_len, self.clock(),
                      ttft_deadline_s=ttft_deadline_s,
                      deadline_s=deadline_s)
        rejected = self.queue_limit and len(self._queue) >= self.queue_limit
        if self.journal is not None:
            # Write-ahead: the admission decision is durable before the
            # caller can observe it.
            self.journal.submit(rid, req.prompt, gen_len,
                                ttft_deadline_s=ttft_deadline_s,
                                deadline_s=deadline_s)
            self.journal.state(rid, (State.REJECTED if rejected
                                     else State.QUEUED).value, -1)
        if rejected:
            req.state = State.REJECTED
            req.finish_t = req.submit_t
            req.history.append((State.REJECTED, -1))
        else:
            req.history.append((State.QUEUED, -1))
            self._queue.append(req)
        self.requests[rid] = req
        return req

    def pop_ready(self, step: int) -> Request | None:
        """Next queued request whose retry backoff has elapsed (FCFS among
        the eligible)."""
        for i, req in enumerate(self._queue):
            if req.not_before_step <= step:
                del self._queue[i]
                return req
        return None

    def eligible(self, step: int) -> list[Request]:
        """Every queued request whose retry backoff has elapsed, in FCFS
        order — the candidate set a pluggable admission policy
        (launch/scheduler.py) picks from."""
        return [r for r in self._queue if r.not_before_step <= step]

    def take(self, req: Request) -> None:
        """Remove a specific request from the admission queue (the
        scheduler admitted it out of FCFS order)."""
        self._queue.remove(req)

    def next_eligible_step(self) -> int | None:
        """Earliest step at which *some* queued request becomes eligible
        (None if the queue is empty) — lets an otherwise-idle loop jump its
        virtual clock instead of spinning empty decode steps."""
        if not self._queue:
            return None
        return min(r.not_before_step for r in self._queue)

    # -- transitions --------------------------------------------------------

    def transition(self, req: Request, new: State, step: int) -> None:
        if new not in _ALLOWED.get(req.state, frozenset()):
            raise TransitionError(
                f"request {req.rid}: illegal transition "
                f"{req.state.value} -> {new.value} at step {step}")
        if self.journal is not None:
            # Write-ahead: the edge is durable before it takes effect.  A
            # QUEUED entry carries the retry-backoff eligibility so a
            # recovery reconstructs the backoff schedule exactly.
            self.journal.state(
                req.rid, new.value, step, retries=req.retries,
                **({"not_before_step": req.not_before_step}
                   if new is State.QUEUED else {}))
        req.state = new
        if new in TERMINAL:
            req.finish_t = self.clock()
        req.history.append((new, step))

    def record_first_token(self, req: Request) -> None:
        req.first_token_t = self.clock()

    def evict(self, req: Request, step: int, reason: str = "") -> bool:
        """Quarantine a request (NaN slot, kernel fault, interrupted
        prefill): EVICTED, then either requeued with exponential step
        backoff (returns True) or FAILED once retries are spent.  A
        retried request starts over — its tokens are discarded so the
        retry reproduces solo decode token-for-token from a fresh slot."""
        self.transition(req, State.EVICTED, step)
        self.evicted_events += 1
        req.tokens = []
        if req.retries < self.max_retries:
            req.retries += 1
            req.not_before_step = (
                step + self.backoff_steps * 2 ** (req.retries - 1))
            self.transition(req, State.QUEUED, step)
            self._queue.append(req)
            self.retried_events += 1
            return True
        self.transition(req, State.FAILED, step)
        return False

    def reject(self, req: Request, step: int) -> None:
        """Backpressure a QUEUED request out of the system entirely —
        used by the paged-pool scheduler when a request's predicted KV
        footprint exceeds what the pool could ever hold.  Terminal and
        conserved, never silently dropped."""
        if req in self._queue:
            self._queue.remove(req)
        self.transition(req, State.REJECTED, step)

    def check_deadlines(self, step: int) -> list[Request]:
        """Sweep every open request against its deadlines; newly
        TIMED_OUT requests are returned so the loop can free their slots
        (queued ones are dropped from the admission queue here)."""
        now = self.clock()
        expired = []
        for req in self.requests.values():
            if req.state in TERMINAL or req.state is State.EVICTED:
                continue
            waited = now - req.submit_t
            over_total = (req.deadline_s is not None
                          and waited > req.deadline_s)
            over_ttft = (req.ttft_deadline_s is not None
                         and req.first_token_t is None
                         and waited > req.ttft_deadline_s)
            if over_total or over_ttft:
                if req in self._queue:
                    self._queue.remove(req)
                self.transition(req, State.TIMED_OUT, step)
                expired.append(req)
        return expired

    # -- accounting ---------------------------------------------------------

    def open_requests(self) -> list[Request]:
        return [r for r in self.requests.values() if r.state not in TERMINAL]

    def open_count(self) -> int:
        return len(self.open_requests())

    def counters(self) -> dict:
        by_state = {s.value: 0 for s in
                    (State.COMPLETED, State.TIMED_OUT, State.FAILED,
                     State.REJECTED)}
        for r in self.requests.values():
            if r.state in TERMINAL:
                by_state[r.state.value] += 1
        by_state["evicted"] = self.evicted_events
        by_state["retried"] = self.retried_events
        return by_state

    @property
    def submitted(self) -> int:
        return len(self.requests)

    def conserved(self) -> bool:
        """submitted == completed + timed_out + failed + rejected — every
        request in exactly one terminal state."""
        c = self.counters()
        terminal = (c["completed"] + c["timed_out"] + c["failed"]
                    + c["rejected"])
        return terminal == self.submitted

    def ttft_percentiles(self) -> dict:
        return _percentiles([r.ttft_ms for r in self.requests.values()
                             if r.ttft_ms is not None])

    def per_token_percentiles(self) -> dict:
        return _percentiles([r.per_token_ms for r in self.requests.values()
                             if r.per_token_ms is not None])

    def outcome_trace(self) -> list[dict]:
        """Per-request final states + retry counts, rid-ordered — the
        record chaos determinism is asserted on."""
        return [self.requests[rid].outcome()
                for rid in sorted(self.requests)]

    def table(self) -> str:
        """Human-readable lifecycle table — what the no-progress guard
        prints instead of spinning forever."""
        lines = [f"{'rid':>5}  {'state':<11} {'retries':>7}  {'tokens':>6}  "
                 f"history"]
        for rid in sorted(self.requests):
            r = self.requests[rid]
            hist = " -> ".join(f"{s.value}@{step}" for s, step in r.history)
            lines.append(f"{rid:>5}  {r.state.value:<11} {r.retries:>7}  "
                         f"{len(r.tokens):>6}  {hist}")
        return "\n".join(lines)


def _percentiles(vals: list) -> dict:
    if not vals:
        return {"p50": None, "p99": None, "n": 0}
    p50, p99 = np.percentile(vals, [50, 99])
    return {"p50": round(float(p50), 3), "p99": round(float(p99), 3),
            "n": len(vals)}


def submit_all(lc: Lifecycle, requests: Sequence[tuple], *,
               ttft_deadline_s: float | None = None,
               deadline_s: float | None = None) -> None:
    """Admit a [(rid, prompt, gen_len)] batch (the CLI's arrival model:
    everything at t0)."""
    for rid, prompt, gen_len in requests:
        lc.submit(rid, prompt, gen_len, ttft_deadline_s=ttft_deadline_s,
                  deadline_s=deadline_s)
