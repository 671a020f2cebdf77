"""One generator for every traffic mix: a mix is a data file under
``bench/traffic/``, and this module turns it and a seed into requests.

Lengths.  A ``uniform`` distribution over ``lo..hi`` (both included, as
`repro_torch.runtime.loadgen.sample_lengths` draws it) is not drawn at
random here: request j takes the quantile ``frac((j + 1/2) * a)`` of it,
a Kronecker sequence, every prefix of which spreads evenly over the
range.  Prompt and output lengths use two rationally independent steps
``a``, so they are not correlated.  The lengths and their order are the mix's and the same for every
seed: in a closed loop the order of the lengths decides which requests
finish together and so how many admissions a window holds, and a seeded
order made the work of a window differ from seed to seed by more than
the run-to-run noise (PERF.md, PR 28).

Tokens.  A request's prompt is uniform over the vocabulary, drawn by
numpy from ``(seed, rid)``; the weights come from the seed too
(`bench.weights`).

Loop.  ``closed``: each of ``clients`` clients keeps one request in the
system; when it completes, the client submits its next request at the
next pump (``think_s`` 0).  Client c's k-th request is request
``k * clients + c`` of the sequence.  The first request of client c has
its output length cut to a share ``(p(c) + 1/2) / clients`` of its
length, ``p`` a fixed permutation of the clients, so the remaining
outputs are staggered evenly when the window opens and completions
spread through it.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
SILVER = math.sqrt(2.0) - 1.0


class WindowClosed(Exception):
    """Raised by `ClosedLoop.pump` once the measured window has ended:
    the serve loop lets it through, so the run stops with no drain."""


def length(dist: dict, u: float) -> int:
    """The length at quantile ``u`` in [0, 1) of ``dist``."""
    if dist["kind"] != "uniform":
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    lo, hi = int(dist["lo"]), int(dist["hi"])
    return lo + min(int(u * (hi - lo + 1)), hi - lo)


def mean(dist: dict) -> float:
    return (int(dist["lo"]) + int(dist["hi"])) / 2.0


class Plan:
    """The requests of one mix: lengths by request index (the same for
    every seed), prompts by request id (from the seed)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix["loop"] != "closed" or float(mix.get("think_s", 0)) != 0:
            raise ValueError("only closed loops with no think time are "
                             "generated")
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.clients = int(mix["clients"])
        self.stagger = np.random.default_rng(0).permutation(self.clients)

    def lengths(self, j: int) -> tuple[int, int]:
        """(prompt, output) of request index ``j``."""
        up = ((j + 0.5) * GOLDEN) % 1.0
        uo = ((j + 0.5) * SILVER) % 1.0
        prompt = length(self.mix["prompt"], up)
        out = length(self.mix["output"], uo)
        if j < self.clients:
            share = (self.stagger[j] + 0.5) / self.clients
            out = max(1, math.ceil(share * out))
        return prompt, out

    def warm_prompt(self, i: int, n: int) -> np.ndarray:
        """A set-up prompt, drawn apart from every request's."""
        return self.prompt((1 << 62) + i, n)

    def prompt(self, rid: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed % (1 << 64), 4, int(rid)]))
        return rng.integers(0, self.vocab, size=n, dtype=np.int64).astype(
            np.int32)


class ClosedLoop:
    """The arrival source `serve_loop` pumps (``pump``, ``exhausted``,
    ``next_arrival_step``).

    The window opens at the first pump at which every client's first
    request has its first token, and closes ``seconds`` later: the pump
    after that raises `WindowClosed`.  ``on_pump(now)``, called at the
    end of every pump, lets the caller act inside the window (the
    profiler of a traced run), and each pump runs inside ``span()``.
    Times are ``clock()``'s, the lifecycle's clock."""

    def __init__(self, plan: Plan, seconds: float, *, clock=time.monotonic,
                 on_pump=None, span=contextlib.nullcontext):
        self.plan, self.seconds, self.clock = plan, float(seconds), clock
        self.on_pump, self.span = on_pump, span
        self.t_open = self.t_close = None
        self.current = [None] * plan.clients      # open rid of each client
        self.count = [0] * plan.clients           # requests each submitted

    def pump(self, lc, step: int) -> None:
        with self.span():
            self._pump(lc)

    def _pump(self, lc) -> None:
        now = self.clock()
        if self.t_close is not None and now >= self.t_close:
            raise WindowClosed
        n = self.plan.clients
        for c in range(n):
            rid = self.current[c]
            if rid is not None and lc.requests[rid].finish_t is None:
                continue                      # still in the system
            rid = self.count[c] * n + c
            self.count[c] += 1
            prompt_len, out = self.plan.lengths(rid)
            lc.submit(rid, self.plan.prompt(rid, prompt_len), out)
            self.current[c] = rid
        if self.t_open is None and all(
                lc.requests[r].first_token_t is not None for r in range(n)):
            self.t_open, self.t_close = now, now + self.seconds
        if self.on_pump is not None:
            self.on_pump(now)

    def exhausted(self) -> bool:
        return False

    def next_arrival_step(self, lc, step: int) -> int:
        return step + 1


class Burst:
    """A warm-up source: ``requests`` (``(prompt, output)`` pairs)
    submitted at the first pump, then nothing."""

    def __init__(self, requests):
        self.requests = list(requests)
        self.done = False

    def pump(self, lc, step: int) -> None:
        if not self.done:
            for rid, (prompt, out) in enumerate(self.requests):
                lc.submit(rid, prompt, out)
            self.done = True

    def exhausted(self) -> bool:
        return self.done

    def next_arrival_step(self, lc, step: int):
        return None
