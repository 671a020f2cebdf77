"""The server under test, timed: `repro_torch.launch.serve.Server` with
each forward the serve loop drives stamped on the host clock.

`prefill`, `admit_chunk` and `decode_step` each end in the ``.cpu()``
copy of the next tokens, which waits for the card; so a stamp taken when
one returns is the time its tokens exist.  Each call becomes a `Record`:
its kind, its start and end, its width, the rows it carried and the
requests it gave a token; ``slot_of`` keeps the slot each request was
admitted to.  While ``tracing`` is set, each call also runs
inside a profiler range named ``bench.<kind>#<seq>``, so the trace's
device work can be tied to the record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.launch.serve import Server


@dataclasses.dataclass
class Record:
    kind: str                 # "admit" or "decode"
    seq: int
    t0: float
    t1: float
    width: int                # positions per row of the forward
    rows: list                # (slot, depth before, positions carried)
    emitted: list             # request ids given a token at t1


class TimedServer(Server):
    def __init__(self, *args, clock=time.monotonic, **kwargs):
        super().__init__(*args, **kwargs)
        self.clock = clock
        self.records: list[Record] = []
        self.slot_of: dict[int, int] = {}
        self.tracing = False
        self.prompt_len = np.zeros(self.batch, np.int64)

    def _span(self, kind: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(
            f"bench.{kind}#{len(self.records)}")

    def _depth(self, s: int) -> int:
        return int(self.prompt_len[s] + self.slot_len[s])

    def _record(self, kind, t0, width, rows, emitted) -> None:
        self.records.append(Record(kind, len(self.records), t0,
                                   self.clock(), width, rows, emitted))

    def prefill(self, slot, req_id, prompt, gen_len):
        n = int(np.asarray(prompt).size)
        t0 = self.clock()
        with self._span("admit"):
            ok = super().prefill(slot, req_id, prompt, gen_len)
        self.prompt_len[slot] = n
        self.slot_of[int(req_id)] = int(slot)
        self._record("admit", t0, n, [(slot, 0, n)], [req_id] if ok else [])
        return ok

    def admit_chunk(self, admits):
        rode = [(s, self._depth(s), int(self.slot_req[s]))
                for s in range(self.batch) if self.slot_req[s] >= 0]
        width = max(int(np.asarray(p).size) for _, _, p, _ in admits)
        t0 = self.clock()
        with self._span("admit"):
            out = super().admit_chunk(admits)
        ok_admit, _, _, _, bad = out
        rows = [(s, d, 1) for s, d, _ in rode]
        emitted = [rid for s, _, rid in rode if s not in bad]
        for slot, rid, prompt, _ in admits:
            n = int(np.asarray(prompt).size)
            self.prompt_len[slot] = n
            self.slot_of[int(rid)] = int(slot)
            rows.append((slot, 0, n))
            if ok_admit[slot]:
                emitted.append(rid)
        self._record("admit", t0, width, rows, emitted)
        return out

    def decode_step(self, step=0, *, inject=True):
        active = [(s, self._depth(s), int(self.slot_req[s]))
                  for s in range(self.batch) if self.slot_req[s] >= 0]
        t0 = self.clock()
        with self._span("decode"):
            out = super().decode_step(step, inject=inject)
        bad = out[2]
        self._record("decode", t0, 1, [(s, d, 1) for s, d, _ in active],
                     [rid for s, _, rid in active if s not in bad])
        return out
