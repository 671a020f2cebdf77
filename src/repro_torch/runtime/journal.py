"""Append-only request journal: the write-ahead log of the serving loop
(numpy and the standard library only).  Counterpart of
`repro.runtime.journal`, with the JAX package's record format, so
``tools/check_serve.py --recovery`` folds the port's journal and the port
folds the JAX package's.

The serve loop must be able to die at any decode step and come back
without losing a request or emitting a token twice.  The journal is half
of that: an append-only JSONL log of lifecycle transitions and emitted
tokens, each written *before* its effect becomes visible.  After a crash
it is the record of what the outside world may already have seen.  The
other half is `runtime.snapshot`, which bounds the tail a recovery
replays.

Record kinds (each also carries a ``seq`` the writer stamps, rising by
one):

``submit``      rid, prompt (token ids), gen_len, deadlines.
``state``       rid, state, step: one per lifecycle transition.
``token``       rid, i (index into the request's token list), tok, step:
                one per emitted token, written before the token is
                appended to the request.  Token ids are Python ints.
``snapshot``    step, path: the commit marker of a snapshot that covers
                every record of smaller ``seq``.

A process dying mid-append leaves a partial final line; the reader drops
exactly that (the write never happened).  A malformed line anywhere else
is corruption and raises :class:`JournalError`.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np

RECORD_KINDS = ("submit", "state", "token", "snapshot")


class JournalError(RuntimeError):
    """Corrupt journal interior — not the partial-final-line crash
    signature, which the reader absorbs silently."""


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return [int(x) for x in v.tolist()]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class Journal:
    """Append-only JSONL writer with atomic, durable appends.

    Each :meth:`append` writes one complete line and flushes it to the OS
    (plus ``fsync`` unless ``durable=False`` — tests that append thousands
    of records can opt out; the serve loop keeps the default).  A line is
    the atomicity unit: the reader discards a torn final line, so a crash
    mid-append loses only the record being written — whose effect, by the
    write-ahead discipline, was not yet externally visible.
    """

    def __init__(self, path, *, durable: bool = True):
        self.path = pathlib.Path(path)
        self.durable = durable
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.seq = 0
        if self.path.exists():
            # Resume appending after existing committed records; a torn
            # final line is truncated away so the next append starts on a
            # clean line boundary.
            records, torn = read_journal(self.path, return_torn=True)
            self.seq = (records[-1]["seq"] + 1) if records else 0
            if torn is not None:
                good = "".join(json.dumps(r, sort_keys=True) + "\n"
                               for r in records)
                self.path.write_text(good)
        self._f = open(self.path, "a")

    def append(self, kind: str, **fields) -> dict:
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown journal record kind {kind!r}")
        rec = {"kind": kind, "seq": self.seq,
               **{k: _jsonable(v) for k, v in fields.items()}}
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        if self.durable:
            os.fsync(self._f.fileno())
        self.seq += 1
        return rec

    # -- convenience wrappers (the serve loop's write-ahead points) --------

    def submit(self, rid: int, prompt, gen_len: int, *,
               ttft_deadline_s=None, deadline_s=None) -> dict:
        return self.append("submit", rid=rid, prompt=np.asarray(prompt),
                           gen_len=gen_len, ttft_deadline_s=ttft_deadline_s,
                           deadline_s=deadline_s)

    def state(self, rid: int, state: str, step: int, *, retries: int = 0,
              not_before_step: int | None = None) -> dict:
        extra = ({} if not_before_step is None
                 else {"not_before_step": not_before_step})
        return self.append("state", rid=rid, state=state, step=step,
                           retries=retries, **extra)

    def token(self, rid: int, i: int, tok: int, step: int) -> dict:
        return self.append("token", rid=rid, i=i, tok=tok, step=step)

    def snapshot(self, step: int, path: str) -> dict:
        return self.append("snapshot", step=step, path=str(path))

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.durable:
                os.fsync(self._f.fileno())
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_journal(path, *, return_torn: bool = False):
    """Read every committed record of a journal, tolerating the
    crash-truncation signature.

    Returns the record list, or ``(records, torn)`` with
    ``return_torn=True`` where ``torn`` is the dropped partial final line
    (None for a clean log).  Raises :class:`JournalError` — with line
    number and offending payload — for a malformed line that is *not* the
    final one, or for records whose ``seq`` is missing or out of order
    (interior truncation: records were lost, not merely torn).
    """
    path = pathlib.Path(path)
    raw = path.read_text() if path.exists() else ""
    lines = raw.split("\n")
    # split() leaves a trailing "" when the file ends in a newline — the
    # clean-shutdown shape.  A non-empty last element = no trailing
    # newline = a torn final append.
    torn = lines.pop() if lines and lines[-1] != "" else None
    records: list[dict] = []
    expect = None
    for ln, line in enumerate(lines, start=1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise JournalError(
                f"{path}:{ln}: corrupt journal line (not the torn-final-"
                f"line crash signature): {e}; payload: {line[:200]!r}"
            ) from None
        if not isinstance(rec, dict) or not isinstance(rec.get("seq"), int):
            raise JournalError(
                f"{path}:{ln}: journal record without integer 'seq': "
                f"{line[:200]!r}")
        if expect is not None and rec["seq"] != expect:
            raise JournalError(
                f"{path}:{ln}: journal seq jumped {expect} -> "
                f"{rec['seq']} — interior records lost")
        expect = rec["seq"] + 1
        records.append(rec)
    if torn is not None:
        try:
            rec = json.loads(torn)
            # parseable but newline-less: the crash hit between the
            # payload and the newline — still a torn append; keep it,
            # it is complete.
            if isinstance(rec, dict) and isinstance(rec.get("seq"), int) \
                    and (expect is None or rec["seq"] == expect):
                records.append(rec)
                torn = None
        except ValueError:
            pass        # genuinely truncated JSON: drop it
    return (records, torn) if return_torn else records


def replay(records: list[dict]) -> dict:
    """Fold a journal into per-request recovery state.

    Returns ``{rid: {"prompt": [...], "gen_len": int, "state": str,
    "retries": int, "tokens": [...], "last_step": int,
    "ttft_deadline_s": ..., "deadline_s": ...}}`` — the view `serve
    --resume` rebuilds the lifecycle and in-flight slots from.  Token
    records are applied by index (``i``), so a re-emitted token after an
    eviction (retries discard partial output) overwrites instead of
    duplicating.
    """
    reqs: dict[int, dict] = {}
    for rec in records:
        kind = rec["kind"]
        if kind == "submit":
            reqs[rec["rid"]] = {
                "prompt": list(rec["prompt"]), "gen_len": rec["gen_len"],
                "state": "queued", "retries": 0, "tokens": [],
                "last_step": 0, "not_before_step": 0,
                "ttft_deadline_s": rec.get("ttft_deadline_s"),
                "deadline_s": rec.get("deadline_s"),
            }
        elif kind == "state":
            r = reqs.get(rec["rid"])
            if r is None:
                raise JournalError(
                    f"state record for unknown rid {rec['rid']} "
                    f"(seq {rec['seq']}) — journal tail without its head")
            r["state"] = rec["state"]
            r["retries"] = rec.get("retries", r["retries"])
            r["last_step"] = rec["step"]
            if rec["state"] == "queued":
                r["not_before_step"] = rec.get("not_before_step", 0)
                if r["tokens"]:
                    r["tokens"] = []  # eviction requeue discards output
        elif kind == "token":
            r = reqs.get(rec["rid"])
            if r is None:
                raise JournalError(
                    f"token record for unknown rid {rec['rid']} "
                    f"(seq {rec['seq']})")
            i = rec["i"]
            del r["tokens"][i:]
            if i != len(r["tokens"]):
                raise JournalError(
                    f"token index gap for rid {rec['rid']}: got i={i}, "
                    f"have {len(r['tokens'])} tokens (seq {rec['seq']})")
            r["tokens"].append(rec["tok"])
            r["last_step"] = rec["step"]
    return reqs
