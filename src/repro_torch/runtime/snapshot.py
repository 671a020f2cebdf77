"""Atomic, incremental snapshots of the serving state (numpy and the
standard library only).  Counterpart of `repro.runtime.snapshot`; the
second half of crash tolerance (`runtime.journal` is the first).

A snapshot is what `serve --resume` needs to rebuild a server mid-run
without replaying the whole history: the cache leaves and per-slot
``lengths``, the slot-to-request map and per-slot counters, the
lifecycle table, the injector's state and the journal ``seq`` it covers,
which bounds the journal tail a recovery replays to one snapshot
interval.

Durability:

* array payloads land in ``snap-<step>.npz`` by temp file and
  ``os.replace``, so a crash mid-write leaves only a ``*.tmp`` orphan;
* the JSON manifest ``snap-<step>.json`` is written last, the same way:
  its presence is the commit point, and a manifest whose payload is
  missing or fails its hash is skipped by :func:`latest_snapshot`;
* a leaf whose content hash equals the previous snapshot's is referenced
  from the older payload file instead of written again.  Pruning keeps
  every payload file a surviving manifest references.

numpy has no bfloat16.  The server hands a bf16 leaf over as its
``uint16`` view (the same bytes, so the hash and the round trip are
bitwise) and names its real dtype in ``dtypes``; each manifest entry
records ``"dtype"``, the leaf's dtype as the server holds it, and
:func:`leaf_dtypes` reads them back.
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import time
import zipfile

import numpy as np

from repro_torch.core.ioutil import atomic_write_bytes, atomic_write_json
from repro_torch.runtime.lifecycle import Lifecycle, Request, State

SNAPSHOT_SCHEMA = 1


def _leaf_hash(a: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _manifest_paths(dirpath) -> list[pathlib.Path]:
    return sorted(pathlib.Path(dirpath).glob("snap-*.json"))


class SnapshotStore:
    """Reader and writer over one snapshot directory.

    The serve loop calls ``save`` every ``every`` decode steps
    (``due(step)``); ``keep`` bounds how many committed snapshots, and so
    which payload files, survive pruning.
    """

    def __init__(self, dirpath, *, every: int = 8, keep: int = 3):
        if every < 1:
            raise ValueError(f"snapshot interval must be >= 1, got {every}")
        self.dir = pathlib.Path(dirpath)
        self.every = int(every)
        self.keep = max(1, int(keep))
        self.dir.mkdir(parents=True, exist_ok=True)
        self._prev: dict | None = None     # last committed manifest
        self.saved = 0
        self.bytes_written = 0             # payload bytes, all saves
        self.save_seconds: list[float] = []

    def due(self, step: int, last_step: int) -> bool:
        """True when ``step`` crossed a snapshot boundary since
        ``last_step`` (the loop may jump its step counter)."""
        return step // self.every > last_step // self.every

    def save(self, *, step: int, arrays: dict, meta: dict, journal_seq: int,
             dtypes: dict | None = None) -> pathlib.Path:
        """Commit one snapshot; returns the manifest path.  ``dtypes``
        names, per leaf, the dtype the server holds where it is not the
        array's own (a bf16 leaf handed over as ``uint16``)."""
        t0 = time.perf_counter()
        dtypes = dtypes or {}
        name = f"snap-{step:08d}"
        payload_file = f"{name}.npz"
        prev_arrays = (self._prev or {}).get("arrays", {})
        entries: dict[str, dict] = {}
        fresh: dict[str, np.ndarray] = {}
        for leaf, a in arrays.items():
            a = np.asarray(a)
            sha = _leaf_hash(a)
            dtype = dtypes.get(leaf, a.dtype.name)
            prev = prev_arrays.get(leaf)
            if (prev and prev["sha"] == sha and prev.get("dtype") == dtype
                    and (self.dir / prev["file"]).exists()):
                entries[leaf] = dict(prev)          # incremental: reuse
            else:
                key = f"a{len(fresh)}"
                fresh[key] = a
                entries[leaf] = {"file": payload_file, "key": key,
                                 "sha": sha, "dtype": dtype}
        if fresh:
            buf = io.BytesIO()
            np.savez(buf, **fresh)
            payload = buf.getvalue()
            atomic_write_bytes(self.dir / payload_file, payload)
            self.bytes_written += len(payload)
        manifest = {
            "schema": SNAPSHOT_SCHEMA,
            "step": int(step),
            "journal_seq": int(journal_seq),
            "meta": meta,
            "arrays": entries,
        }
        atomic_write_json(self.dir / f"{name}.json", manifest)
        self._prev = manifest
        self.saved += 1
        self._prune()
        self.save_seconds.append(time.perf_counter() - t0)
        return self.dir / f"{name}.json"

    def _prune(self) -> None:
        manifests = _manifest_paths(self.dir)
        drop, keep = manifests[:-self.keep], manifests[-self.keep:]
        referenced = set()
        for m in keep:
            try:
                man = json.loads(m.read_text())
                referenced |= {e["file"] for e in man["arrays"].values()}
            except (ValueError, KeyError, OSError):
                continue
        for m in drop:
            payload = m.with_suffix(".npz")
            m.unlink(missing_ok=True)
            if payload.name not in referenced:
                payload.unlink(missing_ok=True)


def load_snapshot(manifest_path) -> tuple[dict, dict]:
    """Load one committed snapshot: ``(manifest, {leaf: np.ndarray})``,
    each array as it was stored (a bf16 leaf as ``uint16``; see
    :func:`leaf_dtypes`).  Raises on a manifest whose payloads are
    missing, torn, or fail their content hash."""
    manifest_path = pathlib.Path(manifest_path)
    manifest = json.loads(manifest_path.read_text())
    if manifest.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"{manifest_path}: snapshot schema "
                         f"{manifest.get('schema')!r} != {SNAPSHOT_SCHEMA}")
    by_file: dict[str, dict] = {}
    arrays: dict[str, np.ndarray] = {}
    for leaf, e in manifest["arrays"].items():
        if e["file"] not in by_file:
            with np.load(manifest_path.parent / e["file"]) as z:
                by_file[e["file"]] = {k: z[k] for k in z.files}
        a = by_file[e["file"]][e["key"]]
        if _leaf_hash(a) != e["sha"]:
            raise ValueError(f"{manifest_path}: leaf {leaf!r} failed its "
                             f"content hash — torn or corrupted payload")
        arrays[leaf] = a
    return manifest, arrays


def leaf_dtypes(manifest: dict) -> dict:
    """Each leaf's dtype as the server held it, from a manifest."""
    return {leaf: e["dtype"] for leaf, e in manifest["arrays"].items()}


def latest_snapshot(dirpath) -> tuple[dict, dict] | None:
    """The newest committed and loadable snapshot of a directory (None
    when there is none).  A snapshot that fails to load (the crash
    mid-write window) is skipped and the next older one tried."""
    for manifest_path in reversed(_manifest_paths(dirpath)):
        try:
            return load_snapshot(manifest_path)
        except (ValueError, OSError, KeyError, zipfile.BadZipFile):
            continue
    return None


# ---------------------------------------------------------------------------
# lifecycle table <-> JSON state
# ---------------------------------------------------------------------------

def lifecycle_state(lc: Lifecycle) -> dict:
    """The lifecycle table as a JSON-able snapshot payload: every request
    record in full (prompt tokens, history, deadlines), the queue order,
    and the event counters."""
    reqs = []
    for rid in sorted(lc.requests):
        r = lc.requests[rid]
        reqs.append({
            "rid": r.rid,
            "prompt": [int(t) for t in np.asarray(r.prompt).tolist()],
            "gen_len": int(r.gen_len),
            "submit_t": float(r.submit_t),
            "ttft_deadline_s": r.ttft_deadline_s,
            "deadline_s": r.deadline_s,
            "state": r.state.value,
            "retries": int(r.retries),
            "not_before_step": int(r.not_before_step),
            "first_token_t": r.first_token_t,
            "finish_t": r.finish_t,
            "tokens": [int(t) for t in r.tokens],
            "history": [[s.value, int(st)] for s, st in r.history],
        })
    return {
        "queue_limit": lc.queue_limit,
        "max_retries": lc.max_retries,
        "backoff_steps": lc.backoff_steps,
        "evicted_events": lc.evicted_events,
        "retried_events": lc.retried_events,
        "queue": [r.rid for r in lc._queue],
        "requests": reqs,
    }


def restore_lifecycle(state: dict, *, clock=None) -> Lifecycle:
    """Rebuild a Lifecycle (requests, queue order, counters) from
    :func:`lifecycle_state` output.  ``clock`` is the resumed run's clock
    (a `loadgen.VirtualClock` set to the crash step, or None for the
    wall clock)."""
    kw = {} if clock is None else {"clock": clock}
    lc = Lifecycle(queue_limit=state["queue_limit"],
                   max_retries=state["max_retries"],
                   backoff_steps=state["backoff_steps"], **kw)
    lc.evicted_events = state["evicted_events"]
    lc.retried_events = state["retried_events"]
    for r in state["requests"]:
        req = Request(
            rid=r["rid"], prompt=np.asarray(r["prompt"], np.int32),
            gen_len=r["gen_len"], submit_t=r["submit_t"],
            ttft_deadline_s=r["ttft_deadline_s"], deadline_s=r["deadline_s"],
            state=State(r["state"]), retries=r["retries"],
            not_before_step=r["not_before_step"],
            first_token_t=r["first_token_t"], finish_t=r["finish_t"],
            tokens=list(r["tokens"]),
            history=[(State(s), st) for s, st in r["history"]])
        lc.requests[req.rid] = req
    for rid in state["queue"]:
        lc._queue.append(lc.requests[rid])
    return lc
