"""Data pipeline: deterministic synthetic LM stream + memmap-backed shards,
host-sharded loading with background prefetch.  Counterpart of
`repro.data.pipeline`, copied (numpy only: `repro.data` imports jax
through its loss module), so its batches equal the reference's bit for
bit.

Determinism contract (needed for fault tolerance): batch contents are a pure
function of (seed, step, shard_id, num_shards).  After a failure/elastic
re-mesh, the restored trainer replays exactly the batches it would have seen
— no data loss, no duplication — because assignment is recomputed from the
new shard count (the paper's DMA "programmed by the host" becomes a pure
indexing scheme).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.parallel.loss import IGNORE


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"        # "synthetic" | "memmap"
    path: str | None = None        # token file for memmap
    frontend: str | None = None    # None | "frame" | "patch"
    frontend_dim: int = 0
    num_patches: int = 0


def _batch_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


class SyntheticSource:
    """Structured synthetic LM data: noisy affine-recurrence token streams so
    the model has real signal to fit (loss decreases — used by tests and the
    quickstart trainer)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, shard: int, num_shards: int) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        rng = _batch_rng(cfg, step, shard)
        s = cfg.seq_len
        # token t+1 = (a * token t + c) mod V with occasional noise.  The
        # (a, c) "language" is a function of the SEED only, so the mapping is
        # stable across steps/shards (learnable); start tokens and noise vary
        # per (step, shard) (deterministic replay after restart).
        lang = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0xA11CE]))
        a = int(lang.integers(2, 8))
        c = int(lang.integers(1, max(cfg.vocab_size - 1, 2)))
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        for t in range(s):
            toks[:, t + 1] = (a * toks[:, t] + c) % cfg.vocab_size
        noise = rng.random((b, s + 1)) < 0.02
        toks[noise] = rng.integers(0, cfg.vocab_size, size=int(noise.sum()))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend == "frame":
            batch = {
                "frames": rng.standard_normal(
                    (b, s, cfg.frontend_dim)).astype(np.float32),
                "labels": batch["labels"] % cfg.vocab_size,
            }
        elif cfg.frontend == "patch":
            npatch = cfg.num_patches
            labels = np.concatenate(
                [np.full((b, npatch), IGNORE, np.int32),
                 batch["labels"][:, : s - npatch]], axis=1)
            batch = {
                "patches": rng.standard_normal(
                    (b, npatch, cfg.frontend_dim)).astype(np.float32),
                "tokens": batch["tokens"][:, : s - npatch],
                "labels": labels,
            }
        return batch


class MemmapSource:
    """Token-file-backed source (np.memmap of int32), deterministic window
    assignment by (step, shard)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.path, "memmap source needs a path"
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch(self, step: int, shard: int, num_shards: int) -> dict:
        cfg = self.cfg
        b = cfg.global_batch // num_shards
        rng = _batch_rng(cfg, step, shard)
        idx = rng.integers(0, self.windows, size=b)
        starts = idx * cfg.seq_len
        toks = np.stack([self.tokens[s0 : s0 + cfg.seq_len + 1]
                         for s0 in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_source(cfg: DataConfig):
    return MemmapSource(cfg) if cfg.kind == "memmap" else SyntheticSource(cfg)


class Prefetcher:
    """Background-thread prefetch of upcoming batches (depth-bounded)."""

    def __init__(self, source, start_step: int, shard: int, num_shards: int,
                 depth: int = 2):
        self.source = source
        self.shard = shard
        self.num_shards = num_shards
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step, self.shard, self.num_shards)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
