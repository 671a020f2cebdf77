"""Checkpointing: async save, atomic commit, keep-N retention, restore.
Counterpart of `repro.checkpoint.manager`, in its on-disk format, so a
checkpoint written by either package restores in the other.

Format: one directory per step, ``step_<10 digits>``, containing
  - ``meta.json``: step, the flat key list (the path strings of
    `jax.tree_util.tree_flatten_with_path`, in its sorted-key order:
    `repro_torch.tree.flatten_with_paths`), shapes, dtypes and the
    time;
  - ``<idx>.npy``: one file per leaf, in that order.
A ``COMMITTED`` marker is written last; readers ignore uncommitted
directories, so a crash mid-save never corrupts the restore point.  The
write runs on a background thread after every leaf has been copied to
the host (a copy, ``.to("cpu", copy=True)``), the consistency point: the
trainer may update its state in place as soon as `save` returns.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit pattern
with ``"bfloat16"`` as its dtype in ``meta.json``, as the serving
snapshots store it (`convert.host_array`), and restored by view.

A checkpoint is mesh-agnostic: a DTensor leaf (a state placed on a
mesh) is gathered whole first, so every rank of a process group of more
than one calls `save` at the same steps; rank 0 writes, at once, and the
ranks meet at a barrier after, so each then reads the same directory.
`restore` places each leaf on a mesh by its placements, as the
reference's puts each on its sharding: any mesh, the one that wrote it
or another (`runtime.elastic`).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.convert import from_host_array, host_array
from repro_torch.parallel.sharding import full_tensor

COMMITTED = "COMMITTED"


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (a copy even of a CPU tensor, which the
    trainer may update in place while the write runs; a DTensor's whole
    value) and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        return host_array(full_tensor(leaf))
    a = np.array(leaf)
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---------------- save ----------------

    def save(self, step: int, state, blocking: bool = False):
        """Copy every leaf to host memory now (the consistency point),
        write to disk on a background thread (by rank 0 at once, when
        several ranks save)."""
        self.wait()  # one in-flight save at a time
        keys, leaves = tree_lib.flatten_with_paths(state)
        pairs = [_to_host(leaf) for leaf in leaves]
        ranks = _ranks()
        if ranks > 1 and dist.get_rank() != 0:
            dist.barrier()
            return
        host = [h for h, _ in pairs]
        meta = {
            "step": int(step),
            "keys": keys,
            "shapes": [list(h.shape) for h in host],
            "dtypes": [dtype for _, dtype in pairs],
            "time": time.time(),
        }

        def _write():
            try:
                tmp = self.dir / f"step_{step:010d}.tmp"
                final = self.dir / f"step_{step:010d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for i, arr in enumerate(host):
                    np.save(tmp / f"{i}.npy", arr)
                (tmp / "meta.json").write_text(json.dumps(meta))
                (tmp / COMMITTED).write_text("ok")
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking or ranks > 1:
            self.wait()
        if ranks > 1:
            dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self._committed_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------- restore ----------------

    def _committed_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / COMMITTED).exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self._committed_steps()
        return max(steps) if steps else None

    def restore(self, step: int | None, like, device=None, mesh=None,
                placements=None):
        """Restore into the structure of ``like`` (a tree of tensors, or
        anything with its keys).  The leaves are tensors on ``device``
        (the CPU for None), or, with ``mesh`` and ``placements`` (a tree
        of DTensor placements of ``like``'s structure, the reference's
        ``shardings``), DTensors on ``mesh`` (`distribute_tensor`).
        Raises ValueError when the checkpoint's keys are not ``like``'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        meta = json.loads((d / "meta.json").read_text())
        keys, _ = tree_lib.flatten_with_paths(like)
        if keys != meta["keys"]:
            raise ValueError(
                f"checkpoint/model structure mismatch in {d}: "
                f"{len(meta['keys'])} keys on disk, {len(keys)} expected")
        out = [from_host_array(np.load(d / f"{i}.npy"), dtype)
               for i, dtype in enumerate(meta["dtypes"])]
        if device is not None:
            out = [t.to(device) for t in out]
        tree = tree_lib.unflatten_like(like, out)
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor
            dev = ("cpu" if mesh.device_type == "cpu" else
                   torch.device("cuda", torch.cuda.current_device()))
            tree = tree_lib.map_structure(
                lambda t, pl: distribute_tensor(t.to(dev), mesh, pl), tree,
                placements)
        return tree, meta
