"""Fault-tolerant batched greedy serving: ragged continuous batching with
a request lifecycle, a chaos mode, crash recovery and trace replay.
Counterpart of `repro.launch.serve`.

Requests enter a bounded admission queue (`runtime.lifecycle`) and move
through its state machine.  The batch is the tuner's by default
(``--batch 0``: `kernels.autotune.select_serving_batch` sweeps
``--batch-candidates`` up to ``--requests``, each priced by the model at
quantiles of the workload's slot depths, under ``--latency-budget-ms``)
or the flag's.  The server tunes its kernel plans once when it is built
(`autotune.plan_for_model`, by the model alone); a contiguous cache's
decode runs the span of its ``attn_decode`` plan, handed down with the
cache, and the watchdog holds each decode step to the plans' predicted
step time.  The server packs up to the batch's sequences;
a burst of arrivals is prefilled as one chunked forward (every admitted
prompt plus each in-flight slot's next token, under a (B, S) ``active``
mask), a single arrival by a masked one-slot prefill.  Each decode step
then runs every occupied slot at its own cache depth; the single-token
attention goes through the CUDA decode kernel of the cache's layout on a
card.  Finished slots are zeroed and refilled.  Every family the JAX
server serves is served: dense, MoE, RWKV6, the Jamba hybrid and the
token stream of a patch-frontend model.  A sliding-window model's prompt
is trimmed to the window (its cache is a ring of ``window`` rows) and
decodes on the plain path, as the JAX server's does; only dense and MoE
models prefill in chunks or take ``--paged``; an encoder-only model has
no decode path, and the CLI says so and exits 0.  The summary line conserves
every submitted request: ``submitted == completed + timed_out + failed +
rejected``.

The KV cache is contiguous (f32, bf16 or int8 with per-row scales,
``--kv-dtype``) or paged (``--paged --page-size --pool-pages``): a pool of
pages shared by every slot, handed out by a host `PageAllocator` whose
table the server copies to the device after every change.  ``--sched
fcfs|spf|paged-aware`` picks the admission policy (`launch.scheduler`);
with a paged cache a request is admitted only when the pool can cover its
predicted footprint, and the summary carries ``sched`` and ``kv`` blocks.

Robustness, as in the JAX server:

* a per-slot NaN/Inf logits guard: a poisoned slot is quarantined alone
  (reset and requeued with backoff) while its neighbours decode on;
* ``--chaos --fault-seed N``: the seeded schedule of `runtime.faults`,
  one fault of each class;
* ``--state-dir``: every emitted token journaled write-ahead
  (`runtime.journal`) and the whole state snapshotted every
  ``--snapshot-every`` decode steps (`runtime.snapshot`); ``--crash``
  kills the loop at a seeded step (exit ``CRASH_EXIT``) and ``--resume``
  rebuilds the run from the state dir and drains it to the streams of an
  uninterrupted run;
* ``--load-trace``: replay a `runtime.loadgen` trace on a virtual clock
  (one ``--step-time-us``, by default the tuner's predicted decode step,
  per loop step), the path behind `benchmarks.serving_load`.

**The kernel_dispatch fault, with no fallback.**  The JAX server answers
an injected dispatch failure by finishing the step on its jnp path.  The
port has no plain path on a CUDA tensor, so the injected fault is raised
before the step's forward (its state untouched); the loop marks the
decode plan poisoned, re-resolves the server's decode plan (writing the
span into the cache) and runs the same step again on the kernel, without
consulting the injector again and keeping any ``nan_logits`` armed at
that step.  The summary keeps ``kernel_fallbacks: 0`` and counts
``kernel_replans``.  A real launch failure raises, and the CLI exits
non-zero.

The plans are priced for the H100 of the data sheet on the CPU
(``--device cpu``) and for the card that is present
(`core.hardware.detect`) on a card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \\
      --smoke --requests 6 --prompt-len 16 --gen 12 [--batch 2] \\
      [--paged] [--sched spf] [--kv-dtype int8] [--device cpu] \\
      [--chaos --fault-seed 0] [--state-dir D [--crash] | --resume] \\
      [--load-trace trace.jsonl [--step-time-us 1000]]
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import pathlib
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import hardware
from repro_torch.core.ioutil import atomic_write_json
from repro_torch.kernels import autotune
from repro_torch.launch import steps
from repro_torch.launch.scheduler import POLICIES, Scheduler
from repro_torch.models import transformer
from repro_torch.runtime import faults, loadgen, paging
from repro_torch.runtime import journal as journal_mod
from repro_torch.runtime import snapshot as snapshot_mod
from repro_torch.runtime.fault_tolerance import DecodeWatchdog
from repro_torch.runtime.lifecycle import Lifecycle, Request, State, TERMINAL

# The JAX server's forward runs at transformer.forward's default, bf16.
COMPUTE_DTYPE = torch.bfloat16
KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}
# Exit code of a run killed by an injected crash: neither success nor an
# ordinary failure, so a caller can tell the process died mid-serve.
CRASH_EXIT = 17
# A journaled token that the re-prefill at resume does not predict is
# accepted only at a near-tie: its logit below the argmax's by less than
# this share of the largest |logit| (the bf16 logit bound of ROADMAP
# queue C).  Prefill and decode round differently in bf16.
BF16_LOGIT_REL = 3e-2


def _cast_weights(params: dict, dtype, device) -> dict:
    """Every leaf the forward only consumes through ``.to(compute dtype)``
    (matrices, biases, embedding tables, shift mixes, conv taps) cast to
    ``dtype`` once; the leaves the models name in
    `transformer.OWN_DTYPE_LEAVES` keep their dtype.
    The numbers are those of casting at every use."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v.to(device) if k in transformer.OWN_DTYPE_LEAVES
                    else v.to(device=device, dtype=dtype))
                for k, v in tree.items()}
    return walk(params)


def _tensor_leaves(tree: dict, prefix: str = ""):
    """``(name, tensor)`` for every tensor leaf, named as the JAX server
    names its snapshot leaves (``"['blocks']['k']"``), in key order."""
    for k, v in tree.items():
        name = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            yield from _tensor_leaves(v, name)
        elif isinstance(v, torch.Tensor):
            yield name, v


def params_digest(params: dict) -> str:
    """A digest of a parameter tree, computed on its device: for each
    leaf, its name, dtype, shape and the exact integer sums of its bit
    patterns and of their squares.  Two processes that drew the same
    weights print the same digest."""
    h = hashlib.sha1()
    chunk = 1 << 26
    for name, t in _tensor_leaves(params):
        bits = {2: torch.int16, 4: torch.int32}[t.element_size()]
        flat = t.detach().reshape(-1).view(bits)
        s1 = s2 = 0
        for i in range(0, flat.numel(), chunk):
            c = flat[i:i + chunk].to(torch.int64)
            s1 += int(c.sum())
            s2 += int((c * c).sum())
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}:{s1}:{s2};".encode())
    return h.hexdigest()


class Server:
    """A continuous-batching server over ``batch`` cache slots of
    ``max_len`` rows.

    Built, it tunes its kernel plans once (``kernel_plan``,
    `autotune.plan_for_model` at ``batch``, ``prefill_len`` and a cache of
    ``max_len`` rows, by the model alone; ``slot_lengths`` is the
    workload's slot-depth distribution) unless ``autotune_kernels`` is
    False.  A contiguous cache decodes at its ``attn_decode`` plan's span
    (``decode_span``), resolved here and never per layer; a paged one,
    and a server without plans, at the kernels' default.

    ``params`` is a JAX-layout parameter tree (for example converted from
    the JAX server's); when it is None, random weights are drawn on the
    device from a ``torch.Generator`` seeded with 0.  Either way the
    matrices are held in the compute dtype (bf16).  ``device`` defaults to
    ``cuda`` and raises without a card.  ``kv_dtype`` is the cache's
    storage type (f32, bf16 or int8).  ``paged`` (a
    `runtime.paging.PageSpec`, or None for the contiguous cache) switches
    the cache to the page-pool layout; the host `PageAllocator` is the
    truth and `_sync_pages` copies its table to the device cache.
    ``injector`` (a `runtime.faults.FaultInjector`) arms the chaos hooks
    of `prefill` and `decode_step`."""

    def __init__(self, cfg, batch: int, max_len: int, *, params=None,
                 kv_dtype=torch.float32, device="cuda", paged=None,
                 prefill_len: int = 0, slot_lengths=None,
                 autotune_kernels: bool = True, injector=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self.paged = paged
        self.injector = injector
        self.allocator = (paging.PageAllocator(paged, batch)
                          if paged is not None else None)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = transformer.init(cfg, gen, dtype=COMPUTE_DTYPE)
        self.params = _cast_weights(params, COMPUTE_DTYPE, self.device)
        self.serve_step = steps.make_guarded_serve_step(cfg, COMPUTE_DTYPE,
                                                        paged=paged)
        self.kernel_plan = (autotune.plan_for_model(
            cfg, batch, prefill_len=prefill_len, cache_len=max_len,
            kv_dtype=kv_dtype, slot_lengths=slot_lengths,
            device=self.device) if autotune_kernels else [])
        decode_plan = next((p for p in self.kernel_plan
                            if p.op == "attn_decode"), None)
        self.decode_span = (decode_plan.plan.knobs["block_k"]
                            if decode_plan is not None and paged is None
                            else None)
        self.cache = transformer.cache_init(cfg, batch, max_len,
                                            dtype=kv_dtype,
                                            device=self.device, paged=paged,
                                            decode_span=self.decode_span)
        self.slot_len = np.zeros(batch, np.int32)      # tokens generated
        self.slot_target = np.zeros(batch, np.int32)   # stop length
        self.slot_req = -np.ones(batch, np.int32)      # request id
        self.last_tok = np.zeros((batch, 1), np.int32)
        self.poison = np.zeros(batch, bool)            # chaos logits-NaN arm
        self.decode_forwards = 0                       # forwards with S == 1
        self.near_ties: list[dict] = []                # accepted at restore

    def _step(self, tokens: np.ndarray, active: np.ndarray,
              poison: np.ndarray | None = None, logits: bool = False):
        """One guarded forward; returns host ``(next (B, 1), ok (B,))``,
        and with ``logits`` the final-position logits (B, V) as f32 on the
        host.  The poison mask is copied to the device before the caller
        clears it."""
        dev = self.device
        mask = None if poison is None else torch.tensor(poison, device=dev)
        out = self.serve_step(
            self.params, self.cache, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(active, device=dev), mask,
            return_logits=logits)
        nxt, ok, self.cache = out[:3]
        if tokens.shape[1] == 1:
            self.decode_forwards += 1
        res = (nxt.cpu().numpy(), ok.cpu().numpy())
        if logits:
            res += (out[3].float().cpu().numpy(),)
        return res

    def prefill(self, slot: int, req_id: int, prompt, gen_len: int) -> bool:
        """Masked batched prefill of one slot: the whole prompt in one
        forward whose ``active`` mask is the slot's one-hot, after zeroing
        the slot (and, paged, covering the prompt with pages).  Returns
        True iff its first-token logits were finite; raises
        `paging.PageOOM` when the pool cannot cover the prompt, and in
        chaos mode may raise `faults.PrefillInterrupt` after the slot
        reset (the slot is left zeroed, so the caller releases it)."""
        return self._prefill(slot, req_id, prompt, gen_len)[0]

    def _prefill(self, slot, req_id, prompt, gen_len, *, hook=True,
                 logits=False):
        prompt = np.asarray(prompt, np.int32)
        if self.cfg.sliding_window:
            # The ring keeps at most `window` rows, and a fresh slot
            # attends only the prompt's last `window` tokens: more in one
            # forward would alias ring rows.
            prompt = prompt[-self.cfg.sliding_window:]
        self._fresh_slot(slot, req_id, prompt.size)
        if self.allocator is not None:
            self._sync_pages()
        if hook and self.injector is not None:
            self.injector.prefill_hook(slot, req_id)   # may raise
        toks = np.zeros((self.batch, prompt.size), np.int32)
        toks[slot] = prompt
        active = np.zeros((self.batch,), bool)
        active[slot] = True
        out = self._step(toks, active, logits=logits)
        nxt, ok = out[:2]
        self.last_tok[slot, 0] = nxt[slot, 0]
        self.slot_len[slot] = 0
        self.slot_target[slot] = gen_len
        self.slot_req[slot] = req_id
        return bool(ok[slot]), (out[2][slot] if logits else None)

    def can_chunk(self) -> bool:
        """Chunked prefill needs the (B, S) active-mask path, which only
        the attention families have (a per-slot valid-prefix scatter; a
        recurrent state would run over a packed row's padding); the ring
        buffer and the chaos injector's ordinal-keyed prefill faults stay
        on the one-slot path."""
        return (self.cfg.family in ("dense", "moe") and self.cfg.causal
                and not self.cfg.sliding_window and self.injector is None)

    def admit_chunk(self, admits):
        """Chunked prefill: every admitted prompt, left-aligned under a
        (B, S) active mask, plus each in-flight slot's next token at column
        0, in ONE forward.  ``admits`` is ``[(slot, rid, prompt, gen_len)]``.

        Returns ``(ok_admit, nxt, rode, done, bad)``: per-admitted-slot
        finite-logits verdicts, the tokens, the riding slots, and the
        riding slots that finished / went non-finite this step."""
        width = max(int(np.asarray(p).size) for _, _, p, _ in admits)
        rode = [s for s in range(self.batch) if self.slot_req[s] >= 0]
        for slot, rid, prompt, _ in admits:
            self._fresh_slot(slot, rid, np.asarray(prompt).size)
        if self.allocator is not None:
            self._grow(rode)                   # riding slots write one row
            self._sync_pages()
        tokens = np.zeros((self.batch, width), np.int32)
        act = np.zeros((self.batch, width), bool)
        for s in rode:
            tokens[s, 0] = self.last_tok[s, 0]
            act[s, 0] = True
        for slot, _, prompt, _ in admits:
            p = np.asarray(prompt, np.int32)
            tokens[slot, :p.size] = p
            act[slot, :p.size] = True
        nxt, ok = self._step(tokens, act, self.poison)
        self.poison[:] = False
        ok_admit = {}
        for slot, rid, _, gen_len in admits:
            self.last_tok[slot, 0] = nxt[slot, 0]
            self.slot_len[slot] = 0
            self.slot_target[slot] = gen_len
            self.slot_req[slot] = rid
            ok_admit[slot] = bool(ok[slot])
        adv = [s for s in rode if ok[s]]
        for s in adv:
            self.last_tok[s, 0] = nxt[s, 0]
            self.slot_len[s] += 1
        done = [s for s in adv if self.slot_len[s] >= self.slot_target[s]]
        bad = [s for s in rode if not ok[s]]
        return ok_admit, nxt, rode, done, bad

    def restore_slot(self, slot: int, rid: int, prompt, tokens,
                     gen_len: int) -> None:
        """Re-prefill an in-flight request to its crash-point state.

        ``tokens`` is the request's journaled output.  After emitting
        token m-1 the live server held cache = prompt ++ tokens[:-1] with
        ``last_tok`` = tokens[-1], so one masked prefill over that prefix
        rebuilds the slot, and its prediction must be the journaled
        tokens[-1].  Prefill (plain attention over the prefix) and decode
        (the decode kernels) round differently in bf16, so a differing
        prediction is accepted only at a near-tie: the journaled token's
        logit below the argmax's by less than ``BF16_LOGIT_REL`` of the
        largest |logit|.  The journal is what the outside world saw, so
        the slot then continues from the journaled token, and the case is
        recorded in ``near_ties``.  Anything else raises: changed
        weights, config drift or a corrupt journal."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError(f"restore_slot needs >= 1 journaled token "
                             f"for request {rid}")
        prefix = np.concatenate([np.asarray(prompt, np.int32),
                                 np.asarray(tokens[:-1], np.int32)])
        # The injector stays out of recovery: its prefill faults are keyed
        # on live prefill ordinals.
        ok, last = self._prefill(slot, rid, prefix, gen_len, hook=False,
                                 logits=True)
        predicted = int(self.last_tok[slot, 0])
        journaled = tokens[-1]
        gap = (float(last[predicted] - last[journaled]) if ok
               else float("nan"))
        bound = BF16_LOGIT_REL * float(np.abs(last).max()) if ok else 0.0
        if not ok or (predicted != journaled and not gap < bound):
            raise RuntimeError(
                f"deterministic recovery violated for request {rid}: "
                f"re-prefill of {prefix.size} tokens predicted "
                f"{predicted} (finite={ok}) but the journal recorded "
                f"{journaled} (logit gap {gap}, near-tie bound {bound}) — "
                f"weights/config drift or a corrupt journal; refusing to "
                f"serve a diverged continuation")
        if predicted != journaled:
            self.near_ties.append({"rid": rid, "position": len(tokens) - 1,
                                   "journaled": journaled,
                                   "predicted": predicted, "gap": gap,
                                   "bound": bound})
            self.last_tok[slot, 0] = journaled
        self.slot_len[slot] = len(tokens) - 1

    # -- crash tolerance: full-state export / restore -----------------------

    def export_state(self) -> tuple[dict, dict]:
        """The server's mutable state as flat host numpy arrays, the
        payload `runtime.snapshot` persists: every cache tensor (K/V or
        pools, int8 scales, ``lengths``, ``index``, the page table) and the
        slot vectors.  Returns ``(arrays, dtypes)``: a bf16 leaf is its
        ``uint16`` view (numpy has no bfloat16; the bytes are the same),
        named ``"bfloat16"`` in ``dtypes``.  The cache's ``decode_span``
        is a Python int, not a tensor; the serve loop keeps it in the
        snapshot's meta."""
        arrays, dtypes = {}, {}
        for name, t in _tensor_leaves(self.cache, "cache"):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                arrays[name] = t.view(torch.int16).numpy().view(np.uint16)
                dtypes[name] = "bfloat16"
            else:
                arrays[name] = t.numpy().copy()
        arrays["slot_len"] = self.slot_len.copy()
        arrays["slot_target"] = self.slot_target.copy()
        arrays["slot_req"] = self.slot_req.copy()
        arrays["last_tok"] = self.last_tok.copy()
        return arrays, dtypes

    def restore_state(self, arrays: dict, dtypes: dict | None = None,
                      decode_span: int | None = None) -> None:
        """Inverse of :meth:`export_state`: copy a snapshot's arrays into
        this (same-config, same-batch) server's cache in place, bitwise.
        A leaf whose shape or dtype (``dtypes``, as a snapshot manifest
        records them) differs means a snapshot of another serving
        configuration, and raises.  ``decode_span``, when given, is the
        span the snapshotted server decoded at (a contiguous cache)."""
        dtypes = dtypes or {}
        for name, t in _tensor_leaves(self.cache, "cache"):
            if name not in arrays:
                raise ValueError(f"snapshot missing cache leaf {name!r}")
            a = arrays[name]
            want = str(t.dtype).removeprefix("torch.")
            got = dtypes.get(name, a.dtype.name)
            stored = np.uint16 if t.dtype == torch.bfloat16 else None
            if (tuple(a.shape) != tuple(t.shape) or got != want
                    or (stored is not None and a.dtype != stored)):
                raise ValueError(
                    f"snapshot leaf {name!r} is {got}{tuple(a.shape)}, "
                    f"server expects {want}{tuple(t.shape)} — snapshot "
                    f"from a different serving configuration")
            src = torch.from_numpy(np.array(a, order="C"))
            if stored is not None:
                src = src.view(torch.int16).view(torch.bfloat16)
            t.copy_(src)
        self.slot_len = np.asarray(arrays["slot_len"], np.int32).copy()
        self.slot_target = np.asarray(arrays["slot_target"], np.int32).copy()
        self.slot_req = np.asarray(arrays["slot_req"], np.int32).copy()
        self.last_tok = np.asarray(arrays["last_tok"], np.int32).copy()
        self.poison[:] = False
        if decode_span is not None and self.paged is None:
            self.decode_span = int(decode_span)
            self.cache["decode_span"] = self.decode_span
        if self.paged is not None:
            # Allocation order is canonical (a min-heap), so the restored
            # page table fully determines the allocator's state.
            self.allocator = paging.PageAllocator.adopt(
                self.paged, self.cache["pages"].cpu().numpy())

    def release_slot(self, slot: int) -> None:
        """Free a slot and zero its cache rows; paged, its pages return to
        the pool and its outstanding reservation is dropped."""
        rid = int(self.slot_req[slot])
        self.slot_req[slot] = -1
        transformer.cache_reset_slot(self.cache, slot, paged=self.paged)
        if self.allocator is not None:
            self.allocator.free_slot(slot, rid=rid)
            self._sync_pages()

    def corrupt_kv(self, slot: int) -> None:
        """Chaos hook: NaN over one slot's float cache leaves."""
        transformer.cache_poison_slot(self.cache, slot, paged=self.paged)

    def replan_decode(self) -> None:
        """After a decode-kernel dispatch failure: mark the decode plan
        poisoned, tune its problem again (by the model, as at start-up)
        and hand the new span to a contiguous cache."""
        i = next((i for i, p in enumerate(self.kernel_plan)
                  if p.op == "attn_decode"), None)
        if i is None:
            return
        old = self.kernel_plan[i].plan
        autotune.mark_plan_poisoned(old.key)
        dtype = (torch.bfloat16 if self.kv_dtype == torch.int8
                 else self.kv_dtype)
        plan = autotune.tune(old.family, old.problem, dtype,
                             device=self.device, measure_k=0)
        self.kernel_plan[i] = autotune.OpPlan("attn_decode", plan)
        if self.paged is None:
            self.decode_span = plan.knobs["block_k"]
            self.cache["decode_span"] = self.decode_span

    def _fresh_slot(self, slot: int, rid: int, n_tokens: int) -> None:
        """Zero ``slot`` for request ``rid``; paged, drop the pages a
        previous occupant left and cover ``n_tokens`` rows (consuming the
        scheduler's reservation).  May raise `paging.PageOOM`."""
        transformer.cache_reset_slot(self.cache, slot, paged=self.paged)
        if self.allocator is not None:
            self.allocator.free_slot(slot, rid=int(self.slot_req[slot]))
            self.allocator.ensure(slot, n_tokens, rid=rid)

    def _grow(self, slots) -> bool:
        """Grow each slot's pages to cover the row it writes next; True if
        any page was added.  May raise `paging.PageOOM`."""
        depths = self.cache["lengths"].cpu().numpy()
        grew = False
        for s in slots:
            grew |= self.allocator.ensure(s, int(depths[s]) + 1,
                                          rid=int(self.slot_req[s]))
        return grew

    def _sync_pages(self) -> None:
        """Copy the host allocator's page table into the device table, in
        place (the allocator is the truth; the kernels read the copy)."""
        self.cache["pages"].copy_(torch.from_numpy(self.allocator.table))

    def decode_step(self, step: int = 0, *, inject: bool = True):
        """One ragged decode step over the occupied slots; idle slots
        neither write nor advance.  Returns ``(next_tokens, done, bad)``:
        ``bad`` slots produced non-finite logits, did not advance, and must
        be quarantined by the caller.  Paged: every occupied slot's table
        first grows to cover the row it writes; an overcommitted pool
        raises `paging.PageOOM`.  With an injector (and ``inject``) the
        faults scheduled at ``step`` are applied first, and a
        `faults.KernelDispatchFault` or `faults.CrashFault` may raise
        before the forward."""
        if inject and self.injector is not None:
            self.injector.apply_decode_faults(self, step)   # may raise
        active = self.slot_req >= 0
        if self.allocator is not None and self._grow(np.flatnonzero(active)):
            self._sync_pages()
        nxt, ok = self._step(self.last_tok, active, self.poison)
        self.poison[:] = False
        adv = active & ok
        self.last_tok = np.where(adv[:, None], nxt, self.last_tok)
        self.slot_len[adv] += 1
        done = [s for s in range(self.batch)
                if adv[s] and self.slot_len[s] >= self.slot_target[s]]
        bad = [s for s in range(self.batch) if active[s] and not ok[s]]
        return nxt, done, bad


def serve_loop(server: Server, lc: Lifecycle, *, watchdog=None,
               max_steps: int = 100_000, source=None, journal=None,
               snapshots=None, start_step: int = 0,
               scheduler=None) -> dict:
    """Drain every admitted request to a terminal state.

    Each iteration drives an injected clock that has ``on_step`` with the
    step counter, pumps the arrival ``source`` (`runtime.loadgen`), takes
    a due snapshot, fills idle slots (chunked when more than one request
    is admitted and the server can chunk), sweeps deadlines, and decodes
    one step, or jumps the step counter to the next retry eligibility or
    arrival; it raises with the lifecycle table instead of spinning when
    no progress is possible.  ``scheduler`` (a `launch.scheduler.Scheduler`)
    replaces the lifecycle's FCFS pop; with a paged server it admits a
    request only when the pool can cover it.  A `paging.PageOOM` (an
    overcommitted pool) evicts a request instead of failing the run.

    With a ``journal`` (`runtime.journal.Journal`, shared with
    ``lc.journal``) every emitted token is journaled before it is
    appended to its request; with ``snapshots`` (`runtime.snapshot.
    SnapshotStore`) the server, lifecycle and injector state is saved
    every ``snapshots.every`` decode steps.  ``start_step`` is a resumed
    run's first step.  An injected `faults.KernelDispatchFault` re-plans
    the decode kernel and runs the step again on it (module docstring);
    an injected `faults.CrashFault` propagates out of the loop.
    """
    step = start_step
    last_snap = start_step
    generated = 0
    kernel_replans = 0
    max_concurrent = 0
    chunked_prefills = 0
    kv_pages_peak = 0
    kv_peak = None           # allocator utilization at the peak
    kv_ooms = 0
    first_new_token_s = None
    t_start = time.monotonic()
    tick = getattr(lc.clock, "on_step", None)

    def note_kv() -> None:
        nonlocal kv_pages_peak, kv_peak
        a = server.allocator
        if a is not None and a.allocated_pages >= kv_pages_peak:
            kv_pages_peak = a.allocated_pages
            kv_peak = a.utilization()

    def emit(req, tok: int) -> None:
        """Write-ahead token emission: journal first, then append."""
        nonlocal first_new_token_s
        if journal is not None:
            journal.token(req.rid, len(req.tokens), tok, step)
        req.tokens.append(tok)
        if first_new_token_s is None:
            first_new_token_s = time.monotonic() - t_start

    def start_decoding(req, slot) -> None:
        emit(req, int(server.last_tok[slot, 0]))
        lc.record_first_token(req)
        lc.transition(req, State.DECODING, step)

    def take_snapshot() -> None:
        nonlocal last_snap
        arrays, dtypes = server.export_state()
        meta = {
            "step": step,
            "lifecycle": snapshot_mod.lifecycle_state(lc),
            "injector": (server.injector.state()
                         if server.injector is not None else None),
            "decode_span": server.decode_span,
        }
        path = snapshots.save(step=step, arrays=arrays, meta=meta,
                              journal_seq=(journal.seq if journal is not None
                                           else 0),
                              dtypes=dtypes)
        if journal is not None:
            journal.snapshot(step, path.name)
        last_snap = step

    def pending() -> bool:
        return (lc.open_count() > 0
                or (source is not None and not source.exhausted()))

    while pending():
        if tick is not None:
            tick(step)
        if source is not None:
            source.pump(lc, step)
        if step > max_steps:
            raise RuntimeError(
                f"serve loop exceeded {max_steps} steps without draining; "
                f"lifecycle table:\n{lc.table()}")
        if snapshots is not None and snapshots.due(step, last_snap):
            take_snapshot()
        admits = []
        for slot in range(server.batch):
            if server.slot_req[slot] >= 0:
                continue
            req = (scheduler.pop_ready(lc, step) if scheduler is not None
                   else lc.pop_ready(step))
            if req is None:
                break
            admits.append((slot, req))
        chunk = None
        if len(admits) > 1 and server.can_chunk():
            for slot, req in admits:
                lc.transition(req, State.PREFILLING, step)
            ok_admit, c_nxt, c_rode, c_done, c_bad = server.admit_chunk(
                [(slot, req.rid, req.prompt, req.gen_len)
                 for slot, req in admits])
            chunked_prefills += 1
            for slot, req in admits:
                if not ok_admit[slot]:
                    server.release_slot(slot)
                    lc.evict(req, step, reason="nan_prefill")
                    continue
                start_decoding(req, slot)
            chunk = (c_nxt, c_rode, c_done, c_bad)
        else:
            for slot, req in admits:
                lc.transition(req, State.PREFILLING, step)
                try:
                    ok = server.prefill(slot, req.rid, req.prompt,
                                        req.gen_len)
                except faults.PrefillInterrupt:
                    # the slot was reset before the interrupt: release it
                    server.release_slot(slot)
                    if server.allocator is not None:
                        server.allocator.release_reservation(req.rid)
                    lc.evict(req, step, reason="prefill_interrupt")
                    continue
                except paging.PageOOM:
                    # admission reservations normally cover the prompt; an
                    # overcommitted pool requeues the request instead
                    kv_ooms += 1
                    server.release_slot(slot)
                    server.allocator.release_reservation(req.rid)
                    lc.evict(req, step, reason="kv_oom")
                    continue
                if not ok:
                    server.release_slot(slot)
                    lc.evict(req, step, reason="nan_prefill")
                    continue
                start_decoding(req, slot)
        max_concurrent = max(max_concurrent,
                             int((server.slot_req >= 0).sum()))
        note_kv()
        for req in lc.check_deadlines(step):
            tslot = np.nonzero(server.slot_req == req.rid)[0]
            if tslot.size:
                server.release_slot(int(tslot[0]))
        if not pending():
            break
        if not (server.slot_req >= 0).any():
            jumps = [s for s in (
                lc.next_eligible_step(),
                source.next_arrival_step(lc, step)
                if source is not None else None) if s is not None]
            if not jumps:
                raise RuntimeError(
                    "serve loop stalled: no occupied slots, empty queue, "
                    f"but {lc.open_count()} request(s) not in a terminal "
                    f"state — a request leaked.  Lifecycle table:\n"
                    f"{lc.table()}")
            step = max(step + 1, min(jumps))
            continue
        if chunk is not None:
            # the chunked forward already advanced every riding slot
            nxt, rode, done, bad = chunk
            advanced = [s for s in rode if s not in bad]
        else:
            t0 = time.monotonic()
            try:
                nxt, done, bad = server.decode_step(step)
            except faults.KernelDispatchFault:
                # No plain path on a card: re-plan the decode kernel and
                # run the untouched step again on it.
                kernel_replans += 1
                server.replan_decode()
                nxt, done, bad = server.decode_step(step, inject=False)
            except paging.PageOOM:
                # pool overcommitted mid-decode: evict the slot with the
                # fewest generated tokens (lowest slot on a tie) and retry
                kv_ooms += 1
                victim = min((s for s in range(server.batch)
                              if server.slot_req[s] >= 0),
                             key=lambda s: (int(server.slot_len[s]), s))
                vreq = lc.requests[int(server.slot_req[victim])]
                server.release_slot(victim)
                lc.evict(vreq, step, reason="kv_oom")
                step += 1
                continue
            if watchdog is not None:
                watchdog.observe(step, time.monotonic() - t0)
            advanced = [s for s in range(server.batch)
                        if server.slot_req[s] >= 0 and s not in bad]
        note_kv()
        for slot in advanced:
            emit(lc.requests[int(server.slot_req[slot])], int(nxt[slot, 0]))
            generated += 1
        for slot in bad:
            # quarantine exactly the poisoned slot: reset and requeue
            req = lc.requests[int(server.slot_req[slot])]
            server.release_slot(slot)
            lc.evict(req, step, reason="nan_decode")
        for slot in done:
            req = lc.requests[int(server.slot_req[slot])]
            lc.transition(req, State.COMPLETED, step)
            server.release_slot(slot)
        step += 1
    if not lc.conserved():
        raise RuntimeError(
            "request conservation violated after drain: "
            f"{lc.counters()} vs submitted={lc.submitted}.  Lifecycle "
            f"table:\n{lc.table()}")
    stats = {"generated": generated, "steps": step,
             "kernel_fallbacks": 0, "kernel_replans": kernel_replans,
             "first_new_token_s": first_new_token_s,
             "max_concurrent": max_concurrent,
             "kv_pages_peak": kv_pages_peak, "kv_peak": kv_peak,
             "kv_ooms": kv_ooms,
             "chunked_prefills": chunked_prefills,
             "snapshots_saved": 0 if snapshots is None else snapshots.saved}
    if snapshots is not None:
        stats["snapshot_bytes"] = snapshots.bytes_written
        stats["snapshot_save_s"] = list(snapshots.save_seconds)
    return stats


def build_fault_plan(*, chaos: bool, fault_seed: int, crash: bool,
                     crash_step: int | None = None):
    """The run's fault schedule: the smoke plan (--chaos), a seeded crash
    (--crash [--crash-step]), or their merge.  None = no injection."""
    plan = faults.FaultPlan.smoke(fault_seed) if chaos else None
    if crash:
        cp = faults.FaultPlan.crash(fault_seed, step=crash_step)
        plan = cp if plan is None else plan.merge(cp)
    return plan


def prepare_resume(state_dir, cfg=None, device="cuda") -> dict:
    """Rebuild the serving state of a crashed run from its
    ``--state-dir``.

    Three durable artifacts drive it:

    * ``serving.json``, the static serving context (arch, batch, cache
      geometry, fault schedule, clock rate), written at run start, so a
      crash before the first snapshot is resumable too;
    * the newest committed snapshot (``snaps/``): lifecycle table, server
      arrays, injector state and decode span at some step S;
    * the journal tail: every record past the snapshot's ``seq``, folded
      on top to bring the lifecycle to the crash point.

    In-flight requests go back onto slots: a slot whose snapshot already
    matches the journal is kept bitwise, one that advanced past the
    snapshot (or never made it into one) is rebuilt by
    `Server.restore_slot`'s re-prefill, which checks the journaled
    continuation.  Requests the crash caught mid-transition
    (PREFILLING, EVICTED, token-less DECODING) are demoted to QUEUED and
    start over.  The server is built on ``device``.

    Returns a dict: cfg, serving, server, lc, journal, snapshots,
    injector, source, step_us, start_step, recovery (the summary block),
    scheduler.
    """
    sd = pathlib.Path(state_dir)
    serving_path = sd / "serving.json"
    if not serving_path.exists():
        raise FileNotFoundError(
            f"{serving_path}: no serving.json — --resume needs the "
            f"--state-dir of a previous journaled run")
    serving = json.loads(serving_path.read_text())
    if cfg is None:
        cfg = (configs.get_smoke(serving["arch"]) if serving["smoke"]
               else configs.get(serving["arch"]))

    records = journal_mod.read_journal(sd / "journal.jsonl")
    snap = snapshot_mod.latest_snapshot(sd / "snaps")
    step_us = serving.get("step_time_us")
    clock = loadgen.VirtualClock(step_us * 1e-6) if step_us else None

    if snap is not None:
        manifest, arrays = snap
        snap_step = int(manifest["step"])
        start_seq = int(manifest["journal_seq"])
        lc = snapshot_mod.restore_lifecycle(manifest["meta"]["lifecycle"],
                                            clock=clock)
        inj_state = manifest["meta"].get("injector")
    else:
        manifest, arrays = None, None
        snap_step, start_seq = 0, 0
        lc = Lifecycle(queue_limit=serving["queue_limit"],
                       max_retries=serving["max_retries"],
                       **({} if clock is None else {"clock": clock}))
        inj_state = None

    # -- fold the journal tail onto the snapshot ----------------------------
    # Direct field mutation, not transition(): the history was validated
    # by the state machine when it was lived, and the admission queue is
    # rebuilt wholesale below.
    queued_order = [r.rid for r in lc._queue]

    def queue_drop(rid: int) -> None:
        if rid in queued_order:
            queued_order.remove(rid)

    tail = [r for r in records if r["seq"] >= start_seq]
    last_step = snap_step
    for rec in tail:
        step = int(rec.get("step", -1))
        last_step = max(last_step, step)
        if clock is not None:
            # virtual time is a function of the step, so replayed stamps
            # land where the live run put them
            clock.on_step(max(step, snap_step))
        kind = rec["kind"]
        if kind == "submit":
            if rec["rid"] in lc.requests:
                continue
            req = Request(rid=rec["rid"],
                          prompt=np.asarray(rec["prompt"], np.int32),
                          gen_len=int(rec["gen_len"]), submit_t=lc.clock(),
                          ttft_deadline_s=rec.get("ttft_deadline_s"),
                          deadline_s=rec.get("deadline_s"))
            lc.requests[req.rid] = req
        elif kind == "state":
            req = lc.requests[rec["rid"]]
            new = State(rec["state"])
            req.retries = int(rec.get("retries", req.retries))
            if new is State.EVICTED:
                lc.evicted_events += 1
            if new is State.QUEUED:
                req.not_before_step = int(rec.get("not_before_step", 0))
                if req.tokens:
                    req.tokens = []       # eviction requeue discards output
                if step >= 0:             # retry requeue, not admission
                    lc.retried_events += 1
                queue_drop(req.rid)
                queued_order.append(req.rid)
            else:
                queue_drop(req.rid)
            if new in TERMINAL and req.finish_t is None:
                req.finish_t = lc.clock()
            req.state = new
            req.history.append((new, step))
        elif kind == "token":
            req = lc.requests[rec["rid"]]
            del req.tokens[int(rec["i"]):]
            req.tokens.append(int(rec["tok"]))
            if req.first_token_t is None:
                req.first_token_t = lc.clock()

    resume_step = last_step + 1

    # -- demote requests the crash caught mid-transition --------------------
    demoted = []

    def demote(req) -> None:
        req.state = State.QUEUED
        req.tokens = []
        req.not_before_step = resume_step
        req.history.append((State.QUEUED, resume_step))
        queue_drop(req.rid)
        queued_order.append(req.rid)
        demoted.append(req.rid)

    for rid in sorted(lc.requests):
        req = lc.requests[rid]
        if req.state in (State.PREFILLING, State.EVICTED) or (
                req.state is State.DECODING and not req.tokens):
            demote(req)

    lc._queue = collections.deque(
        lc.requests[rid] for rid in queued_order
        if lc.requests[rid].state is State.QUEUED)

    if clock is not None:
        clock.on_step(resume_step)
    else:
        # Wall-clock runs: rebase the restored stamps onto this process's
        # monotonic clock, so deadlines do not charge the downtime.
        times = [t for r in lc.requests.values()
                 for t in (r.submit_t, r.first_token_t, r.finish_t)
                 if t is not None]
        if times:
            offset = time.monotonic() - max(times)
            for r in lc.requests.values():
                r.submit_t += offset
                if r.first_token_t is not None:
                    r.first_token_t += offset
                if r.finish_t is not None:
                    r.finish_t += offset

    # -- injector: the same seeded schedule, minus the crash that fired -----
    plan = build_fault_plan(chaos=serving.get("chaos", False),
                            fault_seed=serving.get("fault_seed", 0),
                            crash=serving.get("crash", False),
                            crash_step=serving.get("crash_step"))
    injector = None
    if plan is not None:
        if inj_state is None:
            # crash before the first snapshot: the whole plan is pending;
            # the prefill ordinal is the count of journaled prefills
            inj_state = {"pending": plan.record(), "fired": [],
                         "prefill_count": sum(
                             1 for r in records if r["kind"] == "state"
                             and r["state"] == State.PREFILLING.value)}
        injector = faults.FaultInjector.restore(plan, inj_state,
                                                resume_step=resume_step)

    # -- server: snapshot arrays, then re-prefill what moved past it --------
    pg = serving.get("paging")
    paged = (paging.PageSpec(page_size=int(pg["page_size"]),
                             num_pages=int(pg["num_pages"]),
                             max_pages=int(pg["max_pages"]))
             if pg else None)
    server = Server(cfg, int(serving["batch"]), int(serving["max_len"]),
                    prefill_len=int(serving["prefill_len"]),
                    slot_lengths=serving["dist"], injector=injector,
                    paged=paged, device=device,
                    kv_dtype=getattr(torch, serving.get("kv_dtype",
                                                        "float32")))
    if arrays is not None:
        server.restore_state(arrays, snapshot_mod.leaf_dtypes(manifest),
                             decode_span=manifest["meta"].get("decode_span"))

    reprefilled, placed = [], set()
    for slot in range(server.batch):
        rid = int(server.slot_req[slot])
        if rid < 0:
            continue
        req = lc.requests.get(rid)
        if req is None or req.state is not State.DECODING:
            server.release_slot(slot)     # finished or demoted in the tail
            continue
        if (len(req.tokens) == int(server.slot_len[slot]) + 1
                and int(server.last_tok[slot, 0]) == req.tokens[-1]):
            placed.add(rid)               # snapshot already at crash point
            continue
        server.restore_slot(slot, rid, req.prompt, req.tokens, req.gen_len)
        placed.add(rid)
        reprefilled.append(rid)
    for rid in sorted(lc.requests):       # in flight but on no slot
        req = lc.requests[rid]
        if req.state is not State.DECODING or rid in placed:
            continue
        free = [s for s in range(server.batch)
                if int(server.slot_req[s]) < 0]
        if not free:
            demote(req)
            lc._queue.append(req)
            continue
        server.restore_slot(free[0], rid, req.prompt, req.tokens,
                            req.gen_len)
        placed.add(rid)
        reprefilled.append(rid)

    # -- scheduler: re-pledge the in-flight footprints ----------------------
    sched_policy = serving.get("sched", "fcfs")
    scheduler = (Scheduler(sched_policy, allocator=server.allocator)
                 if (paged is not None or sched_policy != "fcfs") else None)
    if server.allocator is not None:
        # The dead process's reservations died with it; re-pledge each
        # placed request's remaining footprint.
        for slot in range(server.batch):
            rid = int(server.slot_req[slot])
            if rid < 0 or rid not in lc.requests:
                continue
            req = lc.requests[rid]
            total = int(len(req.prompt)) + int(req.gen_len)
            short = (server.allocator.pages_for(total)
                     - server.allocator.slot_pages(slot))
            if short > 0:
                server.allocator.reserve(rid, short * paged.page_size)

    # -- arrival source: re-cursor past the journaled prefix ----------------
    source = None
    if serving.get("load_trace"):
        trace = loadgen.load_trace(serving["load_trace"])
        source = loadgen.TraceSource(trace, cfg.vocab_size)
        source.skip_submitted(lc)

    # -- reattach durability (Journal.__init__ truncates a torn tail) -------
    journal = journal_mod.Journal(sd / "journal.jsonl")
    lc.journal = journal
    snapshots = snapshot_mod.SnapshotStore(
        sd / "snaps", every=serving.get("snapshot_every", 8),
        keep=serving.get("snapshot_keep", 3))

    recovery = {
        "resumed": True,
        "snapshot_step": None if manifest is None else snap_step,
        "resume_step": resume_step,
        "replayed_steps": resume_step - snap_step,
        "replayed_records": len(tail),
        "reprefilled_slots": len(reprefilled),
        "restored_requests": len(lc.requests),
        "demoted": demoted,
        "near_ties": list(server.near_ties),
        "decode_span": server.decode_span,
    }
    return {"cfg": cfg, "serving": serving, "server": server, "lc": lc,
            "journal": journal, "snapshots": snapshots,
            "injector": injector, "source": source, "step_us": step_us,
            "start_step": resume_step, "recovery": recovery,
            "scheduler": scheduler}


def _summary(server: Server, lc: Lifecycle, stats: dict, wall: float, *,
             batch: int, batch_source: str, watchdog, scheduler=None) -> dict:
    """The conservation-bearing summary line, with the JAX server's keys,
    its ``sched`` and paged ``kv`` blocks, the decode span the cache ran
    (None: the kernels' default) and the decode kernel's re-plans."""
    out = {
        "arch": server.cfg.name,
        "requests": lc.counters()["completed"],
        "submitted": lc.submitted,
        "batch": batch, "batch_source": batch_source,
        "tokens_generated": stats["generated"],
        "decode_steps": stats["steps"],
        "decode_forwards": server.decode_forwards,
        "wall_s": round(wall, 2),
        "tok_per_s": round(stats["generated"] / max(wall, 1e-9), 1),
        "outcomes": lc.counters(),
        "retries_total": lc.retried_events,
        "kernel_fallbacks": stats["kernel_fallbacks"],
        "kernel_replans": stats["kernel_replans"],
        "snapshots_saved": stats["snapshots_saved"],
        "max_concurrent": stats["max_concurrent"],
        "chunked_prefills": stats["chunked_prefills"],
        "ttft_ms": lc.ttft_percentiles(),
        "per_token_ms": lc.per_token_percentiles(),
        "request_outcomes": lc.outcome_trace(),
        "watchdog": watchdog.summary(),
        "kv_dtype": str(server.kv_dtype).removeprefix("torch."),
        "kernel_plan": [p.record() for p in server.kernel_plan],
        "decode_span": server.decode_span,
        "device": (torch.cuda.get_device_name(server.device)
                   if server.device.type == "cuda" else "cpu"),
    }
    if "snapshot_bytes" in stats:
        out["snapshot_bytes"] = stats["snapshot_bytes"]
        out["snapshot_save_s"] = stats["snapshot_save_s"]
    if scheduler is not None:
        out["sched"] = {"policy": scheduler.policy,
                        "rejected_oversize": scheduler.rejected_oversize}
    if server.allocator is not None:
        # pages allocated vs tokens resident in them at drain, and the peak
        resident = int(server.cache["lengths"].cpu().numpy()[
            server.slot_req >= 0].sum())
        out["kv"] = {**server.allocator.utilization(resident),
                     "pages_peak": stats.get("kv_pages_peak", 0),
                     "peak": stats.get("kv_peak"),
                     "kv_ooms": stats.get("kv_ooms", 0)}
    return out


def _load_block(trace_path, source, step_us) -> dict:
    return {"trace": trace_path, "arrivals": len(source.trace),
            "step_time_us": None if step_us is None else round(step_us, 3),
            "queue_depth_max": max((q[1] for q in source.queue_depth),
                                   default=0)}


def _chip(device: torch.device) -> hardware.Chip:
    return hardware.detect() if device.type == "cuda" else hardware.H100_SXM


def _crash_line(cf, state_dir) -> str:
    return json.dumps({"crash": {"step": cf.step, "msg": str(cf),
                                 "state_dir": state_dir}})


def _run_resume(args) -> int:
    """`serve --resume`: rebuild from --state-dir and drain to a summary
    whose completions are token for token those of the uninterrupted
    run."""
    t0 = time.time()
    try:
        R = prepare_resume(args.state_dir, device=args.device)
        server, lc, serving = R["server"], R["lc"], R["serving"]
        print(json.dumps({"params_digest": params_digest(server.params)}))
        if R["injector"] is not None:
            autotune.install_dispatch_hook(R["injector"].dispatch_hook)
        watchdog = DecodeWatchdog(autotune.predict_decode_step_us(
            server.cfg, server.batch, cache_len=server.max_len,
            kv_dtype=server.kv_dtype,
            lengths=autotune._quantile_lengths(
                server.batch, serving["dist"], server.max_len),
            plans=server.kernel_plan, chip=_chip(server.device))
            if server.kernel_plan else None)
        prep_s = time.time() - t0
        print(json.dumps({"recovery": {**R["recovery"],
                                       "prepare_s": round(prep_s, 3)}}))
        try:
            stats = serve_loop(server, lc, watchdog=watchdog,
                               source=R["source"], journal=R["journal"],
                               snapshots=R["snapshots"],
                               start_step=R["start_step"],
                               scheduler=R["scheduler"])
        except faults.CrashFault as cf:
            print(_crash_line(cf, args.state_dir))
            R["journal"].close()
            return CRASH_EXIT
        wall = time.time() - t0
        R["journal"].close()
    finally:
        autotune.install_dispatch_hook(None)

    summary = _summary(server, lc, stats, wall, batch=server.batch,
                       batch_source="resume", watchdog=watchdog,
                       scheduler=R["scheduler"])
    summary["recovery"] = {
        **R["recovery"],
        "prepare_s": round(prep_s, 3),
        # --resume start to the first newly generated token
        "first_new_token_s": (
            None if stats["first_new_token_s"] is None
            else round(prep_s + stats["first_new_token_s"], 3)),
    }
    if R["injector"] is not None:
        summary["faults"] = R["injector"].record()
    if R["source"] is not None:
        summary["load"] = _load_block(serving.get("load_trace"),
                                      R["source"], R["step_us"])
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=0,
                    help="decode batch; 0 = let the autotuner pick "
                         "(select_serving_batch sweep)")
    ap.add_argument("--batch-candidates", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--latency-budget-ms", type=float, default=None,
                    help="per-decode-step latency ceiling for the batch "
                         "sweep (None = pure throughput)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--kv-dtype", default="f32", choices=list(KV_DTYPES),
                    help="KV-cache storage dtype: int8 stores codes and one "
                         "f32 scale per token row and KV head")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: a pool of page-size-token pages "
                         "shared by every slot through per-slot page tables")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="pages in the pool (with --paged); 0 = the "
                         "contiguous equivalent, batch * ceil(max_len / "
                         "page_size)")
    ap.add_argument("--sched", default="fcfs", choices=list(POLICIES),
                    help="admission policy; with --paged admission also "
                         "waits for the pool to cover the request's "
                         "predicted KV footprint")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="admission-queue bound; submits past it are "
                         "REJECTED (0 = unbounded)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="retry budget for evicted requests")
    ap.add_argument("--ttft-ms", type=float, default=None,
                    help="time-to-first-token deadline per request")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="total deadline per request")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--chaos", action="store_true",
                    help="inject the seeded smoke fault schedule (one fault "
                         "of each class)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the --chaos and --crash schedules")
    ap.add_argument("--load-trace", default=None,
                    help="replay a runtime.loadgen JSONL trace: arrivals "
                         "fire on a virtual clock (one --step-time-us per "
                         "loop step) instead of --requests prompts at t0")
    ap.add_argument("--step-time-us", type=float, default=0.0,
                    help="virtual decode-step time for --load-trace; 0 = "
                         "the tuner's predicted step time")
    ap.add_argument("--state-dir", default=None,
                    help="directory for the request journal and state "
                         "snapshots (crash tolerance, --resume)")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="decode steps between state snapshots")
    ap.add_argument("--snapshot-keep", type=int, default=3,
                    help="committed snapshots kept after pruning")
    ap.add_argument("--crash", action="store_true",
                    help="inject a seeded crash: the process dies mid-serve "
                         f"(exit {CRASH_EXIT}) leaving only the journal and "
                         "snapshots; with --state-dir, then --resume")
    ap.add_argument("--crash-step", type=int, default=None,
                    help="pin the --crash decode step (default: seeded)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a crashed run from --state-dir instead of "
                         "starting fresh")
    args = ap.parse_args(argv)
    # The products the models compute in f32 (the MoE router, the RWKV
    # decay, the Mamba step) run in full f32 on a card, never in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.resume:
        if not args.state_dir:
            ap.error("--resume requires --state-dir")
        return _run_resume(args)
    if args.batch < 0:
        ap.error("--batch must be >= 0")
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if cfg.family == "encoder":
        print("encoder-only arch has no decode path; nothing to serve")
        return 0

    device = resolve_device(args.device)
    kv_dtype = KV_DTYPES[args.kv_dtype]
    trace = None
    if args.load_trace:
        # Replay: the workload is the trace's, so the slot-depth
        # distribution and the cache come from its lengths (a request's
        # midpoint depth is where a slot serving it spends its time).
        trace = loadgen.load_trace(args.load_trace)
        args.requests = len(trace)
        prefill_len = max(t.prompt_len for t in trace)
        max_len = max(t.prompt_len + t.gen_len for t in trace) + 8
        dist = sorted(t.prompt_len + t.gen_len // 2 for t in trace)
    else:
        prefill_len = args.prompt_len
        max_len = args.prompt_len + args.gen + 8
        # The steady-state slot-depth distribution: continuous batching
        # staggers the occupied slots over [prompt, prompt + gen], the
        # length model of the batch sweep and of the decode plan.
        n_dist = max(args.batch_candidates + [args.batch, 1])
        dist = [args.prompt_len + ((2 * i + 1) * args.gen) // (2 * n_dist)
                for i in range(n_dist)]
    chip = _chip(device)
    if args.batch > 0:
        decision = {"batch": args.batch, "source": "flag"}
    else:
        # Candidates past the queued workload only add empty slots.
        cands = [c for c in args.batch_candidates if c <= args.requests]
        cands = cands or [min(args.batch_candidates)]
        decision = autotune.select_serving_batch(
            cfg, cache_len=max_len, prefill_len=prefill_len,
            kv_dtype=kv_dtype, candidates=tuple(cands), slot_lengths=dist,
            latency_budget_ms=args.latency_budget_ms,
            pool_pages=(args.pool_pages or None) if args.paged else None,
            page_size=args.page_size if args.paged else None, chip=chip,
            device=device)
        decision["source"] = "autotune"
        decision["chip"] = chip.variant
    batch = decision["batch"]
    print(json.dumps({"serving_plan": decision}))
    paged = None
    if args.paged:
        if cfg.family not in ("dense", "moe") or not cfg.causal \
                or cfg.sliding_window:
            ap.error("--paged needs a dense/moe causal arch without "
                     "sliding-window attention (the SWA ring buffer is "
                     "contiguous-only)")
        paged = paging.PageSpec.build(batch, max_len, args.page_size,
                                      pool_pages=args.pool_pages)
        print(json.dumps({"paging": {"page_size": paged.page_size,
                                     "num_pages": paged.num_pages,
                                     "max_pages": paged.max_pages}}))

    injector = None
    plan = build_fault_plan(chaos=args.chaos, fault_seed=args.fault_seed,
                            crash=args.crash, crash_step=args.crash_step)
    if plan is not None:
        injector = faults.FaultInjector(plan)
        print(json.dumps({"fault_plan": {"seed": args.fault_seed,
                                         "schedule": plan.record()}}))

    journal = snapshots = None
    state_dir = pathlib.Path(args.state_dir) if args.state_dir else None
    if state_dir is not None:
        # A fresh run owns its state dir: a previous run's journal or
        # snapshots would corrupt the recovery's accounting.
        state_dir.mkdir(parents=True, exist_ok=True)
        (state_dir / "journal.jsonl").unlink(missing_ok=True)
        for p in (state_dir / "snaps").glob("snap-*"):
            p.unlink()
        journal = journal_mod.Journal(state_dir / "journal.jsonl")
        snapshots = snapshot_mod.SnapshotStore(state_dir / "snaps",
                                               every=args.snapshot_every,
                                               keep=args.snapshot_keep)

    source = step_us = None
    if trace is not None:
        # One predicted decode step of virtual time per loop step: TTFT
        # and per-token percentiles in model milliseconds, deterministic.
        step_us = args.step_time_us or loadgen.virtual_step_us(
            decision.get("predicted_step_us")
            or autotune.predict_decode_step_us(
                cfg, batch, cache_len=max_len, kv_dtype=kv_dtype,
                lengths=autotune._quantile_lengths(batch, dist, max_len),
                chip=chip))
        source = loadgen.TraceSource(trace, cfg.vocab_size)
        lc = Lifecycle(queue_limit=args.queue_limit,
                       max_retries=args.max_retries,
                       clock=loadgen.VirtualClock(step_us * 1e-6),
                       journal=journal)
    else:
        rng = np.random.default_rng(0)
        lc = Lifecycle(queue_limit=args.queue_limit,
                       max_retries=args.max_retries, journal=journal)
        for rid in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
            lc.submit(rid, prompt, args.gen,
                      ttft_deadline_s=(args.ttft_ms / 1e3
                                       if args.ttft_ms else None),
                      deadline_s=(args.deadline_ms / 1e3
                                  if args.deadline_ms else None))

    if state_dir is not None:
        # The static serving context, durable before any step can crash:
        # --resume rebuilds the server, clock and fault schedule from it
        # even when the crash predates the first snapshot.
        atomic_write_json(state_dir / "serving.json", {
            "arch": args.arch, "smoke": bool(args.smoke),
            "batch": batch, "max_len": max_len,
            "prefill_len": prefill_len, "dist": [int(d) for d in dist],
            "decision": decision,
            "queue_limit": args.queue_limit,
            "max_retries": args.max_retries,
            "snapshot_every": args.snapshot_every,
            "snapshot_keep": args.snapshot_keep,
            "step_time_us": step_us,
            "load_trace": args.load_trace,
            "chaos": bool(args.chaos), "fault_seed": args.fault_seed,
            "crash": bool(args.crash), "crash_step": args.crash_step,
            "requests": args.requests, "prompt_len": args.prompt_len,
            "gen": args.gen,
            "ttft_ms": args.ttft_ms, "deadline_ms": args.deadline_ms,
            "paging": (None if paged is None else
                       {"page_size": paged.page_size,
                        "num_pages": paged.num_pages,
                        "max_pages": paged.max_pages}),
            "sched": args.sched,
            "kv_dtype": str(kv_dtype).removeprefix("torch."),
        })

    try:
        if injector is not None:
            autotune.install_dispatch_hook(injector.dispatch_hook)
        server = Server(cfg, batch, max_len, kv_dtype=kv_dtype,
                        device=device, paged=paged, prefill_len=prefill_len,
                        slot_lengths=dist, injector=injector)
        # A resumed process must rebuild these weights bit for bit.
        print(json.dumps({"params_digest": params_digest(server.params)}))
        scheduler = (Scheduler(args.sched, allocator=server.allocator)
                     if (paged is not None or args.sched != "fcfs") else None)
        watchdog = DecodeWatchdog(autotune.predict_decode_step_us(
            cfg, batch, cache_len=max_len, kv_dtype=kv_dtype,
            lengths=autotune._quantile_lengths(batch, dist, max_len),
            plans=server.kernel_plan, chip=chip))
        t0 = time.time()
        try:
            stats = serve_loop(server, lc, watchdog=watchdog, source=source,
                               journal=journal, snapshots=snapshots,
                               scheduler=scheduler)
        except faults.CrashFault as cf:
            # The one fault the process must not absorb: no summary, a
            # distinct exit code; only the journal and snapshots survive.
            print(_crash_line(cf, args.state_dir))
            if journal is not None:
                journal.close()
            return CRASH_EXIT
        wall = time.time() - t0
        if journal is not None:
            journal.close()
    finally:
        autotune.install_dispatch_hook(None)

    summary = _summary(server, lc, stats, wall, batch=batch,
                       batch_source=decision["source"], watchdog=watchdog,
                       scheduler=scheduler)
    if injector is not None:
        summary["faults"] = injector.record()
    if source is not None:
        summary["load"] = _load_block(args.load_trace, source, step_us)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
