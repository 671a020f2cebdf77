"""Batched greedy serving: ragged continuous batching with a request
lifecycle.  Counterpart of `repro.launch.serve`.

Requests enter a bounded admission queue (`runtime.lifecycle`) and move
through its state machine.  The server packs up to ``--batch`` sequences;
a burst of arrivals is prefilled as one chunked forward (every admitted
prompt plus each in-flight slot's next token, under a (B, S) ``active``
mask), a single arrival by a masked one-slot prefill.  Each decode step
then runs every occupied slot at its own cache depth; the single-token
attention goes through the CUDA decode kernel of the cache's layout on a
card.  Finished slots are zeroed and refilled.  The summary line conserves
every submitted request: ``submitted == completed + timed_out + failed +
rejected``.

The KV cache is contiguous (f32, bf16 or int8 with per-row scales,
``--kv-dtype``) or paged (``--paged --page-size --pool-pages``): a pool of
pages shared by every slot, handed out by a host `PageAllocator` whose
table the server copies to the device after every change.  ``--sched
fcfs|spf|paged-aware`` picks the admission policy (`launch.scheduler`);
with a paged cache a request is admitted only when the pool can cover its
predicted footprint, and the summary carries ``sched`` and ``kv`` blocks.

A kernel failure raises.  The JAX server's degradation step (rerunning a
failed step on the reference path) is deliberately not ported: it is the
fallback that would hide the kernel.  Not ported yet, and refused by name:
``--batch 0`` (ROADMAP A8), ``--chaos`` / ``--state-dir`` (A9) and
``--load-trace`` (A10).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \\
      --smoke --batch 2 --requests 6 --prompt-len 16 --gen 12 \\
      [--paged] [--sched spf] [--kv-dtype int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.scheduler import POLICIES, Scheduler
from repro_torch.models import transformer
from repro_torch.runtime import paging
from repro_torch.runtime.fault_tolerance import DecodeWatchdog
from repro_torch.runtime.lifecycle import Lifecycle, State

# The JAX server's forward runs at transformer.forward's default, bf16.
COMPUTE_DTYPE = torch.bfloat16
KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}


def _cast_weights(params: dict, dtype, device) -> dict:
    """Every leaf the forward only consumes through ``.to(compute dtype)``
    (matrices, biases, embedding tables) cast to ``dtype`` once; the norm
    scales (leaves named ``scale``) keep their dtype.  The numbers are
    those of casting at every use."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v.to(device) if k == "scale"
                    else v.to(device=device, dtype=dtype))
                for k, v in tree.items()}
    return walk(params)


class Server:
    """A continuous-batching server over ``batch`` cache slots of
    ``max_len`` rows.

    ``params`` is a JAX-layout parameter tree (for example converted from
    the JAX server's); when it is None, random weights are drawn on the
    device from a ``torch.Generator`` seeded with 0.  Either way the
    matrices are held in the compute dtype (bf16).  ``device`` defaults to
    ``cuda`` and raises without a card.  ``kv_dtype`` is the cache's
    storage type (f32, bf16 or int8).  ``paged`` (a
    `runtime.paging.PageSpec`, or None for the contiguous cache) switches
    the cache to the page-pool layout; the host `PageAllocator` is the
    truth and `_sync_pages` copies its table to the device cache."""

    def __init__(self, cfg, batch: int, max_len: int, *, params=None,
                 kv_dtype=torch.float32, device="cuda", paged=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self.paged = paged
        self.allocator = (paging.PageAllocator(paged, batch)
                          if paged is not None else None)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = transformer.init(cfg, gen, dtype=COMPUTE_DTYPE)
        self.params = _cast_weights(params, COMPUTE_DTYPE, self.device)
        self.serve_step = steps.make_guarded_serve_step(cfg, COMPUTE_DTYPE,
                                                        paged=paged)
        self.cache = transformer.cache_init(cfg, batch, max_len,
                                            dtype=kv_dtype,
                                            device=self.device, paged=paged)
        self.slot_len = np.zeros(batch, np.int32)      # tokens generated
        self.slot_target = np.zeros(batch, np.int32)   # stop length
        self.slot_req = -np.ones(batch, np.int32)      # request id
        self.last_tok = np.zeros((batch, 1), np.int32)
        self.decode_forwards = 0                       # forwards with S == 1

    def _step(self, tokens: np.ndarray, active: np.ndarray):
        """One guarded forward; returns host ``(next (B, 1), ok (B,))``."""
        dev = self.device
        nxt, ok, self.cache = self.serve_step(
            self.params, self.cache, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(active, device=dev))
        if tokens.shape[1] == 1:
            self.decode_forwards += 1
        return nxt.cpu().numpy(), ok.cpu().numpy()

    def prefill(self, slot: int, req_id: int, prompt, gen_len: int) -> bool:
        """Masked batched prefill of one slot: the whole prompt in one
        forward whose ``active`` mask is the slot's one-hot, after zeroing
        the slot (and, paged, covering the prompt with pages).  Returns
        True iff its first-token logits were finite; raises
        `paging.PageOOM` when the pool cannot cover the prompt."""
        prompt = np.asarray(prompt, np.int32)
        self._fresh_slot(slot, req_id, prompt.size)
        if self.allocator is not None:
            self._sync_pages()
        toks = np.zeros((self.batch, prompt.size), np.int32)
        toks[slot] = prompt
        active = np.zeros((self.batch,), bool)
        active[slot] = True
        nxt, ok = self._step(toks, active)
        self.last_tok[slot, 0] = nxt[slot, 0]
        self.slot_len[slot] = 0
        self.slot_target[slot] = gen_len
        self.slot_req[slot] = req_id
        return bool(ok[slot])

    def can_chunk(self) -> bool:
        """Chunked prefill needs the (B, S) active-mask path of a causal
        attention stack."""
        return self.cfg.causal and not self.cfg.sliding_window

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
        nxt, ok = self._step(tokens, act)
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

    def release_slot(self, slot: int) -> None:
        """Free a slot and zero its cache rows; paged, its pages return to
        the pool and its outstanding reservation is dropped."""
        rid = int(self.slot_req[slot])
        self.slot_req[slot] = -1
        transformer.cache_reset_slot(self.cache, slot, paged=self.paged)
        if self.allocator is not None:
            self.allocator.free_slot(slot, rid=rid)
            self._sync_pages()

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

    def decode_step(self):
        """One ragged decode step over the occupied slots; idle slots
        neither write nor advance.  Returns ``(next_tokens, done, bad)``:
        ``bad`` slots produced non-finite logits, did not advance, and must
        be quarantined by the caller.  Paged: every occupied slot's table
        first grows to cover the row it writes; an overcommitted pool
        raises `paging.PageOOM`."""
        active = self.slot_req >= 0
        if self.allocator is not None and self._grow(np.flatnonzero(active)):
            self._sync_pages()
        nxt, ok = self._step(self.last_tok, active)
        adv = active & ok
        self.last_tok = np.where(adv[:, None], nxt, self.last_tok)
        self.slot_len[adv] += 1
        done = [s for s in range(self.batch)
                if adv[s] and self.slot_len[s] >= self.slot_target[s]]
        bad = [s for s in range(self.batch) if active[s] and not ok[s]]
        return nxt, done, bad


def serve_loop(server: Server, lc: Lifecycle, *, watchdog=None,
               max_steps: int = 100_000, scheduler=None) -> dict:
    """Drain every admitted request to a terminal state.

    Each iteration fills idle slots (chunked when more than one request is
    admitted), sweeps deadlines, and decodes one step, or jumps the step
    counter to the next retry-backoff eligibility; it raises with the
    lifecycle table instead of spinning when no progress is possible.
    ``scheduler`` (a `launch.scheduler.Scheduler`) replaces the
    lifecycle's FCFS pop; with a paged server it admits a request only
    when the pool can cover it.  A `paging.PageOOM` (an overcommitted
    pool) evicts a request instead of failing the run.
    """
    step = 0
    generated = 0
    max_concurrent = 0
    chunked_prefills = 0
    kv_pages_peak = 0
    kv_peak = None           # allocator utilization at the peak
    kv_ooms = 0

    def note_kv() -> None:
        nonlocal kv_pages_peak, kv_peak
        a = server.allocator
        if a is not None and a.allocated_pages >= kv_pages_peak:
            kv_pages_peak = a.allocated_pages
            kv_peak = a.utilization()

    def start_decoding(req, slot) -> None:
        req.tokens.append(int(server.last_tok[slot, 0]))
        lc.record_first_token(req)
        lc.transition(req, State.DECODING, step)

    while lc.open_count() > 0:
        if step > max_steps:
            raise RuntimeError(
                f"serve loop exceeded {max_steps} steps without draining; "
                f"lifecycle table:\n{lc.table()}")
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
        if lc.open_count() == 0:
            break
        if not (server.slot_req >= 0).any():
            nxt_step = lc.next_eligible_step()
            if nxt_step is None:
                raise RuntimeError(
                    "serve loop stalled: no occupied slots, empty queue, "
                    f"but {lc.open_count()} request(s) not in a terminal "
                    f"state.  Lifecycle table:\n{lc.table()}")
            step = max(step + 1, nxt_step)
            continue
        if chunk is not None:
            # the chunked forward already advanced every riding slot
            nxt, rode, done, bad = chunk
            advanced = [s for s in rode if s not in bad]
        else:
            t0 = time.monotonic()
            try:
                nxt, done, bad = server.decode_step()
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
            lc.requests[int(server.slot_req[slot])].tokens.append(
                int(nxt[slot, 0]))
            generated += 1
        for slot in bad:
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
    return {"generated": generated, "steps": step,
            "max_concurrent": max_concurrent,
            "kv_pages_peak": kv_pages_peak, "kv_peak": kv_peak,
            "kv_ooms": kv_ooms,
            "chunked_prefills": chunked_prefills}


def _summary(server: Server, lc: Lifecycle, stats: dict, wall: float, *,
             batch: int, batch_source: str, watchdog, scheduler=None) -> dict:
    """The conservation-bearing summary line, with the JAX server's keys
    (no kernel plan: the port has no tuner yet, ROADMAP A8), and its
    ``sched`` and paged ``kv`` blocks."""
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
        "kernel_fallbacks": 0,
        "snapshots_saved": 0,
        "max_concurrent": stats["max_concurrent"],
        "chunked_prefills": stats["chunked_prefills"],
        "ttft_ms": lc.ttft_percentiles(),
        "per_token_ms": lc.per_token_percentiles(),
        "request_outcomes": lc.outcome_trace(),
        "watchdog": watchdog.summary(),
        "kv_dtype": str(server.kv_dtype).removeprefix("torch."),
        "kernel_plan": [],
        "device": (torch.cuda.get_device_name(server.device)
                   if server.device.type == "cuda" else "cpu"),
    }
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch (0, the autotuned sweep, is not "
                         "ported yet: ROADMAP A8)")
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
    # Flags of the JAX server that are refused by name until ported.
    ap.add_argument("--chaos", action="store_true", help="ROADMAP A9")
    ap.add_argument("--state-dir", default=None, help="ROADMAP A9")
    ap.add_argument("--load-trace", default=None, help="ROADMAP A10")
    args = ap.parse_args(argv)

    refused = [
        (args.batch == 0, "--batch 0 (the autotuned batch sweep)", "A8"),
        (args.chaos, "--chaos (fault injection)", "A9"),
        (args.state_dir is not None, "--state-dir (crash tolerance)", "A9"),
        (args.load_trace is not None, "--load-trace (trace replay)", "A10"),
    ]
    for hit, what, item in refused:
        if hit:
            ap.error(f"{what} is not ported to repro_torch yet "
                     f"(ROADMAP {item})")
    if args.batch < 0:
        ap.error("--batch must be >= 1")
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if cfg.family != "dense" or cfg.frontend or cfg.sliding_window:
        ap.error(f"{cfg.name} needs a model family or layer that is not "
                 f"ported to repro_torch yet (ROADMAP A12)")

    batch = args.batch
    max_len = args.prompt_len + args.gen + 8
    print(json.dumps({"serving_plan": {"batch": batch, "source": "flag"}}))
    paged = None
    if args.paged:
        paged = paging.PageSpec.build(batch, max_len, args.page_size,
                                      pool_pages=args.pool_pages)
        print(json.dumps({"paging": {"page_size": paged.page_size,
                                     "num_pages": paged.num_pages,
                                     "max_pages": paged.max_pages}}))

    rng = np.random.default_rng(0)
    lc = Lifecycle(queue_limit=args.queue_limit, max_retries=args.max_retries)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        lc.submit(rid, prompt, args.gen,
                  ttft_deadline_s=(args.ttft_ms / 1e3
                                   if args.ttft_ms else None),
                  deadline_s=(args.deadline_ms / 1e3
                              if args.deadline_ms else None))

    server = Server(cfg, batch, max_len, kv_dtype=KV_DTYPES[args.kv_dtype],
                    device=args.device, paged=paged)
    scheduler = (Scheduler(args.sched, allocator=server.allocator)
                 if (paged is not None or args.sched != "fcfs") else None)
    watchdog = DecodeWatchdog(None)
    t0 = time.time()
    stats = serve_loop(server, lc, watchdog=watchdog, scheduler=scheduler)
    wall = time.time() - t0
    print(json.dumps(_summary(server, lc, stats, wall, batch=batch,
                              batch_source="flag", watchdog=watchdog,
                              scheduler=scheduler)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
