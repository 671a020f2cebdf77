"""Batched greedy serving: ragged continuous batching with a request
lifecycle.  Counterpart of `repro.launch.serve`, contiguous KV cache and
first-come-first-served admission.

Requests enter a bounded admission queue (`runtime.lifecycle`) and move
through its state machine.  The server packs up to ``--batch`` sequences;
a burst of arrivals is prefilled as one chunked forward (every admitted
prompt plus each in-flight slot's next token, under a (B, S) ``active``
mask), a single arrival by a masked one-slot prefill.  Each decode step
then runs every occupied slot at its own cache depth; the single-token
attention goes through the CUDA decode kernel on a card.  Finished slots
are zeroed and refilled.  The summary line conserves every submitted
request: ``submitted == completed + timed_out + failed + rejected``.

A kernel failure raises.  The JAX server's degradation step (rerunning a
failed step on the reference path) is deliberately not ported: it is the
fallback that would hide the kernel.  Not ported yet, and refused by name:
``--batch 0`` (ROADMAP A8), ``--paged`` (A6), ``--sched`` other than fcfs
(A5), ``--kv-dtype int8`` (A7), ``--chaos`` / ``--state-dir`` (A9) and
``--load-trace`` (A10).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \\
      --smoke --batch 2 --requests 6 --prompt-len 16 --gen 12 [--device cpu]
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
from repro_torch.models import transformer
from repro_torch.runtime.fault_tolerance import DecodeWatchdog
from repro_torch.runtime.lifecycle import Lifecycle, State

# The JAX server's forward runs at transformer.forward's default, bf16.
COMPUTE_DTYPE = torch.bfloat16
KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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
    ``cuda`` and raises without a card."""

    def __init__(self, cfg, batch: int, max_len: int, *, params=None,
                 kv_dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = transformer.init(cfg, gen, dtype=COMPUTE_DTYPE)
        self.params = _cast_weights(params, COMPUTE_DTYPE, self.device)
        self.serve_step = steps.make_guarded_serve_step(cfg, COMPUTE_DTYPE)
        self.cache = transformer.cache_init(cfg, batch, max_len,
                                            dtype=kv_dtype,
                                            device=self.device)
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
        the slot.  Returns True iff its first-token logits were finite."""
        prompt = np.asarray(prompt, np.int32)
        transformer.cache_reset_slot(self.cache, slot)
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
        for slot, _, _, _ in admits:
            transformer.cache_reset_slot(self.cache, slot)
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
        """Free a slot and zero its cache rows."""
        self.slot_req[slot] = -1
        transformer.cache_reset_slot(self.cache, slot)

    def decode_step(self):
        """One ragged decode step over the occupied slots; idle slots
        neither write nor advance.  Returns ``(next_tokens, done, bad)``:
        ``bad`` slots produced non-finite logits, did not advance, and must
        be quarantined by the caller."""
        active = self.slot_req >= 0
        nxt, ok = self._step(self.last_tok, active)
        adv = active & ok
        self.last_tok = np.where(adv[:, None], nxt, self.last_tok)
        self.slot_len[adv] += 1
        done = [s for s in range(self.batch)
                if adv[s] and self.slot_len[s] >= self.slot_target[s]]
        bad = [s for s in range(self.batch) if active[s] and not ok[s]]
        return nxt, done, bad


def serve_loop(server: Server, lc: Lifecycle, *, watchdog=None,
               max_steps: int = 100_000) -> dict:
    """Drain every admitted request to a terminal state.

    Each iteration fills idle slots (chunked when more than one request is
    admitted), sweeps deadlines, and decodes one step, or jumps the step
    counter to the next retry-backoff eligibility; it raises with the
    lifecycle table instead of spinning when no progress is possible.
    """
    step = 0
    generated = 0
    max_concurrent = 0
    chunked_prefills = 0

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
            req = lc.pop_ready(step)
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
                if not server.prefill(slot, req.rid, req.prompt,
                                      req.gen_len):
                    server.release_slot(slot)
                    lc.evict(req, step, reason="nan_prefill")
                    continue
                start_decoding(req, slot)
        max_concurrent = max(max_concurrent,
                             int((server.slot_req >= 0).sum()))
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
            nxt, done, bad = server.decode_step()
            if watchdog is not None:
                watchdog.observe(step, time.monotonic() - t0)
            advanced = [s for s in range(server.batch)
                        if server.slot_req[s] >= 0 and s not in bad]
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
            "chunked_prefills": chunked_prefills}


def _summary(server: Server, lc: Lifecycle, stats: dict, wall: float, *,
             batch: int, batch_source: str, watchdog) -> dict:
    """The conservation-bearing summary line, with the JAX server's keys
    (no kernel plan: the port has no tuner yet, ROADMAP A8)."""
    return {
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
    ap.add_argument("--kv-dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="KV-cache storage dtype (int8: ROADMAP A7)")
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
    ap.add_argument("--paged", action="store_true", help="ROADMAP A6")
    ap.add_argument("--sched", default="fcfs",
                    choices=["fcfs", "spf", "paged-aware"],
                    help="only fcfs is ported (ROADMAP A5)")
    ap.add_argument("--chaos", action="store_true", help="ROADMAP A9")
    ap.add_argument("--state-dir", default=None, help="ROADMAP A9")
    ap.add_argument("--load-trace", default=None, help="ROADMAP A10")
    args = ap.parse_args(argv)

    refused = [
        (args.batch == 0, "--batch 0 (the autotuned batch sweep)", "A8"),
        (args.paged, "--paged (the paged KV cache)", "A6"),
        (args.sched != "fcfs", f"--sched {args.sched}", "A5"),
        (args.kv_dtype == "int8", "--kv-dtype int8", "A7"),
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
                    device=args.device)
    watchdog = DecodeWatchdog(None)
    t0 = time.time()
    stats = serve_loop(server, lc, watchdog=watchdog)
    wall = time.time() - t0
    print(json.dumps(_summary(server, lc, stats, wall, batch=batch,
                              batch_source="flag", watchdog=watchdog)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
