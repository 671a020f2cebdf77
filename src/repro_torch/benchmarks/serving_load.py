"""Traffic-shaped serving benchmark: drive `launch.serve.serve_loop` with
seeded load mixes and write a report for the JAX package's unchanged
``tools/check_load.py``.  Counterpart of the JAX package's
``benchmarks/serving_load.py``, with its mixes, seeds and schema.

Each mix in :data:`MIXES` is a seeded workload shape (`runtime.loadgen`):

* ``steady``: open-loop Poisson arrivals at about half the predicted
  capacity, staggered prompt lengths (the sweep's slot-depth model);
* ``bursty``: open-loop arrivals at about 3x capacity, a queue builds;
* ``interactive``: closed-loop think-time sessions;
* ``heavytail``: lognormal prompt and output lengths on the paged cache
  under ``spf`` admission;
* ``quantized``: the steady workload on the int8 cache.

The ``paging`` block replays the heavy-tail workload at one KV-memory
budget, contiguous against paged, and reports the concurrency ratio; the
``recovery`` block crashes the serving CLI at a pinned step and resumes
it.

Every mix runs on the virtual clock (one predicted decode step per loop
step), so TTFT, per-token and tokens/s are model milliseconds, the same
on any machine for the same seeds.  The wall clock rides along in each
mix's ``wall`` block (volatile, `loadgen.strip_volatile`): the measured
decode step beside the predicted one.  SLO budgets are priced in steps.

``--device cpu`` runs the SMOKE config, as the JAX harness does;
``--device cuda`` (the default) runs the full published config (Qwen3-14B
at full width and depth, random weights from a seed) on the card, its
steps priced by the tuner's model of the card.  ``--smoke`` cuts the
request counts only.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_load --smoke \\
      --device cpu --out /tmp/s.json --emit-traces /tmp/traces
  python tools/check_load.py /tmp/s.json
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import platform
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import hardware
from repro_torch.core.ioutil import atomic_write_json
from repro_torch.kernels import autotune
from repro_torch.launch import serve
from repro_torch.launch.scheduler import Scheduler
from repro_torch.runtime import loadgen, paging
from repro_torch.runtime.fault_tolerance import DecodeWatchdog
from repro_torch.runtime.lifecycle import Lifecycle

SERVING_SCHEMA = 3

# At one KV-memory budget the paged allocator must sustain at least this
# many times the contiguous path's concurrent slots.
PAGING_RATIO_FLOOR = 1.5

# One entry per workload shape.  `requests` is the full-run count,
# `smoke_requests` the --smoke count; slo budgets are in decode steps of
# the mix's predicted step time.
MIXES: dict[str, dict] = {
    "steady": {
        "kind": "open",
        "seed": 11,
        "requests": 24,
        "smoke_requests": 10,
        "rate_factor": 0.5,            # x predicted capacity
        "prompt_dist": {"kind": "staggered", "base": 8, "spread": 8},
        "gen_dist": {"kind": "fixed", "value": 8},
        "queue_limit": 0,
        "slo": {"ttft_p99_steps": 30, "per_token_p99_steps": 3,
                "min_tok_per_step_frac": 0.15},
    },
    "bursty": {
        "kind": "open",
        "seed": 13,
        "requests": 28,
        "smoke_requests": 12,
        "rate_factor": 3.0,            # overload: arrivals outrun capacity
        "prompt_dist": {"kind": "uniform", "lo": 6, "hi": 14},
        "gen_dist": {"kind": "choice", "values": [4, 8, 16],
                     "weights": [0.5, 0.375, 0.125]},
        # a capped sweep, so the burst outruns the server and the queue
        # (and the TTFT tail) is exercised
        "batch_candidates": [1, 2, 4],
        "queue_limit": 0,
        "slo": {"ttft_p99_steps": 90, "per_token_p99_steps": 3,
                "min_tok_per_step_frac": 0.3},
    },
    "interactive": {
        "kind": "closed",
        "seed": 17,
        "sessions": 4,
        "requests": 24,
        "smoke_requests": 12,
        "think_steps": {"kind": "exponential", "mean": 5.0},
        "prompt_dist": {"kind": "uniform", "lo": 8, "hi": 12},
        "gen_dist": {"kind": "fixed", "value": 6},
        "queue_limit": 0,
        "slo": {"ttft_p99_steps": 30, "per_token_p99_steps": 3,
                "min_tok_per_step_frac": 0.05},
    },
    "quantized": {
        "kind": "open",
        "seed": 23,
        "requests": 24,
        "smoke_requests": 10,
        "rate_factor": 0.5,
        "prompt_dist": {"kind": "staggered", "base": 8, "spread": 8},
        "gen_dist": {"kind": "fixed", "value": 8},
        "queue_limit": 0,
        "kv_dtype": "int8",
        "slo": {"ttft_p99_steps": 30, "per_token_p99_steps": 3,
                "min_tok_per_step_frac": 0.15},
    },
    "heavytail": {
        "kind": "open",
        "seed": 19,
        "requests": 24,
        "smoke_requests": 12,
        "rate_factor": 1.5,
        "prompt_dist": {"kind": "lognormal", "mean": 8, "sigma": 0.6,
                        "lo": 4, "hi": 48},
        "gen_dist": {"kind": "lognormal", "mean": 6, "sigma": 0.8,
                     "lo": 2, "hi": 40},
        "batch_candidates": [1, 2, 4, 8],
        "queue_limit": 0,
        "paged": True,
        "page_size": 8,
        "sched": "spf",
        "slo": {"ttft_p99_steps": 160, "per_token_p99_steps": 4,
                "min_tok_per_step_frac": 0.15},
    },
}


def default_chip(device) -> hardware.Chip:
    """The chip the model prices: the card present, or the H100 of the
    data sheet on the CPU."""
    device = resolve_device(device)
    return hardware.detect() if device.type == "cuda" else hardware.H100_SXM


def config_for(arch: str, device):
    """The SMOKE config on the CPU, the published one on a card."""
    device = resolve_device(device)
    return configs.get_smoke(arch) if device.type == "cpu" \
        else configs.get(arch)


def _lengths(spec: dict, n: int):
    len_rng = np.random.default_rng(spec["seed"])
    prompts = [max(1, p) for p in
               loadgen.sample_lengths(len_rng, n, spec["prompt_dist"])]
    gens = [max(1, g) for g in
            loadgen.sample_lengths(len_rng, n, spec["gen_dist"])]
    return prompts, gens


def build_trace(spec: dict, n: int, step_s: float, batch: int):
    """The mix's seeded trace.  Lengths are drawn before arrivals (the
    batch sweep needs the slot depths, the arrival rate the chosen
    batch's step time), from independent seeded streams."""
    seed = spec["seed"]
    prompts, gens = _lengths(spec, n)
    if spec["kind"] == "open":
        mean_gen = sum(gens) / n
        # capacity ~= batch slots finishing every (gen+1) steps
        rate_rps = spec["rate_factor"] * batch / ((mean_gen + 1.0) * step_s)
        gaps = np.random.default_rng(seed + 1).exponential(
            1.0 / rate_rps, size=n)
        arrivals = np.cumsum(gaps)
        thinks = [0.0] * n
    else:
        n_sessions = spec["sessions"]
        # sessions_from_trace round-robins rids: session si starts with
        # rid si; its first arrival is si steps in.
        arrivals = np.array([(i % n_sessions) * step_s for i in range(n)])
        think_steps = loadgen.sample_times(
            np.random.default_rng(seed + 2), n, spec["think_steps"])
        thinks = [t * step_s for t in think_steps]
        rate_rps = None
    trace = [loadgen.TraceRequest(
        rid=i, arrival_s=float(arrivals[i]), prompt_len=prompts[i],
        gen_len=gens[i], think_s=thinks[i]) for i in range(n)]
    return trace, rate_rps


def run_mix(cfg, name: str, spec: dict, *, smoke: bool = False,
            batch: int = 0, batch_candidates=(1, 2, 4, 8), emit_dir=None,
            pool_pages: int = 0, device="cuda", chip=None) -> dict:
    """Run one load mix end to end and return its report row.  ``batch``
    forces the decode batch (0 = `select_serving_batch` picks).  Spec
    keys ``paged``, ``page_size`` and ``sched`` run the mix on the paged
    cache under that policy; ``pool_pages`` overrides the pool (the
    paging comparison pins both paths to one KV budget).  ``chip`` is
    the chip the tuner's model prices (default: `default_chip`)."""
    device = resolve_device(device)
    chip = chip or default_chip(device)
    n = spec["smoke_requests"] if smoke else spec["requests"]
    seed = spec["seed"]
    kv_dtype = getattr(torch, spec.get("kv_dtype", "float32"))

    # Phase 1: lengths only, the slot-depth distribution the sweep prices.
    prompts, gens = _lengths(spec, n)
    prefill_len = max(prompts)
    max_len = max(p + g for p, g in zip(prompts, gens)) + 8
    dist = sorted(p + g // 2 for p, g in zip(prompts, gens))

    if batch > 0:
        step_us = autotune.predict_decode_step_us(
            cfg, batch, cache_len=max_len, kv_dtype=kv_dtype,
            lengths=autotune._quantile_lengths(batch, dist, max_len),
            chip=chip, device=device)
        decision = {"batch": batch, "source": "flag",
                    "predicted_step_us": round(step_us, 3)}
    else:
        batch_candidates = spec.get("batch_candidates", batch_candidates)
        cands = [c for c in batch_candidates if c <= n] \
            or [min(batch_candidates)]
        decision = autotune.select_serving_batch(
            cfg, cache_len=max_len, prefill_len=prefill_len,
            kv_dtype=kv_dtype, candidates=tuple(cands), slot_lengths=dist,
            chip=chip, device=device)
        decision["source"] = "autotune"
        batch = decision["batch"]
        step_us = decision["predicted_step_us"]
    # The virtual clock runs at the predicted step floored to one model
    # ms; predicted-against-measured keeps the raw prediction.
    clock_us = loadgen.virtual_step_us(step_us)
    step_s = clock_us * 1e-6

    # Phase 2: arrivals at a rate from the chosen batch's capacity.
    trace, rate_rps = build_trace(spec, n, step_s, batch)
    if emit_dir is not None:
        loadgen.save_trace(pathlib.Path(emit_dir) / f"{name}.jsonl", trace)

    lc = Lifecycle(queue_limit=spec.get("queue_limit", 0),
                   clock=loadgen.VirtualClock(step_s))
    if spec["kind"] == "closed":
        source = loadgen.SessionSource(
            loadgen.sessions_from_trace(trace, spec["sessions"]),
            cfg.vocab_size, seed=seed)
    else:
        source = loadgen.TraceSource(trace, cfg.vocab_size, seed=seed)

    paged_spec = None
    if spec.get("paged"):
        paged_spec = paging.PageSpec.build(
            batch, max_len, spec.get("page_size", 8),
            pool_pages=pool_pages or spec.get("pool_pages", 0))
    sched = spec.get("sched", "fcfs")

    server = serve.Server(cfg, batch, max_len, prefill_len=prefill_len,
                          slot_lengths=dist, paged=paged_spec,
                          kv_dtype=kv_dtype, device=device)
    scheduler = (Scheduler(sched, allocator=server.allocator)
                 if (paged_spec is not None or sched != "fcfs") else None)
    recorder = loadgen.StepTimeRecorder(DecodeWatchdog(step_us))
    t0 = time.time()
    stats = serve.serve_loop(server, lc, watchdog=recorder, source=source,
                             scheduler=scheduler)
    wall = time.time() - t0

    metrics = loadgen.collect_metrics(lc, predicted_step_us=step_us,
                                      step_times=recorder.times,
                                      queue_depth=source.queue_depth)

    # SLOs: budgets in steps, converted at this mix's step time.
    budgets = spec["slo"]
    step_ms = clock_us * 1e-3
    slo = {
        "ttft_p99_ms": round(budgets["ttft_p99_steps"] * step_ms, 3),
        "per_token_p99_ms": round(
            budgets["per_token_p99_steps"] * step_ms, 3),
        "min_tok_per_s": round(
            budgets["min_tok_per_step_frac"] * batch / step_s, 3),
        "budget_steps": dict(budgets),
    }
    violations = []
    ttft_p99 = metrics["ttft_ms"]["p99"]
    if ttft_p99 is None or ttft_p99 > slo["ttft_p99_ms"]:
        violations.append(
            f"ttft p99 {ttft_p99} ms > budget {slo['ttft_p99_ms']} ms")
    ptok_p99 = metrics["per_token_ms"]["p99"]
    if ptok_p99 is None or ptok_p99 > slo["per_token_p99_ms"]:
        violations.append(
            f"per-token p99 {ptok_p99} ms > budget "
            f"{slo['per_token_p99_ms']} ms")
    tok_per_s = metrics["tok_per_s"]
    if tok_per_s is None or tok_per_s < slo["min_tok_per_s"]:
        violations.append(
            f"sustained {tok_per_s} tok/s < floor {slo['min_tok_per_s']}")

    row = {
        "name": name,
        "kind": spec["kind"],
        "seed": seed,
        "batch": batch,
        "batch_source": decision["source"],
        "serving_plan": {k: decision[k] for k in
                         ("batch", "predicted_step_us",
                          "predicted_tok_per_s", "latency_budget_ms")
                         if k in decision},
        "step_time_us": round(clock_us, 3),
        "rate_rps": None if rate_rps is None else round(rate_rps, 3),
        "trace": [t.record() for t in trace],
        "decode_steps": stats["steps"],
        "generated": stats["generated"],
        "max_concurrent": stats.get("max_concurrent", 0),
        "paged": paged_spec is not None,
        "sched": sched,
        "kv_dtype": str(kv_dtype).removeprefix("torch."),
        **metrics,
        "slo": slo,
        "slo_ok": not violations,
        "slo_violations": violations,
        "wall": {"wall_s": round(wall, 3),
                 "wall_tok_per_s": round(stats["generated"]
                                         / max(wall, 1e-9), 1),
                 **recorder.summary()},
    }
    if paged_spec is not None:
        # pages allocated against tokens resident at the pool's peak
        row["kv"] = {**(stats.get("kv_peak")
                        or server.allocator.utilization()),
                     "pages_peak": stats.get("kv_pages_peak", 0),
                     "kv_ooms": stats.get("kv_ooms", 0)}
        server.allocator.check_conserved()   # the pool drains leak-free
    return row


def measure_recovery(arch: str = "qwen3_14b", *, smoke: bool = False,
                     device="cuda") -> dict:
    """The crash-recovery row: the serving CLI crashed at a pinned step
    (`serve --crash --crash-step`) and resumed (`serve --resume`): how far
    the journal bounded the replay (``replayed_steps``, at most the
    snapshot interval), whether every request ended once across both
    processes, and the recovery latency (the ``wall`` block; volatile).
    The SMOKE config on the CPU, the published one on a card."""
    device = resolve_device(device)
    n = 6 if smoke else 10
    gen = 12
    crash_step = 9
    snapshot_every = 4
    state_dir = tempfile.mkdtemp(prefix="repro-torch-recovery-")
    base = ["--arch", arch, "--requests", str(n), "--prompt-len", "12",
            "--gen", str(gen), "--state-dir", state_dir,
            "--snapshot-every", str(snapshot_every),
            "--device", device.type]
    if device.type == "cpu":
        base.append("--smoke")

    with contextlib.redirect_stdout(io.StringIO()):
        crash_rc = serve.main(base + ["--crash", "--crash-step",
                                      str(crash_step)])
    resume_buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(resume_buf):
        resume_rc = serve.main(["--resume", "--state-dir", state_dir,
                                "--device", device.type])
    resume_wall = time.time() - t0

    summary = {}
    for line in resume_buf.getvalue().splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if "tokens_generated" in row:
                summary = row
    rec = summary.get("recovery", {})
    outcomes = summary.get("outcomes", {})
    submitted = summary.get("submitted", 0)
    terminal = sum(outcomes.get(k, 0) for k in
                   ("completed", "timed_out", "failed", "rejected"))
    return {
        "requests": n,
        "gen": gen,
        "crash_step": crash_step,
        "snapshot_every": snapshot_every,
        "crash_exit_ok": crash_rc == serve.CRASH_EXIT,
        "resume_exit_ok": resume_rc == 0,
        "snapshot_step": rec.get("snapshot_step"),
        "resume_step": rec.get("resume_step"),
        "replayed_steps": rec.get("replayed_steps"),
        "replayed_records": rec.get("replayed_records"),
        "reprefilled_slots": rec.get("reprefilled_slots"),
        "submitted": submitted,
        "outcomes": outcomes,
        "conserved": bool(submitted) and terminal == submitted,
        "wall": {
            "resume_wall_s": round(resume_wall, 3),
            "prepare_s": rec.get("prepare_s"),
            "first_new_token_s": rec.get("first_new_token_s"),
        },
    }


def measure_paging(cfg, *, smoke: bool = False, device="cuda",
                   chip=None) -> dict:
    """The paging block: the heavy-tail workload at one KV-memory budget
    twice, contiguous per-slot reservations against the paged pool, and
    the concurrent slots each sustains.  The budget is ``cont_batch *
    max_len`` tokens, what the contiguous cache reserves for
    ``cont_batch`` slots; the paged run gets those tokens as a shared
    pool with more slots than it could cover at the worst case."""
    spec = MIXES["heavytail"]
    n = spec["smoke_requests"] if smoke else spec["requests"]
    prompts, gens = _lengths(spec, n)
    max_len = max(p + g for p, g in zip(prompts, gens)) + 8
    page_size = spec.get("page_size", 8)
    cont_batch = 2
    budget_tokens = cont_batch * max_len
    pool_pages = budget_tokens // page_size
    paged_batch = 8

    def brief(row):
        return {"batch": row["batch"],
                "max_concurrent": row["max_concurrent"],
                "generated": row["generated"],
                "decode_steps": row["decode_steps"],
                "tok_per_s": row["tok_per_s"],
                "outcomes": row["outcomes"]}

    cont = run_mix(cfg, "paging_contiguous",
                   {**spec, "paged": False, "sched": "fcfs"},
                   smoke=smoke, batch=cont_batch, device=device, chip=chip)
    paged = run_mix(cfg, "paging_paged", spec, smoke=smoke,
                    batch=paged_batch, pool_pages=pool_pages, device=device,
                    chip=chip)
    ratio = paged["max_concurrent"] / max(1, cont["max_concurrent"])
    return {
        "mix": "heavytail",
        "page_size": page_size,
        "max_len": max_len,
        "budget_tokens": budget_tokens,
        "pool_pages": pool_pages,
        "contiguous": brief(cont),
        "paged": {**brief(paged), "pool_pages": pool_pages,
                  "kv": paged["kv"]},
        "concurrency_ratio": round(ratio, 3),
        "ratio_floor": PAGING_RATIO_FLOOR,
        "ratio_ok": ratio >= PAGING_RATIO_FLOOR,
    }


def build_report(arch: str = "qwen3_14b", mixes=None, smoke: bool = False,
                 emit_dir=None, device="cuda") -> dict:
    """The whole report: every mix, the recovery row and the paging
    block, with the device it ran on."""
    device = resolve_device(device)
    cfg = config_for(arch, device)
    chip = default_chip(device)
    names = list(mixes) if mixes else list(MIXES)
    rows = {}
    for name in names:
        rows[name] = run_mix(cfg, name, MIXES[name], smoke=smoke,
                             emit_dir=emit_dir, device=device, chip=chip)
        r = rows[name]
        print(json.dumps({"mix": name, "batch": r["batch"],
                          "ttft_ms": r["ttft_ms"],
                          "per_token_ms": r["per_token_ms"],
                          "tok_per_s": r["tok_per_s"],
                          "queue_depth_max": r["queue_depth_max"],
                          "slo_ok": r["slo_ok"],
                          "slo_violations": r["slo_violations"]}),
              flush=True)
    recovery = measure_recovery(arch, smoke=smoke, device=device)
    print(json.dumps({"recovery": {
        k: recovery[k] for k in ("crash_step", "snapshot_every",
                                 "replayed_steps", "conserved",
                                 "crash_exit_ok", "resume_exit_ok")}}),
          flush=True)
    paging = measure_paging(cfg, smoke=smoke, device=device, chip=chip)
    print(json.dumps({"paging": {
        k: paging[k] for k in ("budget_tokens", "pool_pages",
                               "concurrency_ratio", "ratio_floor",
                               "ratio_ok")}}), flush=True)
    return {
        "schema": SERVING_SCHEMA,
        "arch": cfg.name,
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "chip": chip.variant,
        "host": platform.machine(),
        "smoke": bool(smoke),
        "mixes": rows,
        "recovery": recovery,
        "paging": paging,
        "slo_ok": all(r["slo_ok"] for r in rows.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/serving_load.json")
    ap.add_argument("--arch", default="qwen3_14b")
    ap.add_argument("--smoke", action="store_true",
                    help="the short request counts (same mixes, same "
                         "schema)")
    ap.add_argument("--mixes", nargs="+", default=None,
                    choices=sorted(MIXES))
    ap.add_argument("--emit-traces", default=None, metavar="DIR",
                    help="also write each mix's trace as DIR/<mix>.jsonl "
                         "(replayable by launch.serve --load-trace)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # Tune fresh in a throwaway cache unless the caller pinned one: the
    # report must reflect the code under benchmark.
    if "REPRO_TORCH_AUTOTUNE_CACHE" not in os.environ:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tempfile.mkdtemp(prefix="repro-torch-serving-"),
            "autotune.json")
    if args.emit_traces:
        pathlib.Path(args.emit_traces).mkdir(parents=True, exist_ok=True)
    report = build_report(args.arch, mixes=args.mixes, smoke=args.smoke,
                          emit_dir=args.emit_traces, device=args.device)
    atomic_write_json(args.out, report)
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
