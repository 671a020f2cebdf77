"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (counted in ``setup_s``, from process start to the window's
opening): the weights are drawn on the device from the seed
(`bench.weights`); `bench.timed.TimedServer` is built as the serve CLI
builds its server, under `serving_rules` with TF32 off, at the cell's
slots, cache and rows; then one admission of every slot at the widest
prompt and two decode steps warm the kernels the traffic uses; the nvcc
builds of the kernels land in ``build/kernels/`` of the checkout at the
first run and are reused after.

The window: `serve_loop` drives the server from the cell's closed loop
(`bench.traffic.ClosedLoop`), first filling every slot at once; the
window opens when every slot has its first token and the pump after
``seconds`` raises `WindowClosed`, so nothing drains.  With ``trace`` the
profiler is started inside the window where ``trace_seconds`` of it
remain, and the window is held open until it has recorded
``trace_seconds`` (starting it takes seconds); the host-clock readings of
a traced run end where it starts (`Run.t_end`), so that none of them
carries the profiler's cost.

After the window: the device's peak memory is read, the program's state
freed, and the reference judges a seeded sample of the finished
requests (`bench.check`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time

import torch

from bench import check, counts, devtrace, spec, traffic, weights
from bench.reference.dense import Dense

KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.int8}
# Top-level modules that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    model: dict
    batch: int
    t_start: float
    t_open: float
    t_close: float
    records: list             # bench.timed.Record, window and around it
    requests: list            # the measured lifecycle's requests
    chip: dict | None         # bench.counts.PEAKS entry, or None
    memory_peak_bytes: int
    trace: devtrace.Trace | None = None
    t_trace: float | None = None       # when the profiler was started
    slot_of: dict = dataclasses.field(default_factory=dict)  # rid: slot
    phases: dict = dataclasses.field(default_factory=dict)

    @property
    def t_end(self) -> float:
        """The end of the host clock's window: the close, or in a traced
        run the profiler's start."""
        return self.t_close if self.t_trace is None else self.t_trace

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_end

    def window_records(self, kind: str | None = None) -> list:
        return [r for r in self.records if self.in_window(r.t1)
                and (kind is None or r.kind == kind)]


def model_config(m: dict):
    """The program's `ModelConfig` of a configuration file."""
    from repro_torch.models.config import ModelConfig
    if m["tie_word_embeddings"] or m.get("sliding_window"):
        raise ValueError(f"{m['name']}: only untied, full-attention dense "
                         f"decoders are served here")
    return ModelConfig(
        name=m["name"], family="dense",
        num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        qkv_bias=bool(m["attention_bias"]), rope_theta=m["rope_theta"],
        norm_eps=m["rms_norm_eps"])


def forbidden_modules() -> list[str]:
    return sorted({k for k in sys.modules if k.split(".")[0] in FORBIDDEN})


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_window(cell: spec.Cell, seed: int, seconds: float, trace: bool,
                 dev: torch.device, t_start: float):
    """Set-up and the measured window.  Returns ``(run, lc)``; the server
    and its weights are freed before it returns."""
    from repro_torch.launch.scheduler import Scheduler
    from repro_torch.launch.serve import serve_loop, serving_rules
    from repro_torch.runtime import paging
    from repro_torch.runtime.fault_tolerance import DecodeWatchdog
    from repro_torch.runtime.lifecycle import Lifecycle
    from bench.timed import TimedServer

    m, w, mix = cell.config, cell.workload, cell.mix
    slots, max_len = int(w["slots"]), int(w["max_len"])
    wide = int(mix["prompt"]["hi"])
    if int(mix["clients"]) > slots:
        raise ValueError(f"{cell.name}: {mix['clients']} clients need as "
                         f"many slots ({slots})")
    if wide + int(mix["output"]["hi"]) > max_len:
        raise ValueError(f"{cell.name}: the longest request does not fit "
                         f"{max_len} cache rows")
    cfg = model_config(m)
    plan = traffic.Plan(mix, seed, m["vocab_size"])
    paged = (paging.PageSpec.build(slots, max_len, int(w["page_size"]))
             if w["cache"] == "paged" else None)
    # The steady state's slot depths, which the server's decode plan is
    # tuned at: prompts at their mean, outputs staggered over their mean.
    p_mid, o_mid = traffic.mean(mix["prompt"]), traffic.mean(mix["output"])
    depths = [int(p_mid + (2 * i + 1) * o_mid / (2 * slots))
              for i in range(slots)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    phases = {"imports": time.monotonic() - t_start}
    with serving_rules(dev):
        phases["mesh"] = time.monotonic() - t_start
        params = weights.server_tree(m, seed, dev)
        _sync(dev)
        phases["weights"] = time.monotonic() - t_start
        server = TimedServer(cfg, slots, max_len, params=params,
                             kv_dtype=KV_DTYPES[w["kv_dtype"]], device=dev,
                             paged=paged, prefill_len=wide,
                             slot_lengths=depths)
        del params
        phases["server"] = time.monotonic() - t_start
        # FCFS; a paged cache's scheduler admits only what the pool covers
        scheduler = (Scheduler("fcfs", allocator=server.allocator)
                     if paged is not None else None)
        warm = [(plan.warm_prompt(i, wide), 2) for i in range(slots)]
        serve_loop(server, Lifecycle(), source=traffic.Burst(warm),
                   scheduler=scheduler)
        server.records.clear()
        server.slot_of.clear()
        _sync(dev)
        phases["warm_up"] = time.monotonic() - t_start

        tracing = {"on": False, "range": None, "t": None}
        trace_s = float(w.get("trace_seconds", seconds))

        def on_pump(now):
            if (prof is not None and not tracing["on"]
                    and source.t_close is not None
                    and now >= source.t_close - trace_s):
                tracing["t"] = now
                prof.prepare_trace()
                prof.start_trace()
                tracing["range"] = torch.profiler.record_function(
                    devtrace.WINDOW)
                tracing["range"].__enter__()
                tracing["on"] = server.tracing = True
                # the profiler's start takes seconds: trace a whole
                # ``trace_s`` after it
                source.t_close = source.clock() + trace_s

        def span():
            return (torch.profiler.record_function("bench.source")
                    if server.tracing else contextlib.nullcontext())

        source = traffic.ClosedLoop(plan, seconds, on_pump=on_pump,
                                    span=span)
        lc = Lifecycle()
        try:
            serve_loop(server, lc, watchdog=DecodeWatchdog(None),
                       source=source, scheduler=scheduler)
            raise RuntimeError("the serve loop ended before the window "
                               "closed")
        except traffic.WindowClosed:
            pass
        if tracing["on"]:
            tracing["range"].__exit__(None, None, None)
            server.tracing = False
            _sync(dev)
            prof.stop_trace()
        _sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        phases["window_open"] = source.t_open - t_start
        run = Run(m, slots, t_start, source.t_open, source.t_close,
                  server.records, list(lc.requests.values()),
                  counts.peak(_device_kind(dev)), peak, t_trace=tracing["t"],
                  slot_of=dict(server.slot_of), phases=phases)
        del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        run.trace = devtrace.read(prof)
    return run, lc


def _mean_ms(recs) -> float | None:
    return 1e3 * sum(r.t1 - r.t0 for r in recs) / len(recs) if recs else None


def _window_counts(run: Run) -> dict:
    """What the host clock's window held, for the record beside the
    metrics: forwards of each kind, their mean host time, and the tokens
    given; in a traced run also the mean decode step under the profiler,
    which prices its cost."""
    out = {"tokens": sum(len(r.emitted) for r in run.window_records())}
    for kind in ("decode", "admit"):
        recs = run.window_records(kind)
        out[f"{kind}_calls"] = len(recs)
        out[f"{kind}_ms_mean"] = _mean_ms(recs)
    if run.t_trace is not None:
        out["traced_decode_ms_mean"] = _mean_ms(
            [r for r in run.records if r.kind == "decode"
             and run.t_trace <= r.t0 and r.t1 <= run.t_close])
    return out


def judge(cell: spec.Cell, run: Run, seed: int, dev: torch.device) -> dict:
    """The reference over a seeded sample of the finished requests:
    ``{"logit_gap": widest gap, "tokens": tokens compared, "slots":
    slots the sample covers}``."""
    reqs = check.sample(run.requests, run.slot_of, seed,
                        int(cell.workload["check"]["sample_tokens"]))
    if not reqs:
        return {"logit_gap": None, "tokens": 0, "slots": 0}
    seqs, pos, served = check.sequences(reqs)
    logits = Dense(cell.config, seed, dev).logits(seqs, pos)
    return {"logit_gap": check.widest_gap(logits, served),
            "tokens": int(sum(t.numel() for t in served)),
            "slots": len({run.slot_of[r.rid] for r in reqs})}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of ``cell``: the result line's object, ``checks`` last."""
    t_start = time.monotonic() if t_start is None else t_start
    dev = torch.device(device)
    run, lc = serve_window(cell, seed, seconds, trace, dev, t_start)
    metrics = {}
    for e in cell.metrics(trace):
        value = spec.reader(e["name"])(run)
        if value is not None:
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    device_block = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                    "kind": _device_kind(dev), "count": cell.chips,
                    "memory_peak_bytes": run.memory_peak_bytes}
    n = lc.counters()
    out = {"correct": False, "attempted": len(run.requests),
           "failed": n["failed"] + n["timed_out"] + n["rejected"]
           + n["evicted"],
           "metrics": metrics, "device": device_block}
    if run.trace is not None:
        device_block["busy_s"] = devtrace.busy_s(run.trace)
        device_block["window_s"] = run.trace.window_s
        out["breakdown"] = devtrace.breakdown(run.trace)
    verdict = judge(cell, run, seed, dev)
    lim = cell.workload["check"]
    gap = verdict["logit_gap"]
    checks = {
        "logit_gap": {"value": gap, "limit": lim["logit_gap_limit"]},
        "tokens_compared": {"value": verdict["tokens"],
                            "limit": lim["min_tokens"]},
        "failed_requests": {"value": out["failed"], "limit": 0},
    }
    out["correct"] = bool(gap is not None and gap <= lim["logit_gap_limit"]
                          and verdict["tokens"] >= lim["min_tokens"]
                          and out["failed"] == 0)
    out["window"] = _window_counts(run)
    out["window"]["slots_compared"] = verdict["slots"]
    out["setup_phases_s"] = run.phases
    out["checks"] = checks
    return out
