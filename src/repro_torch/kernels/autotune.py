"""The tuning engine: one generic DSE -> measure -> cache pipeline.
Counterpart of `repro.kernels.autotune` (its engine, not its deprecated
per-family shims).

1. **candidates**: the family's ``KernelSpec.enumerate_candidates`` ranks
   the configurations that fit the card's shared memory and registers by
   the analytic model (the paper's "simulate" step);
2. **measure**: on a CUDA device the top ``measure_k`` are timed with
   CUDA events (`measure`).  A CPU tensor runs the plain PyTorch
   version, which says nothing of the kernel, so on the CPU nothing is
   measured and a plan's source is always ``"model"``;
3. **memoize**: winners go to a JSON cache keyed
   ``family:{spec.key_fn(...)}:v{budget}`` (schema v3, the JAX package's:
   a file written by either package loads in the other; v2 files are
   migrated in place).  The backend part of a key is
   ``cuda:<device name>`` or ``cpu``, and the file is this package's own
   (``$REPRO_TORCH_AUTOTUNE_CACHE``, default ``build/autotune.json`` of
   the checkout), so no entry is ever shared with the JAX package's.

`dispatch` has no fallback: where the JAX engine answers a failing
launch with its jnp path, this one marks the plan poisoned, so the next
`tune` re-runs the DSE, and re-raises.  A CUDA tensor launches the kernel
or fails.

The serving plans (`OpPlan`, `plan_for_model`, `predict_decode_step_us`,
`select_serving_batch`) are the JAX package's: the server tunes its
shapes once at start-up, ranked by the model alone, and the batch sweep
prices each candidate batch from those plans' model times.  The matmul
plans feed that prediction only (the model's projections are
`torch.matmul`, as they are XLA matmuls in the JAX package); the decode
plan's span is what the server's decode kernel runs.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import time
import warnings
from typing import Callable, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import cost_model, hardware, ioutil
from repro_torch.kernels import _build, registry
from repro_torch.kernels.registry import KernelSpec, Plan

ENGINE_VERSION = 3
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


# ---------------------------------------------------------------------------
# On-disk memo cache
# ---------------------------------------------------------------------------

def default_cache_path() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return pathlib.Path(env)
    return _build.BUILD.parent / "autotune.json"


# v2 entries carried family-specific field names; map them onto the v3
# {"knobs", "detail"} shape by key prefix (the JAX package's table, so a
# v2 file migrates the same in both).  Unknown prefixes are dropped.
_V2_KNOB_FIELDS = {
    "matmul": (("tile",), ()),
    "spmv": (("block_rows", "block_cols"), ("waste",)),
    "attention": (("block_q", "block_k"), ()),
    "decode": (("block_k",), ()),
}


def _migrate_v2_entry(key: str, entry: dict) -> dict | None:
    family = key.split(":", 1)[0]
    fields = _V2_KNOB_FIELDS.get(family)
    if fields is None or not isinstance(entry, dict):
        return None
    knob_names, detail_names = fields
    if any(f not in entry for f in knob_names):
        return None
    return {
        "knobs": {f: entry[f] for f in knob_names},
        "source": entry.get("source", "model"),
        "model_time_s": entry.get("model_time_s", 0.0),
        "measured_us": entry.get("measured_us"),
        "detail": {f: entry[f] for f in detail_names if f in entry},
    }


class TuneCache:
    """Write-through JSON cache: {key: plan-dict}, loaded lazily and
    rewritten atomically on every put."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path else default_cache_path()
        self._data: dict | None = None
        self.hits = 0
        self.misses = 0

    def _load(self) -> dict:
        if self._data is None:
            raw = None
            try:
                text = self.path.read_text()
            except OSError:
                text = None          # no file yet: a fresh cache, silently
            if text is not None:
                try:
                    raw = json.loads(text)
                except ValueError:
                    # Corrupt JSON: keep the evidence (and any measured
                    # entries someone may recover) and warn.
                    self._quarantine_corrupt()
            if (isinstance(raw, dict) and raw.get("version") == 2
                    and isinstance(raw.get("entries"), dict)):
                migrated = {}
                for key, entry in raw["entries"].items():
                    new = _migrate_v2_entry(key, entry)
                    if new is not None:
                        migrated[key] = new
                raw = {"version": ENGINE_VERSION, "entries": migrated}
            if not (isinstance(raw, dict)
                    and raw.get("version") == ENGINE_VERSION
                    and isinstance(raw.get("entries"), dict)):
                raw = {"version": ENGINE_VERSION, "entries": {}}
            self._data = raw
        return self._data

    def _quarantine_corrupt(self) -> None:
        corrupt = self.path.with_name(self.path.name + ".corrupt")
        try:
            self.path.replace(corrupt)
        except OSError:
            return               # unrenamable (e.g. read-only fs): move on
        warnings.warn(
            f"autotune cache {self.path} held corrupt JSON; quarantined it "
            f"to {corrupt} and starting a fresh cache", RuntimeWarning,
            stacklevel=3)

    def get(self, key: str) -> dict | None:
        entry = self._load()["entries"].get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: str, value: dict) -> None:
        data = self._load()
        data["entries"][key] = value
        try:
            ioutil.atomic_write_json(self.path, data)
        except OSError:
            # An unwritable cache must never take down the compute path;
            # the in-memory entry still serves this process.
            pass


_default_cache: TuneCache | None = None


def get_cache() -> TuneCache:
    """Process-wide cache bound to the current cache path."""
    global _default_cache
    path = default_cache_path()
    if _default_cache is None or _default_cache.path != path:
        _default_cache = TuneCache(path)
    return _default_cache


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

# On the card the timed calls start behind a spin of LEAD_CYCLES clocks
# (about 2 ms of an H100), which outlasts the host's launch of MAX_REPS
# calls: a call shorter than its host-side launch (a published SpMV
# matrix takes microseconds) is then timed by the card's work, not by
# the enqueue.  Without ``reps`` a first call's time sets how many more
# cover COVER_US of device time, at most MAX_REPS.
LEAD_CYCLES = 4_000_000
MAX_REPS = 25
COVER_US = 1000.0


def _cuda_us(fn: Callable[[], object], device, reps: int) -> float:
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def measure(fn: Callable[[], object], device, reps: int | None = None,
            warmup: int = 1) -> float:
    """Mean time of ``fn`` in microseconds over ``reps`` calls after
    ``warmup``: between CUDA events behind a spin of the card on a CUDA
    device, on the host clock otherwise.  ``reps=None``: on the card one
    call, then as many as cover `COVER_US` (at most `MAX_REPS`) when one
    does not; on the host 3."""
    device = torch.device(device)
    for _ in range(max(warmup, 0)):
        fn()
    if device.type == "cuda":
        if reps is not None:
            return _cuda_us(fn, device, max(reps, 1))
        us = _cuda_us(fn, device, 1)
        more = min(MAX_REPS, math.ceil(COVER_US / max(us, 1e-3)))
        return us if more <= 1 else _cuda_us(fn, device, more)
    reps = max(reps or 3, 1)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _backend(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _budget_tag(smem_bytes: int | None) -> str:
    # The budget shapes the feasible set, so constrained and default
    # tunings must not share cache entries.
    return "dflt" if smem_bytes is None else str(smem_bytes)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cache_key(spec: KernelSpec, problem: dict, dtype: str, backend: str,
              smem_bytes: int | None) -> str:
    """`family:{spec suffix}:v{budget}`, the v3 key format."""
    return (f"{spec.name}:{spec.key_fn(problem, dtype, backend)}"
            f":v{_budget_tag(smem_bytes)}")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def tune(
    spec: KernelSpec | str, problem: dict, dtype=torch.float32, *,
    device="cuda",
    measure_k: int = 3,
    smem_bytes: int | None = None,
    cache: TuneCache | None = None,
) -> Plan:
    """Pick the family's knobs for ``problem`` on ``device`` via DSE ->
    measure -> cache.  ``measure_k=0`` ranks by the model alone."""
    if isinstance(spec, str):
        spec = registry.get(spec)
    device = resolve_device(device)
    backend = _backend(device)
    cache = cache or get_cache()
    key = cache_key(spec, problem, _dtype_name(dtype), backend, smem_bytes)
    measurable = measure_k > 0 and backend.startswith("cuda")

    hit = cache.get(key)
    if hit is not None and hit.get("poisoned"):
        # A launch with this winner failed (`mark_plan_poisoned`): re-run
        # the DSE; the put below replaces the quarantined entry.
        hit = None
    # A model-only entry is upgraded, not returned, once a measuring
    # caller shows up.
    if hit is not None and not (measurable and hit.get("source") == "model"):
        return Plan(spec.name, key, dict(problem), dict(hit["knobs"]),
                    "cache", hit["model_time_s"], hit.get("measured_us"),
                    dict(hit.get("detail") or {}))

    ranked = spec.enumerate_candidates(
        problem, dtype_bytes=torch.empty((), dtype=dtype).element_size(),
        smem_bytes=smem_bytes, top=max(measure_k, 1))
    # Deterministic order and dedupe: score first, the family's
    # tie-break second, identical knob sets collapsed.
    seen, cands = set(), []
    for c in sorted(ranked, key=lambda c: (c.score, spec.tie_break(c.knobs))):
        sig = json.dumps(c.knobs, sort_keys=True)
        if sig not in seen:
            seen.add(sig)
            cands.append(c)

    best, best_us = None, float("inf")
    if measurable and cands:
        inputs = spec.make_inputs(problem, dtype, device)
        for c in cands[:measure_k]:
            fn = spec.build_launcher(problem, c.knobs)
            us = measure(lambda fn=fn: fn(*inputs), device)
            if us < best_us:
                best, best_us = c, us
    if best is not None:
        chosen, source, measured_us = best, "measured", best_us
    else:
        chosen, source, measured_us = cands[0], "model", None

    detail = {f: chosen.detail[f] for f in spec.detail_keys
              if chosen.detail and f in chosen.detail}
    cache.put(key, {"knobs": chosen.knobs, "source": source,
                    "model_time_s": chosen.score,
                    "measured_us": measured_us, "detail": detail})
    return Plan(spec.name, key, dict(problem), dict(chosen.knobs), source,
                chosen.score, measured_us, detail)


def mark_plan_poisoned(key: str, cache: TuneCache | None = None) -> None:
    """Quarantine a cached winner whose launch failed: the entry is kept
    but flagged, so the next `tune` of its problem re-runs the DSE."""
    cache = cache or get_cache()
    entry = dict(cache._load()["entries"].get(key) or {})
    entry["poisoned"] = True
    cache.put(key, entry)


def _device_of(args) -> torch.device:
    """The device of the first argument that has one (a tensor, or an
    `EllMatrix`); the CPU when none has."""
    for a in args:
        dev = getattr(a, "device", None)
        if dev is not None:
            return torch.device(dev)
    return torch.device("cpu")


def dispatch(family: str, *args, cache: TuneCache | None = None, **kwargs):
    """Run ``family``'s kernel on ``args`` with its tuned plan.

    Arguments on the CPU take the family's plain PyTorch version and pay
    no tuning; on a CUDA device the plan comes from `tune` and the kernel
    runs.  A launch that raises poisons the plan and the error propagates.
    """
    spec = registry.get(family)
    device = _device_of(args)
    if device.type == "cpu":
        return spec.reference_fn(*args, **kwargs)
    problem, dtype = spec.problem_fn(*args, **kwargs)
    plan = tune(spec, problem, dtype, device=device, cache=cache)
    try:
        return spec.run_fn(plan, *args, **kwargs)
    except Exception:
        mark_plan_poisoned(plan.key, cache=cache)
        raise


# ---------------------------------------------------------------------------
# Model-serving plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpPlan:
    """A tuned Plan bound to a named serving op (e.g. "ffn_up"): the unit
    `plan_for_model` returns and `predict_decode_step_us` consumes."""

    op: str
    plan: Plan

    def record(self) -> dict:
        return {"op": self.op, "problem": dict(self.plan.problem),
                **self.plan.record()}


def plan_for_model(cfg, batch: int, *, prefill_len: int = 0,
                   cache_len: int = 0, kv_dtype=torch.bfloat16,
                   slot_lengths: Sequence[int] | None = None,
                   cache: TuneCache | None = None, measure_k: int = 0,
                   device="cpu") -> list[OpPlan]:
    """Tune the serving shapes of a model config at ``batch``: the decode
    step's matmuls, the prefill flash attention when ``prefill_len`` is
    given, and the decode attention over a cache of ``cache_len`` rows of
    ``kv_dtype`` (an int8 cache takes the ``decode_int8`` family, keyed
    on the bf16 activations).  ``device`` names the backend of the keys.
    ``measure_k=0`` (the default) ranks by the model alone: the server
    calls this at start-up.

    ``slot_lengths`` (optional) is the workload's steady-state slot-depth
    distribution: the decode plan is then tuned at ``batch`` quantiles of
    it, and its span is pinned under the plain key (no lengths) unless a
    measured entry owns that key, so a later lookup of the runtime problem
    finds the workload-aware span."""
    device = resolve_device(device)
    d, f, v = cfg.d_model, cfg.d_ff or cfg.d_model * 4, cfg.vocab_size
    qkv = max(cfg.num_heads * cfg.head_dim, d) or d
    shapes = [
        ("qkv_proj", batch, qkv, d),
        ("out_proj", batch, d, qkv),
        ("ffn_up", batch, f, d),
        ("ffn_down", batch, d, f),
        ("logits", batch, v, d),
    ]
    plans = [OpPlan(name, tune("matmul", {"m": m, "n": n, "k": k},
                               torch.bfloat16, device=device,
                               measure_k=measure_k, cache=cache))
             for name, m, n, k in shapes]
    if prefill_len > 0 and cfg.num_heads:
        plans.append(OpPlan("attn_prefill", tune(
            "attention",
            {"bh": batch * cfg.num_heads, "sq": prefill_len,
             "sk": prefill_len, "dh": cfg.head_dim,
             "causal": cfg.causal, "window": cfg.sliding_window},
            torch.bfloat16, device=device, measure_k=measure_k,
            cache=cache)))
    if cache_len > 0 and cfg.num_heads and cfg.num_kv_heads:
        quantized = kv_dtype == torch.int8
        family = "decode_int8" if quantized else "decode"
        tune_dtype = torch.bfloat16 if quantized else kv_dtype
        problem = {"bkv": batch * cfg.num_kv_heads,
                   "g": cfg.num_heads // cfg.num_kv_heads,
                   "cache_len": cache_len, "dh": cfg.head_dim}
        if slot_lengths:
            problem["lengths"] = tuple(
                _quantile_lengths(batch, slot_lengths, cache_len))
        plan = tune(family, problem, tune_dtype, device=device,
                    measure_k=measure_k, cache=cache)
        if slot_lengths:
            run_problem = {k: v for k, v in problem.items()
                           if k != "lengths"}
            spec = registry.get(family)
            cache_obj = cache or get_cache()
            run_key = cache_key(spec, run_problem, _dtype_name(tune_dtype),
                                _backend(device), None)
            existing = cache_obj._load()["entries"].get(run_key)
            if existing is None or existing.get("source") == "model":
                # The pinned entry's model time is that of its own key's
                # problem (every row at the whole cache), not the ragged
                # score.
                run_cost = spec.cost_fn(run_problem, plan.knobs)
                cache_obj.put(run_key, {
                    "knobs": dict(plan.knobs), "source": "model",
                    "model_time_s": run_cost["time_s"],
                    "measured_us": None,
                    "detail": {"pinned_from": plan.key}})
        plans.append(OpPlan("attn_decode", plan))
    return plans


def _attn_layer_count(cfg) -> int:
    return sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l))


def _quantile_lengths(batch: int, slot_lengths: Sequence[int],
                      cache_len: int) -> list[int]:
    """A slot-depth distribution resampled to ``batch`` evenly spaced
    quantiles (sorted, clamped to the cache): the per-slot lengths a
    candidate batch is priced at."""
    ls = sorted(max(0, min(int(l), cache_len)) for l in slot_lengths)
    return [ls[((2 * i + 1) * len(ls)) // (2 * batch)] for i in range(batch)]


def predict_decode_step_us(cfg, batch: int, *, cache_len: int,
                           kv_dtype=torch.bfloat16,
                           lengths: Sequence[int] | None = None,
                           plans: list[OpPlan] | None = None,
                           cache: TuneCache | None = None,
                           block_k: int | None = None,
                           chip: hardware.Chip = hardware.H100_SXM,
                           device="cpu") -> float:
    """Model time of one decode step at ``batch``, in microseconds, from
    the plans' model times (`plan_for_model` at ``batch`` unless
    ``plans`` are given): the qkv and out projections and the KV stream
    per attention layer, the FFN matmuls per layer, the logits once.

    ``lengths`` (one valid prefix per slot) re-prices the decode plan's
    span at those prefixes on ``chip`` instead of charging every slot the
    whole ``cache_len``; ``block_k`` overrides that span (a paged server
    prices at its page size).  Without a decode plan the KV stream is its
    bytes over ``chip.hbm_bw``."""
    lengths = lengths or None            # empty == no distribution
    plans = plans if plans is not None else plan_for_model(
        cfg, batch, cache_len=cache_len, kv_dtype=kv_dtype,
        slot_lengths=lengths, cache=cache, device=device)
    attn_ops_ = {"qkv_proj", "out_proj"}
    ffn_ops = {"ffn_up", "ffn_down"}
    n_attn = _attn_layer_count(cfg)
    attn_us = sum(p.plan.model_time_us for p in plans if p.op in attn_ops_)
    ffn_us = sum(p.plan.model_time_us for p in plans if p.op in ffn_ops)
    logits_us = sum(p.plan.model_time_us for p in plans if p.op == "logits")
    quantized = kv_dtype == torch.int8
    decode_plan = next((p for p in plans if p.op == "attn_decode"), None)
    if decode_plan is not None:
        if lengths is not None:
            prob = decode_plan.plan.problem
            bk = block_k or decode_plan.plan.knobs["block_k"]
            if quantized:
                model = cost_model.quantized_decode_time_model(
                    prob["bkv"], prob["g"], prob["cache_len"], prob["dh"],
                    bk, chip=chip, lengths=list(lengths))
            else:
                model = cost_model.decode_time_model(
                    prob["bkv"], prob["g"], prob["cache_len"], prob["dh"],
                    bk, chip=chip,
                    dtype_bytes=torch.empty((), dtype=kv_dtype).element_size(),
                    lengths=list(lengths))
            kv_us = n_attn * model["time_s"] * 1e6
        else:
            kv_us = n_attn * decode_plan.plan.model_time_us
    else:
        streamed = (float(sum(lengths)) if lengths is not None
                    else float(batch * cache_len))
        if quantized:
            # int8 values + one f32 scale per token per KV head, K and V.
            kv_bytes = 2.0 * streamed * (cfg.kv_dim + 4 * cfg.num_kv_heads)
        else:
            kv_bytes = (2.0 * streamed * cfg.kv_dim
                        * torch.empty((), dtype=kv_dtype).element_size())
        kv_us = n_attn * kv_bytes / chip.hbm_bw * 1e6
    return n_attn * attn_us + cfg.num_layers * ffn_us + logits_us + kv_us


def select_serving_batch(
    cfg, *, cache_len: int, prefill_len: int = 0,
    kv_dtype=torch.bfloat16,
    candidates: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    latency_budget_ms: float | None = None,
    slot_lengths: Sequence[int] | None = None,
    cache: TuneCache | None = None,
    pool_pages: int | None = None,
    page_size: int | None = None,
    chip: hardware.Chip = hardware.H100_SXM,
    device="cpu",
) -> dict:
    """The serving batch: each candidate priced by
    `predict_decode_step_us` from its model-ranked plans; the batch of
    most predicted tokens/s whose step fits ``latency_budget_ms`` wins,
    and when none fits, the one of least step time (never one whose pages
    overflow the pool).  Deterministic: model times only.

    ``slot_lengths`` (optional) prices each candidate at ``b`` quantiles
    of the workload's slot depths instead of the whole cache.
    ``page_size`` (paged serving) adds the free-page term: a candidate
    whose steady-state pages exceed the pool (``pool_pages``, or the
    candidate's contiguous equivalent) is infeasible, and the KV stream
    is priced at the page size.  Returns the decision record the server
    logs: the batch, its predicted step and tokens/s, the decode plan and
    the whole sweep."""
    slot_lengths = slot_lengths or None   # empty queue == no distribution
    sweep = []
    best = None
    decode_plans = {}
    for b in candidates:
        plans = plan_for_model(cfg, b, prefill_len=prefill_len,
                               cache_len=cache_len, kv_dtype=kv_dtype,
                               slot_lengths=slot_lengths, cache=cache,
                               device=device)
        lengths_b = (None if slot_lengths is None
                     else _quantile_lengths(b, slot_lengths, cache_len))
        dp = next((p for p in plans if p.op == "attn_decode"), None)
        # Provenance and timings vary from run to run, so the record
        # keeps the knobs and model time only; the server's kernel_plan
        # has the rest.
        if dp is not None:
            rec = dp.record()
            for volatile in ("source", "provenance", "measured_us"):
                rec.pop(volatile, None)
            decode_plans[b] = rec
        else:
            decode_plans[b] = None
        step_us = predict_decode_step_us(cfg, b, cache_len=cache_len,
                                         kv_dtype=kv_dtype, plans=plans,
                                         lengths=lengths_b,
                                         block_k=page_size, chip=chip)
        tok_per_s = b / (step_us * 1e-6)
        feasible = (latency_budget_ms is None
                    or step_us <= latency_budget_ms * 1e3)
        row = {"batch": b, "step_us": step_us,
               "tok_per_s": tok_per_s, "feasible": feasible}
        if lengths_b is not None:
            row["slot_lengths"] = lengths_b
            row["mean_len"] = sum(lengths_b) / len(lengths_b)
        if page_size:
            # the free-page term: steady-state pages against the pool
            lens = lengths_b if lengths_b is not None else [cache_len] * b
            kv_pages = sum(-(-max(1, l) // page_size) for l in lens)
            pool = pool_pages or b * (-(-cache_len // page_size))
            row["kv_pages"] = kv_pages
            row["pool_pages"] = pool
            row["free_pages"] = max(0, pool - kv_pages)
            row["kv_fits"] = kv_pages <= pool
            row["feasible"] = feasible = feasible and row["kv_fits"]
        sweep.append(row)
        if feasible and (best is None or tok_per_s > best["tok_per_s"]):
            best = sweep[-1]
    if best is None:       # nothing met the budget: least-bad latency wins
        fits = [r for r in sweep if r.get("kv_fits", True)]
        best = min(fits or sweep, key=lambda r: r["step_us"])
    return {"batch": best["batch"],
            "predicted_step_us": best["step_us"],
            "predicted_tok_per_s": best["tok_per_s"],
            "latency_budget_ms": latency_budget_ms,
            "length_model": ("active-prefix" if slot_lengths is not None
                             else "batch-max"),
            "decode_plan": decode_plans[best["batch"]],
            "sweep": sweep}
