#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Run from the root of a checkout, on a host with a CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``device``: the card as ``nvidia-smi`` reports it (also printed raw),
   the torch and CUDA versions.
2. ``build``: every kernel under ``src/repro_torch/csrc`` compiled with
   ``nvcc`` for ``sm_90a``, and its seconds.
3. ``kernel_cases``: the CUDA decode-attention kernel against its plain
   PyTorch version ``decode_ref`` on the card at Qwen3-14B decode shapes
   (Hq 40, Hkv 8, dh 128), with kernel, plain, library (PyTorch SDPA,
   timed only) and bound times.
4. ``decode_vs_teacher_forcing``: a small model decoded token by token
   through the kernel agrees with its own full-sequence forward.
5. ``serve``: `repro_torch.launch.serve` at Qwen3-14B's full published
   width (random bf16 weights from a seeded generator) serves 6 requests;
   the summary must conserve all 6, pass ``tools/check_serve.py``, and the
   kernel must have launched 40 times (once per layer) per decode forward.
6. ``decode_step``: where one decode step of that serve shape goes (batch
   4, depth 600): host-clock time of untraced steps, then device time by
   kernel from `torch.profiler` over traced steps.
7. ``kernels``: one entry per ported kernel, with its TPU counterpart,
   launches on the serve run, error and times.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
exits non-zero without it; so does a host without a CUDA card.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
SERVE_ARGV = ["--arch", "qwen3_14b", "--batch", "4", "--requests", "6",
              "--prompt-len", "600", "--gen", "16", "--kv-dtype", "f32"]
SERVE_LEN = 600 + 16 + 8             # the serve run's cache rows
STEP_BATCH, STEP_DEPTH = 4, 600      # decode_step: the serve run's shape
STEP_WARMUP, STEP_COUNT = 2, 8       # untraced steps, then as many traced
TOP_KERNELS = 12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class Fail(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Fail(msg)


def median_ms(torch, fn, n: int, flush) -> float:
    """Median device time of ``n`` calls of ``fn``, each alone between CUDA
    events after a write of ``flush`` evicts the 50 MB L2 (the decode
    caches of a real step are cold).  A spin of about 2 ms on the card
    before each start event lets the host enqueue the call before the
    card reaches it, so the time is the device's and not the host's."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[n // 2]


def row_errors(torch, out, ref, f32: bool):
    """Largest |out - ref| and largest ratio of it to its tolerance, over
    (sequence, query head) rows.  f32 output: summation order only, 1e-4.
    bf16 output: each side rounds to bf16 once, so one bf16 ulp of an
    element, at most 2^-7 of the row's largest |ref|; taken per row so a
    long row's error cannot hide under a short row's larger scale.  A row
    of length 0 must be exactly zero."""
    err = (out.float() - ref.float()).abs()
    tol = (torch.full_like(err[..., :1], 1e-4) if f32
           else 2.0 ** -7 * ref.float().abs().amax(-1, keepdim=True))
    ratio = (err / tol).nan_to_num(nan=0.0, posinf=float("inf"))
    return float(err.max()), float(ratio.max())


def kernel_case(torch, decode, flush, *, name, lengths, q_dtype, kv_dtype,
                cache_len, hq=40, hkv=8, dh=128, seed=0):
    """One shape: error of the kernel against `decode_ref`, and times."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    q = torch.randn((b, hq, dh), generator=gen, device=dev).to(q_dtype)
    k = torch.randn((b, cache_len, hkv, dh), generator=gen,
                    device=dev).to(kv_dtype)
    v = torch.randn((b, cache_len, hkv, dh), generator=gen,
                    device=dev).to(kv_dtype)
    lv = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = dh ** -0.5

    out = decode.gqa_decode_attention(q, k, v, length=lv, scale=scale)
    ref = decode.decode_ref(q, k, v, length=lv, scale=scale)
    torch.cuda.synchronize()
    err, err_over_tol = row_errors(torch, out, ref, q_dtype == torch.float32)
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    zeros_ok = all(not out[i].any() for i in zero_rows)

    def library():
        mask = (torch.arange(cache_len, device=dev)[None, :]
                < lv[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q.to(kv_dtype)[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True)

    ms = median_ms(torch, lambda: decode.gqa_decode_attention(
        q, k, v, length=lv, scale=scale), 21, flush)
    plain_ms = median_ms(torch, lambda: decode.decode_ref(
        q, k, v, length=lv, scale=scale), 5, flush)
    library_ms = median_ms(torch, library, 11, flush)

    valid = sum(min(max(n, 0), cache_len) for n in lengths)
    kv_elt = k.element_size()
    nbytes = (2 * valid * hkv * dh * kv_elt + q.numel() * q.element_size()
              + out.numel() * out.element_size() + lv.numel() * 4)
    ops = 4 * valid * hq * dh          # q.k and p.v multiply-adds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    kv_name = str(kv_dtype).removeprefix("torch.")
    t_ops = ops / PEAK_OPS_PER_S[kv_name] * 1e3
    return {"name": name, "batch": b, "cache_len": cache_len,
            "lengths": list(lengths),
            "q_dtype": str(q_dtype).removeprefix("torch."),
            "kv_dtype": kv_name, "max_abs_err": err,
            "tolerance": ("1e-4" if q_dtype == torch.float32
                          else "2^-7 x the row's max |ref|"),
            "max_err_over_tol": err_over_tol,
            "zero_rows_ok": zeros_ok, "ok": err_over_tol <= 1 and zeros_ok,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def decode_vs_teacher_forcing(torch, configs, transformer):
    """Qwen3-14B's SMOKE config on the card, f32: per-token decode through
    the cache (the CUDA kernel) against the full-sequence forward
    (`attention_core`).  Both are f32 with TF32 off: 1e-3."""
    dev = torch.device("cuda")
    cfg = configs.get_smoke("qwen3_14b")
    params = transformer.init(cfg, torch.Generator(device=dev).manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (3, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    full, _ = transformer.forward(cfg, params, {"tokens": toks},
                                  compute_dtype=torch.float32)
    cache = transformer.cache_init(cfg, 3, 24, dtype=torch.float32,
                                   device=dev)
    steps = []
    for t in range(toks.shape[1]):
        lg, cache = transformer.forward(cfg, params,
                                        {"tokens": toks[:, t:t + 1]},
                                        cache=cache,
                                        compute_dtype=torch.float32)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, 1)
    err = float((dec - full).abs().max())
    finite = bool(torch.isfinite(dec).all())
    return {"shape": list(dec.shape), "max_abs_err": err, "tolerance": 1e-3,
            "finite": finite, "ok": finite and err <= 1e-3}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val:
            return float(val)
    return 0.0


def decode_step_breakdown(torch, configs, serve):
    """One decode step of the serve shape at full width: host-clock ms of
    ``STEP_COUNT`` untraced steps (each ends in its host synchronisation,
    the copy of the next tokens), then device time by kernel over as many
    steps traced by `torch.profiler`.  The profiler slows the host, so the
    busy share of an untraced step is the traced device time per step over
    the median untraced step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get("qwen3_14b")
    steps = STEP_WARMUP + 2 * STEP_COUNT
    server = serve.Server(cfg, STEP_BATCH, STEP_DEPTH + steps + 8)
    rng = np.random.default_rng(0)
    server.admit_chunk([(s, s, rng.integers(0, cfg.vocab_size, STEP_DEPTH),
                         steps + 1) for s in range(STEP_BATCH)])
    for _ in range(STEP_WARMUP):
        server.decode_step()
    host_ms = []
    for _ in range(STEP_COUNT):
        t0 = time.perf_counter()
        server.decode_step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(host_ms))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEP_COUNT):
            server.decode_step()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sorted((k for k in kernels if k[2] > 0), key=lambda k: -k[2])
    busy_ms = sum(k[2] for k in kernels) / 1e3 / STEP_COUNT
    attn_ms = sum(k[2] for k in kernels
                  if "decode_attention" in k[0]) / 1e3 / STEP_COUNT
    return {"batch": STEP_BATCH, "depth": STEP_DEPTH,
            "host_ms": host_ms, "host_median_ms": median,
            "device_time_measured": bool(kernels),
            "device_ms_per_step": busy_ms,
            "decode_attention_ms_per_step": attn_ms,
            "device_busy_share": busy_ms / median,
            "kernel_launches_per_step": sum(k[1] for k in kernels)
            / STEP_COUNT,
            "top_kernels": [{"name": n[:120], "calls": c,
                             "ms_per_step": us / 1e3 / STEP_COUNT}
                            for n, c, us in kernels[:TOP_KERNELS]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import check_serve
    import repro_torch.configs as configs
    from repro_torch.convert import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import decode
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", nvidia_smi=smi, kind=kind, count=count,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.time()
    built = _build.build()
    emit("build", seconds=round(time.time() - t0, 3),
         libraries=sorted(p.name for p in built.values()),
         flags=" ".join(_build.NVCC_FLAGS))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    mixed = [0, 1, 511, 512, 513, 2048, 3000, 4096]
    cases = [kernel_case(torch, decode, flush, name="serve_shape",
                         lengths=[601, 608, 612, 616], q_dtype=bf16,
                         kv_dtype=f32, cache_len=SERVE_LEN)]
    for q_dtype, kv_dtype in ((bf16, f32), (bf16, bf16), (f32, f32)):
        for lengths in ([4096], mixed):
            cases.append(kernel_case(
                torch, decode, flush, name=f"b{len(lengths)}_l4096",
                lengths=lengths, q_dtype=q_dtype, kv_dtype=kv_dtype,
                cache_len=4096))
    del flush
    torch.cuda.empty_cache()
    emit("kernel_cases", cases=cases)
    check(all(c["ok"] for c in cases),
          "decode_attention disagrees with decode_ref: "
          + json.dumps([c for c in cases if not c["ok"]]))

    tf = decode_vs_teacher_forcing(torch, configs, transformer)
    emit("decode_vs_teacher_forcing", **tf)
    check(tf["ok"], f"decode through the kernel != teacher forcing: {tf}")

    decode.launches = 0
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(SERVE_ARGV)
    seconds = time.time() - t0
    launches = decode.launches
    log = buf.getvalue()
    print(log, end="", flush=True)
    summary = check_serve._json_lines(log)[-1]
    problems = check_serve.check(log, requests=6, min_tokens=6 * 16)
    layers = configs.get("qwen3_14b").num_layers
    emit("serve", argv=SERVE_ARGV, rc=rc, seconds=round(seconds, 3),
         decode_forwards=summary.get("decode_forwards"),
         kernel_launches=launches, layers=layers,
         check_serve_problems=problems,
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    check(rc == 0 and not problems, f"serve run failed: {problems}")
    outcomes = summary["outcomes"]
    check(summary["submitted"] == 6 and outcomes["completed"] == 6
          and outcomes["evicted"] == 0,
          f"serve did not complete all 6 requests cleanly: {outcomes}")
    check(summary["decode_forwards"] > 0
          and launches == summary["decode_forwards"] * layers,
          f"{launches} kernel launches for {summary['decode_forwards']} "
          f"decode forwards x {layers} layers")

    gc.collect()                      # the serve run's weights and cache
    torch.cuda.empty_cache()
    emit("decode_step", **decode_step_breakdown(torch, configs, serve))

    serve_case = cases[0]
    entry = {"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/attention/decode.py:144",
             "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             "ok": True}
    entry.update({k: serve_case[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
