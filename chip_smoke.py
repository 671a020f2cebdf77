#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Run from the root of a checkout, on a host with a CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``device``: the card as ``nvidia-smi`` reports it (also printed raw),
   the torch and CUDA versions.
2. ``build``: every kernel under ``src/repro_torch/csrc`` compiled with
   ``nvcc`` for ``sm_90a`` (B1-B8 in nine sources: B6's wgmma kernel in
   its own, its mma.sync and f32 kernels in another, the two SpMV kernels
   in one), one ``nvcc`` per source, all at once, and the seconds.
3. ``kernel_cases``: each CUDA decode-attention kernel against its plain
   PyTorch version on the card at Qwen3-14B decode shapes (Hq 40, Hkv 8,
   dh 128), up to its 32,768-key context at batch 1 and 4: contiguous
   (``decode_ref``, with PyTorch SDPA timed as the library yardstick),
   paged (``paged_decode_ref``; its output must also equal the contiguous
   kernel's bit for bit over the same rows), int8 and paged int8
   (``quantized_decode_ref``, ``paged_quantized_decode_ref``; no single
   PyTorch call computes attention through a page table or over int8
   codes, so they have no library time).  Paged tables are a shuffled
   permutation of the pool, at page sizes 16 and 48.  Each case has the
   call's event time and the kernel's own device time from
   `torch.profiler`, its split span and its blocks.
   ``split_sweep``: B1 (f32 and bf16 cache) and B3 at each span of the
   decode tuner's candidate set, the default 256 and the tuner's pick,
   passed at run time, at the serve shape, 4,096 and 32,768 keys, in
   turns; each row with the tuned span's time against 256's.
4. ``decode_vs_teacher_forcing`` and ``decode_vs_teacher_forcing_paged``:
   a small model decoded token by token through the contiguous and the
   paged kernel agrees with its own full-sequence forward.
5. ``flash_cases``: the prefill flash-attention kernels against
   ``ref.attention_ref`` on the card (the per-row tolerance of
   `row_errors`; rows with no key exactly 0) at Qwen3-14B's prefill shape
   (causal, Hq 40, Hkv 8, dh 128: the TMA/wgmma kernel) at 32,768 and
   4,096 tokens, Danube's (window 4096, Hq 32, Hkv 8, dh 80: the mma.sync
   kernel) at 32,768, a non-causal ragged case, window cases with Sq > Sk
   at dh 80 and 128, and an f32 case; each with its design and tile, its
   time, its bound from the pairs the mask keeps, the plain version's
   time and PyTorch SDPA's.
6. ``prefill`` and ``prefill_danube``: `steps.make_prefill_step` at the
   full published width and depth of Qwen3-14B and H2O-Danube-1.8B
   (random bf16 weights from a seeded generator) on 1 x 32,768 tokens,
   ``prefill_32k``'s length (its global batch of 32 is cut to 1): host ms
   per forward, prompt tokens/s, flash launches (one per layer per
   forward, no decode kernel), peak memory and device time by kernel
   from `torch.profiler` over one traced forward.
   ``prefill_vs_forward``: with the same weights at 4,096 (Qwen3) and
   6,144 (Danube, past its window) tokens, the last-position logits of
   the prefill path (flash kernel) and of the full forward
   (`attention_core`) agree within 1e-4 in f32; in bf16 the prefill path
   is no farther from the f32 logits than the full forward plus the bf16
   logit bound, within that bound on the first 2 layers, and the greedy
   tokens agree (or the top-2 gap is below the bound).
7. ``serve``, ``serve_paged``, ``serve_int8``, ``serve_paged_int8``:
   `repro_torch.launch.serve` at Qwen3-14B's full published width (random
   bf16 weights from a seeded generator) serves 6 requests through each
   cache layout (``--paged --sched spf``, ``--kv-dtype int8``, and both in
   a pool of 100 pages under ``--sched paged-aware``, where at most two
   requests fit at once), at ``--batch 4``.  Each summary must conserve
   all 6, pass ``tools/check_serve.py``, and its layout's kernel must have
   launched 40 times (once per layer) per decode forward, the other
   kernels never, and at the server's decode span only (a contiguous
   cache: its plan's; a paged one: the default); a paged run must end
   with no page allocated and no pool overflow; the flash kernel must not
   launch (serving prefill with a cache runs `attention_core`).
   ``serve_autobatch`` and ``serve_autobatch_int8``: the default CLI
   (``--batch 0``) with an f32 and an int8 cache, the same checks; each
   ``*_plan`` line prints the sweep's batch, predicted step, decode plan,
   the kernel plan, the predicted step against the measured per-token
   p50 and the kernel's launches; the decode kernel (B1, B3) must run at
   the plan's span, and when the sweep picks 4 the token streams must
   equal the ``--batch 4`` run's.
   ``serve_chaos`` and ``serve_chaos_paged_int8``: the CLI at full width
   under ``--chaos --fault-seed 0`` (the seeded smoke schedule: one NaN
   logits, one NaN cache slot, one kernel-dispatch failure, one
   straggler, one prefill interrupt), f32 contiguous (B1) and paged int8
   under ``spf`` (B4): each log passes ``check_serve.py --chaos``, every
   class fired, no request failed, one re-plan of the decode kernel and
   no fallback (the port has no plain path on a card), and the slots
   quarantined are exactly those ``fired`` names for the two NaN faults;
   the completed streams equal to the fault-free run's are counted.
   ``serve_crash_resume`` and ``serve_crash_resume_paged_bf16``: 6
   requests of 128 + 16 tokens, a snapshot every 4 steps, f32 contiguous
   (B1) and paged bf16 (B2): an uninterrupted run, ``--crash --crash-step
   9`` (exit 17) and ``--resume``, which passes ``check_serve.py
   --recovery`` and ``--serving-json``; streams equal the uninterrupted
   run's (or part at a near-tie under the bf16 logit bound); snapshot
   bytes and seconds per save, replayed steps, the resume's prepare and
   first-new-token seconds, and both processes' weight digests.
   ``serving_load``: `repro_torch.benchmarks.serving_load` at full width
   with the ``--smoke`` counts (five mixes, ``recovery``, ``paging``;
   B1, B2, B3), its report passing ``tools/check_load.py``, each mix's
   predicted step beside the measured one; then its ``steady.jsonl``
   through ``serve --load-trace``, whose percentiles must equal the
   steady mix's.
   The other model families (ROADMAP A12), each serve phase through the
   CLI, its log passing ``check_serve.py`` with every request completed,
   the decode kernel of its attention layers launched once per attention
   layer a decode forward and nothing else, with its host wall time and
   per-token p50: ``serve_danube_ring`` (H2O-Danube-1.8B, full width and
   depth, prompts of 4,200 tokens trimmed to the 4,096-token window, a
   ring cache of 4,096 rows that every decode step overwrites; decode on
   the plain path, as the JAX package's) and
   ``danube_ring_vs_teacher_forcing`` (4,096 tokens prefilled into the
   ring, 20 more one at a time, f32, against the cache-free windowed
   forward, 1e-4 of the largest |logit|); ``serve_moe`` and
   ``serve_moe_paged`` (Phi-3.5-MoE at full width, 16 of 32 layers: B1,
   B2) and ``moe_paged_vs_contiguous`` (the paged run's streams equal a
   contiguous server's with its weights at the same, default, span);
   ``moe_vs_teacher_forcing`` (4 layers, capacity raised so nothing
   drops, 64 tokens through B1 in f32); ``serve_qwen3_moe`` twice
   (Qwen3-MoE-235B at full width, 128 experts, top 8, 4 of 94 layers: the
   two runs' streams bitwise equal); ``serve_rwkv`` (RWKV6-7B, full width
   and depth, no kernel) and ``rwkv_vs_teacher_forcing``;
   ``serve_jamba_smoke`` and ``serve_chaos_jamba_smoke`` (Jamba's SMOKE
   shapes, the only ones one card holds; the chaos run's ``kv_corrupt``
   must leave the slot's Mamba state NaN and the other slots' finite);
   ``prefill_hubert`` (HuBERT-XLarge, 2 x 1,000 frames, B5 non-causal at
   head_dim 80) and ``prefill_internvl2`` (InternVL2-2B, 1,024 patches and
   512 tokens, B5 causal at 128), each gated as ``prefill_vs_forward``.
8. ``paged_vs_contiguous``: one set of full-width weights serves the same
   4 requests through a contiguous and a paged f32 cache, both at the
   kernels' default span; the greedy token streams must be equal.
9. ``decode_step``: where one decode step of the contiguous serve shape
   goes (batch 4, depth 600), at the span the server resolved from its
   plan and at the default span: host-clock time of untraced steps, then
   device time by kernel from `torch.profiler` over traced steps.
10. ``matmul_cases``: the blocked matmul B6, with the tile the tuner
   measures fastest among the model's top ``TABLE1_MEASURE_K``, against
   `matmul_ref` on the card (per-row tolerance `ref.row_tolerance`: 1e-5
   of the row's largest |ref| in f32, 2^-7 in bf16) at the four Table-1
   shapes in bf16, 4096^3 in f32, ragged 130x70x50 (bf16 and f32, with a
   bias and GELU; rows of 100 bytes, so the mma.sync kernel), ragged
   4000x3000x1000 (the wgmma kernel, TMA filling the edges) and
   1x128x256, and every activation with a bias at 4096^3 bf16; each with
   the design that ran (`kernel.design`: wgmma+TMA, mma.sync or CUDA
   cores), its time, the plain version's, cuBLAS's (`torch.matmul` in
   the same dtype, TF32 off), the bound and TFLOP/s.
11. ``spmv_cases``: B7 (x resident, reading only each row's nonzeros by
   the row lengths) and B8 (x in slabs: staged when x is one slab, else
   gathered directly) against `spmv_ell_ref` (B7 also with the row
   lengths, B8 also against its slab walk) and, in the original row
   order, `spmv_csr_ref`, within 1e-5 of each row's sum of |products|:
   B7 on the four Table-II
   matrices, both on ``spmv_1m_narrow`` (1M rows, x of 128 KB), B8 on
   ``spmv_1m_wide`` (1M rows and columns, every row spread over x) and on
   ``spmv_1m_banded`` (1M rows and columns, LD_pilot87's 1-96 nonzeros a
   row within 128 columns of the diagonal, seeded here), each at the
   tuner's plan; each with its time, the plain version's, cuSPARSE's
   (`torch.sparse_csr_tensor` @ x), its bytes bound (the nonzeros' cols
   and vals, x and y; the padded ELL's bytes beside it) and, for B7,
   every block_rows that launches differently timed against the tuner's
   pick; for B8, the counts
   of staged, gathered and skipped (row block, slab) pairs
   (`kernel.slab_plan`).
12. ``table1`` and ``table2``: `repro_torch.benchmarks.table1_matmul` and
   ``table2_spmv`` on the card, each in a fresh tuning cache, with the
   launch counts set to 0 just before and read just after: Table-1 plans
   measured on the card (keys naming it), B6 timed at the Table-1 shapes
   (every launch on the wgmma kernel), a second `tune` answered from the
   cache, and every built tile timed at 8192^3 beside its rank under the
   model; the Table-II rows (dense
   baseline against the tuned sparse path) and the tuned plans of the
   four matrices and both 1M-row ones, the wide one on B8.
   ``attention_report``: `repro_torch.benchmarks.run`'s report with its
   attention rows measured at full Qwen3-14B shapes (B5, B1, B3) and the
   Table I and Table II records of the two phases before (not timed
   again); it must pass ``tools/check_bench.py``.
13. ``total``: the script's seconds.  ``kernels``: one entry per ported
   kernel, with its TPU counterpart, its design, launches on its
   main-path run (B1, B3: the default CLI, ``serve_autobatch*``; B2, B4:
   their serve runs; B5: the ``prefill`` phase; B6: ``table1``; B7, B8:
   ``table2``) and B1-B5's launches by phase (the chaos, crash-resume,
   ``serving_load`` and other families' phases among them), error and
   times.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
exits non-zero without it; so does a host without a CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
SERVE_BASE = ["--arch", "qwen3_14b", "--batch", "4", "--requests", "6",
              "--prompt-len", "600", "--gen", "16"]
SERVE_ARGV = SERVE_BASE + ["--kv-dtype", "f32"]
SERVE_LEN = 600 + 16 + 8             # the serve run's cache rows
SERVE_LENGTHS = [601, 608, 612, 616]
# (phase, argv, the kernel its decode steps run, most requests at once)
SERVE_PHASES = [
    ("serve", SERVE_ARGV, "decode_attention", None),
    ("serve_paged", SERVE_ARGV + ["--paged", "--page-size", "16",
                                  "--sched", "spf"],
     "paged_decode_attention", None),
    ("serve_int8", SERVE_BASE + ["--kv-dtype", "int8"],
     "quantized_decode_attention", None),
    ("serve_paged_int8", SERVE_BASE + ["--paged", "--page-size", "16",
                                       "--pool-pages", "100", "--kv-dtype",
                                       "int8", "--sched", "paged-aware"],
     "paged_quantized_decode_attention", 2),
]
# The default CLI run (--batch 0): the tuner's batch and decode span.
AUTOBATCH_BASE = ["--arch", "qwen3_14b", "--requests", "6",
                  "--prompt-len", "600", "--gen", "16"]
# (phase, argv, the kernel its decode steps run, the --batch 4 phase whose
# token streams it must equal when the sweep picks 4)
AUTOBATCH_PHASES = [
    ("serve_autobatch", AUTOBATCH_BASE + ["--kv-dtype", "f32"],
     "decode_attention", "serve"),
    ("serve_autobatch_int8", AUTOBATCH_BASE + ["--kv-dtype", "int8"],
     "quantized_decode_attention", "serve_int8"),
]
# The chaos phases: the seeded smoke schedule (one fault of each class)
# through a full-width serve run.  (phase, argv, the kernel its decode
# steps run, the fault-free phase at the same flags, or None to run one)
CHAOS_FLAGS = ["--chaos", "--fault-seed", "0"]
CHAOS_PHASES = [
    ("serve_chaos", SERVE_ARGV + CHAOS_FLAGS, "decode_attention", "serve"),
    ("serve_chaos_paged_int8",
     SERVE_BASE + ["--paged", "--page-size", "16", "--kv-dtype", "int8",
                   "--sched", "spf"] + CHAOS_FLAGS,
     "paged_quantized_decode_attention", None),
]
SMOKE_FAULTS = ("nan_logits", "kv_corrupt", "kernel_dispatch", "straggler",
                "prefill_interrupt")
# Crash and resume: a 128-token prompt keeps an f32 snapshot at 4 x 152
# rows x 320 KiB (about 199 MB).  (phase, flags, the decode kernel)
RESUME_BASE = ["--arch", "qwen3_14b", "--batch", "4", "--requests", "6",
               "--prompt-len", "128", "--gen", "16", "--snapshot-every", "4"]
SNAPSHOT_EVERY, CRASH_STEP = 4, 9
RESUME_PHASES = [
    ("serve_crash_resume", ["--kv-dtype", "f32"], "decode_attention"),
    ("serve_crash_resume_paged_bf16", ["--paged", "--kv-dtype", "bf16"],
     "paged_decode_attention"),
]
STATE_ROOT = ROOT / "build" / "chip_smoke_state"
# The decode kernel of each serve phase.
KERNELS_OF_SERVE = {p: k for p, _, k, _ in SERVE_PHASES + AUTOBATCH_PHASES}
KERNELS_OF_SERVE.update({p: k for p, _, k, _ in CHAOS_PHASES})
KERNELS_OF_SERVE.update({p: k for p, _, k in RESUME_PHASES})
# Each kernel's design on the card, as the kernels line names it.
DESIGNS = {
    **dict.fromkeys(
        ("decode_attention", "paged_decode_attention",
         "quantized_decode_attention", "paged_quantized_decode_attention"),
        "flash-decoding: keys split in spans across blocks (a runtime "
        "argument: decode.SPLIT_KEYS by default, the tuner's span on a "
        "contiguous serving cache), 8-key warp tiles on cp.async, f32 CUDA "
        "cores, splits combined in the kernel by the last block of each "
        "row"),
    "flash_attention": {"wgmma": "wgmma+TMA", "mma.sync": "mma.sync",
                        "f32": "f32 CUDA cores"},
    "blocked_matmul": "wgmma+TMA (bf16 read by TMA), mma.sync (other "
                      "bf16), CUDA cores (f32): kernel.design",
    "ell_spmv": "x resident in shared memory, row lengths: only the "
                "nonzeros read, in 16-byte vectors",
    "ell_spmv_blocked": "stage-or-gather: x staged when one slab, "
                        "else gathered directly",
}
# Where each kernel's source is and which Pallas kernel it replaces.
KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/attention/decode.py:144"),
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/attention/decode.py:296"),
    "quantized_decode_attention": (
        "src/repro_torch/csrc/quantized_decode_attention.cu",
        "src/repro/kernels/attention/decode_int8.py:130"),
    "paged_quantized_decode_attention": (
        "src/repro_torch/csrc/paged_quantized_decode_attention.cu",
        "src/repro/kernels/attention/decode_int8.py:282"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention/kernel.py:177"),
    "blocked_matmul": ("src/repro_torch/csrc/blocked_matmul_wgmma.cu",
                       "src/repro/kernels/matmul/kernel.py:102"),
    "ell_spmv": ("src/repro_torch/csrc/ell_spmv.cu",
                 "src/repro/kernels/spmv/kernel.py:51"),
    "ell_spmv_blocked": ("src/repro_torch/csrc/ell_spmv.cu",
                         "src/repro/kernels/spmv/kernel.py:105"),
}
NO_LIBRARY = ("none: no single PyTorch call computes attention through a "
              "page table or over int8 codes")
MIXED = [0, 1, 511, 512, 513, 2048, 3000, 4096]
LONG = 32768                         # Qwen3-14B's context
# split_sweep: B1 and B3 at every span of the decode tuner's candidate
# set (`spec.DECODE_BLOCKS`, clamped to the rows), the default span and
# the span the tuner picks, each passed at run time, at the serve shape,
# 4,096 and 32,768 keys
SWEEP_SHAPES = [("serve_shape", SERVE_LENGTHS, SERVE_LEN),
                ("b1_l4096", [4096], 4096), ("b8_l4096", MIXED, 4096),
                ("b1_l32768", [LONG], LONG), ("b4_l32768", [LONG] * 4, LONG)]
STEP_BATCH, STEP_DEPTH = 4, 600      # decode_step: the serve run's shape
STEP_WARMUP, STEP_COUNT = 2, 8       # untraced steps, then as many traced
TOP_KERNELS = 12
# flash_cases: (name, batch, Sq, Sk, Hq, Hkv, dh, causal, window, dtype)
FLASH_CASES = [
    ("qwen3_prefill_32k", 1, 32768, 32768, 40, 8, 128, True, None, "bf16"),
    ("qwen3_prefill_4k", 1, 4096, 4096, 40, 8, 128, True, None, "bf16"),
    ("danube_prefill_32k", 1, 32768, 32768, 32, 8, 80, True, 4096, "bf16"),
    ("non_causal_ragged", 2, 1000, 1000, 40, 8, 128, False, None, "bf16"),
    ("window_sq_gt_sk", 1, 700, 500, 32, 8, 80, True, 64, "bf16"),
    ("window_sq_gt_sk_dh128", 1, 700, 500, 40, 8, 128, True, 64, "bf16"),
    ("qwen3_4k_f32", 1, 4096, 4096, 40, 8, 128, True, None, "f32"),
]
# (phase, arch, prefill_vs_forward's length: past Danube's 4096 window)
PREFILL_PHASES = [("prefill", "qwen3_14b", 4096),
                  ("prefill_danube", "h2o_danube_1_8b", 6144)]
PREFILL_TIMED = 2                    # untraced forwards after a warm-up
BF16_LOGIT_REL = 3e-2                # ROADMAP queue C's bf16 logit bound
SHALLOW = 2                          # the SMOKE depth that bound was set at
MATMUL_MARKS = ("nvjet", "gemm", "xmma", "cutlass")


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


def decode_kernel_ms(torch, fn, flush, n: int = 5):
    """Mean device time of the decode kernel itself over ``n`` calls, each
    after an L2-evicting write, by kernel name from `torch.profiler`: a
    call's event time also holds the wrapper's own small operations.
    None when the trace holds no time of the kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if "decode_kernel" in e.key)
    return us / 1e3 / n if us > 0 else None


def split_plan(decode, lengths, rows: int, hkv: int) -> dict:
    """The split span, the blocks of the grid (sized from the rows) and
    those of them that hold keys (from the lengths)."""
    return {"split_keys": decode.SPLIT_KEYS,
            "grid_blocks": decode.num_splits(rows) * len(lengths) * hkv,
            "blocks_with_keys": hkv * sum(len(decode.split_bounds(n, rows))
                                          for n in lengths)}


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

    def kernel():
        return decode.gqa_decode_attention(q, k, v, length=lv, scale=scale)
    ms = median_ms(torch, kernel, 21, flush)
    kernel_ms = decode_kernel_ms(torch, kernel, flush)
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
            "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops,
            **split_plan(decode, lengths, cache_len, hkv)}


def shuffled_pool(torch, lengths, rows, page_size, hkv, dh, seed):
    """A pool with room for every slot's ``rows`` and a page table filled
    from a shuffled permutation of its pages, -1 past each slot's last
    page; the pool's values are N(0, 1) f32."""
    dev = torch.device("cuda")
    max_pages = -(-rows // page_size)
    num_pages = len(lengths) * max_pages
    cpu = torch.Generator().manual_seed(seed)
    perm = torch.randperm(num_pages, generator=cpu)
    table = torch.full((len(lengths), max_pages), -1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // page_size)
        table[b, :need] = perm[used:used + need]
        used += need
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (num_pages, page_size, hkv, dh)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    return k, v, table.to(dev), used


def new_kernel_case(torch, mods, flush, *, kernel, name, lengths, q_dtype,
                    kv_dtype, rows, page_size=None, hq=40, hkv=8, dh=128,
                    seed=0):
    """One shape of the paged, int8 or paged int8 kernel: its error against
    its plain version, times and bound.  The paged kernel's output must
    also be bitwise that of the contiguous kernel over the same rows."""
    decode, decode_int8, quantize, _ = mods
    dev = torch.device("cuda")
    b = len(lengths)
    q = torch.randn((b, hq, dh), generator=torch.Generator(
        device=dev).manual_seed(seed + 1), device=dev).to(q_dtype)
    lv = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    paged = page_size is not None
    table_pages = 0
    if paged:
        k, v, pages, table_pages = shuffled_pool(torch, lengths, rows,
                                                 page_size, hkv, dh, seed)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        k = torch.randn((b, rows, hkv, dh), generator=gen, device=dev)
        v = torch.randn((b, rows, hkv, dh), generator=gen, device=dev)
    if kv_dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize.quantize_rows(k), quantize.quantize_rows(v)
        cache = (kq, ks, vq, vs)
    else:
        cache = (k.to(kv_dtype), v.to(kv_dtype))
    del k, v
    args = cache + ((pages,) if paged else ())
    fn, ref_fn = {
        "paged_decode_attention": (decode.paged_gqa_decode_attention,
                                   decode.paged_decode_ref),
        "quantized_decode_attention": (
            decode_int8.quantized_gqa_decode_attention,
            decode_int8.quantized_decode_ref),
        "paged_quantized_decode_attention": (
            decode_int8.paged_quantized_gqa_decode_attention,
            decode_int8.paged_quantized_decode_ref),
    }[kernel]

    out = fn(q, *args, length=lv, scale=scale)
    ref = ref_fn(q, *args, length=lv, scale=scale)
    torch.cuda.synchronize()
    err, err_over_tol = row_errors(torch, out, ref, q_dtype == torch.float32)
    zeros_ok = all(not out[i].any() for i, n in enumerate(lengths) if n == 0)
    bitwise = None
    if kernel == "paged_decode_attention":
        contiguous = decode.gqa_decode_attention(
            q, decode.gather_pages(cache[0], pages).contiguous(),
            decode.gather_pages(cache[1], pages).contiguous(), length=lv,
            scale=scale)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(out, contiguous))
    ms = median_ms(torch, lambda: fn(q, *args, length=lv, scale=scale), 21,
                   flush)
    kernel_ms = decode_kernel_ms(
        torch, lambda: fn(q, *args, length=lv, scale=scale), flush)
    plain_ms = median_ms(torch, lambda: ref_fn(q, *args, length=lv,
                                               scale=scale), 5, flush)

    valid = sum(min(max(n, 0), rows) for n in lengths)
    row_bytes = dh + 4 if kv_dtype == torch.int8 else dh * cache[0].element_size()
    nbytes = (2 * valid * hkv * row_bytes + q.numel() * q.element_size()
              + out.numel() * out.element_size() + lv.numel() * 4
              + table_pages * 4)
    ops = 4 * valid * hq * dh          # q.k and p.v multiply-adds
    kv_name = str(kv_dtype).removeprefix("torch.")
    # the int8 kernels dequantize and multiply in f32
    peak = PEAK_OPS_PER_S["float32" if kv_dtype == torch.int8 else kv_name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    ok = err_over_tol <= 1 and zeros_ok and bitwise is not False
    return {"kernel": kernel, "name": name, "batch": b, "rows": rows,
            "page_size": page_size, "lengths": list(lengths),
            "q_dtype": str(q_dtype).removeprefix("torch."),
            "kv_dtype": kv_name, "max_abs_err": err,
            "tolerance": ("1e-4" if q_dtype == torch.float32
                          else "2^-7 x the row's max |ref|"),
            "max_err_over_tol": err_over_tol, "zero_rows_ok": zeros_ok,
            "bitwise_contiguous": bitwise, "ok": ok,
            "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops,
            **split_plan(decode, lengths,
                         pages.shape[1] * page_size if paged else rows, hkv)}


def new_kernel_cases(torch, mods, flush):
    """B2-B4 at the serve shape, at batch 1 and 4096 rows, and at the mixed
    lengths and 4096 rows: B2 with bf16 q and an f32 or bf16 pool, B3 and
    B4 with bf16 and f32 q, the paged ones at page sizes 16 and 48.  At
    32,768 keys, batch 1 and 4: B2 at page 16 with an f32 or bf16 pool, B3
    and B4 (page 16) with bf16 q."""
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    shapes = [("serve_shape", SERVE_LENGTHS, SERVE_LEN),
              ("b1_l4096", [4096], 4096), ("b8_l4096", MIXED, 4096)]
    cases = []
    for name, lengths, rows in shapes:
        for page_size in (16, 48):
            for kv_dtype in (f32, bf16):
                cases.append(new_kernel_case(
                    torch, mods, flush, kernel="paged_decode_attention",
                    name=name, lengths=lengths, q_dtype=bf16,
                    kv_dtype=kv_dtype, rows=rows, page_size=page_size))
        for q_dtype in (bf16, f32):
            cases.append(new_kernel_case(
                torch, mods, flush, kernel="quantized_decode_attention",
                name=name, lengths=lengths, q_dtype=q_dtype, kv_dtype=i8,
                rows=rows))
            for page_size in (16, 48):
                cases.append(new_kernel_case(
                    torch, mods, flush,
                    kernel="paged_quantized_decode_attention", name=name,
                    lengths=lengths, q_dtype=q_dtype, kv_dtype=i8, rows=rows,
                    page_size=page_size))
    for name, lengths in (("b1_l32768", [LONG]), ("b4_l32768", [LONG] * 4)):
        for kv_dtype in (f32, bf16):
            cases.append(new_kernel_case(
                torch, mods, flush, kernel="paged_decode_attention",
                name=name, lengths=lengths, q_dtype=bf16, kv_dtype=kv_dtype,
                rows=LONG, page_size=16))
        for kernel, page_size in (("quantized_decode_attention", None),
                                  ("paged_quantized_decode_attention", 16)):
            cases.append(new_kernel_case(
                torch, mods, flush, kernel=kernel, name=name,
                lengths=lengths, q_dtype=bf16, kv_dtype=i8, rows=LONG,
                page_size=page_size))
        gc.collect()
        torch.cuda.empty_cache()
    return cases


def sweep_spans(spec, rows: int, tuned: int) -> list[int]:
    """The spans `split_sweep` times at a cache of ``rows`` rows: the
    tuner's candidates clamped to the rows, the default span and the
    tuner's pick."""
    from repro_torch.kernels.attention import decode
    return sorted({min(b, rows) for b in spec.DECODE_BLOCKS}
                  | {decode.SPLIT_KEYS, tuned})


def split_sweep(torch, mods, flush):
    """B1 (f32 and bf16 cache) and B3 (int8 cache) at each span of
    `sweep_spans` at the `SWEEP_SHAPES`, bf16 q, the span passed at run
    time: the spans in turns, forward then back, each turn the median of
    11 calls; each span's output held to its plain version (the per-row
    tolerance of `row_errors`).  The tuner's pick is its model ranking
    for the shape's problem with its lengths (`autotune.tune`, no
    measurement), as the server ranks it; each row has the tuned span's
    time over the default span's."""
    import tempfile
    from repro_torch.kernels import autotune
    from repro_torch.kernels.attention import spec
    decode, decode_int8, quantize, _ = mods
    dev = torch.device("cuda")
    kernels = {
        "float32": ("decode", decode.gqa_decode_attention, decode.decode_ref),
        "bfloat16": ("decode", decode.gqa_decode_attention,
                     decode.decode_ref),
        "int8": ("decode_int8", decode_int8.quantized_gqa_decode_attention,
                 decode_int8.quantized_decode_ref)}
    res = []
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.TuneCache(pathlib.Path(tmp) / "autotune.json")
        for name, lengths, rows in SWEEP_SHAPES:
            for kv_name, (family, fn, ref_fn) in kernels.items():
                gen = torch.Generator(device=dev).manual_seed(7)
                b = len(lengths)
                q = torch.randn((b, 40, 128), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                kv = [torch.randn((b, rows, 8, 128), generator=gen,
                                  device=dev) for _ in range(2)]
                if kv_name == "int8":
                    (kq, ks), (vq, vs) = map(quantize.quantize_rows, kv)
                    cache_args = (kq, ks, vq, vs)
                else:
                    dt = getattr(torch, kv_name)
                    cache_args = tuple(x.to(dt) for x in kv)
                del kv
                lv = torch.tensor(lengths, dtype=torch.int32, device=dev)
                ref = ref_fn(q, *cache_args, length=lv)
                problem = {"bkv": b * 8, "g": 5, "cache_len": rows,
                           "dh": 128, "lengths": tuple(lengths)}
                tuned = autotune.tune(
                    family, problem,
                    torch.bfloat16 if kv_name == "int8"
                    else getattr(torch, kv_name),
                    device=dev, measure_k=0, cache=cache).knobs["block_k"]
                spans = sweep_spans(spec, rows, tuned)

                def call(span):
                    return fn(q, *cache_args, length=lv, block_k=span)
                ms = {sp: [] for sp in spans}
                worst = 0.0
                for sp in spans + spans[::-1]:
                    if not ms[sp]:
                        out = call(sp)
                        torch.cuda.synchronize()
                        worst = max(worst, row_errors(torch, out, ref,
                                                      False)[1])
                    ms[sp].append(median_ms(torch, lambda sp=sp: call(sp),
                                            11, flush))
                mean = {sp: sum(t) / len(t) for sp, t in ms.items()}
                res.append({
                    "name": name, "kv_dtype": kv_name,
                    "kernel": ("quantized_decode_attention"
                               if kv_name == "int8" else "decode_attention"),
                    "ms_by_span": {str(sp): t for sp, t in ms.items()},
                    "grid_blocks_by_span": {
                        str(sp): decode.num_splits(rows, sp) * b * 8
                        for sp in spans},
                    "fastest": min(spans, key=lambda sp: mean[sp]),
                    "tuned_span": tuned,
                    "tuned_ms": mean[tuned],
                    "default_span": decode.SPLIT_KEYS,
                    "default_ms": mean[decode.SPLIT_KEYS],
                    "tuned_over_default": (mean[tuned]
                                           / mean[decode.SPLIT_KEYS]),
                    "max_err_over_tol": worst, "ok": worst <= 1})
                del q, cache_args, ref
                torch.cuda.empty_cache()
    return res


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


def decode_vs_teacher_forcing_paged(torch, configs, transformer, paging,
                                    decode):
    """The same check through a paged f32 cache of 4-token pages: before
    each step every slot's table grows by the host allocator, so the
    slots' pages interleave in the pool; decode goes through the paged
    kernel (launched once per layer per step).  f32, TF32 off: 1e-3."""
    dev = torch.device("cuda")
    cfg = configs.get_smoke("qwen3_14b")
    params = transformer.init(cfg, torch.Generator(device=dev).manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (3, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    full, _ = transformer.forward(cfg, params, {"tokens": toks},
                                  compute_dtype=torch.float32)
    spec = paging.PageSpec.build(3, 24, 4)
    alloc = paging.PageAllocator(spec, 3)
    cache = transformer.cache_init(cfg, 3, 24, dtype=torch.float32,
                                   device=dev, paged=spec)
    decode.paged_launches = 0
    steps = []
    for t in range(toks.shape[1]):
        for b in range(3):
            alloc.ensure(b, t + 1)
        cache["pages"].copy_(torch.from_numpy(alloc.table))
        lg, cache = transformer.forward(cfg, params,
                                        {"tokens": toks[:, t:t + 1]},
                                        cache=cache,
                                        compute_dtype=torch.float32,
                                        paged=spec)
        steps.append(lg[:, 0])
    launches = decode.paged_launches
    dec = torch.stack(steps, 1)
    err = float((dec - full).abs().max())
    finite = bool(torch.isfinite(dec).all())
    want = toks.shape[1] * cfg.num_layers
    return {"shape": list(dec.shape), "page_size": spec.page_size,
            "pages": alloc.table.tolist(), "max_abs_err": err,
            "tolerance": 1e-3, "finite": finite,
            "paged_launches": launches, "ok": (finite and err <= 1e-3
                                               and launches == want)}


def launch_counts(mods) -> dict:
    from repro_torch.kernels.matmul import kernel as mm
    from repro_torch.kernels.spmv import kernel as sp
    decode, decode_int8, _, flash = mods
    return {"decode_attention": decode.launches,
            "paged_decode_attention": decode.paged_launches,
            "quantized_decode_attention": decode_int8.launches,
            "paged_quantized_decode_attention": decode_int8.paged_launches,
            "flash_attention": flash.launches,
            "blocked_matmul": mm.launches,
            "ell_spmv": sp.launches,
            "ell_spmv_blocked": sp.blocked_launches}


def reset_launch_counts(mods) -> None:
    from repro_torch.kernels.matmul import kernel as mm
    from repro_torch.kernels.spmv import kernel as sp
    decode, decode_int8, _, flash = mods
    decode.launches = decode.paged_launches = 0
    decode_int8.launches = decode_int8.paged_launches = 0
    flash.launches = 0
    mm.launches = 0
    mm.design_launches.update(dict.fromkeys(mm.design_launches, 0))
    sp.launches = sp.blocked_launches = 0


def cli_run(torch, serve, mods, argv, keep_server=False) -> dict:
    """One run of the serving CLI in this process, its output captured,
    every kernel's launch count set to 0 just before it and read just
    after.  Returns the exit code, the log, the seconds, the counts, the
    (step, slot) pairs each decode step quarantined, every request's
    final state and tokens and, with ``keep_server``, the server (else
    None: its weights and cache are freed)."""
    reset_launch_counts(mods)
    buf = io.StringIO()
    quarantined, requests, servers = [], {}, []
    run_loop, decode_step = serve.serve_loop, serve.Server.decode_step

    def loop(server, lc, **kw):
        if keep_server:
            servers.append(server)
        try:
            return run_loop(server, lc, **kw)
        finally:
            requests.update({rid: (r.state.value, list(r.tokens))
                             for rid, r in lc.requests.items()})

    def step(self, step=0, **kw):
        out = decode_step(self, step, **kw)
        quarantined.extend((step, s) for s in out[2])
        return out
    serve.serve_loop, serve.Server.decode_step = loop, step
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
    finally:
        serve.serve_loop, serve.Server.decode_step = run_loop, decode_step
    seconds = time.time() - t0
    counts = launch_counts(mods)
    log = buf.getvalue()
    print(log, end="", flush=True)
    gc.collect()                      # the run's weights and cache
    torch.cuda.empty_cache()
    return {"rc": rc, "log": log, "seconds": seconds, "counts": counts,
            "quarantined": sorted(quarantined), "requests": requests,
            "server": servers[0] if servers else None}


def serve_phase(torch, serve, check_serve, mods, *, phase, argv, kernel,
                most_at_once, layers) -> dict:
    """One serve run through `serve.main`, with every kernel's launch count
    set to 0 just before it and read just after.  Returns the launches of
    the layout's kernel, each request's token stream, the spans the decode
    kernels were launched with, the serving plan and the summary."""
    decode = mods[0]
    torch.cuda.reset_peak_memory_stats()
    spans = set()
    launch = decode._launch

    def spy(*a, span, **kw):
        spans.add(span)
        return launch(*a, span=span, **kw)
    decode._launch = spy
    try:
        run = cli_run(torch, serve, mods, argv)
    finally:
        decode._launch = launch
    rc, seconds, counts, log = (run[k] for k in ("rc", "seconds", "counts",
                                                 "log"))
    streams = {rid: toks for rid, (_, toks) in run["requests"].items()}
    summary = check_serve._json_lines(log)[-1]
    problems = check_serve.check(log, requests=6, min_tokens=6 * 16)
    launches = counts.pop(kernel)
    plan = check_serve._json_lines(log)[0]["serving_plan"]
    emit(phase, argv=argv, rc=rc, seconds=round(seconds, 3),
         decode_forwards=summary.get("decode_forwards"), kernel=kernel,
         kernel_launches=launches, other_kernel_launches=counts,
         decode_span=summary.get("decode_span"),
         spans_launched=sorted(spans), layers=layers,
         check_serve_problems=problems,
         tok_per_s=summary.get("tok_per_s"),
         per_token_ms=summary.get("per_token_ms"),
         max_concurrent=summary.get("max_concurrent"),
         kv=summary.get("kv"), sched=summary.get("sched"),
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    check(rc == 0 and not problems, f"{phase} run failed: {problems}")
    outcomes = summary["outcomes"]
    check(summary["submitted"] == 6 and outcomes["completed"] == 6
          and outcomes["evicted"] == 0,
          f"{phase} did not complete all 6 requests cleanly: {outcomes}")
    check(summary["decode_forwards"] > 0
          and launches == summary["decode_forwards"] * layers,
          f"{phase}: {launches} {kernel} launches for "
          f"{summary['decode_forwards']} decode forwards x {layers} layers")
    check(not any(counts.values()),
          f"{phase}: other kernels launched: {counts}")
    if "--paged" in argv:
        kv = summary["kv"]
        check(kv["kv_ooms"] == 0 and kv["pages_allocated"] == 0,
              f"{phase}: pool overflowed or leaked pages: {kv}")
    if most_at_once is not None:
        check(summary["max_concurrent"] <= most_at_once,
              f"{phase}: {summary['max_concurrent']} requests at once in a "
              f"pool that holds {most_at_once}")
    check(spans == {summary["decode_span"] or decode.SPLIT_KEYS},
          f"{phase}: decode kernels launched at spans {sorted(spans)}, the "
          f"server's span is {summary['decode_span']}")
    return {"launches": launches, "streams": streams, "plan": plan,
            "summary": summary}


def autobatch_phase(torch, serve, check_serve, mods, *, phase, argv, kernel,
                    layers, flagged) -> dict:
    """The default CLI run, ``--batch 0``: the batch from the tuner's
    sweep, the decode kernel at the span of the server's plan.  Prints the
    serving plan, the kernel plan, the predicted step against the
    measured per-token time and the kernel's launches; when the sweep
    picks 4 the token streams must equal those of ``flagged`` (the
    ``--batch 4`` run of the same layout)."""
    run = serve_phase(torch, serve, check_serve, mods, phase=phase,
                      argv=argv, kernel=kernel, most_at_once=None,
                      layers=layers)
    plan, summary = run["plan"], run["summary"]
    decode_plan = plan["decode_plan"]
    check(plan["source"] == "autotune",
          f"{phase}: serving plan not from the sweep: {plan}")
    check(summary["decode_span"] == decode_plan["knobs"]["block_k"],
          f"{phase}: the server ran span {summary['decode_span']}, the "
          f"sweep's decode plan has {decode_plan['knobs']}")
    same = (run["streams"] == flagged["streams"] if plan["batch"] == 4
            else None)
    check(same is not False,
          f"{phase}: the sweep picked batch 4 but the token streams differ "
          f"from the --batch 4 run's")
    per_token = summary["per_token_ms"]
    out = {"batch": plan["batch"],
           "predicted_step_us": plan["predicted_step_us"],
           "chip": plan["chip"], "decode_plan": decode_plan,
           "sweep": [{k: r[k] for k in ("batch", "step_us", "feasible")}
                     for r in plan["sweep"]],
           "kernel_plan": summary["kernel_plan"],
           "decode_span": summary["decode_span"],
           "watchdog": summary["watchdog"],
           "per_token_ms": per_token,
           "predicted_over_measured_p50": (
               plan["predicted_step_us"] / 1e3 / per_token["p50"]
               if per_token.get("p50") else None),
           "kernel": kernel, "launches": run["launches"],
           "streams_equal_batch4": same}
    emit(phase + "_plan", **out)
    return {**out, "run": run}


def paged_vs_contiguous(torch, configs, serve, paging, lifecycle):
    """One set of full-width weights, the same 4 requests of 600 + 16
    tokens through a contiguous and a paged (16-token pages) f32 cache,
    both decoding at the kernels' default span (no plans): the greedy
    token streams must be equal, since the paged kernel reads the same
    keys in the same splits and order as the contiguous one."""
    import numpy as np
    cfg = configs.get("qwen3_14b")
    rng = np.random.default_rng(1)
    reqs = [(rid, rng.integers(0, cfg.vocab_size, 600), 16)
            for rid in range(4)]
    contiguous = serve.Server(cfg, 4, SERVE_LEN, autotune_kernels=False)
    spec = paging.PageSpec.build(4, SERVE_LEN, 16)
    paged = serve.Server(cfg, 4, SERVE_LEN, params=contiguous.params,
                         paged=spec, autotune_kernels=False)
    shared = all(a is b for a, b in zip(
        _leaves(contiguous.params), _leaves(paged.params)))
    streams = []
    for server in (contiguous, paged):
        lc = lifecycle.Lifecycle()
        for rid, prompt, gen in reqs:
            lc.submit(rid, prompt, gen)
        serve.serve_loop(server, lc)
        streams.append({rid: lc.requests[rid].tokens for rid, _, _ in reqs})
        server.cache = None
    del contiguous, paged
    gc.collect()
    torch.cuda.empty_cache()
    equal = streams[0] == streams[1]
    return {"requests": len(reqs), "prompt_len": 600, "gen": 16,
            "page_size": spec.page_size, "weights_shared": shared,
            "tokens": sum(len(t) for t in streams[0].values()),
            "equal": equal, "ok": equal and shared}


def _lines(check_serve, log, key):
    return [r[key] for r in check_serve._json_lines(log) if key in r]


def chaos_phase(torch, serve, check_serve, mods, *, phase, argv, kernel,
                layers, clean) -> dict:
    """The serving CLI at full width under ``--chaos --fault-seed 0``: the
    log must pass ``check_serve.py --chaos --requests 6`` with every smoke
    class fired, no request failed, one re-plan of the decode kernel and
    no fallback; the slots quarantined must be exactly those ``fired``
    names for ``nan_logits`` and ``kv_corrupt`` (the kernel carries a NaN
    cache row into that slot's logits, and no other slot's).  Prints, not
    gates, how many completed streams equal the fault-free run's at the
    same flags (``clean``: that run's requests, or None to run it)."""
    run = cli_run(torch, serve, mods, argv)
    log, counts = run["log"], dict(run["counts"])
    summary = check_serve._json_lines(log)[-1]
    problems = check_serve.check(log, requests=6, chaos=True)
    fired = [e for e in summary.get("faults", {}).get("fired", [])
             if not e.get("skipped")]
    kinds = sorted({e["kind"] for e in fired})
    named = sorted((e["fired_step"], e["slot"]) for e in fired
                   if e["kind"] in ("nan_logits", "kv_corrupt"))
    launches = counts.pop(kernel)
    if clean is None:
        plain = [a for a in argv if a not in CHAOS_FLAGS]
        clean = cli_run(torch, serve, mods, plain)["requests"]
    done = {rid: toks for rid, (state, toks) in run["requests"].items()
            if state == "completed"}
    equal = sum(1 for rid, toks in done.items()
                if clean.get(rid, (None, None))[1] == toks)
    out = {"argv": argv, "rc": run["rc"], "seconds": round(run["seconds"], 3),
           "kernel": kernel, "kernel_launches": launches,
           "other_kernel_launches": counts, "batch": summary.get("batch"),
           "decode_forwards": summary.get("decode_forwards"),
           "check_serve_problems": problems, "fired_kinds": kinds,
           "fired": fired, "quarantined": run["quarantined"],
           "named_by_fired": named, "outcomes": summary.get("outcomes"),
           "request_outcomes": summary.get("request_outcomes"),
           "kernel_replans": summary.get("kernel_replans"),
           "kernel_fallbacks": summary.get("kernel_fallbacks"),
           "decode_span": summary.get("decode_span"),
           "watchdog": summary.get("watchdog"),
           "completed_streams_equal_fault_free": equal,
           "completed": len(done)}
    emit(phase, **out)
    check(run["rc"] == 0 and not problems,
          f"{phase}: check_serve --chaos failed: {problems}")
    check(kinds == sorted(SMOKE_FAULTS),
          f"{phase}: fired {kinds}, not every smoke class")
    check(summary["outcomes"]["failed"] == 0, f"{phase}: a request failed")
    check(summary["kernel_replans"] == 1
          and summary["kernel_fallbacks"] == 0,
          f"{phase}: replans {summary['kernel_replans']}, fallbacks "
          f"{summary['kernel_fallbacks']}")
    check(run["quarantined"] == named,
          f"{phase}: quarantined {run['quarantined']}, fired names {named}")
    check(launches > 0 and launches == summary["decode_forwards"] * layers,
          f"{phase}: {launches} {kernel} launches for "
          f"{summary['decode_forwards']} decode forwards x {layers} layers")
    check(not any(counts.values()),
          f"{phase}: other kernels launched: {counts}")
    return out


def _near_tie(torch, serve, cfg, device, kv_dtype, prompt, want, got):
    """Where a resumed stream first parts from the uninterrupted one: the
    two tokens' logit gap after a teacher-forced prefill of the prompt and
    the uninterrupted tokens before it (the CLI's seeded weights), against
    the bf16 logit bound.  Builds a one-slot server of ``cfg``."""
    m = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    server = serve.Server(cfg, 1, len(prompt) + m + 8, device=device,
                          kv_dtype=kv_dtype, autotune_kernels=False)
    _, last = server._prefill(0, 0, list(prompt) + want[:m], 1, logits=True)
    gap = abs(float(last[want[m]] - last[got[m]]))
    bound = serve.BF16_LOGIT_REL * float(abs(last).max())
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"position": m, "uninterrupted": want[m], "resumed": got[m],
            "gap": gap, "bound": bound, "near_tie": gap < bound}


def crash_resume_phase(torch, serve, check_serve, mods, configs, *, phase,
                       flags, kernel, layers, cli=(),
                       state_root=STATE_ROOT) -> dict:
    """Full-width Qwen3-14B, 6 requests of 128 + 16 tokens at batch 4,
    journaled with a snapshot every 4 decode steps: an uninterrupted run,
    a run killed by ``--crash --crash-step 9`` (exit 17, a crash line, no
    summary) and its ``--resume``, which must pass ``check_serve.py
    --recovery --crash-log --journal --snapshot-every 4`` and
    ``--serving-json``.  The completed streams must equal the
    uninterrupted run's, or part from them only at a near-tie (the bf16
    logit bound; printed with the request and position).  Both
    processes must print one weights digest.  ``cli`` extends every run's
    arguments (``--smoke --device cpu`` rehearses the phase on the CPU)."""
    import shutil

    from repro_torch.runtime import journal
    root = state_root / phase
    shutil.rmtree(root, ignore_errors=True)
    clean_dir, crash_dir = root / "clean", root / "crashed"
    base = RESUME_BASE + flags + list(cli)
    runs = {"clean": cli_run(torch, serve, mods,
                             base + ["--state-dir", str(clean_dir)]),
            "crash": cli_run(torch, serve, mods,
                             base + ["--state-dir", str(crash_dir),
                                     "--crash", "--crash-step",
                                     str(CRASH_STEP)]),
            "resume": cli_run(torch, serve, mods,
                              ["--resume", "--state-dir", str(crash_dir),
                               *cli])}
    clean_log, crash_log, resume_log = (runs[k]["log"] for k in
                                        ("clean", "crash", "resume"))
    serving = json.loads((crash_dir / "serving.json").read_text())
    problems = (check_serve.check(clean_log, requests=6)
                + check_serve.check(resume_log, require_plan=False)
                + check_serve.check_recovery(
                    resume_log, crash_text=crash_log,
                    journal=crash_dir / "journal.jsonl",
                    snapshot_every=SNAPSHOT_EVERY)
                + check_serve.check_serving_json(resume_log, serving))
    folded = {k: journal.replay(journal.read_journal(d / "journal.jsonl"))
              for k, d in (("clean", clean_dir), ("crashed", crash_dir))}
    kv_dtype = getattr(torch, serving["kv_dtype"])
    cfg = (configs.get_smoke(serving["arch"]) if serving["smoke"]
           else configs.get(serving["arch"]))
    device = "cpu" if "cpu" in cli else "cuda"
    ties = {}
    for rid, want in folded["clean"].items():
        got = folded["crashed"][rid]["tokens"]
        if got != want["tokens"]:
            ties[rid] = _near_tie(torch, serve, cfg, device, kv_dtype,
                                  want["prompt"], want["tokens"], got)
    digests = {k: _lines(check_serve, runs[k]["log"], "params_digest")
               for k in runs}
    clean_sum = check_serve._json_lines(clean_log)[-1]
    resume_sum = check_serve._json_lines(resume_log)[-1]
    rec = resume_sum.get("recovery", {})
    launches = {k: r["counts"][kernel] for k, r in runs.items()}
    out = {"flags": flags, "rcs": {k: r["rc"] for k, r in runs.items()},
           "seconds": {k: round(r["seconds"], 3) for k, r in runs.items()},
           "kernel": kernel, "kernel_launches": launches,
           "check_serve_problems": problems,
           "crash_lines": _lines(check_serve, crash_log, "crash"),
           "snapshot_bytes": {"clean": clean_sum.get("snapshot_bytes"),
                              "resume": resume_sum.get("snapshot_bytes")},
           "snapshot_save_s": {"clean": clean_sum.get("snapshot_save_s"),
                               "resume": resume_sum.get("snapshot_save_s")},
           "snapshots_saved": clean_sum.get("snapshots_saved"),
           "recovery": rec, "replayed_steps": rec.get("replayed_steps"),
           "prepare_s": rec.get("prepare_s"),
           "first_new_token_s": rec.get("first_new_token_s"),
           "params_digests": digests,
           "decode_span": {"clean": clean_sum.get("decode_span"),
                           "resume": resume_sum.get("decode_span")},
           "streams_equal": len(folded["clean"]) - len(ties),
           "near_ties": ties,
           "per_token_ms": {"clean": clean_sum.get("per_token_ms"),
                            "resume": resume_sum.get("per_token_ms")}}
    emit(phase, **out)
    shutil.rmtree(root, ignore_errors=True)
    check(runs["clean"]["rc"] == 0 and runs["resume"]["rc"] == 0
          and runs["crash"]["rc"] == serve.CRASH_EXIT,
          f"{phase}: exit codes {out['rcs']}")
    check(not problems, f"{phase}: {problems}")
    check(all(t["near_tie"] for t in ties.values()),
          f"{phase}: a resumed stream parts from the uninterrupted one "
          f"above the bf16 bound: {ties}")
    flat = [d for ds in digests.values() for d in ds]
    check(len(flat) == 3 and len(set(flat)) == 1,
          f"{phase}: weight digests differ: {digests}")
    check(out["decode_span"]["clean"] == out["decode_span"]["resume"],
          f"{phase}: resumed at another decode span: {out['decode_span']}")
    check(all(n > 0 for n in launches.values()),
          f"{phase}: {kernel} not launched in every run: {launches}")
    for k, summary in (("clean", clean_sum), ("resume", resume_sum)):
        check(launches[k] == summary["decode_forwards"] * layers,
              f"{phase}: {launches[k]} {kernel} launches in the {k} run "
              f"for {summary['decode_forwards']} forwards x {layers}")
    return out


def serving_load_phase(torch, serve, check_serve, check_load, mods, *,
                       device="cuda", state_root=STATE_ROOT) -> dict:
    """The port's load harness on the card (`benchmarks.serving_load`):
    Qwen3-14B at full width, the five mixes at the ``--smoke`` counts,
    ``recovery`` and ``paging``; the report must pass
    ``tools/check_load.py``.  Each mix prints the tuner's predicted step
    (the model of this card) beside the measured one (its ``wall``
    block); the virtual-clock latencies are model milliseconds.  Then the
    emitted ``steady.jsonl`` replays through ``serve --load-trace``: its
    TTFT and per-token percentiles must equal the steady mix's.
    ``device="cpu"`` rehearses it with the SMOKE config."""
    import shutil

    from repro_torch.benchmarks import serving_load
    from repro_torch.core.ioutil import atomic_write_json
    root = state_root / "serving_load"
    shutil.rmtree(root, ignore_errors=True)
    traces = root / "traces"
    traces.mkdir(parents=True)
    reset_launch_counts(mods)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        report = serving_load.build_report("qwen3_14b", smoke=True,
                                           emit_dir=traces, device=device)
    seconds = time.time() - t0
    counts = launch_counts(mods)
    gc.collect()
    torch.cuda.empty_cache()
    path = root / "serving_load.json"
    atomic_write_json(path, report)
    problems = check_load.check(path)
    mixes = {}
    for name, m in report["mixes"].items():
        wall = m["wall"]
        mixes[name] = {
            "batch": m["batch"], "kv_dtype": m["kv_dtype"],
            "paged": m["paged"], "decode_steps": m["decode_steps"],
            "predicted_step_us": m["serving_plan"].get("predicted_step_us"),
            "measured_step_us_p50": wall.get("measured_step_us_p50"),
            "divergence": wall.get("divergence"), "wall_s": wall["wall_s"],
            "wall_tok_per_s": wall["wall_tok_per_s"],
            "model_ms": {"ttft": m["ttft_ms"], "per_token": m["per_token_ms"],
                         "step_time_us": m["step_time_us"]},
            "model_tok_per_s": m["tok_per_s"], "slo_ok": m["slo_ok"]}
    steady = report["mixes"]["steady"]
    replay = cli_run(torch, serve, mods,
                     ["--arch", "qwen3_14b", "--load-trace",
                      str(traces / "steady.jsonl"), "--device", device]
                     + (["--smoke"] if device == "cpu" else []))
    rsum = check_serve._json_lines(replay["log"])[-1]
    equal = (rsum["ttft_ms"] == steady["ttft_ms"]
             and rsum["per_token_ms"] == steady["per_token_ms"])
    out = {"seconds": round(seconds, 3), "device": report["device"],
           "chip": report["chip"], "check_load_problems": problems,
           "mixes": mixes, "recovery": report["recovery"],
           "paging": {k: report["paging"][k] for k in (
               "budget_tokens", "pool_pages", "concurrency_ratio",
               "ratio_ok", "contiguous", "paged")},
           "kernel_launches": counts,
           "replay": {"rc": replay["rc"],
                      "seconds": round(replay["seconds"], 3),
                      "ttft_ms": rsum["ttft_ms"],
                      "per_token_ms": rsum["per_token_ms"],
                      "load": rsum.get("load"),
                      "steady_ttft_ms": steady["ttft_ms"],
                      "steady_per_token_ms": steady["per_token_ms"],
                      "equal": equal,
                      "kernel_launches": replay["counts"]
                      ["decode_attention"]}}
    emit("serving_load", **out)
    shutil.rmtree(root, ignore_errors=True)
    check(not problems, f"serving_load: check_load.py: {problems}")
    for k in ("decode_attention", "paged_decode_attention",
              "quantized_decode_attention"):
        check(counts[k] > 0, f"serving_load: {k} never launched: {counts}")
    check(replay["rc"] == 0 and equal,
          f"serving_load: the replay's percentiles differ from the steady "
          f"mix's: {out['replay']}")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val:
            return float(val)
    return 0.0


def decode_step_breakdown(torch, configs, serve):
    """One decode step of the serve shape at full width, with the decode
    span the server resolved from its plan and then with the kernels'
    default span, on one server (the span rides the cache): for each,
    host-clock ms of ``STEP_COUNT`` untraced steps (each ends in its host
    synchronisation, the copy of the next tokens), then device time by
    kernel over as many steps traced by `torch.profiler`.  The profiler
    slows the host, so the busy share of an untraced step is the traced
    device time per step over the median untraced step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get("qwen3_14b")
    steps = 2 * (STEP_WARMUP + 2 * STEP_COUNT)
    server = serve.Server(cfg, STEP_BATCH, STEP_DEPTH + steps + 8)
    rng = np.random.default_rng(0)
    server.admit_chunk([(s, s, rng.integers(0, cfg.vocab_size, STEP_DEPTH),
                         steps + 1) for s in range(STEP_BATCH)])
    out = {"batch": STEP_BATCH, "depth": STEP_DEPTH,
           "cache_rows": server.max_len}
    for label, span in (("tuned", server.decode_span), ("default", None)):
        server.cache.pop("decode_span", None)
        if span is not None:
            server.cache["decode_span"] = span
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
        kernels = [(e.key, e.count, _device_us(e))
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = sorted((k for k in kernels if k[2] > 0), key=lambda k: -k[2])
        busy_ms = sum(k[2] for k in kernels) / 1e3 / STEP_COUNT
        attn_ms = sum(k[2] for k in kernels      # the kernels' shared body
                      if "decode_kernel" in k[0]) / 1e3 / STEP_COUNT
        out[label] = {
            "decode_span": span,
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
    out["decode_attention_ms_per_step"] = min(
        out[k]["decode_attention_ms_per_step"] for k in ("tuned", "default"))
    return out


def keys_per_row(sq: int, sk: int, causal: bool, window):
    """The number of keys each query row sees, as a numpy vector: row i
    sees keys [max(0, i - window + 1), min(i, Sk - 1)] (causal) or up to
    Sk - 1.  Its sum is the (query, key) pairs the mask keeps."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, np.int64)
    return np.maximum(0, hi - lo + 1)


def _sdpa(torch, q, k, v, *, causal, window, scale):
    """PyTorch SDPA on the same (B, S, H, dh) inputs, heads moved to axis 1
    as views, GQA by ``enable_gqa``; a boolean mask for a window.  The
    math backend is excluded (it would materialise the logits).  Where no
    other backend takes ``enable_gqa`` for the inputs (f32), K and V are
    repeated to Hq heads before the timed call, and the note says so.
    Returns (call, note): call is None, and note the reason, when no
    backend takes the shape."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.attention import ref
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = {"scale": scale}
    if window is None:
        kw["is_causal"] = causal
    else:
        dev = q.device
        kw["attn_mask"] = ref.mask(torch.arange(q.shape[1], device=dev),
                                   torch.arange(k.shape[1], device=dev),
                                   causal=causal, window=window)
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    g = q.shape[2] // k.shape[2]
    errors = []
    for gqa in (True, False):
        if gqa:
            kk, vv, note = kt, vt, None
        else:
            kk, vv = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
            note = ("K/V repeated to Hq heads before the timed call: no "
                    "SDPA backend but math takes enable_gqa here")

        def call(kk=kk, vv=vv, gqa=gqa):
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(qt, kk, vv,
                                                      enable_gqa=gqa, **kw)
        try:
            call()
            torch.cuda.synchronize()
            return call, note
        except RuntimeError as e:        # no backend for this shape
            errors.append(str(e)[:200])
    return None, "none: no SDPA backend but math takes it: " + " | ".join(
        errors)


def flash_case(torch, flash, ref, cost_model, flush, *, name, b, sq, sk, hq,
               hkv, dh, causal, window, dtype, seed=0):
    """One shape of the flash kernel: its error against `attention_ref`,
    times and bound.  The 32k cases time fewer calls: the plain version
    takes seconds there."""
    dev = torch.device("cuda")
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, hq, dh), generator=gen, device=dev).to(dt)
    k = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dt)
    v = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dt)
    scale = dh ** -0.5

    def kernel():
        return flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                     window=window)

    def plain():
        return ref.attention_ref(q, k, v, scale=scale, causal=causal,
                                 window=window)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err, err_over_tol = row_errors(torch, out, want, dt == torch.float32)
    del want
    per_row = keys_per_row(sq, sk, causal, window)
    empty = torch.from_numpy(per_row == 0).to(dev)
    zeros_ok = not bool(out[:, empty].any())
    long = sq * sk > 2 ** 26
    ms = median_ms(torch, kernel, 5 if long else 21, flush)
    plain_ms = median_ms(torch, plain, 3 if long else 5, flush)
    library, note = _sdpa(torch, q, k, v, causal=causal, window=window,
                          scale=scale)
    library_ms = (median_ms(torch, library, 5 if long else 11, flush)
                  if library else None)
    del library
    pairs = int(per_row.sum())
    ops = 4 * dh * hq * b * pairs        # q.k and p.v multiply-adds
    nbytes = ((q.numel() + k.numel() + v.numel() + out.numel())
              * q.element_size())
    t_ops = ops / PEAK_OPS_PER_S["bfloat16" if dtype == "bf16"
                                 else "float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    design = flash.design(dt, dh)
    active, dense = cost_model.attention_active_block_pairs(
        sq, sk, *flash.TILES[design], causal=causal, window=window)
    res = {"kernel": "flash_attention", "name": name, "batch": b, "sq": sq,
           "sk": sk, "hq": hq, "hkv": hkv, "dh": dh, "causal": causal,
           "window": window, "dtype": dtype,
           "design": DESIGNS["flash_attention"][design],
           "tile": list(flash.TILES[design]), "max_abs_err": err,
           "tolerance": ("1e-4" if dtype == "f32"
                         else "2^-7 x the row's max |ref|"),
           "max_err_over_tol": err_over_tol,
           "empty_rows": int((per_row == 0).sum()),
           "zero_rows_ok": zeros_ok, "ok": err_over_tol <= 1 and zeros_ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": ops, "pairs": pairs,
           "tiles_walked": active * b * hq, "tiles_dense": dense * b * hq,
           "tflops": ops / ms / 1e9}
    if note:
        res["library"] = note
    return res


def _by_kernel(torch, prof):
    kernels = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted((k for k in kernels if k[2] > 0), key=lambda k: -k[2])


def prefill_phase(torch, shapes, steps, transformer, mods, cfg, params,
                  seed=3):
    """`make_prefill_step` on 1 x ``prefill_32k`` tokens at full width:
    a warm-up forward (its last logits must be finite), ``PREFILL_TIMED``
    untraced steps on the host clock with every launch count set to 0 just
    before them, then one step traced by `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    shape = shapes.SHAPES["prefill_32k"]
    runs, why = shapes.applicable(cfg, shape)
    check(runs, f"{cfg.name} does not run prefill_32k: {why}")
    dev = torch.device("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, shape.seq_len), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
    batch = {"tokens": tokens}
    step = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    logits, _ = transformer.forward(cfg, params, batch, last_only=True)
    first = logits[:, -1].argmax(-1).to(torch.int32)
    finite = bool(torch.isfinite(logits).all())
    del logits
    torch.cuda.synchronize()
    reset_launch_counts(mods)
    host_ms, nxt = [], None
    for _ in range(PREFILL_TIMED):
        t0 = time.perf_counter()
        nxt = step(params, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    kernels = _by_kernel(torch, prof)
    device_ms = sum(k[2] for k in kernels) / 1e3
    flash_ms = sum(k[2] for k in kernels if "flash_" in k[0]) / 1e3
    matmul_ms = sum(k[2] for k in kernels
                    if any(m in k[0] for m in MATMUL_MARKS)) / 1e3
    launches = counts.pop("flash_attention")
    median = sorted(host_ms)[len(host_ms) // 2]
    tok = nxt.tolist()
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "shape": shape.name, "batch": 1, "seq_len": shape.seq_len,
           "reduced": {"global_batch": [shape.global_batch, 1]},
           "host_ms": host_ms, "host_median_ms": median,
           "prompt_tok_per_s": shape.seq_len / (median / 1e3),
           "flash_launches": launches,
           "flash_launches_per_forward": launches / PREFILL_TIMED,
           "other_kernel_launches": counts,
           "peak_memory_gb": round(peak / 1e9, 3),
           "next_token": tok, "warmup_token": first.tolist(),
           "logits_finite": finite,
           "device_time_measured": bool(kernels),
           "device_ms": device_ms, "flash_ms": flash_ms,
           "matmul_ms": matmul_ms,
           "flash_share": flash_ms / device_ms if device_ms else None,
           "matmul_share": matmul_ms / device_ms if device_ms else None,
           "device_busy_share": device_ms / median,
           "top_kernels": [{"name": n[:120], "calls": c, "ms": us / 1e3}
                           for n, c, us in kernels[:TOP_KERNELS]]}
    res["ok"] = (finite and launches == PREFILL_TIMED * cfg.num_layers
                 and not any(counts.values())
                 and all(0 <= t < cfg.vocab_size for t in tok))
    return res


def prefill_vs_forward(torch, steps, transformer, mods, cfg, params, seq_len,
                       seed=4, inputs=None):
    """The prefill path (flash kernel) against the full forward
    (`attention_core`) on one prompt, at full width and depth, in f32 and
    in bf16 compute.

    f32 separates the two paths from rounding: their last-position logits
    must agree within 1e-4 of the largest |logit|, the CPU parity
    tolerance.  In bf16 each path rounds differently, and over 40 layers
    two bf16 evaluations drift apart by more than queue C's bound of 3e-2
    of the largest |logit| (set on 2-layer SMOKE configs): the full
    forward itself lands about 5e-2 from the f32 logits.  So in bf16 the
    prefill path must be no farther from the f32 logits than the full
    forward is, plus that bound, and its greedy token must equal the full
    forward's unless the latter's top-2 gap is below the bound.  The
    bf16-to-bf16 difference is reported beside the bound, and held to it
    on the first ``SHALLOW`` layers of the same weights.  Runs where
    ``params`` lie, on one seeded prompt of ``seq_len`` tokens or on
    ``inputs`` (a frontend's features, tokens too or not, a batch of
    sequences): every sequence's last logits and greedy token are
    compared, the bounds taken of the largest |logit| over the batch."""
    dev = params["embed"]["table"].device
    batch = inputs
    if batch is None:
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (1, seq_len), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed))}
    bf16, f32 = torch.bfloat16, torch.float32
    reset_launch_counts(mods)
    prefill, full = {}, {}
    for dt in (bf16, f32):
        lp, _ = transformer.forward(cfg, params, batch, last_only=True,
                                    compute_dtype=dt)
        prefill[dt] = lp[:, -1].float()
    tok_p = steps.make_prefill_step(cfg)(params, batch).reshape(-1).tolist()
    flash_launches = launch_counts(mods)["flash_attention"]
    for dt in (bf16, f32):
        lf, _ = transformer.forward(cfg, params, batch, compute_dtype=dt)
        full[dt] = lf[:, -1].float()
        del lf
    core_launches = launch_counts(mods)["flash_attention"] - flash_launches

    def dist(a, b):
        return float((a - b).abs().max())

    s_cfg, s_params = first_layers(cfg, params, SHALLOW)
    s_prefill = transformer.forward(s_cfg, s_params, batch,
                                    last_only=True)[0][:, -1].float()
    s_full = transformer.forward(s_cfg, s_params, batch)[0][:, -1].float()
    s_bound = BF16_LOGIT_REL * float(s_full.abs().max())

    f32_tol = 1e-4 * float(full[f32].abs().max())
    bound = BF16_LOGIT_REL * float(full[bf16].abs().max())
    top2 = full[bf16].topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    tok_f = full[bf16].argmax(-1).tolist()
    # a sequence's tokens may differ only where the forward's top-2 gap is
    # below the bound
    near = [p != f and g < bound for p, f, g in zip(tok_p, tok_f, gaps)]
    res = {"arch": cfg.name, "seq_len": seq_len,
           "window": cfg.sliding_window,
           "f32_max_abs_err": dist(prefill[f32], full[f32]),
           "f32_tolerance": f32_tol,
           "bf16_max_abs_err": dist(prefill[bf16], full[bf16]),
           "bf16_bound": bound,
           "bf16_prefill_vs_f32": dist(prefill[bf16], full[f32]),
           "bf16_forward_vs_f32": dist(full[bf16], full[f32]),
           "shallow_layers": s_cfg.num_layers,
           "shallow_bf16_max_abs_err": dist(s_prefill, s_full),
           "shallow_bf16_bound": s_bound,
           "sequences": len(tok_p),
           "token_prefill": tok_p, "token_forward": tok_f,
           "argmax_equal": tok_p == tok_f, "forward_top2_gap": gaps,
           "flash_launches_prefill": flash_launches,
           "flash_launches_forward": core_launches,
           "finite": all(bool(torch.isfinite(t).all())
                         for t in (*prefill.values(), *full.values()))}
    if tok_p != tok_f:
        res["note"] = ("argmax differs at a top-2 gap below the bound"
                       if any(near) else "argmax differs")
    res["ok"] = (res["finite"] and res["f32_max_abs_err"] <= f32_tol
                 and res["bf16_prefill_vs_f32"]
                 <= res["bf16_forward_vs_f32"] + bound
                 and res["shallow_bf16_max_abs_err"] <= s_bound
                 and all(p == f or n for p, f, n in zip(tok_p, tok_f, near))
                 and flash_launches == 3 * cfg.num_layers
                 and core_launches == 0)
    return res


def first_layers(cfg, params, n: int):
    """``cfg`` and ``params`` cut to their first ``n`` layers (at most all
    of them); the stacked leaves are sliced as views."""
    n = min(n, cfg.num_layers)

    def cut(tree):
        return ({k: cut(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[:n])
    return (dataclasses.replace(cfg, num_layers=n),
            {**params, "blocks": cut(params["blocks"])})


# --------------------------------------------------------------------------
# The other model families (ROADMAP A12): the ring buffer, MoE, RWKV6,
# the Jamba hybrid, the frame and patch frontends
# --------------------------------------------------------------------------

def _serve_argv(arch, prompt, gen, *extra):
    return ["--arch", arch, "--batch", "4", "--requests", "6",
            "--prompt-len", str(prompt), "--gen", str(gen), *extra]


# Danube's prompts pass its 4,096-token window: the server trims them to
# it, and every decode step overwrites the ring's oldest row.
DANUBE_ARGV = _serve_argv("h2o_danube_1_8b", 4200, 16, "--kv-dtype", "f32")
DANUBE_TF = (4100, 16)               # prompt tokens, forced tokens
# Phi-3.5-MoE at full width, 16 of its 32 layers (about 42 GB in bf16).
MOE_ARGV = _serve_argv("phi3_5_moe_42b", 600, 16, "--kv-dtype", "f32")
MOE_PAGED_ARGV = MOE_ARGV + ["--paged", "--page-size", "16"]
MOE_LAYERS = 16
MOE_TF_LAYERS, MOE_TF_TOKENS = 4, 64
# Qwen3-MoE-235B at full width (128 experts, top 8), 4 of its 94 layers.
QWEN3_MOE_ARGV = _serve_argv("qwen3_moe_235b", 128, 8)
QWEN3_MOE_LAYERS = 4
RWKV_ARGV = _serve_argv("rwkv6_7b", 128, 16)
RWKV_TF_TOKENS = 64
# Jamba at its SMOKE shapes: one period group of the full width holds 88
# GB of expert weights in bf16, more than one card.
JAMBA_ARGV = ["--arch", "jamba_1_5_large_398b", "--smoke", "--requests",
              "6"]
# The serve runs whose decode shapes `family_kernel_cases` holds B1 (B2
# where paged) to its plain version at.
FAMILY_DECODE = [MOE_ARGV, MOE_PAGED_ARGV, QWEN3_MOE_ARGV, JAMBA_ARGV]
# (phase, arch, frames, or (patches, tokens), batch)
FRONTEND_PHASES = [("prefill_hubert", "hubert_xlarge", (1000, None), 2),
                   ("prefill_internvl2", "internvl2_2b", (1024, 512), 1)]
TF_REL = 1e-4                        # f32 decode vs forward, of max |logit|


def _flag(argv, flag, default):
    """``flag``'s value in ``argv``, else the CLI's ``default``."""
    return argv[argv.index(flag) + 1] if flag in argv else default


def family_decode_shape(configs, argv):
    """``(Hq, Hkv, dh, lengths, rows)`` of the decode kernel in the serve
    run of ``argv``: the arch's heads, four slots spread over the decode
    lengths from prompt + 1 to prompt + gen, the run's cache rows."""
    arch = _flag(argv, "--arch", None)
    cfg = (configs.get_smoke if "--smoke" in argv else configs.get)(arch)
    prompt = int(_flag(argv, "--prompt-len", 16))
    gen = int(_flag(argv, "--gen", 12))
    lengths = [prompt + 1, prompt + gen // 2, prompt + 3 * gen // 4,
               prompt + gen]
    return (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, lengths,
            prompt + gen + 8)


def family_kernel_cases(torch, configs, mods, flush):
    """B1 at the decode shape of each family serve run that launches it
    (Phi-3.5-MoE: g 4; Qwen3-MoE: g 16; Jamba SMOKE: g 2, dh 16) and B2
    at Phi-3.5-MoE's paged one (pages of 16): bf16 q over an f32 and a
    bf16 cache, each held to its plain version at `row_errors`'
    tolerance, B2 also bitwise to B1 over the same rows."""
    decode = mods[0]
    cases = []
    for argv in FAMILY_DECODE:
        hq, hkv, dh, lengths, rows = family_decode_shape(configs, argv)
        name = (_flag(argv, "--arch", None)
                + ("_smoke" if "--smoke" in argv else "") + "_serve")
        for kv_dtype in (torch.float32, torch.bfloat16):
            if "--paged" in argv:
                cases.append(new_kernel_case(
                    torch, mods, flush, kernel="paged_decode_attention",
                    name=name + "_paged", lengths=lengths,
                    q_dtype=torch.bfloat16, kv_dtype=kv_dtype, rows=rows,
                    page_size=int(_flag(argv, "--page-size", 16)), hq=hq,
                    hkv=hkv, dh=dh))
            else:
                cases.append({"kernel": "decode_attention", **kernel_case(
                    torch, decode, flush, name=name, lengths=lengths,
                    q_dtype=torch.bfloat16, kv_dtype=kv_dtype,
                    cache_len=rows, hq=hq, hkv=hkv, dh=dh)})
    return cases


def cut_serve_run(torch, serve, mods, cfg, argv) -> dict:
    """A serving run of ``cfg`` (an arch cut in depth by
    `dataclasses.replace`) through `serve.Server` and `serve.serve_loop`,
    set up as the CLI sets up ``argv``: its seeded requests, batch, cache
    dtype, paging and device, the scheduler a paged pool runs under and a
    decode watchdog; every kernel's launch count set to 0 just before the
    loop and read just after.  Returns `cli_run`'s record with the server;
    the log is the serving-plan and summary lines the CLI would print."""
    import numpy as np
    from repro_torch.kernels import autotune
    from repro_torch.runtime import lifecycle, paging
    batch = int(_flag(argv, "--batch", 4))
    prompt = int(_flag(argv, "--prompt-len", 16))
    gen = int(_flag(argv, "--gen", 12))
    kv_dtype = serve.KV_DTYPES[_flag(argv, "--kv-dtype", "f32")]
    max_len = prompt + gen + 8
    spec = (paging.PageSpec.build(batch, max_len,
                                  int(_flag(argv, "--page-size", 16)))
            if "--paged" in argv else None)
    server = serve.Server(cfg, batch, max_len, kv_dtype=kv_dtype,
                          device=_flag(argv, "--device", "cuda"), paged=spec,
                          prefill_len=prompt)
    scheduler = (serve.Scheduler("fcfs", allocator=server.allocator)
                 if spec is not None else None)
    watchdog = serve.DecodeWatchdog(autotune.predict_decode_step_us(
        cfg, batch, cache_len=max_len, kv_dtype=kv_dtype,
        plans=server.kernel_plan, chip=serve._chip(server.device)))
    rng = np.random.default_rng(0)
    lc = lifecycle.Lifecycle()
    for rid in range(int(_flag(argv, "--requests", 6))):
        lc.submit(rid, rng.integers(0, cfg.vocab_size, size=prompt), gen)
    reset_launch_counts(mods)
    t0 = time.time()
    stats = serve.serve_loop(server, lc, watchdog=watchdog,
                             scheduler=scheduler)
    seconds = time.time() - t0
    counts = launch_counts(mods)
    summary = serve._summary(server, lc, stats, seconds, batch=batch,
                             batch_source="flag", watchdog=watchdog,
                             scheduler=scheduler)
    log = "".join(json.dumps(row) + "\n" for row in (
        {"serving_plan": {"batch": batch, "source": "flag"}}, summary))
    print(log, end="", flush=True)
    return {"rc": 0, "log": log, "seconds": seconds, "counts": counts,
            "requests": {rid: (r.state.value, list(r.tokens))
                         for rid, r in lc.requests.items()},
            "server": server}


def family_serve(torch, serve, configs, check_serve, mods, *, phase, argv,
                 kernel, depth=None, card=None) -> dict:
    """One serving run of another family, its launch counts set to 0 just
    before it and read just after: the CLI at the config's own depth, or
    with ``depth`` the config cut to its first ``depth`` layers
    (`cut_serve_run`).  Its log must pass ``check_serve.py`` with every
    request completed; ``kernel`` (the decode kernel its attention layers
    run, or None where decode stays on the plain path: the ring buffer,
    RWKV) must have launched once per attention layer per decode forward
    and no other kernel at all.  Returns the streams, the summary and the
    server's weights (for the checks that reuse them)."""
    arch = _flag(argv, "--arch", None)
    own = (configs.get_smoke if "--smoke" in argv else configs.get)(arch)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    if depth is None:
        run = cli_run(torch, serve, mods, argv, keep_server=True)
    else:
        run = cut_serve_run(torch, serve, mods,
                            dataclasses.replace(own, num_layers=depth), argv)
    server = run.pop("server")
    cfg = server.cfg
    attn = sum(1 for l in range(cfg.num_layers)
               if cfg.family != "ssm" and cfg.is_attn_layer(l))
    log, counts = run["log"], dict(run["counts"])
    summary = check_serve._json_lines(log)[-1]
    requests = int(_flag(argv, "--requests", 6))
    problems = check_serve.check(log, requests=requests)
    launches = counts.pop(kernel) if kernel else 0
    streams = {rid: toks for rid, (_, toks) in run["requests"].items()}
    out = {"argv": argv, "arch": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "attention_layers": attn,
           "depth_cut": None if depth is None else [own.num_layers, depth],
           "driven_by": "cli" if depth is None else "Server, serve_loop",
           "rc": run["rc"], "host_wall_s": round(run["seconds"], 3),
           "card": card, "batch": summary.get("batch"),
           "cache_rows": (int(server.cache["blocks"]["k"].shape[2])
                          if "k" in server.cache["blocks"] else None),
           "decode_forwards": summary.get("decode_forwards"),
           "kernel": kernel, "kernel_launches": launches,
           "other_kernel_launches": counts,
           "tok_per_s": summary.get("tok_per_s"),
           "per_token_ms": summary.get("per_token_ms"),
           "ttft_ms": summary.get("ttft_ms"),
           "outcomes": summary.get("outcomes"),
           "check_serve_problems": problems,
           "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                   3) if torch.cuda.is_available() else None}
    emit(phase, **out)
    check(run["rc"] == 0 and not problems, f"{phase} run failed: {problems}")
    check(summary["outcomes"]["completed"] == requests,
          f"{phase}: not every request completed: {summary['outcomes']}")
    check(summary["decode_forwards"] > 0
          and launches == summary["decode_forwards"] * (attn if kernel
                                                        else 0),
          f"{phase}: {launches} {kernel} launches for "
          f"{summary['decode_forwards']} decode forwards x {attn} "
          f"attention layers")
    check(not any(counts.values()),
          f"{phase}: other kernels launched: {counts}")
    params = server.params
    server.cache = None
    del server, run
    return {**out, "streams": streams, "params": params, "cfg": cfg,
            "summary": summary}


def decode_vs_forward(torch, transformer, cfg, params, *, tokens, prefill=0,
                      seed=6, device="cuda") -> dict:
    """One sequence of ``tokens`` tokens through an f32 cache in f32
    compute: the first ``prefill`` in one cached forward (none: every
    token alone), then one token a step, each step's logits against the
    cache-free forward's at that position (f32, TF32 off): within
    ``TF_REL`` of the largest |logit|.  For a sliding-window model the
    cache is the ring of ``window`` rows, so the steps past the window
    overwrite its oldest rows; the attention of a causal model without a
    window runs the decode kernel."""
    dev = torch.device(device)
    toks = torch.randint(0, cfg.vocab_size, (1, tokens), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))
    f32 = torch.float32
    full, _ = transformer.forward(cfg, params, {"tokens": toks},
                                  compute_dtype=f32)
    cache = transformer.cache_init(cfg, 1, tokens, dtype=f32, device=dev)
    steps = []
    if prefill:
        lg, cache = transformer.forward(cfg, params,
                                        {"tokens": toks[:, :prefill]},
                                        cache=cache, compute_dtype=f32)
        steps.append(lg[:, -1])
    for t in range(prefill, tokens):
        lg, cache = transformer.forward(cfg, params,
                                        {"tokens": toks[:, t:t + 1]},
                                        cache=cache, compute_dtype=f32)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, 1)
    ref = full[:, max(prefill - 1, 0):]
    err = float((dec - ref).abs().max())
    tol = TF_REL * float(ref.abs().max())
    rows = (int(cache["blocks"]["k"].shape[2])
            if "k" in cache["blocks"] else None)
    finite = bool(torch.isfinite(dec).all())
    return {"arch": cfg.name, "layers": cfg.num_layers, "tokens": tokens,
            "prefill": prefill, "steps": tokens - prefill,
            "window": cfg.sliding_window, "cache_rows": rows,
            "max_abs_err": err, "tolerance": tol, "finite": finite,
            "ok": finite and err <= tol}


def moe_paged_vs_contiguous(torch, serve, lifecycle, cfg, params, argv,
                            paged_streams) -> dict:
    """The paged CLI run's streams against a contiguous server with its
    weights at the kernels' default span, as the paged run decodes: the
    same requests (the CLI's seeded prompts), batch and admission, so the
    streams must be equal."""
    import numpy as np
    prompt = int(argv[argv.index("--prompt-len") + 1])
    gen = int(argv[argv.index("--gen") + 1])
    n = int(argv[argv.index("--requests") + 1])
    server = serve.Server(cfg, 4, prompt + gen + 8, params=params,
                          autotune_kernels=False,
                          device=params["embed"]["table"].device)
    rng = np.random.default_rng(0)
    lc = lifecycle.Lifecycle()
    for rid in range(n):
        lc.submit(rid, rng.integers(0, cfg.vocab_size, size=prompt), gen)
    serve.serve_loop(server, lc)
    streams = {rid: list(r.tokens) for rid, r in lc.requests.items()}
    server.cache = None
    equal = streams == paged_streams
    return {"requests": n, "tokens": sum(len(t) for t in streams.values()),
            "equal": equal, "ok": equal}


def jamba_chaos(torch, serve, configs, check_serve, mods, *, phase, argv,
                layers, clean=None) -> dict:
    """`chaos_phase` on the Jamba SMOKE model; then, on a fresh server of
    that run's batch, `Server.corrupt_kv` (the ``kv_corrupt`` hook) on
    each slot a ``kv_corrupt`` of the run hit must leave that slot's Mamba
    conv tails and states NaN and every other slot's finite."""
    out = chaos_phase(torch, serve, check_serve, mods, phase=phase,
                      argv=argv, kernel="decode_attention", layers=layers,
                      clean=clean)
    cfg = configs.get_smoke(_flag(argv, "--arch", None))
    server = serve.Server(cfg, out["batch"], 8, autotune_kernels=False,
                          device=_flag(argv, "--device", "cuda"))
    mamba = [a for grp in server.cache["blocks"].values() if "h" in grp
             for a in grp.values()]
    seen = []
    for slot in sorted({e["slot"] for e in out["fired"]
                        if e["kind"] == "kv_corrupt"}):
        server.corrupt_kv(slot)
        others = [s for s in range(server.batch) if s != slot]
        seen.append({"slot": slot, "mamba_leaves": len(mamba),
                     "poisoned": all(bool(torch.isnan(a[:, slot]).all())
                                     for a in mamba),
                     "others_finite": all(bool(torch.isfinite(
                         a[:, others]).all()) for a in mamba)})
        server.release_slot(slot)
    emit(phase + "_mamba", kv_corrupt=seen)
    check(bool(seen) and all(s["poisoned"] and s["others_finite"]
                             and s["mamba_leaves"] > 0 for s in seen),
          f"{phase}: kv_corrupt did not poison exactly the slot's Mamba "
          f"state: {seen}")
    return {**out, "kv_corrupt": seen}


def frontend_inputs(torch, cfg, frames_or_patches, tokens, batch, device,
                    seed=7) -> dict:
    """Seeded features of the frontend's width (frames for HuBERT;
    patches ahead of text tokens for InternVL2), in bf16."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = "frames" if cfg.frontend == "frame" else "patches"
    inputs = {key: torch.randn((batch, frames_or_patches, cfg.frontend_dim),
                               generator=gen, device=dev).bfloat16()}
    if tokens:
        inputs["tokens"] = torch.randint(0, cfg.vocab_size, (batch, tokens),
                                         generator=gen, device=dev)
    return inputs


def frontend_prefill(torch, steps, transformer, mods, cfg, params, inputs,
                     *, card=None) -> dict:
    """`make_prefill_step` on frontend features at full width: host ms of
    ``PREFILL_TIMED`` steps after a warm-up, with the launch counts set to
    0 just before them (the flash kernel once per layer a forward, causal
    or not as the model is, and nothing else), then `prefill_vs_forward`'s
    gates on the same inputs."""
    step = steps.make_prefill_step(cfg)
    step(params, inputs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    reset_launch_counts(mods)
    host_ms = []
    for _ in range(PREFILL_TIMED):
        t0 = time.perf_counter()
        nxt = step(params, inputs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts(mods)
    launches = counts.pop("flash_attention")
    n = sum(v.shape[1] for v in inputs.values())
    b = next(iter(inputs.values())).shape[0]
    median = sorted(host_ms)[len(host_ms) // 2]
    pvf = prefill_vs_forward(torch, steps, transformer, mods, cfg, params,
                             n, inputs=inputs)
    res = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
           "inputs": {k: list(v.shape) for k, v in inputs.items()},
           "causal": cfg.causal, "head_dim": cfg.head_dim, "card": card,
           "flash_design": mods[3].design(torch.bfloat16, cfg.head_dim),
           "host_ms": host_ms, "host_median_ms": median,
           "prompt_tok_per_s": b * n / (median / 1e3),
           "flash_launches": launches, "other_kernel_launches": counts,
           "next_token": nxt.tolist(), "vs_forward": pvf}
    res["ok"] = (pvf["ok"] and launches == PREFILL_TIMED * cfg.num_layers
                 and not any(counts.values()))
    return res


def family_phases(torch, serve, configs, check_serve, steps, transformer,
                  lifecycle, mods, card) -> dict:
    """The phases of the other families; returns each kernel's launches
    by phase."""
    launches = {}
    res = family_serve(torch, serve, configs, check_serve, mods,
                       phase="serve_danube_ring", argv=DANUBE_ARGV,
                       kernel=None, card=card)
    window = res["cfg"].sliding_window
    check(res["cache_rows"] == window,
          f"serve_danube_ring: a cache of {res['cache_rows']} rows, not the "
          f"window's {window}")
    prompt, forced = DANUBE_TF
    tf = decode_vs_forward(torch, transformer, res["cfg"], res["params"],
                           tokens=prompt + forced, prefill=window)
    emit("danube_ring_vs_teacher_forcing", card=card, **tf)
    check(tf["ok"] and tf["cache_rows"] == window,
          f"ring decode != teacher forcing: {tf}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    moe = family_serve(torch, serve, configs, check_serve, mods,
                       phase="serve_moe", argv=MOE_ARGV,
                       kernel="decode_attention", depth=MOE_LAYERS, card=card)
    launches["serve_moe"] = moe["kernel_launches"]
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    moe = family_serve(torch, serve, configs, check_serve, mods,
                       phase="serve_moe_paged", argv=MOE_PAGED_ARGV,
                       kernel="paged_decode_attention", depth=MOE_LAYERS,
                       card=card)
    launches["serve_moe_paged"] = moe["kernel_launches"]
    pvc = moe_paged_vs_contiguous(torch, serve, lifecycle, moe["cfg"],
                                  moe["params"], MOE_PAGED_ARGV,
                                  moe["streams"])
    emit("moe_paged_vs_contiguous", card=card, **pvc)
    check(pvc["ok"], f"MoE paged and contiguous streams differ: {pvc}")
    del moe
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(configs.get("phi3_5_moe_42b"),
                              num_layers=MOE_TF_LAYERS,
                              capacity_factor=64.0)
    params = transformer.init(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), dtype=torch.bfloat16)
    tf = decode_vs_forward(torch, transformer, cfg, params,
                           tokens=MOE_TF_TOKENS)
    emit("moe_vs_teacher_forcing", card=card,
         capacity_factor=cfg.capacity_factor, **tf)
    check(tf["ok"], f"MoE decode != teacher forcing: {tf}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    runs = []
    for i in range(2):
        run = family_serve(torch, serve, configs, check_serve, mods,
                           phase="serve_qwen3_moe", argv=QWEN3_MOE_ARGV,
                           kernel="decode_attention",
                           depth=QWEN3_MOE_LAYERS, card=card)
        runs.append(run["streams"])
        launches.setdefault("serve_qwen3_moe", run["kernel_launches"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
    emit("serve_qwen3_moe_repeat", card=card, streams_equal=runs[0] == runs[1],
         tokens=sum(len(t) for t in runs[0].values()))
    check(runs[0] == runs[1], "Qwen3-MoE: two runs gave different streams")

    res = family_serve(torch, serve, configs, check_serve, mods,
                       phase="serve_rwkv", argv=RWKV_ARGV, kernel=None,
                       card=card)
    tf = decode_vs_forward(torch, transformer, res["cfg"], res["params"],
                           tokens=RWKV_TF_TOKENS)
    emit("rwkv_vs_teacher_forcing", card=card, **tf)
    check(tf["ok"], f"RWKV decode != teacher forcing: {tf}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    res = family_serve(torch, serve, configs, check_serve, mods,
                       phase="serve_jamba_smoke", argv=JAMBA_ARGV,
                       kernel="decode_attention", card=card)
    launches["serve_jamba_smoke"] = res["kernel_launches"]
    attn = res["attention_layers"]
    clean = {rid: ("completed", toks) for rid, toks in res["streams"].items()}
    del res
    out = jamba_chaos(torch, serve, configs, check_serve, mods,
                      phase="serve_chaos_jamba_smoke",
                      argv=JAMBA_ARGV + CHAOS_FLAGS, layers=attn, clean=clean)
    launches["serve_chaos_jamba_smoke"] = out["kernel_launches"]

    flash = {}
    for phase, arch, (feats, toks), batch in FRONTEND_PHASES:
        cfg = configs.get(arch)
        params = transformer.init(cfg, torch.Generator(device="cuda")
                                  .manual_seed(0), dtype=torch.bfloat16)
        inputs = frontend_inputs(torch, cfg, feats, toks, batch, "cuda")
        res = frontend_prefill(torch, steps, transformer, mods, cfg, params,
                               inputs, card=card)
        emit(phase, **res)
        check(res["ok"], f"{phase} failed: {res}")
        flash[phase] = res["flash_launches"]
        del params, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return {"decode_attention": {k: launches[k] for k in (
                "serve_moe", "serve_qwen3_moe", "serve_jamba_smoke",
                "serve_chaos_jamba_smoke")},
            "paged_decode_attention": {"serve_moe_paged":
                                       launches["serve_moe_paged"]},
            "flash_attention": flash}


# --------------------------------------------------------------------------
# The paper's slice: blocked matmul (B6), ELL SpMV (B7, B8), Tables I, II
# --------------------------------------------------------------------------

# matmul_cases: (name, m, n, k, dtype, activation, with bias)
MATMUL_CASES = (
    [(f"table1_{m}x{n}x{k}", m, n, k, "bf16", None, False)
     for m, n, k in [(4096, 4096, 4096), (8192, 8192, 8192),
                     (16384, 16384, 16384), (8192, 2048, 8192)]]
    + [("f32_4096", 4096, 4096, 4096, "f32", None, False),
       ("ragged_130x70x50", 130, 70, 50, "bf16", "gelu", True),
       ("ragged_4000x3000x1000", 4000, 3000, 1000, "bf16", "gelu", True),
       ("ragged_130x70x50_f32", 130, 70, 50, "f32", "gelu", True),
       ("row_1x128x256", 1, 128, 256, "bf16", None, False)]
    + [(f"epilogue_{act}_4096", 4096, 4096, 4096, "bf16", act, True)
       for act in ("relu", "gelu", "silu", "tanh")])
MATMUL_MAIN = "table1_8192x8192x8192"     # the kernels line's B6 case
TABLE1_MEASURE_K = 8                      # of the model's top tiles, timed
SPMV_MEASURE_K = 3                        # as many as `autotune.tune` times
SPMV_MAIN = {"ell_spmv": "spmv_1m_narrow", "ell_spmv_blocked": "spmv_1m_wide"}
# spmv_1m_banded: (rows = columns, nonzeros a row, half band), seed
BANDED = (1_048_576, (1, 96), 128)
BANDED_SEED = 5


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time of a call on one H100: the larger of its bytes over
    the memory rate and its operations over the peak for ``dtype``
    ("bfloat16" or "float32"), and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def matmul_bound(m: int, n: int, k: int, in_bytes: int, out_bytes: int,
                 bias: bool) -> tuple[float, float, float, str]:
    """(bytes, operations, bound ms, bound by) of act(A @ B + bias): A and
    B read once, C written once, the f32 bias read once; 2mnk operations
    at the tensor cores' bf16 rate (2-byte operands) or the CUDA cores'
    f32 rate."""
    nbytes = (m * k + k * n) * in_bytes + m * n * out_bytes + 4 * n * bias
    ops = 2.0 * m * n * k
    ms, by = bound_ms(nbytes, ops, "bfloat16" if in_bytes == 2
                      else "float32")
    return nbytes, ops, ms, by


def spmv_bound(m: int, n: int, nnz: int, rows: int, width: int
               ) -> tuple[float, float, float, str, float]:
    """(bytes, operations, bound ms, bound by, padded bytes) of y = A @ x
    for an (m, n) matrix of ``nnz`` nonzeros: the bytes the function needs
    are each nonzero's int32 column and f32 value, x and y once; 2
    operations a nonzero at the f32 rate.  The padded bytes are what a
    walk of the whole (rows, width) ELL reads (the bound of earlier
    runs)."""
    nbytes = nnz * 8 + n * 4 + m * 4
    ops = 2.0 * nnz
    ms, by = bound_ms(nbytes, ops, "float32")
    return nbytes, ops, ms, by, rows * width * 8 + n * 4 + rows * 4


def matmul_case(torch, mm_ops, mm_ref, flush, *, name, m, n, k, dtype,
                activation, with_bias, tile, seed=0):
    """One shape of B6 with ``tile`` against `matmul_ref` on the card,
    within `ref.row_tolerance`; the design that ran
    (`kernel.design`), its time, the plain version's, cuBLAS's
    (`torch.matmul` in the same dtype, TF32 off, without the epilogue)
    and the bound.  Runs where ``flush`` lies."""
    dev = flush.device
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=dev).to(dt)
    b = torch.randn((k, n), generator=gen, device=dev).to(dt)
    bias = (torch.randn((1, n), generator=gen, device=dev) if with_bias
            else None)

    def kernel():
        return mm_ops.matmul(a, b, tile=tile, bias=bias,
                             activation=activation)

    def plain():
        return mm_ref.matmul_ref(a, b, bias=bias, activation=activation)

    design = mm_ops.kernel.design(a, b, tile)
    before = dict(mm_ops.kernel.design_launches)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    ran = {d: v - before[d] for d, v in mm_ops.kernel.design_launches.items()
           if v != before[d]}
    err = (out.float() - want.float()).abs()
    ratio = float((err / mm_ref.row_tolerance(want, out.dtype))
                  .nan_to_num(0.0).max())
    finite = bool(torch.isfinite(out).all())
    del out, want
    big = m * n * k >= 8192 ** 3
    reps = 5 if big else 11
    ms = median_ms(torch, kernel, reps, flush)
    plain_ms = median_ms(torch, plain, 3 if big else 5, flush)
    library_ms = median_ms(torch, lambda: torch.matmul(a, b), reps, flush)
    nbytes, ops, b_ms, by = matmul_bound(m, n, k, a.element_size(),
                                         a.element_size(), with_bias)
    return {"kernel": "blocked_matmul", "name": name, "m": m, "n": n, "k": k,
            "dtype": dtype, "activation": activation, "bias": with_bias,
            "design": design, "launched": ran,
            "tile": [tile.y, tile.x, tile.z], "max_abs_err": float(err.max()),
            "tolerance": ("1e-5" if dtype == "f32" else "2^-7")
            + " x the row's max |ref|",
            "max_err_over_tol": ratio, "finite": finite,
            "ok": ratio <= 1 and finite and ran == {design: 1},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.matmul (cuBLAS), no epilogue",
            "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
            "operations": ops, "tflops": ops / ms / 1e9,
            "library_tflops": ops / library_ms / 1e9}


def spmv_matrix(torch, table2, ops, name, dev):
    """CSR arrays of a Table-II or a large matrix, its ELL packing under
    the sorted law on ``dev``, x from a seed, and the CSR arrays there
    with each row's columns sorted (the same matrix, in the order a
    `torch.sparse_csr_tensor` requires)."""
    import numpy as np
    if name == "spmv_1m_banded":
        rows, (lo, hi), half = BANDED
        indptr, indices, data, shape = table2.synthesize_banded(
            rows, rows, lo, hi, half, seed=BANDED_SEED)
    else:
        indptr, indices, data, shape = table2.build(name)
    mat = ops.pack_csr(indptr, indices, data, shape, scheme="sorted",
                       device=dev)
    rows = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(indptr))
    order = np.argsort(rows * shape[1] + indices, kind="stable")
    indices, data = indices[order], data[order]
    del rows, order
    x = torch.randn(shape[1], generator=torch.Generator(device=dev)
                    .manual_seed(7), device=dev)
    csr = (torch.from_numpy(indptr.astype("int32")).to(dev),
           torch.from_numpy(indices).to(dev),
           torch.from_numpy(data).to(dev))
    return mat, x, csr


def spmv_case(torch, autotune, sp_ops, sp_kernel, sp_ref, spec, flush,
              cache, *, name, mat, x, csr, kernel):
    """One matrix through B7 (``ell_spmv``) or B8 (``ell_spmv_blocked``)
    at the configuration the main path runs: the tuner's plan on the card
    (`autotune.tune`, as `table2_spmv.tuned_records` calls it) when the
    plan is this kernel's, else the fastest on the card of this kernel's
    top configurations by the model, as many as the tuner times.  B7 runs
    with the row lengths, as `ops.spmv` calls it.  Held against
    `spmv_ell_ref` (B7 also with the row lengths, B8 also against its slab
    walk) within `ref.row_tolerance`, and, in the original row order,
    against `spmv_csr_ref`; its time, the plain version's, cuSPARSE's (a
    `torch.sparse_csr_tensor` of the same CSR times x) and the bound.  For
    B7 also every block_rows that launches differently
    (`kernel.distinct_block_rows`) timed, where there are several, so the
    tuner's pick can be held against the card's fastest."""
    rows, width = mat.cols.shape
    m, n = mat.shape
    blocked = kernel == "ell_spmv_blocked"
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tuned = autotune.tune("spmv", {"mat": mat}, device="cuda", cache=cache)
    if (tuned.knobs["block_cols"] is not None) == blocked:
        br, bc = tuned.knobs["block_rows"], tuned.knobs["block_cols"]
        picked = "the tuner's plan"
    else:
        ranked = [r for r in spec.rank_configs(mat)
                  if (r[2] is not None) == blocked]
        if not blocked:
            launched = sp_kernel.distinct_block_rows(
                rows, width, n, sms, [r[1] for r in ranked])
            ranked = [r for r in ranked if r[1] in launched]
        ranked = ranked[:SPMV_MEASURE_K]
        if not ranked:
            return {"kernel": kernel, "name": name, "ok": False,
                    "why": "no configuration of this kernel fits"}
        timed = [(autotune.measure(
            lambda br=br, bc=bc: sp_ops.packed_spmv(mat, x, block_rows=br,
                                                    block_cols=bc), "cuda"),
                  br, bc)
            for _, br, bc, _ in ranked]
        _, br, bc = min(timed)
        picked = (f"the fastest of this kernel's top {len(ranked)} "
                  "by the model (the tuner's plan is the other kernel's)")
    if blocked:
        def run():
            return sp_kernel.ell_spmv_blocked(x, mat.cols, mat.vals,
                                              block_rows=br, block_cols=bc)

        def plain():
            return sp_ref.spmv_blocked_ref(mat.cols, mat.vals, x, bc)
    else:
        def run(br=br):
            return sp_kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=br,
                                      row_lens=mat.lens)

        def plain():
            return sp_ref.spmv_ell_ref(mat.cols, mat.vals, x, mat.lens)
    y = run()
    tol = sp_ref.row_tolerance(mat.cols, mat.vals, x)
    checks = {"ell_ref": sp_ref.spmv_ell_ref(mat.cols, mat.vals, x)}
    if blocked:
        checks["slab_walk_ref"] = plain()
    else:
        checks["ell_ref_row_lens"] = plain()
    ratios = {k: float(((y - v).abs() / tol).nan_to_num(0.0).max())
              for k, v in checks.items()}
    errs = {k: float((y - v).abs().max()) for k, v in checks.items()}
    indptr, indices, data = csr
    y_orig = torch.empty(m, device=x.device)
    y_orig[mat.perm_index] = y[:m]
    tol_orig = torch.empty(m, device=x.device)
    tol_orig[mat.perm_index] = tol[:m]
    want = sp_ref.spmv_csr_ref(indptr, indices, data, x, m)
    ratios["csr_ref"] = float(((y_orig - want).abs() / tol_orig)
                              .nan_to_num(0.0).max())
    errs["csr_ref"] = float((y_orig - want).abs().max())
    del checks, want, y_orig, tol_orig
    a_csr = torch.sparse_csr_tensor(indptr, indices, data, size=(m, n),
                                    check_invariants=True)
    big = rows * width > 2 ** 24
    ms = median_ms(torch, run, 11 if big else 21, flush)
    sweep = None
    distinct = ([] if blocked else
                sp_kernel.distinct_block_rows(rows, width, n, sms))
    if len(distinct) > 1:
        sweep = {r: median_ms(torch, lambda r=r: run(r), 11, flush)
                 for r in distinct}
    plain_ms = median_ms(torch, plain, 3 if big else 5, flush)
    library_ms = median_ms(torch, lambda: a_csr @ x, 11 if big else 21,
                           flush)
    del a_csr
    nbytes, ops, b_ms, by, padded = spmv_bound(m, n, mat.nnz, rows, width)
    plan = (sp_kernel.slab_plan(mat.cols, mat.vals, n, br, bc) if blocked
            else None)
    return {"kernel": kernel, "name": name, "rows": m, "n": n,
            "nnz": mat.nnz, "width": width, "block_rows": br,
            "block_cols": bc, "configuration": picked,
            "design": DESIGNS[kernel], "slab_plan": plan,
            "tuned_plan": tuned.knobs, "slabs": -(-n // bc) if bc else None,
            "block_rows_ms": sweep,
            "fastest_block_rows": sweep and min(sweep, key=sweep.get),
            "ms_over_fastest": sweep and ms / min(sweep.values()),
            "max_abs_err": max(errs.values()), "errors": errs,
            "tolerance": "1e-5 x the row's sum of |products|",
            "max_err_over_tol": max(ratios.values()),
            "err_over_tol": ratios,
            "ok": max(ratios.values()) <= 1,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.sparse_csr_tensor @ x (cuSPARSE)",
            "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
            "padded_bytes": padded, "operations": ops,
            "gb_per_s": nbytes / ms / 1e6}


def spmv_cases(torch, table2, ops, autotune, sp_kernel, sp_ref, spec,
               flush):
    """B7 on the four Table-II matrices and on ``spmv_1m_narrow``, B8 on
    ``spmv_1m_narrow``, ``spmv_1m_wide`` and ``spmv_1m_banded`` (x of 4 MB
    fits no block's shared memory, so B7 cannot take the last two)."""
    plan = [(name, ("ell_spmv",)) for name in table2.MATRICES]
    plan += [("spmv_1m_narrow", ("ell_spmv", "ell_spmv_blocked")),
             ("spmv_1m_wide", ("ell_spmv_blocked",)),
             ("spmv_1m_banded", ("ell_spmv_blocked",))]
    import tempfile
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.TuneCache(pathlib.Path(tmp) / "autotune.json")
        for name, kernels in plan:
            mat, x, csr = spmv_matrix(torch, table2, ops, name, flush.device)
            for kernel in kernels:
                cases.append(spmv_case(torch, autotune, ops, sp_kernel,
                                       sp_ref, spec, flush, cache, name=name,
                                       mat=mat, x=x, csr=csr, kernel=kernel))
            del mat, x, csr
            gc.collect()
            torch.cuda.empty_cache()
    return cases


def tile_sweep(torch, shape=(8192, 8192, 8192), reps: int = 5
               ) -> list[dict]:
    """B6 at ``shape`` in bf16 with every built tile beside its rank and
    time under the model (`spec.rank_tiles`), fastest first: whether the
    model's order is the card's (D5).  Each tile's time is the median of
    ``reps`` calls timed as `median_ms` times them (L2 evicted, a spin
    before each), the tiles taken in turn within each round so that a
    drift of the card's clock falls on all of them alike."""
    from repro_torch.benchmarks import table1_matmul as table1
    from repro_torch.core import tiling
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import spec as mm_spec
    m, n, k = shape
    ranked = mm_spec.rank_tiles(m, n, k, top=len(tiling.HOPPER_TILES) + 1)
    rank = {c.detail["tile"]: (i + 1, c.score) for i, c in enumerate(ranked)}
    a, b = table1._operands(m, n, k, torch.bfloat16, torch.device("cuda"))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    times = {t: [] for t in tiling.HOPPER_TILES}
    for t in times:
        mm_ops.matmul(a, b, tile=t)
    torch.cuda.synchronize()
    for _ in range(reps):
        for t in times:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            flush.zero_()
            torch.cuda._sleep(4_000_000)
            start.record()
            mm_ops.matmul(a, b, tile=t)
            end.record()
            torch.cuda.synchronize()
            times[t].append(start.elapsed_time(end))
    rows = []
    for t, ms in times.items():
        ms = sorted(ms)[reps // 2]
        rows.append({"tile": [t.y, t.x, t.z], "ms": ms,
                     "tflops": 2.0 * m * n * k / ms / 1e9,
                     "model_rank": rank[t][0] if t in rank else None,
                     "model_ms": rank[t][1] * 1e3 if t in rank else None,
                     "design": mm_ops.kernel.design(a, b, t)})
    del a, b, flush
    return sorted(rows, key=lambda r: r["ms"])


def table1_phase(torch, table1, autotune, mods):
    """The port's Table I on the card, in a fresh cache file: the tuner
    against the eq. 2 tile at the Table-1 shapes (plans measured on the
    card among the model's top ``TABLE1_MEASURE_K`` tiles, keys naming
    it), B6 timed with the tuned, eq. 2 and fixed tiles,
    the measured TFLOP/s beside the model's, and a second `tune` of each
    shape answered from the cache.  Launch counts are set to 0 just
    before and read just after; every launch must be on the wgmma
    kernel.  Then, outside that window, every built tile at 8192^3
    (`tile_sweep`)."""
    import tempfile
    from repro_torch.kernels.matmul import kernel as mm_kernel
    kind = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.TuneCache(pathlib.Path(tmp) / "autotune.json")
        reset_launch_counts(mods)
        t0 = time.time()
        tuned = table1.tuned_vs_fixed("cuda", cache=cache,
                                      measure_k=TABLE1_MEASURE_K)
        measured = table1.tuned_vs_fixed_measured("cuda", cache=cache)
        seconds = time.time() - t0
        counts = launch_counts(mods)
        by_design = dict(mm_kernel.design_launches)
        again = [autotune.tune("matmul", {"m": m, "n": n, "k": k},
                               torch.bfloat16, device="cuda", cache=cache)
                 for m, n, k in table1.TABLE1_SHAPES]
    sweep = tile_sweep(torch)
    ok = (all(r["tuned_source"] == "measured" and kind in r["key"]
              for r in tuned)
          and all(p.source == "cache" and p.provenance == "measured"
                  for p in again)
          and counts["blocked_matmul"] > 0
          and by_design["wgmma+TMA"] == counts["blocked_matmul"]
          and all(v == 0 for k, v in counts.items() if k != "blocked_matmul")
          and all(r["design"] == "wgmma+TMA" for r in sweep))
    from repro_torch.core import hardware
    return {"chip": dataclasses.asdict(hardware.detect()),
            "seconds": seconds, "tuned_vs_fixed": tuned,
            "measured": measured,
            "second_tune_sources": [p.source for p in again],
            "launches": counts, "launches_by_design": by_design,
            "tile_sweep_8192": sweep, "ok": ok}


def table2_phase(torch, table2, autotune, mods):
    """The port's Table II on the card, in a fresh cache file: one row per
    Table-II matrix (dense baseline against the tuned sparse path) and the
    tuned plans of those and of the two 1M-row matrices; the wide one must
    be tuned to the blocked kernel.  Launch counts are set to 0 just
    before and read just after."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.TuneCache(pathlib.Path(tmp) / "autotune.json")
        reset_launch_counts(mods)
        t0 = time.time()
        rows = [table2.bench_one(name, device="cuda", cache=cache)
                for name in table2.MATRICES]
        records = table2.tuned_records(
            "cuda", names=(*table2.MATRICES, *table2.LARGE), cache=cache)
        seconds = time.time() - t0
        counts = launch_counts(mods)
    by_name = {r["matrix"]: r for r in records}
    ok = (all(r["err"] < 1e-3 for r in rows)
          and by_name["spmv_1m_wide"]["block_cols"] is not None
          and all(r["measured_us"] is not None for r in records)
          and counts["ell_spmv"] > 0 and counts["ell_spmv_blocked"] > 0
          and counts["blocked_matmul"] == 0
          and records[0]["blocked_vs_resident_err"] < 1e-3)
    return {"seconds": seconds, "rows": rows, "tuned_records": records,
            "launches": counts, "ok": ok}


def paper_phases(torch, mods):
    """The paper's slice: ``matmul_cases`` and ``spmv_cases`` (B6-B8
    against their plain versions), then ``table1`` and ``table2`` (the
    port's benchmarks on the card, the main path of B6-B8).  Emits a line
    per phase and fails on any; returns the cases, each kernel's launches
    on its main path, and the two tables' records."""
    from repro_torch.benchmarks import table1_matmul as table1
    from repro_torch.benchmarks import table2_spmv as table2
    from repro_torch.kernels import autotune
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.spmv import kernel as sp_kernel
    from repro_torch.kernels.spmv import ops as sp_ops
    from repro_torch.kernels.spmv import ref as sp_ref
    from repro_torch.kernels.spmv import spec as sp_spec

    import tempfile
    from repro_torch.core import tiling
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    mcases = []
    with tempfile.TemporaryDirectory() as tmp:
        # each shape's tile as the main path picks it: measured on the card
        tiles = autotune.TuneCache(pathlib.Path(tmp) / "autotune.json")
        for name, m, n, k, dt, act, with_bias in MATMUL_CASES:
            plan = autotune.tune(
                "matmul", {"m": m, "n": n, "k": k},
                {"bf16": torch.bfloat16, "f32": torch.float32}[dt],
                device="cuda", measure_k=TABLE1_MEASURE_K, cache=tiles)
            mcases.append(matmul_case(
                torch, mm_ops, mm_ref, flush, name=name, m=m, n=n, k=k,
                dtype=dt, activation=act, with_bias=with_bias,
                tile=tiling.Tile(*plan.knobs["tile"])))
            gc.collect()
            torch.cuda.empty_cache()
    emit("matmul_cases", cases=mcases)
    check(all(c["ok"] for c in mcases),
          "the matmul kernel disagrees with its plain version: "
          + json.dumps([c for c in mcases if not c["ok"]]))
    scases = spmv_cases(torch, table2, sp_ops, autotune, sp_kernel, sp_ref,
                        sp_spec, flush)
    del flush
    torch.cuda.empty_cache()
    emit("spmv_cases", cases=scases)
    check(all(c["ok"] for c in scases),
          "an SpMV kernel disagrees with its plain versions: "
          + json.dumps([c for c in scases if not c["ok"]]))

    t1 = table1_phase(torch, table1, autotune, mods)
    emit("table1", **t1)
    check(t1["ok"], "table1 failed: " + json.dumps(t1["launches"]))
    t2 = table2_phase(torch, table2, autotune, mods)
    emit("table2", **t2)
    check(t2["ok"], "table2 failed: " + json.dumps(
        {"launches": t2["launches"], "plans": t2["tuned_records"]}))
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"blocked_matmul": t1["launches"]["blocked_matmul"],
                "blocked_matmul_by_design": t1["launches_by_design"],
                "ell_spmv": t2["launches"]["ell_spmv"],
                "ell_spmv_blocked": t2["launches"]["ell_spmv_blocked"]}
    return mcases + scases, launches, (t1, t2)


def attention_report(torch, mods, t1, t2) -> dict:
    """`repro_torch.benchmarks.run`'s report on the card: its attention
    rows measured here at full Qwen3-14B shapes (B5, B1 and B3 launched,
    counts set to 0 just before and read just after; the decode rows at
    the tuner's spans), its Table I and Table II rows the records the
    ``table1`` and ``table2`` phases made (B6-B8 are not timed again).
    The report must pass ``tools/check_bench.py`` unchanged."""
    import tempfile
    import check_bench
    from repro_torch.benchmarks import run
    reset_launch_counts(mods)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        rows = run.attention_rows("cuda", smoke=False)
        counts = launch_counts(mods)
        report = run.kernel_report(
            "cuda", tuned_recs=t1["tuned_vs_fixed"],
            matmul_measured=t1["measured"], spmv_recs=t2["tuned_records"],
            attention=rows)
        path = pathlib.Path(tmp) / "report.json"
        path.write_text(json.dumps(report))
        problems = check_bench.check(path)
    return {"seconds": time.time() - t0, "report": report,
            "launches": counts, "check_bench_problems": problems,
            "ok": (not problems and counts["flash_attention"] > 0
                   and counts["decode_attention"] > 0
                   and counts["quantized_decode_attention"] > 0)}


def main_path_case(kernel: str, cases: list) -> dict:
    """The case at the shape the kernel's main path gives it: Qwen3-14B's
    32k prefill for the flash kernel; for the decode kernels the serve
    shape with bf16 q and an f32 or int8 cache (paged: pages of 16); a
    Table-1 shape in bf16 for the matmul; the 1M-row matrices for the
    SpMV kernels (x narrow for B7, wide for B8)."""
    if kernel == "flash_attention":
        return next(c for c in cases if c["name"] == "qwen3_prefill_32k")
    if kernel == "blocked_matmul":
        return next(c for c in cases if c["name"] == MATMUL_MAIN)
    if kernel in SPMV_MAIN:
        return next(c for c in cases if c["name"] == SPMV_MAIN[kernel])
    return next(c for c in cases if c["name"] == "serve_shape"
                and c["q_dtype"] == "bfloat16"
                and c["kv_dtype"] in ("float32", "int8")
                and c.get("page_size") in (None, 16))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import check_load
    import check_serve
    import repro_torch.configs as configs
    from repro_torch.configs import shapes
    from repro_torch.convert import disable_tf32
    from repro_torch.core import cost_model
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import decode, decode_int8, ref
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer
    from repro_torch.runtime import lifecycle, paging, quantize
    mods = (decode, decode_int8, quantize, flash)

    started = time.time()
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
    sources = {pathlib.Path(src).stem for src, _ in KERNELS.values()}
    emit("build", seconds=round(time.time() - t0, 3),
         libraries=sorted(p.name for p in built.values()),
         kernels=list(KERNELS), flags=" ".join(_build.NVCC_FLAGS))
    check(sources <= set(built), f"not built: {sources - set(built)}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [kernel_case(torch, decode, flush, name="serve_shape",
                         lengths=SERVE_LENGTHS, q_dtype=bf16,
                         kv_dtype=f32, cache_len=SERVE_LEN)]
    for q_dtype, kv_dtype in ((bf16, f32), (bf16, bf16), (f32, f32)):
        for lengths in ([4096], MIXED):
            cases.append(kernel_case(
                torch, decode, flush, name=f"b{len(lengths)}_l4096",
                lengths=lengths, q_dtype=q_dtype, kv_dtype=kv_dtype,
                cache_len=4096))
    for kv_dtype in (f32, bf16):
        for lengths in ([LONG], [LONG] * 4):
            cases.append(kernel_case(
                torch, decode, flush, name=f"b{len(lengths)}_l{LONG}",
                lengths=lengths, q_dtype=bf16, kv_dtype=kv_dtype,
                cache_len=LONG))
            gc.collect()
            torch.cuda.empty_cache()
    for c in cases:
        c["kernel"] = "decode_attention"
    cases += new_kernel_cases(torch, mods, flush)
    # the decode shapes of the other families' serve phases
    cases += family_kernel_cases(torch, configs, mods, flush)
    emit("kernel_cases", cases=cases)
    check(all(c["ok"] for c in cases),
          "a kernel disagrees with its plain version: "
          + json.dumps([c for c in cases if not c["ok"]]))

    sweep = split_sweep(torch, mods, flush)
    del flush
    torch.cuda.empty_cache()
    emit("split_sweep", split_keys=decode.SPLIT_KEYS, rows=sweep)
    check(all(r["ok"] for r in sweep),
          "a split span disagrees with its plain version: "
          + json.dumps([r for r in sweep if not r["ok"]]))

    tf = decode_vs_teacher_forcing(torch, configs, transformer)
    emit("decode_vs_teacher_forcing", **tf)
    check(tf["ok"], f"decode through the kernel != teacher forcing: {tf}")
    tf = decode_vs_teacher_forcing_paged(torch, configs, transformer, paging,
                                         decode)
    emit("decode_vs_teacher_forcing_paged", **tf)
    check(tf["ok"], f"decode through the paged kernel != teacher forcing: "
                    f"{tf}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fcases = []
    for name, b, sq, sk, hq, hkv, dh, causal, window, dt in FLASH_CASES:
        fcases.append(flash_case(
            torch, flash, ref, cost_model, flush, name=name, b=b, sq=sq,
            sk=sk, hq=hq, hkv=hkv, dh=dh, causal=causal, window=window,
            dtype=dt))
        gc.collect()
        torch.cuda.empty_cache()
    del flush
    emit("flash_cases", cases=fcases)
    check(all(c["ok"] for c in fcases),
          "the flash kernel disagrees with its plain version: "
          + json.dumps([c for c in fcases if not c["ok"]]))
    cases += fcases

    prefill_launches = {}
    for phase, arch, check_len in PREFILL_PHASES:
        cfg = configs.get(arch)
        params = transformer.init(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            dtype=torch.bfloat16)
        res = prefill_phase(torch, shapes, steps, transformer, mods, cfg,
                            params)
        emit(phase, **res)
        check(res["ok"], f"{phase} failed: {res}")
        prefill_launches[phase] = res["flash_launches"]
        pvf = prefill_vs_forward(torch, steps, transformer, mods, cfg,
                                 params, check_len)
        emit("prefill_vs_forward", **pvf)
        check(pvf["ok"], f"prefill and full forward disagree: {pvf}")
        del params
        gc.collect()
        torch.cuda.empty_cache()

    layers = configs.get("qwen3_14b").num_layers
    launches = {"flash_attention": prefill_launches["prefill"]}
    serve_runs, serve_launches, main_spans = {}, {}, {}
    for phase, argv, kernel, most_at_once in SERVE_PHASES:
        serve_runs[phase] = serve_phase(
            torch, serve, check_serve, mods, phase=phase, argv=argv,
            kernel=kernel, most_at_once=most_at_once, layers=layers)
        launches[kernel] = serve_runs[phase]["launches"]
        serve_launches[phase] = launches[kernel]
    # The default CLI (--batch 0) is the main path of B1 and B3.
    for phase, argv, kernel, flagged in AUTOBATCH_PHASES:
        auto = autobatch_phase(torch, serve, check_serve, mods, phase=phase,
                               argv=argv, kernel=kernel, layers=layers,
                               flagged=serve_runs[flagged])
        launches[kernel] = auto["launches"]
        serve_launches[phase] = auto["launches"]
        main_spans[kernel] = auto["decode_span"]
    # Fault tolerance and the load harness: chaos, crash and resume, the
    # harness and its replay, each at full width through B1-B4.
    for phase, argv, kernel, clean_phase in CHAOS_PHASES:
        clean = (None if clean_phase is None else
                 {rid: ("completed", toks) for rid, toks in
                  serve_runs[clean_phase]["streams"].items()})
        res = chaos_phase(torch, serve, check_serve, mods, phase=phase,
                          argv=argv, kernel=kernel, layers=layers,
                          clean=clean)
        serve_launches[phase] = res["kernel_launches"]
    del serve_runs
    for phase, flags, kernel in RESUME_PHASES:
        res = crash_resume_phase(torch, serve, check_serve, mods, configs,
                                 phase=phase, flags=flags, kernel=kernel,
                                 layers=layers)
        serve_launches[phase] = sum(res["kernel_launches"].values())
    load_launches = serving_load_phase(torch, serve, check_serve, check_load,
                                       mods)["kernel_launches"]

    # The other families: the ring buffer, MoE, RWKV6, Jamba, frontends.
    family_launches = family_phases(torch, serve, configs, check_serve,
                                    steps, transformer, lifecycle, mods, smi)

    pvc = paged_vs_contiguous(torch, configs, serve, paging, lifecycle)
    emit("paged_vs_contiguous", **pvc)
    check(pvc["ok"], f"paged and contiguous token streams differ: {pvc}")

    step = decode_step_breakdown(torch, configs, serve)
    emit("decode_step", **step)
    check(step["decode_attention_ms_per_step"] > 0,
          "decode_step found no device time of the decode kernel")

    paper_cases, paper_launches, (t1, t2) = paper_phases(torch, mods)
    cases += paper_cases
    launches.update(paper_launches)
    rep = attention_report(torch, mods, t1, t2)
    emit("attention_report", **rep)
    check(rep["ok"], "attention_report failed: " + json.dumps(
        {"problems": rep["check_bench_problems"],
         "launches": rep["launches"]}))
    del t1, t2

    entries = []
    for name, (source, replaces) in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        serve_case = main_path_case(name, mine)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max(c["max_abs_err"] for c in mine),
                 "ok": True,
                 "design": serve_case.get("design", DESIGNS[name])}
        entry.update({k: serve_case[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if entry["library_ms"] is None:
            entry["library"] = serve_case.get("library", NO_LIBRARY)
        if name == "flash_attention":
            entry["launches_by_phase"] = {**prefill_launches,
                                          **family_launches[name]}
        if name in KERNELS_OF_SERVE.values():
            entry["launches_by_phase"] = {
                phase: n for phase, n in serve_launches.items()
                if KERNELS_OF_SERVE[phase] == name}
            if load_launches[name]:
                entry["launches_by_phase"]["serving_load"] = \
                    load_launches[name]
            entry["launches_by_phase"].update(family_launches.get(name, {}))
        if name in main_spans:
            # ms above is the default span's; the default CLI ran this one
            span = main_spans[name]
            row = next(r for r in sweep if r["name"] == "serve_shape"
                       and r["kernel"] == name
                       and r["kv_dtype"] in ("float32", "int8"))
            times = row["ms_by_span"].get(str(span))
            entry["main_path_span"] = span
            entry["main_path_span_ms"] = (sum(times) / len(times) if times
                                          else None)
        if name == "blocked_matmul":
            entry["launches_by_design"] = launches["blocked_matmul_by_design"]
        entries.append(entry)
    emit("total", seconds=round(time.time() - started, 3))
    print(json.dumps({"kernels": entries}), flush=True)
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
