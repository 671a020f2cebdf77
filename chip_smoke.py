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
   Then, while this process holds nothing on the card,
   ``tensor_parallel``: tensor and expert parallelism over a (1, 2) mesh
   of two processes of this script on the one card over a gloo group
   (`tensor_parallel`): H2O-Danube-1.8B at full width, 2 layers, one f32
   train step against the one-rank step (loss, gradients and their norm
   within 1e-5 of the largest |value|; the rank's step ms and its
   collectives' ms, recorded, not gated), its prefill through B5 at the
   rank's 16 query heads with the one-rank greedy token, 16 decode steps
   under `decode_rules` over a cache split by sequence (Danube's ring,
   and Qwen3-14B at 2 layers through B1 and, int8, B3 with their softmax
   statistics) or a paged pool whole on each rank (B2, B4 at the rank's
   query heads) with the one-rank decode's tokens, RWKV6-7B at 2 layers
   (its time mix over its heads, its channel mix over d_ff: a train
   step, a prefill and 16 decode steps), Mamba alone at
   Jamba-1.5-Large's width (d_in over the ranks), and Phi-3.5-MoE at 2
   layers, one train step with its experts over the model axis at a
   capacity where neither side drops an item.  ``kernel_cases`` holds B1
   and B3 with their statistics on a rank's segment of the rows, B2 and
   B4 at a rank's 20 query heads on the strided view of its 4 KV heads
   of a whole pool, and ``flash_cases`` B5 at a rank's heads of
   Qwen3-14B's prefill.
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
   at dh 80 and 128, an f32 case and Phi-3-mini's 4k prefill (Hq = Hkv
   = 32, dh 96: mma.sync); each with its design and tile, its
   time, its bound from the pairs the mask keeps, the plain version's
   time and PyTorch SDPA's.
6. ``prefill``, ``prefill_danube`` and ``prefill_phi3_mini``:
   `steps.make_prefill_step` at the full published width and depth of
   Qwen3-14B, H2O-Danube-1.8B and Phi-3-mini-3.8B (random bf16 weights
   from a seeded generator) on 1 x 32,768 tokens, ``prefill_32k``'s
   length (its global batch of 32 is cut to 1; Phi-3-mini-4k to its
   4,096-token context, B5 launched 3 x 32 times in the check): host ms
   per forward, prompt tokens/s, flash launches (one per layer per
   forward, no decode kernel), peak memory and device time by kernel
   from `torch.profiler` over one traced forward.
   ``prefill_vs_forward``: with the same weights at 4,096 (Qwen3) and
   6,144 (Danube, past its window) tokens, the last-position logits of
   the prefill path (flash kernel) and of the full forward
   (`attention_core`) agree within 1e-4 in f32; in bf16 the prefill path
   is no farther from the f32 logits than the full forward plus the bf16
   logit bound, within that bound on the first 2 layers and within the
   depth's derived bound (`bf16_logit_rel`) on the first 8 (and 40,
   where the model is deeper) and at full depth, and the greedy tokens
   agree (or the top-2 gap is below the bound).
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
   B2) and ``moe_paged_vs_contiguous`` (`paged_run_vs_contiguous`: the
   paged run's streams equal a
   contiguous server's with its weights at the same, default, span);
   every serve run under the CLI's sharding rules (`serve.serving_rules`:
   a (1, 1) mesh over a one-rank NCCL group), so MoE layers take
   `moe.apply_sharded`'s expert exchange with its two-stage capacity, as
   the JAX CLI's do;
   ``moe_vs_teacher_forcing`` (4 layers, capacity raised so nothing
   drops, 64 tokens through B1 in f32); ``serve_qwen3_moe`` twice
   (Qwen3-MoE-235B at full width, 128 experts, top 8, 4 of 94 layers: the
   two runs' streams bitwise equal); ``moe_expert_parallel`` (one
   Phi-3.5-MoE MoE layer at full width, 4 x 128 tokens whose repeats
   overflow two experts: `apply_sharded` over the NCCL group against
   `apply_grouped` at the compounded capacity within 1e-5 in f32, the
   items each stage dropped); ``serve_rwkv`` (RWKV6-7B, full width
   and depth, no kernel) and ``rwkv_vs_teacher_forcing``;
   ``serve_jamba_smoke`` and ``serve_chaos_jamba_smoke`` (Jamba's SMOKE
   shapes, the only ones one card holds; the chaos run's ``kv_corrupt``
   must leave the slot's Mamba state NaN and the other slots' finite);
   ``prefill_hubert`` (HuBERT-XLarge, 2 x 1,000 frames, B5 non-causal at
   head_dim 80) and ``prefill_internvl2`` (InternVL2-2B, 1,024 patches and
   512 tokens, B5 causal at 128), each gated as ``prefill_vs_forward``.
   The last dense configurations (ROADMAP F1, F3; `dense_phases`), each
   serve run through `family_serve` at full width and depth:
   ``serve_phi3_mini``, ``_paged``, ``_int8`` (at the tuner's batch,
   ``--batch 0``: its pick and predicted step beside the measured p50)
   and ``_paged_int8`` (Phi-3-mini-3.8B, plain MHA at head_dim 96: B1-B4
   at g 1), ``phi3_mini_vs_teacher_forcing`` (64 tokens through B1 in
   f32, 1e-4 of the largest |logit|, B1 once per layer a step),
   ``phi3_mini_paged_vs_contiguous``; ``serve_internvl2`` (InternVL2-2B's
   token stream, B1 at g 2); ``qwen2_5_32b_memory`` (with every earlier
   weight and cache freed, the card's free memory against Qwen2.5-32B's
   65.5 GB of bf16 weights, its cache and a reserve: the depth that fits,
   cut only where all 64 layers do not), ``serve_qwen2_5_32b`` (f32, B1)
   and ``serve_qwen2_5_32b_paged_bf16`` (B2), each with its peak memory,
   and ``prefill_qwen2_5_32b`` (`prefill_vs_forward` on those weights at
   4,096 tokens: the bf16 bound at 2, 8, 40 and 64 layers).  Phi-3-mini's
   prefill is ``prefill_phi3_mini`` (step 6, 1 x 4,096 tokens, its
   context; B5 on mma.sync at head_dim 96), and ``kernel_cases`` holds
   B1-B4 at Phi-3-mini's serve shape and B1 at InternVL2's.
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
13. The paper's design flow and training on one card.  ``quickstart``
   and ``spmv_pipeline``: `repro_torch.examples.quickstart` (B6 in f32 at
   256x192x128 on the CUDA cores, then B7 or B8 as the tuner picks) and
   ``examples.spmv_pipeline`` (every balancing law on B7, the tuned plan,
   B8 over 256-column slabs) on the card in a fresh tuning cache, each
   kernel result within its case's tolerance and the kernels launched
   (counts set to 0 before each).  ``train_step_parity``: one f32 train
   step of Qwen3-14B's and Phi-3.5-MoE's SMOKE configs on the card
   against the CPU's, loss and gradients within 1e-5 of the largest
   |gradient|, AdamW's update within 1e-5, the card's step bitwise its
   own gradient and update, the parameters after the step within 1e-5
   wherever the gradient is above 1e-4 of the largest, B5 never
   launched.
   ``train_danube``: H2O-Danube-1.8B at full width and depth
   (``remat="full"``), f32 weights and moments placed by
   `launch.specs` on the trainer CLI's (1, 1) mesh (a one-rank NCCL
   group), the data-parallel step, 4 x 2,048 tokens a step of
   `SyntheticSource`: step ms (median of 5 after a warm step),
   tokens/s, peak memory, losses and grad norms, the bound, device time
   by kernel, and the gradient tree's one-rank all-reduce and
   `compressed_psum` times.  ``train_mesh_parity``: Danube at full width
   cut to 4 layers, one step through the mesh path bitwise the plain
   step (loss, gradients, every updated leaf), the ``grad_dtype=bf16``
   gradients bitwise the f32 ones rounded, `compressed_psum` of the
   gradient tree within each block's scale/2 (the worst ratio printed).  ``train_resume_danube_cut``: Danube at full width cut to
   4 layers, 10 steps through `run_resilient` with checkpoints, restored
   at 6 and replayed to the same state bit for bit, and a fault at step
   4 recovered to it too.  ``train_cli``: `repro_torch.launch.train` on
   Qwen3-14B's SMOKE config for 30 steps, then ``--resume`` to 40 in a
   second process.  ``train_lm``: ``examples.train_lm --hundred-m
   --steps 200``, its loss falling by 10 %.
14. Compile analysis (ROADMAP A14 items 6-10).  ``dryrun_counts``: one
   more step of ``train_danube`` (through the one-rank NCCL mesh),
   ``prefill`` (Qwen3-14B, 1 x 32,768 tokens, B5 launched once a layer)
   and ``decode_step`` (batch 4, B1 launched once a layer) counted by
   `core.hlo_stats.count_step` on the card and on meta (prefill and
   decode on a meta mirror of the same arguments; the train step in a
   process of its own over a one-rank ``fake`` group, `meta_count_main`):
   FLOPs and collectives (counts and operand bytes) must be equal and
   bytes within 1 %, any operator that differs named; beside each, the
   counter's tracked peak and `torch.cuda.max_memory_allocated`, the
   phase's measured step and the roofline bound of the counted step (a
   model of the data sheet: `step_bound`).  ``dryrun_cells``: six cells
   of ``python -m repro_torch.launch.dryrun`` on the single-pod mesh,
   one process each, all at once (they need no card): Qwen3-14B's
   ``train_4k``, ``prefill_32k`` and ``decode_32k``, Qwen3-MoE's
   ``decode_32k``, Jamba's ``long_500k`` and Qwen3-MoE's ``train_4k``
   (its experts trained over the model axis), each ``ok``; then
   `benchmarks.roofline_report`'s table and CSV lines of them.
15. ``total``: the script's seconds.  ``kernels``: one entry per ported
   kernel, with its TPU counterpart, its design, launches on its
   main-path run (B1, B3: the default CLI, ``serve_autobatch*``; B2, B4:
   their serve runs; B5: the ``prefill`` phase; B6: ``table1``; B7, B8:
   ``table2``) and each kernel's launches by phase (the chaos,
   crash-resume, ``serving_load`` and other families' phases among them;
   B6-B8's in the two design-flow phases), error and times; B1-B5's
   entries also carry ``per_rank``, their case at one rank's shape on a
   model axis of 2, and their ``tensor_parallel`` launches.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
exits non-zero without it; so does a host without a CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import pathlib
import subprocess
import sys
import threading
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
# The kernels of the paper's slice (their sources: every one but the
# attention kernels'), first launched by `paper_phases`.
PAPER_KERNELS = ("blocked_matmul", "ell_spmv", "ell_spmv_blocked")
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
STEP_WARMUP, STEP_COUNT = 2, 8       # untraced steps
STEP_TRACED = 4                      # then traced steps
TOP_KERNELS = 12
# flash_cases: (name, batch, Sq, Sk, Hq, Hkv, dh, causal, window, dtype)
TP_FLASH_CASE = "qwen3_prefill_8k_heads_of_2"
TP_STATS_CASE = "serve_shape_segment_of_2"
TP_INT8_STATS_CASE = "int8_segment_of_2"
TP_PAGED_CASE = "paged_heads_of_2"
TP_PAGED_INT8_CASE = "paged_int8_heads_of_2"
FLASH_CASES = [
    ("qwen3_prefill_32k", 1, 32768, 32768, 40, 8, 128, True, None, "bf16"),
    ("qwen3_prefill_4k", 1, 4096, 4096, 40, 8, 128, True, None, "bf16"),
    ("danube_prefill_32k", 1, 32768, 32768, 32, 8, 80, True, 4096, "bf16"),
    ("non_causal_ragged", 2, 1000, 1000, 40, 8, 128, False, None, "bf16"),
    ("window_sq_gt_sk", 1, 700, 500, 32, 8, 80, True, 64, "bf16"),
    ("window_sq_gt_sk_dh128", 1, 700, 500, 40, 8, 128, True, 64, "bf16"),
    ("qwen3_4k_f32", 1, 4096, 4096, 40, 8, 128, True, None, "f32"),
    # one rank's heads of Qwen3-14B's prefill on a model axis of 2
    (TP_FLASH_CASE, 1, 8192, 8192, 20, 4, 128, True, None, "bf16"),
    # Phi-3-mini-3.8B's prefill at its 4k context: MHA at head_dim 96, the
    # mma.sync design
    ("phi3_mini_prefill_4k", 1, 4096, 4096, 32, 32, 96, True, None, "bf16"),
]
# (phase, arch, prompt tokens: prefill_32k's 32,768, or the model's own
# context where shorter, prefill_vs_forward's length: past Danube's 4096
# window)
PREFILL_PHASES = [("prefill", "qwen3_14b", 32768, 4096),
                  ("prefill_danube", "h2o_danube_1_8b", 32768, 6144),
                  ("prefill_phi3_mini", "phi3_mini_3_8b", 4096, 4096)]
PREFILL_TIMED = 2                    # untraced forwards after a warm-up
MID_DEPTH = 8                        # a depth between it and the full
DEEP_DEPTH = 40                      # Qwen3-14B's depth, read on deeper models
# One definition of the bf16 logit bound serves the server's near-tie
# rule, `prefill_vs_forward` and `_near_tie`: 3e-2 of max |logit| at the
# SMOKE depth of 2 layers, and `bf16_logit_rel(layers)` derived from it.
from repro_torch.launch.serve import (  # noqa: E402
    BF16_LOGIT_REL, BF16_SHALLOW as SHALLOW, bf16_logit_rel)
MATMUL_MARKS = ("nvjet", "gemm", "xmma", "cutlass")


STARTED = time.time()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``at_s`` is the script's seconds so far, so
    the difference of two lines' is the time between them."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.time() - STARTED, 3)}), flush=True)


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


def decode_sdpa(torch, q, k, v, lv, scale):
    """PyTorch SDPA over a contiguous (B, rows, Hkv, dh) cache's first
    ``lv`` rows of each slot: one query a slot, in the cache's dtype.
    Plain MHA (Hq == Hkv) needs no GQA, so every backend may take it."""
    import torch.nn.functional as F
    mask = (torch.arange(k.shape[1], device=k.device)[None, :]
            < lv[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.to(k.dtype)[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale, enable_gqa=q.shape[1] != k.shape[2])


def kernel_case(torch, decode, flush, *, name, lengths, q_dtype, kv_dtype,
                cache_len, hq=40, hkv=8, dh=128, seed=0):
    """One shape: error of the kernel against `decode_ref`, and times."""
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
        return decode_sdpa(torch, q, k, v, lv, scale)

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


def stats_case(torch, mods, flush, *, name, lengths, q_dtype, kv_dtype,
               cache_len):
    """B1 (B3 for an int8 ``kv_dtype``) with its softmax statistics
    (``return_stats``) at Qwen3-14B's decode heads on one rank's segment
    of a cache split by sequence over 2 ranks: rows [cache_len, 2 * cache_len) of the slots'
    ``lengths``, each clamped to the segment, as `models.layers` calls it.
    The output against the plain version's (`row_errors`: 1e-4 in f32)
    and bitwise the call's without statistics, m and l against the plain
    version's statistics (m within 1e-4 of max(1, |m|), l within 1e-4 of
    l; m = -1e30 and l = 0 exactly for a slot with no key there), and the
    call's time beside the call without statistics."""
    decode, decode_int8, quantize, _ = mods
    dev = torch.device("cuda")
    hq, hkv, dh = 40, 8, 128
    int8 = kv_dtype == torch.int8
    gen = torch.Generator(device=dev).manual_seed(0)
    seg = [min(max(n - cache_len, 0), cache_len) for n in lengths]
    b = len(seg)
    # q holds values of the cache's type, as the layers' f32 copy of a
    # query in that type does (the kernel meets the keys in it)
    q = torch.randn((b, hq, dh), generator=gen, device=dev)
    q = (q if int8 else q.to(kv_dtype)).to(q_dtype)
    k = torch.randn((b, cache_len, hkv, dh), generator=gen, device=dev)
    v = torch.randn((b, cache_len, hkv, dh), generator=gen, device=dev)
    if int8:
        cache = (*quantize.quantize_rows(k), *quantize.quantize_rows(v))
        fn = decode_int8.quantized_gqa_decode_attention
        ref_fn = decode_int8.quantized_decode_ref
    else:
        cache = (k.to(kv_dtype), v.to(kv_dtype))
        fn, ref_fn = decode.gqa_decode_attention, decode.decode_ref
    del k, v
    lv = torch.tensor(seg, dtype=torch.int32, device=dev)
    scale = dh ** -0.5

    def kernel():
        return fn(q, *cache, length=lv, scale=scale, return_stats=True)

    def no_stats():
        return fn(q, *cache, length=lv, scale=scale)

    out, m, l = kernel()
    ref, rm, rl = ref_fn(q, *cache, length=lv, scale=scale,
                         return_stats=True)
    same = bool(torch.equal(out, no_stats()))
    torch.cuda.synchronize()
    err, err_over_tol = row_errors(torch, out, ref, q_dtype == torch.float32)
    m_err = float(((m - rm).abs() / rm.abs().clamp_min(1.0)).max())
    l_err = float(((l - rl).abs() / rl.clamp_min(1e-30)).max())
    empty = [i for i, n in enumerate(seg) if n == 0]
    empty_ok = all(bool((m[i] == decode.NEG_INF).all())
                   and not bool(l[i].any()) for i in empty)
    ms = median_ms(torch, kernel, 21, flush)
    plain_ms = median_ms(torch, lambda: ref_fn(
        q, *cache, length=lv, scale=scale, return_stats=True), 5, flush)
    no_stats_ms = median_ms(torch, no_stats, 21, flush)
    valid = sum(seg)
    row_bytes = sum(c[0, 0].numel() * c.element_size() for c in cache)
    nbytes = (valid * row_bytes + q.numel() * q.element_size()
              + out.numel() * out.element_size() + lv.numel() * 4
              + 2 * b * hq * 4)
    ops = 4 * valid * hq * dh
    kv_name = str(kv_dtype).removeprefix("torch.")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # int8 codes are dequantized and multiplied in f32
    t_ops = ops / PEAK_OPS_PER_S["float32" if int8 else kv_name] * 1e3
    return {"name": name, "kernel": ("quantized_decode_attention" if int8
                                     else "decode_attention"),
            "stats": True,
            "batch": b, "cache_len": cache_len, "lengths": seg,
            "q_dtype": str(q_dtype).removeprefix("torch."),
            "kv_dtype": kv_name, "max_abs_err": err,
            "max_err_over_tol": err_over_tol, "m_rel_err": m_err,
            "l_rel_err": l_err, "empty_rows_ok": empty_ok,
            "equal_without_stats": same,
            "tolerance": ("out as row_errors; m 1e-4 of max(1, |m|); "
                          "l 1e-4 relative; out bitwise without stats"),
            "ok": (err_over_tol <= 1 and m_err <= 1e-4 and l_err <= 1e-4
                   and empty_ok and same),
            "ms": ms, "no_stats_ms": no_stats_ms,
            "stats_over_no_stats": ms / no_stats_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


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
                    seed=0, kv_heads=None):
    """One shape of the paged, int8 or paged int8 kernel: its error against
    its plain version, times and bound.  The paged kernel's output must
    also be bitwise that of the contiguous kernel over the same rows, and
    SDPA is timed over those rows gathered (``sdpa_same_rows_ms``: no
    PyTorch call attends through a page table, so no library time).
    ``kv_heads`` (first, count): the kernel reads the strided view of
    those of the cache's ``hkv`` heads (``narrow`` on the head axis, as
    a rank's query heads read a pool that `decode_rules` keeps whole),
    ``hq`` the query heads that read them; the plain version reads the
    same view."""
    decode, decode_int8, quantize, _ = mods
    dev = torch.device("cuda")
    b = len(lengths)
    # q holds values of a float cache's type: the kernels meet the keys
    # in it (the int8 kernels keep q in f32)
    q = torch.randn((b, hq, dh), generator=torch.Generator(
        device=dev).manual_seed(seed + 1), device=dev)
    q = (q if kv_dtype == torch.int8 else q.to(kv_dtype)).to(q_dtype)
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
    if kv_heads is not None:
        cache = tuple(c.narrow(2, *kv_heads) for c in cache)
        hkv = kv_heads[1]
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
    bitwise = sdpa_ms = None
    if kernel == "paged_decode_attention":
        rows_kv = [decode.gather_pages(c, pages).contiguous()
                   for c in cache]
        contiguous = decode.gqa_decode_attention(q, *rows_kv, length=lv,
                                                 scale=scale)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(out, contiguous))
        sdpa_ms = median_ms(torch, lambda: decode_sdpa(
            torch, q, *rows_kv, lv, scale), 11, flush)
        del rows_kv
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
    ok = (err_over_tol <= 1 and zeros_ok and bitwise is not False
          and (kv_heads is None or not cache[0].is_contiguous()))
    return {"kernel": kernel, "name": name, "batch": b, "rows": rows,
            "page_size": page_size, "lengths": list(lengths),
            "query_heads": hq, "kv_heads": kv_heads,
            "strided_view": not cache[0].is_contiguous(),
            "q_dtype": str(q_dtype).removeprefix("torch."),
            "kv_dtype": kv_name, "max_abs_err": err,
            "tolerance": ("1e-4" if q_dtype == torch.float32
                          else "2^-7 x the row's max |ref|"),
            "max_err_over_tol": err_over_tol, "zero_rows_ok": zeros_ok,
            "bitwise_contiguous": bitwise, "ok": ok,
            "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "sdpa_same_rows_ms": sdpa_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops,
            **split_plan(decode, lengths,
                         pages.shape[1] * page_size if paged else rows, hkv)}


def new_kernel_cases(torch, mods, flush):
    """B2-B4 at the serve shape, at batch 1 and 4096 rows, and at the mixed
    lengths and 4096 rows: B2 with bf16 q and an f32 or bf16 pool, B3 and
    B4 with bf16 and f32 q, the paged ones at page sizes 16 and 48.  At
    32,768 keys, batch 1 and 4: B2 at page 16 with an f32 or bf16 pool, B3
    and B4 (page 16) with bf16 q.  B2 (bf16 pool) and B4 at one rank's
    heads of the serve shape (``TP_PAGED_CASE``, ``TP_PAGED_INT8_CASE``)."""
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
    # B2 and B4 at one rank's heads of a pool `decode_rules` keeps whole
    # on a model axis of 2: rank 1's 20 query heads on the strided view of
    # KV heads 4-7 of 8, f32 q as the split f32 decode passes it
    for name, kernel, kv_dtype in (
            (TP_PAGED_CASE, "paged_decode_attention", bf16),
            (TP_PAGED_INT8_CASE, "paged_quantized_decode_attention", i8)):
        cases.append(new_kernel_case(
            torch, mods, flush, kernel=kernel, name=name,
            lengths=SERVE_LENGTHS, q_dtype=f32, kv_dtype=kv_dtype,
            rows=SERVE_LEN, page_size=TP_PAGE, hq=20, kv_heads=(4, 4)))
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

    from repro_torch import tree as tree_lib
    cfg = configs.get("qwen3_14b")
    rng = np.random.default_rng(1)
    reqs = [(rid, rng.integers(0, cfg.vocab_size, 600), 16)
            for rid in range(4)]
    contiguous = serve.Server(cfg, 4, SERVE_LEN, autotune_kernels=False)
    spec = paging.PageSpec.build(4, SERVE_LEN, 16)
    paged = serve.Server(cfg, 4, SERVE_LEN, params=contiguous.params,
                         paged=spec, autotune_kernels=False)
    shared = all(a is b for a, b in zip(
        tree_lib.leaves(contiguous.params), tree_lib.leaves(paged.params)))
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
    top = float(abs(last).max())
    bound = serve.BF16_LOGIT_REL * top
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"position": m, "uninterrupted": want[m], "resumed": got[m],
            "gap": gap, "max_abs_logit": top, "gap_rel": gap / top,
            "bound_rel": serve.BF16_LOGIT_REL,
            "derived_bound_rel": serve.bf16_logit_rel(cfg.num_layers),
            "layers": cfg.num_layers, "bound": bound, "near_tie": gap < bound}


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


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val:
            return float(val)
    return 0.0


def decode_step_breakdown(torch, configs, serve, mods):
    """One decode step of the serve shape at full width, with the decode
    span the server resolved from its plan and then with the kernels'
    default span, on one server (the span rides the cache): for each,
    host-clock ms of ``STEP_COUNT`` untraced steps (each ends in its host
    synchronisation, the copy of the next tokens), then device time by
    kernel over ``STEP_TRACED`` steps traced by `torch.profiler`.  The
    profiler slows the host, so the busy share of an untraced step is the
    traced device time per step over the median untraced step.  Then
    one more step at the server's span is counted on the card and on
    meta (`decode_counts`)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get("qwen3_14b")
    # room for 2 x (2 + 2 x 8) steps: the 644 cache rows measured since
    # the traced steps were as many as the untraced
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
            for _ in range(STEP_TRACED):
                server.decode_step()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count, _device_us(e))
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = sorted((k for k in kernels if k[2] > 0), key=lambda k: -k[2])
        busy_ms = sum(k[2] for k in kernels) / 1e3 / STEP_TRACED
        attn_ms = sum(k[2] for k in kernels      # the kernels' shared body
                      if "decode_kernel" in k[0]) / 1e3 / STEP_TRACED
        out[label] = {
            "decode_span": span,
            "host_ms": host_ms, "host_median_ms": median,
            "device_time_measured": bool(kernels),
            "device_ms_per_step": busy_ms,
            "decode_attention_ms_per_step": attn_ms,
            "device_busy_share": busy_ms / median,
            "kernel_launches_per_step": sum(k[1] for k in kernels)
            / STEP_TRACED,
            "top_kernels": [{"name": n[:120], "calls": c,
                             "ms_per_step": us / 1e3 / STEP_TRACED}
                            for n, c, us in kernels[:TOP_KERNELS]]}
    out["decode_attention_ms_per_step"] = min(
        out[k]["decode_attention_ms_per_step"] for k in ("tuned", "default"))
    server.cache.pop("decode_span", None)
    server.cache["decode_span"] = server.decode_span
    out["dryrun_counts"] = decode_counts(torch, mods, server,
                                         out["tuned"]["host_median_ms"])
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
                  seq_len, seed=3):
    """`make_prefill_step` on 1 x ``seq_len`` tokens at full width
    (``prefill_32k``'s length, or a model's shorter context): a warm-up
    forward (its last logits must be finite), ``PREFILL_TIMED``
    untraced steps on the host clock with every launch count set to 0 just
    before them, then one step traced by `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    shape = shapes.SHAPES["prefill_32k"]
    runs, why = shapes.applicable(cfg, shape)
    check(runs, f"{cfg.name} does not run prefill_32k: {why}")
    reduced = {"global_batch": [shape.global_batch, 1]}
    if seq_len != shape.seq_len:
        reduced["seq_len"] = [shape.seq_len, seq_len]
    dev = torch.device("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, seq_len), device=dev,
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
           "shape": shape.name, "batch": 1, "seq_len": seq_len,
           "reduced": reduced,
           "host_ms": host_ms, "host_median_ms": median,
           "prompt_tok_per_s": seq_len / (median / 1e3),
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
    bf16-to-bf16 difference is held to that bound on the first
    ``SHALLOW`` layers of the same weights, and to the depth's derived
    bound (`bf16_logit_rel`) on the first ``MID_DEPTH`` and
    ``DEEP_DEPTH`` layers (where the model is deeper) and at full depth;
    ``depths`` records at each depth both bf16 paths' distances from each
    other and from the f32 forward, beside the derived bound.  Runs where
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

    depths = []
    t0 = time.time()
    for n in sorted({min(d, cfg.num_layers)
                     for d in (SHALLOW, MID_DEPTH, DEEP_DEPTH,
                               cfg.num_layers)}):
        if n < cfg.num_layers:
            d_cfg, d_params = first_layers(cfg, params, n)
            d_prefill = transformer.forward(d_cfg, d_params, batch,
                                            last_only=True)[0][:, -1].float()
            d_full = transformer.forward(d_cfg, d_params, batch)[0][:, -1]
            d_f32 = transformer.forward(d_cfg, d_params, batch,
                                        compute_dtype=f32)[0][:, -1]
            d_full, d_f32 = d_full.float(), d_f32.float()
        else:
            d_prefill, d_full, d_f32 = prefill[bf16], full[bf16], full[f32]
        top = float(d_f32.abs().max())
        rel = bf16_logit_rel(n)
        depths.append({"layers": n, "max_abs_logit": top,
                       "bf16_prefill_vs_forward": dist(d_prefill, d_full),
                       "bf16_forward_vs_f32": dist(d_full, d_f32),
                       "bf16_prefill_vs_f32": dist(d_prefill, d_f32),
                       "derived_rel": rel, "derived_bound": rel * top})
        if len(depths) == 1:
            s_prefill, s_full = d_prefill, d_full
    depths_s = time.time() - t0
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
           "shallow_layers": depths[0]["layers"], "depths": depths,
           "depths_s": round(depths_s, 3),
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
                 and all(d["bf16_prefill_vs_forward"] <= d["derived_bound"]
                         for d in depths[1:])
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

def _serve_argv(arch, prompt, gen, *extra, batch=4):
    return ["--arch", arch, "--batch", str(batch), "--requests", "6",
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
# The last dense configurations (ROADMAP F1, F3), at full width and depth
# through the CLI, 6 requests of 600 + 16 tokens each.  Phi-3-mini-3.8B is
# plain MHA (32 query and 32 KV heads, g 1) at head_dim 96: one run per
# cache layout, the int8 one at the tuner's batch (--batch 0).
PAGES_16 = ["--paged", "--page-size", "16"]
PHI3_ARGV = _serve_argv("phi3_mini_3_8b", 600, 16, "--kv-dtype", "f32")
PHI3_PAGED_ARGV = PHI3_ARGV + PAGES_16
PHI3_INT8_ARGV = _serve_argv("phi3_mini_3_8b", 600, 16, "--kv-dtype", "int8",
                             batch=0)
PHI3_PAGED_INT8_ARGV = _serve_argv("phi3_mini_3_8b", 600, 16, *PAGES_16,
                                   "--kv-dtype", "int8")
PHI3_TF_TOKENS = 64
# InternVL2-2B's token stream: B1 at g 2, head_dim 128.
INTERNVL2_ARGV = _serve_argv("internvl2_2b", 600, 16, "--kv-dtype", "f32")
# Qwen2.5-32B: a QKV bias, 64 layers and about 65.5 GB of bf16 weights,
# an f32 cache and a paged bf16 one.  Its depth is cut only where the
# weights, the cache and ``QWEN25_RESERVE`` do not fit the card's free
# memory (`fitting_depth`); the reserve holds the f32 forward of
# `prefill_vs_forward` at ``QWEN25_PREFILL`` tokens, which took 12.0 GB
# over the weights on an H100 80GB HBM3: the head cast to f32 (3.1 GB),
# the f32 logits and their copies (2.5 GB each) and a layer's f32 weight
# copies (2.0 GB; the attention runs in query chunks of 512 past 2,048
# tokens).
QWEN25_ARGV = _serve_argv("qwen2_5_32b", 600, 16, "--kv-dtype", "f32")
QWEN25_PAGED_ARGV = _serve_argv("qwen2_5_32b", 600, 16, *PAGES_16,
                                "--kv-dtype", "bf16")
QWEN25_PREFILL = 4096
QWEN25_RESERVE = 12.5e9
# (phase, argv, the decode kernel of its attention layers)
DENSE_SERVE = [
    ("serve_phi3_mini", PHI3_ARGV, "decode_attention"),
    ("serve_phi3_mini_paged", PHI3_PAGED_ARGV, "paged_decode_attention"),
    ("serve_phi3_mini_int8", PHI3_INT8_ARGV, "quantized_decode_attention"),
    ("serve_phi3_mini_paged_int8", PHI3_PAGED_INT8_ARGV,
     "paged_quantized_decode_attention"),
    ("serve_internvl2", INTERNVL2_ARGV, "decode_attention"),
    ("serve_qwen2_5_32b", QWEN25_ARGV, "decode_attention"),
    ("serve_qwen2_5_32b_paged_bf16", QWEN25_PAGED_ARGV,
     "paged_decode_attention"),
]
# The serve runs whose decode shapes `family_kernel_cases` holds their
# layout's kernel (B1-B4) to its plain version at; Qwen2.5-32B's is the
# Qwen3-14B serve shape of `kernel_cases`.
FAMILY_DECODE = [MOE_ARGV, MOE_PAGED_ARGV, QWEN3_MOE_ARGV, JAMBA_ARGV,
                 PHI3_ARGV, PHI3_PAGED_ARGV, PHI3_INT8_ARGV,
                 PHI3_PAGED_INT8_ARGV, INTERNVL2_ARGV]
# (phase, arch, frames, or (patches, tokens), batch)
FRONTEND_PHASES = [("prefill_hubert", "hubert_xlarge", (1000, None), 2),
                   ("prefill_internvl2", "internvl2_2b", (1024, 512), 1)]
TF_REL = 1e-4                        # f32 decode vs forward, of max |logit|
# moe_expert_parallel: one Phi-3.5-MoE MoE layer at full width, 4 x 128
# tokens, the first 64 of each row one token (its two experts overflow)
MOE_EP_TOKENS, MOE_EP_REPEAT, MOE_EP_TOL = (4, 128), 64, 1e-5
# and at the serve runs' decode shape (batch 4, one token), host ms of a
# call over MOE_EP_CALLS calls
MOE_EP_DECODE, MOE_EP_CALLS = (4, 1), 50


def _flag(argv, flag, default):
    """``flag``'s value in ``argv``, else the CLI's ``default``."""
    return argv[argv.index(flag) + 1] if flag in argv else default


def _arch_cfg(configs, argv):
    """The config a serve ``argv`` runs: its arch's SMOKE one with
    ``--smoke``."""
    arch = _flag(argv, "--arch", None)
    return (configs.get_smoke if "--smoke" in argv else configs.get)(arch)


def _peak_gb(torch):
    return (round(torch.cuda.max_memory_allocated() / 1e9, 3)
            if torch.cuda.is_available() else None)


def family_decode_shape(configs, argv):
    """``(Hq, Hkv, dh, lengths, rows)`` of the decode kernel in the serve
    run of ``argv``: the arch's heads, four slots spread over the decode
    lengths from prompt + 1 to prompt + gen, the run's cache rows."""
    cfg = _arch_cfg(configs, argv)
    prompt = int(_flag(argv, "--prompt-len", 16))
    gen = int(_flag(argv, "--gen", 12))
    lengths = [prompt + 1, prompt + gen // 2, prompt + 3 * gen // 4,
               prompt + gen]
    return (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, lengths,
            prompt + gen + 8)


def family_kernel_cases(torch, configs, mods, flush):
    """The kernel of each family serve run's cache layout at its decode
    shape, bf16 q: B1 (Phi-3.5-MoE: g 4; Qwen3-MoE: g 16; Jamba SMOKE: g
    2, dh 16; Phi-3-mini: g 1, dh 96; InternVL2: g 2) and B2 (pages of 16:
    Phi-3.5-MoE, Phi-3-mini) over an f32 and a bf16 cache, B3 and B4 over
    an int8 one (Phi-3-mini), each held to its plain version at
    `row_errors`' tolerance, B2 also bitwise to B1 over the same rows."""
    decode = mods[0]
    cases = []
    for argv in FAMILY_DECODE:
        hq, hkv, dh, lengths, rows = family_decode_shape(configs, argv)
        paged = "--paged" in argv
        page_size = int(_flag(argv, "--page-size", 16)) if paged else None
        name = (_flag(argv, "--arch", None)
                + ("_smoke" if "--smoke" in argv else "") + "_serve"
                + ("_paged" if paged else ""))
        if _flag(argv, "--kv-dtype", "f32") == "int8":
            cases.append(new_kernel_case(
                torch, mods, flush,
                kernel=("paged_quantized_decode_attention" if paged
                        else "quantized_decode_attention"),
                name=name + "_int8", lengths=lengths, q_dtype=torch.bfloat16,
                kv_dtype=torch.int8, rows=rows, page_size=page_size, hq=hq,
                hkv=hkv, dh=dh))
            continue
        for kv_dtype in (torch.float32, torch.bfloat16):
            if paged:
                cases.append(new_kernel_case(
                    torch, mods, flush, kernel="paged_decode_attention",
                    name=name, lengths=lengths,
                    q_dtype=torch.bfloat16, kv_dtype=kv_dtype, rows=rows,
                    page_size=page_size, hq=hq, hkv=hkv, dh=dh))
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
    decode watchdog, under the CLI's `serve.serving_rules` (MoE layers
    take the expert exchange); every kernel's launch count set to 0 just
    before the loop and read just after.  Returns `cli_run`'s record with the server;
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
    device = _flag(argv, "--device", "cuda")
    with serve.serving_rules(device):
        server = serve.Server(cfg, batch, max_len, kv_dtype=kv_dtype,
                              device=device, paged=spec, prefill_len=prompt)
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
    and no other kernel at all.  The batch must come from the tuner's
    sweep where the CLI runs at ``--batch 0``, whose predicted step is
    printed beside the measured per-token p50.  Returns the streams, the
    summary and the server's weights (for the checks that reuse them)."""
    own = _arch_cfg(configs, argv)
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
    plan = check_serve._json_lines(log)[0]["serving_plan"]
    per_token = summary.get("per_token_ms") or {}
    out = {"argv": argv, "arch": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "attention_layers": attn,
           "depth_cut": None if depth is None else [own.num_layers, depth],
           "driven_by": "cli" if depth is None else "Server, serve_loop",
           "rules": "serve.serving_rules: a (1, 1) mesh, specs.rules_for",
           "rc": run["rc"], "host_wall_s": round(run["seconds"], 3),
           "card": card, "batch": summary.get("batch"),
           "batch_source": plan["source"],
           "predicted_step_us": plan.get("predicted_step_us"),
           "predicted_over_measured_p50": (
               plan["predicted_step_us"] / 1e3 / per_token["p50"]
               if plan.get("predicted_step_us") and per_token.get("p50")
               else None),
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
           "peak_memory_gb": _peak_gb(torch)}
    emit(phase, **out)
    check(run["rc"] == 0 and not problems, f"{phase} run failed: {problems}")
    swept = depth is None and int(_flag(argv, "--batch", 0)) == 0
    check(plan["source"] == ("autotune" if swept else "flag"),
          f"{phase}: the batch is not the one its argv asks for: {plan}")
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


def _host_ms(torch, fn, device, n: int) -> float:
    """Host ms a call of ``fn`` over ``n`` calls after a warm one, the
    device drained before and after: what a host-bound loop pays."""
    fn()
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(torch, device)
    return (time.perf_counter() - t0) / n * 1e3


def _syncs(torch, fn, device):
    """The device-to-host synchronisations one call of ``fn`` makes, as
    `torch.cuda.set_sync_debug_mode` reports them (None on the CPU)."""
    import warnings
    if torch.device(device).type != "cuda":
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def moe_expert_parallel(torch, configs, smi, device="cuda", cfg=None,
                        tokens=MOE_EP_TOKENS, repeat=MOE_EP_REPEAT) -> dict:
    """One MoE layer of Phi-3.5-MoE at full width (d_model 4096, 16
    experts of d_ff 6400, top 2), seeded f32 weights, ``MOE_EP_TOKENS``
    tokens whose first ``MOE_EP_REPEAT`` of each row are one token:
    `moe.apply_sharded` under the serve CLI's rules (`serving_rules`: a
    (1, 1) mesh, NCCL on a card; the expert exchange through the group)
    against its plain two-stage version, `apply_grouped` at the
    compounded capacity ``c_local`` (with one shard the send buffer of
    ``c_send`` slots holds every item), within ``MOE_EP_TOL``.  Reports
    the items each stage dropped, the items `apply_grouped`'s one-stage
    capacity (the JAX `Server`'s path) would drop, and each path's ms.
    At the serve runs' decode shape (``MOE_EP_DECODE``) the host ms of a
    call of each path (`apply_grouped` at its one-stage capacity, as the
    server without rules runs it) and of one exchange and one aux
    all-reduce over the group alone, and the synchronisations of each
    path."""
    import torch.distributed as dist
    from repro_torch.core.loadbalance import expert_capacity
    from repro_torch.launch import serve
    from repro_torch.models import moe
    cfg = cfg or configs.get("phi3_5_moe_42b")
    b, s = tokens
    t, d, k, e = b * s, cfg.d_model, cfg.top_k, cfg.num_experts
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe.moe_init(gen, cfg)
    x = torch.randn(b, s, d, generator=gen, device=device)
    x[:, :repeat] = x[0, 0]
    c_send = expert_capacity(t * k, 1, 1, cfg.capacity_factor)
    c_local = expert_capacity(c_send, e, 1, cfg.capacity_factor)
    one_stage = expert_capacity(t, e, k, cfg.capacity_factor)
    with serve.serving_rules(device):
        out, aux = moe.apply_sharded(params, x, cfg)
        ms = _timed_ms(torch, lambda: moe.apply_sharded(params, x, cfg),
                       device)
    want, want_aux = moe.apply_grouped(params, x.reshape(t, d), cfg,
                                       capacity=c_local)
    plain_ms = _timed_ms(torch, lambda: moe.apply_grouped(
        params, x.reshape(t, d), cfg, capacity=c_local), device)
    idx, _, _ = moe.route(params, x.reshape(t, d), cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    res = {"arch": cfg.name, "d_model": d, "experts": e, "top_k": k,
           "moe_d_ff": cfg.moe_d_ff, "tokens": [b, s], "device": str(device),
           "capacity_factor": cfg.capacity_factor, "c_send": c_send,
           "c_local": c_local, "one_stage_capacity": one_stage,
           "items": t * k, "items_per_expert": counts.tolist(),
           "send_stage_dropped": max(0, t * k - c_send),
           "expert_stage_dropped": int((counts - c_local).clamp(min=0)
                                       .sum()),
           "one_stage_dropped": int((counts - one_stage).clamp(min=0)
                                    .sum()),
           "max_abs_err": float((out.reshape(t, d) - want).abs().max()),
           "aux_abs_err": abs(float(aux) - float(want_aux)),
           "tolerance": MOE_EP_TOL, "ms": ms, "plain_ms": plain_ms,
           "nvidia_smi": smi}
    xd = torch.randn(*MOE_EP_DECODE, d, generator=gen, device=device)
    td = MOE_EP_DECODE[0] * MOE_EP_DECODE[1]
    rows = torch.zeros(expert_capacity(td * k, 1, 1, cfg.capacity_factor),
                       d, device=device)
    one = torch.ones((), device=device)

    def grouped():
        moe.apply_grouped(params, xd.reshape(td, d), cfg)

    def sharded():
        moe.apply_sharded(params, xd, cfg)

    def exchange():
        dist.all_to_all_single(torch.empty_like(rows), rows, group=group)

    def aux_mean():
        dist.all_reduce(one.clone(), group=group)

    with serve.serving_rules(device) as mesh:
        from repro_torch.launch.mesh import axis_group
        group = axis_group(mesh, "model")
        res["decode"] = {
            "tokens": list(MOE_EP_DECODE), "calls": MOE_EP_CALLS,
            "grouped_host_ms": _host_ms(torch, grouped, device,
                                        MOE_EP_CALLS),
            "sharded_host_ms": _host_ms(torch, sharded, device,
                                        MOE_EP_CALLS),
            "all_to_all_host_ms": _host_ms(torch, exchange, device,
                                           MOE_EP_CALLS),
            "all_reduce_host_ms": _host_ms(torch, aux_mean, device,
                                           MOE_EP_CALLS),
            "grouped_syncs": _syncs(torch, grouped, device),
            "sharded_syncs": _syncs(torch, sharded, device)}
    res["ok"] = (res["max_abs_err"] <= MOE_EP_TOL
                 and res["aux_abs_err"] <= MOE_EP_TOL
                 and res["expert_stage_dropped"] > 0)
    del params, x, xd, out, want
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def paged_run_vs_contiguous(torch, serve, lifecycle, cfg, params, argv,
                            paged_streams) -> dict:
    """The paged CLI run's streams against a contiguous server with its
    weights at the kernels' default span, as the paged run decodes: the
    same requests (the CLI's seeded prompts), batch, admission and
    sharding rules, so the streams must be equal."""
    import numpy as np
    prompt = int(argv[argv.index("--prompt-len") + 1])
    gen = int(argv[argv.index("--gen") + 1])
    n = int(argv[argv.index("--requests") + 1])
    device = params["embed"]["table"].device
    with serve.serving_rules(device):
        server = serve.Server(cfg, 4, prompt + gen + 8, params=params,
                              autotune_kernels=False, device=device)
        rng = np.random.default_rng(0)
        lc = lifecycle.Lifecycle()
        for rid in range(n):
            lc.submit(rid, rng.integers(0, cfg.vocab_size, size=prompt),
                      gen)
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
    pvc = paged_run_vs_contiguous(torch, serve, lifecycle, moe["cfg"],
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

    ep = moe_expert_parallel(torch, configs, card)
    emit("moe_expert_parallel", **ep)
    check(ep["ok"], f"expert parallelism != its plain version: {ep}")

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


def state_bytes(torch, tree) -> int:
    """Bytes of the tensors of a nested dict (meta tensors count too)."""
    from repro_torch import tree as tree_lib
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree)
               if isinstance(t, torch.Tensor))


def param_bytes(torch, cfg) -> int:
    """Bytes of ``transformer.init(cfg, ..., dtype=bf16)``'s tree, the
    serving CLI's weights, from its meta copy (`specs.abstract_params`):
    the leaves the init keeps in f32 at 4 bytes."""
    from repro_torch.launch import specs
    return state_bytes(torch, specs.abstract_params(cfg, torch.bfloat16))


def fitting_depth(torch, cfg, free_bytes, *, batch, rows,
                  reserve=QWEN25_RESERVE):
    """The most layers of ``cfg`` whose bf16 weights (`param_bytes`), an
    f32 cache of ``batch`` slots of ``rows`` rows and ``reserve`` bytes
    fit in ``free_bytes``; None when all of them do (no cut)."""
    from repro_torch.models import transformer

    def need(n):
        c = dataclasses.replace(cfg, num_layers=n)
        cache = transformer.cache_init(c, batch, rows, dtype=torch.float32,
                                       device="meta")
        return param_bytes(torch, c) + state_bytes(torch, cache)
    per_layer = need(2) - need(1)
    n = int((free_bytes - reserve - (need(1) - per_layer)) // per_layer)
    check(n >= 1, f"{cfg.name}: not one layer fits in {free_bytes} bytes")
    return None if n >= cfg.num_layers else n



def dense_phases(torch, serve, configs, check_serve, steps, transformer,
                 lifecycle, mods, card, device="cuda") -> dict:
    """The last dense configurations (ROADMAP F1, F3), each serve run of
    ``DENSE_SERVE`` through `family_serve` (the CLI at full width and
    depth; Qwen2.5-32B cut only where it does not fit):
    ``serve_phi3_mini*`` (Phi-3-mini-3.8B in every cache layout: B1-B4 at
    g 1, head_dim 96) with ``phi3_mini_vs_teacher_forcing`` (64 tokens
    one at a time through B1 in f32 against the cache-free forward, B1
    launched once per layer a step and nothing else) and
    ``phi3_mini_paged_vs_contiguous`` (the paged f32 run's streams equal
    a contiguous server's with its weights at the default span);
    ``serve_internvl2`` (InternVL2-2B's token stream, B1 at g 2); then,
    once every earlier phase's weights and caches are freed,
    ``qwen2_5_32b_memory`` (the card's free memory against the weights,
    the cache and ``QWEN25_RESERVE``, and the depth that fits),
    ``serve_qwen2_5_32b*`` (f32 contiguous, B1; paged bf16, B2) and
    ``prefill_qwen2_5_32b`` (`prefill_vs_forward` on the paged run's
    weights at ``QWEN25_PREFILL`` tokens: the bf16 logit bound at 2, 8,
    40 and 64 layers).  Returns each kernel's launches by phase."""
    launches: dict = {}
    depth = None                  # Qwen2.5-32B's cut, the last runs' own
    for phase, argv, kernel in DENSE_SERVE:
        if phase == "serve_qwen2_5_32b":
            depth = qwen25_memory(torch, _arch_cfg(configs, argv), device,
                                  card)
        res = family_serve(torch, serve, configs, check_serve, mods,
                           phase=phase, argv=argv, kernel=kernel,
                           depth=depth, card=card)
        launches.setdefault(kernel, {})[phase] = res["kernel_launches"]
        if phase == "serve_phi3_mini":
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            reset_launch_counts(mods)
            t0 = time.time()
            tf = decode_vs_forward(torch, transformer, res["cfg"],
                                   res["params"], tokens=PHI3_TF_TOKENS,
                                   device=device)
            counts = launch_counts(mods)
            b1 = counts.pop("decode_attention")
            want = PHI3_TF_TOKENS * res["attention_layers"]
            emit("phi3_mini_vs_teacher_forcing", card=card,
                 decode_launches=b1, other_kernel_launches=counts,
                 host_wall_s=round(time.time() - t0, 3),
                 peak_memory_gb=_peak_gb(torch), **tf)
            check(tf["ok"] and b1 == want and not any(counts.values()),
                  f"Phi-3-mini decode != teacher forcing, or {b1} B1 "
                  f"launches for {want} layer steps, others {counts}: {tf}")
            launches[kernel]["phi3_mini_vs_teacher_forcing"] = b1
        elif phase == "serve_phi3_mini_paged":
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            pvc = paged_run_vs_contiguous(torch, serve, lifecycle,
                                          res["cfg"], res["params"], argv,
                                          res["streams"])
            emit("phi3_mini_paged_vs_contiguous", card=card,
                 host_wall_s=round(time.time() - t0, 3),
                 peak_memory_gb=_peak_gb(torch), **pvc)
            check(pvc["ok"], f"Phi-3-mini paged and contiguous streams "
                             f"differ: {pvc}")
        elif phase == "serve_qwen2_5_32b_paged_bf16":
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            pvf = prefill_vs_forward(torch, steps, transformer, mods,
                                     res["cfg"], res["params"],
                                     QWEN25_PREFILL)
            emit("prefill_qwen2_5_32b", card=card, depth_cut=res["depth_cut"],
                 host_wall_s=round(time.time() - t0, 3),
                 peak_memory_gb=_peak_gb(torch), **pvf)
            check(pvf["ok"], f"prefill_qwen2_5_32b failed: {pvf}")
            launches.setdefault("flash_attention", {})[
                "prefill_qwen2_5_32b"] = pvf["flash_launches_prefill"]
        del res
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return launches


def qwen25_memory(torch, cfg, device, card):
    """Before Qwen2.5-32B's first init: the card's free memory
    (`torch.cuda.mem_get_info`, every earlier phase's weights and caches
    freed: under 1 GiB allocated) against its bf16 weights, the f32 cache
    of its serve runs and ``QWEN25_RESERVE``; returns the depth
    `fitting_depth` cuts it to (None: all its layers).  On the CPU
    nothing is cut."""
    rows = SERVE_LEN
    weights = param_bytes(torch, cfg)
    from repro_torch.models import transformer
    cache = state_bytes(torch, transformer.cache_init(
        cfg, 4, rows, dtype=torch.float32, device="meta"))
    free = total = allocated = depth = None
    if torch.device(device).type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        allocated = torch.cuda.memory_allocated()
        depth = fitting_depth(torch, cfg, free, batch=4, rows=rows)
    emit("qwen2_5_32b_memory", card=card, free_bytes=free,
         total_bytes=total, allocated_bytes=allocated, weight_bytes=weights,
         cache_bytes=cache, reserve_bytes=QWEN25_RESERVE,
         depth_cut=None if depth is None else [cfg.num_layers, depth])
    check(allocated is None or allocated < 2 ** 30,
          f"{allocated} bytes of earlier phases still on the card")
    return depth


# --------------------------------------------------------------------------
# The paper's design flow (A15) and training on one card (A13)
# --------------------------------------------------------------------------

FLOW_KERNELS = {"quickstart": ("blocked_matmul", "ell_spmv|ell_spmv_blocked"),
                "spmv_pipeline": ("ell_spmv", "ell_spmv_blocked")}
TRAIN_PARITY_ARCHS = ("qwen3_14b", "phi3_5_moe_42b")
TRAIN_PARITY_REL = 1e-5              # of the step's largest |gradient|
TRAIN_STEP_ABS = 1e-5                # the parameters after a step
TRAIN_STEP_FLOOR = 1e-4              # of the largest |gradient|: below it
                                     # AdamW's first step is ill-conditioned
DANUBE_TRAIN = (4, 2048)             # batch x sequence
DANUBE_TIMED = 5                     # timed steps after one warm step
CUT_LAYERS = 4                       # train_resume_danube_cut's depth
CUT_TRAIN = (2, 2048)                # its batch x sequence
CUT_STEPS, CUT_CKPT, CUT_FAULT = 10, 6, 4
CUT_FAULT_EVERY = 4                  # the fault run's checkpoints: 4, 8
TRAIN_CLI = ["--arch", "qwen3_14b", "--smoke", "--batch", "8", "--seq", "64"]
TRAIN_CLI_STEPS = (30, 40)           # the first run, then --resume
TRAIN_LM_ARGV = ["--hundred-m", "--steps", "200"]


def design_flow_phase(torch, mods, phase: str, device="cuda") -> dict:
    """`examples.quickstart` or `examples.spmv_pipeline` on ``device`` in a
    fresh tuning cache, every launch count set to 0 just before and read
    just after.  Each kernel result must lie within its case's tolerance
    (the examples hold B6 to `matmul.ref.row_tolerance`, 1e-5 in f32, and
    B7/B8 to 1e-5 of each row's sum of |products|); on a card each kernel
    the example drives must have launched ("a|b": either)."""
    import os
    import tempfile

    from repro_torch.examples import quickstart, spmv_pipeline
    from repro_torch.kernels import autotune
    from repro_torch.kernels.matmul import kernel as mm
    run = {"quickstart": quickstart.run,
           "spmv_pipeline": spmv_pipeline.run}[phase]
    old = os.environ.get(autotune.CACHE_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[autotune.CACHE_ENV] = str(pathlib.Path(tmp) / "at.json")
        try:
            reset_launch_counts(mods)
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                res = run(device)
            seconds = time.time() - t0
            counts = launch_counts(mods)
            by_design = dict(mm.design_launches)
        finally:
            if old is None:
                os.environ.pop(autotune.CACHE_ENV, None)
            else:
                os.environ[autotune.CACHE_ENV] = old
    launches = {k: counts[k] for k in
                ("blocked_matmul", "ell_spmv", "ell_spmv_blocked")}
    launched = all(any(counts[k] > 0 for k in need.split("|"))
                   for need in FLOW_KERNELS[phase])
    out = {"device": str(device), "results": res, "launches": launches,
           "blocked_matmul_by_design": by_design,
           "seconds": round(seconds, 3),
           "last_line": buf.getvalue().strip().splitlines()[-1]}
    out["ok"] = (all(r["ok"] for r in res.values())
                 and (launched or torch.device(device).type == "cpu"))
    return out


def _train_batch(torch, cfg, batch: int, seq: int, step: int, device):
    from repro_torch.data import DataConfig, SyntheticSource
    src = SyntheticSource(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=1,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        num_patches=4 if cfg.frontend == "patch" else 0))
    return {k: torch.from_numpy(v).to(device)
            for k, v in src.batch(step, 0, 1).items()}


def train_step_parity(torch, configs, mods, device="cuda", archs=None
                      ) -> dict:
    """One f32 train step on ``device`` against the same step on the CPU
    (TF32 off), for Qwen3-14B's and Phi-3.5-MoE's SMOKE configs from
    seeded weights:

    - the loss and every gradient within 1e-5 of the step's largest
      |gradient| (each leaf's own worst ratio reported);
    - `adamw.update` of the CPU's gradients on both sides: the
      parameters within 1e-5;
    - `make_train_step` on ``device`` bitwise equal to ``device``'s own
      `loss_and_grads` followed by `adamw.update` (parameters, moments and
      step), so the step is its two parts, each held above;
    - the parameters after `make_train_step` on each side within 1e-5 on
      every element whose CPU gradient is at least ``TRAIN_STEP_FLOOR``
      of the largest.  AdamW's first step moves an element by
      ``lr g / (|g| + eps)``, about lr whatever |g|: a gradient error d
      (at most 1e-5 of the largest |g|) shifts it by at most
      ``lr eps d / g^2``, which above the floor is at most
      ``1e3 lr eps`` over the largest |g| (under 1e-5 whenever that
      exceeds 1e-9), but where |g| is near eps or near d the shift reaches
      lr.  The elements below the floor are counted, and their largest
      difference reported;
    - the flash kernel (no backward) never launched."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw

    def clone(tree):
        return tree_lib.map_structure(lambda t: t.clone(), tree)

    rows = []
    for arch in archs or TRAIN_PARITY_ARCHS:
        cfg = configs.get_smoke(arch)
        opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
        host = transformer.init(cfg, torch.Generator().manual_seed(0))
        batches = {"cpu": _train_batch(torch, cfg, 4, 32, 0, "cpu")}
        batches["card"] = {k: v.to(device)
                           for k, v in batches["cpu"].items()}
        sides = {"cpu": host,
                 "card": tree_lib.map_structure(lambda t: t.to(device),
                                                host)}
        reset_launch_counts(mods)
        results = {dev: steps.loss_and_grads(cfg, params, batches[dev],
                                             compute_dtype=torch.float32)
                   for dev, params in sides.items()}
        (l_cpu, _, _, g_cpu), (l_card, _, _, g_card) = (results["cpu"],
                                                        results["card"])
        gc_ = tree_lib.leaves(g_cpu)
        gd_ = [g.cpu() for g in tree_lib.leaves(g_card)]
        step_max = max(float(g.abs().max()) for g in gc_)
        errs = [float((a - b).abs().max()) for a, b in zip(gc_, gd_)]
        leaf_rel = max(e / max(float(a.abs().max()), 1e-30)
                       for e, a in zip(errs, gc_))
        # the optimizer alone: the CPU's gradients on both sides
        updated = {}
        for dev, params in sides.items():
            p = clone(params)
            g = tree_lib.map_structure(
                lambda t: t.to(p["embed"]["table"].device), g_cpu)
            adamw.update(p, g, adamw.init_state(p, opt), opt)
            updated[dev] = p
        upd_err = max(float((a - b.cpu()).abs().max()) for a, b in zip(
            tree_lib.leaves(updated["cpu"]), tree_lib.leaves(updated["card"])))
        # the whole step on each side
        after, total = {}, {}
        for dev, params in sides.items():
            p = clone(params)
            st = {"params": p, "opt": adamw.init_state(p, opt)}
            _, m = steps.make_train_step(
                cfg, opt, compute_dtype=torch.float32)(st, batches[dev])
            after[dev], total[dev] = st, float(m["total_loss"])
        lr = float(m["lr"])
        # the card's step against its own parts
        p = clone(sides["card"])
        s = adamw.init_state(p, opt)
        *_, g = steps.loss_and_grads(cfg, p, batches["card"],
                                     compute_dtype=torch.float32)
        adamw.update(p, g, s, opt)
        composed = _bitwise(torch, after["card"], {"params": p, "opt": s})
        del p, s, g
        floor = TRAIN_STEP_FLOOR * step_max
        kept_err = below_err = 0.0
        below = n = 0
        for a, b, g in zip(tree_lib.leaves(after["cpu"]["params"]),
                           tree_lib.leaves(after["card"]["params"]), gc_):
            d = (a - b.cpu()).abs()
            small = g.abs() < floor
            below += int(small.sum())
            n += d.numel()
            if (~small).any():
                kept_err = max(kept_err, float(d[~small].max()))
            if small.any():
                below_err = max(below_err, float(d[small].max()))
        flash_launches = launch_counts(mods)["flash_attention"]
        row = {"arch": cfg.name, "loss_cpu": float(l_cpu),
               "loss_card": float(l_card),
               "loss_rel_err": abs(float(l_cpu) - float(l_card))
               / abs(float(l_cpu)),
               "grad_max_abs_err": max(errs), "grad_max": step_max,
               "grad_worst_leaf_rel": leaf_rel,
               "update_max_abs_err": upd_err,
               "step_is_its_parts_bitwise": composed,
               "step_grad_floor": floor,
               "step_params_max_abs_err": kept_err,
               "step_params_below_floor": below, "step_params": n,
               "step_params_below_floor_max_abs_err": below_err, "lr": lr,
               "flash_launches": flash_launches}
        row["ok"] = (row["loss_rel_err"] <= TRAIN_PARITY_REL
                     and max(errs) <= TRAIN_PARITY_REL * step_max
                     and upd_err <= TRAIN_STEP_ABS and composed
                     and kept_err <= TRAIN_STEP_ABS
                     and total["card"] == float(l_card)
                     and flash_launches == 0)
        rows.append(row)
    return {"rows": rows, "ok": all(r["ok"] for r in rows)}


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed_ms(torch, fn, device, reps: int = 3) -> float:
    """Mean ms of ``reps`` calls of ``fn``: between CUDA events on a card,
    on the host clock on the CPU."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reduce_costs(torch, leaves, group, device) -> dict:
    """What the data-parallel reduce of a gradient tree's ``leaves``
    costs on ``group``: one `all_reduce` a leaf (the train step's) and
    `compressed_psum` a leaf, each the mean ms of 3 passes over the tree
    after a warm one."""
    import torch.distributed as dist

    from repro_torch.parallel.compression import compressed_psum

    def all_reduce():
        for g in leaves:
            dist.all_reduce(g, group=group)

    def compressed():
        for g in leaves:
            compressed_psum(g, group)

    return {"grad_bytes": sum(g.numel() * g.element_size() for g in leaves),
            "grad_leaves": len(leaves),
            "all_reduce_ms": _timed_ms(torch, all_reduce, device),
            "compressed_psum_ms": _timed_ms(torch, compressed, device)}


def train_danube(torch, configs, mods, smi, cfg=None, shape=DANUBE_TRAIN,
                 timed=DANUBE_TIMED, device="cuda") -> dict:
    """H2O-Danube-1.8B at full width and depth (``remat="full"``, its
    config's), seeded f32 weights and f32 AdamW moments (the policy's
    below 100 G parameters) placed by `launch.train.build_state` on the
    trainer CLI's mesh, a one-rank ``(1, 1)`` mesh (NCCL on a card) by
    `specs.param_pspecs` / `opt_pspecs`, and `make_train_step` on it (the
    data-parallel step; bf16 compute) on ``shape`` batches of
    `SyntheticSource`: one warm step, then ``timed`` steps, each ended by
    a synchronise.  Reports the median step ms, tokens/s, peak memory,
    every step's loss and grad norm, the flash kernel's launches (must be
    0) and the bound: 8 N T operations (6 N T for the forward and
    backward, 2 N T for the recomputed forward) at the bf16 peak, beside
    the bytes of reading and writing the state once; and the f32
    attention's operations at the f32 peak, which the bf16 bound leaves
    out.  `reduce_costs` of the last step's gradient tree: what its
    one-rank all-reduce adds to a step, and `compressed_psum`'s time on
    it.  One more step under `torch.profiler` gives device time by
    kernel.  One more step is counted (`hlo_stats.count_step`) where it
    runs and on meta in a process of its own (`meta_train_count_process`),
    under ``dryrun_counts``, with the flash kernel's launches in it."""
    import statistics

    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.core import cost_model
    from repro_torch.launch import policy, specs, steps
    from repro_torch.launch.mesh import axis_group, make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.optim import adamw
    cfg = cfg or configs.get("h2o_danube_1_8b")
    b, s = shape
    opt = adamw.AdamWConfig(peak_lr=1e-4, warmup_steps=2,
                            total_steps=timed + 2,
                            moment_dtype=policy.moment_dtype(cfg))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(device_type=torch.device(device).type)
    rules = specs.rules_for(mesh)
    state = build_state(cfg, opt, 0, device, mesh, rules)
    step = steps.make_train_step(cfg, opt, mesh=mesh, rules=rules)
    reset_launch_counts(mods)
    times, losses, norms = [], [], []
    for t in range(timed + 1):
        batch = _train_batch(torch, cfg, b, s, t, device)
        _sync(torch, device)
        t0 = time.perf_counter()
        # the last step's gradients are kept for `reduce_costs`
        state, m, *grads = step(state, batch, return_grads=t == timed)
        _sync(torch, device)
        dt = time.perf_counter() - t0
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if t:
            times.append(dt)
    flash_launches = launch_counts(mods)["flash_attention"]
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    costs = reduce_costs(torch, tree_lib.leaves(grads[0]),
                         axis_group(mesh, ("data",)), device)
    del grads
    kernels = []
    if torch.device(device).type == "cuda":
        batch = _train_batch(torch, cfg, b, s, timed + 1, device)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
        kernels = _by_kernel(torch, prof)[:TOP_KERNELS]
    n = cfg.param_count()
    tokens = b * s
    ops = cost_model.model_flops_train(n, tokens) + \
        cost_model.model_flops_decode(n, tokens)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_lib.leaves(state))
    # QK^T and PV, 2 b H s^2 dh operations each, in the forward, the
    # recomputed forward and the backward (twice the forward's)
    attn_ops = (2 * 2 * b * cfg.num_heads * s * s * cfg.head_dim * 4
                * cfg.num_layers)
    med = statistics.median(times) if times else None
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": n, "batch": b, "seq": s,
           "remat": cfg.remat, "device": str(device),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": dist.get_backend(),
           "step_ms": [round(x * 1e3, 3) for x in times],
           "step_ms_median": None if med is None else med * 1e3,
           "tokens_per_s": None if med is None else tokens / med,
           "losses": losses, "grad_norms": norms,
           "max_memory_allocated": peak,
           "peak_gb": None if peak is None else peak / 1e9,
           "state_bytes": state_bytes, **costs,
           "bound_ops": ops, "bound_ms": ops / PEAK_OPS_PER_S["bfloat16"]
           * 1e3, "bound_bytes_ms": 2 * state_bytes / HBM_BYTES_PER_S * 1e3,
           "attention_f32_ops": attn_ops,
           "attention_f32_ms": attn_ops / PEAK_OPS_PER_S["float32"] * 1e3,
           "flash_launches": flash_launches, "kernels": kernels,
           "nvidia_smi": smi}
    res["ok"] = (all(math.isfinite(x) for x in losses + norms)
                 and flash_launches == 0 and len(times) == timed)
    batch = _train_batch(torch, cfg, b, s, timed + 2, device)
    reset_launch_counts(mods)
    card = counted(torch, step, state, batch)
    launches = {"flash_attention": launch_counts(mods)["flash_attention"]}
    meta = meta_train_count_process(cfg, shape, opt)
    pair = {"card": card, "meta": meta,
            "compare": compare_counts(card, meta)}
    bound = step_bound(cfg, card, kind="train", batch=b, seq=s,
                       param_bytes=4, moment_bytes=4.0)
    res["dryrun_counts"] = with_bound(pair, res["step_ms_median"], bound,
                                      launches)
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def train_mesh_parity(torch, configs, mods, smi, cfg=None, shape=CUT_TRAIN,
                      device="cuda") -> dict:
    """H2O-Danube-1.8B at full width cut to ``CUT_LAYERS`` layers (the
    resume phase's cut), one step from the same seeded state and batch
    through the trainer CLI's path (`build_state` on a one-rank ``(1,
    1)`` mesh, NCCL on a card; the data-parallel step) and through the
    plain step:

    - loss, total loss, every gradient and every updated leaf bitwise;
    - with ``grad_dtype=bfloat16`` the reduced gradients bitwise the f32
      ones rounded to bf16;
    - `compressed_psum` of the f32 gradient tree over the group within
      each 256-block's scale/2 (the block's largest |g| / 254, plus 2^-23
      of it for f32's rounding of the dequantized value) of the tree:
      the worst ratio to that bound is reported (at most 1), and
      `reduce_costs` of the tree.
    The flash kernel never launches."""
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.launch import policy, specs, steps
    from repro_torch.launch.mesh import axis_group, make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.optim import adamw
    from repro_torch.parallel.compression import QBLOCK, compressed_psum
    cfg = cfg or dataclasses.replace(configs.get("h2o_danube_1_8b"),
                                     num_layers=CUT_LAYERS)
    b, s = shape
    opt = adamw.AdamWConfig(peak_lr=1e-4, warmup_steps=2,
                            total_steps=CUT_STEPS,
                            moment_dtype=policy.moment_dtype(cfg))
    mesh = make_host_mesh(device_type=torch.device(device).type)
    rules = specs.rules_for(mesh)
    group = axis_group(mesh, ("data",))
    batch = _train_batch(torch, cfg, b, s, 0, device)
    reset_launch_counts(mods)
    plain = build_state(cfg, opt, 0, device)
    plain, m0, g0 = steps.make_train_step(cfg, opt)(plain, batch,
                                                     return_grads=True)
    meshed = build_state(cfg, opt, 0, device, mesh, rules)
    meshed, m1, g1 = steps.make_train_step(cfg, opt, mesh=mesh, rules=rules)(
        meshed, batch, return_grads=True)
    g0, g1 = tree_lib.leaves(g0), tree_lib.leaves(g1)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b, "seq": s,
           "device": str(device), "backend": dist.get_backend(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "loss": float(m0["loss"]),
           "loss_bitwise": (torch.equal(m0["loss"], m1["loss"])
                            and torch.equal(m0["total_loss"],
                                            m1["total_loss"])),
           "grads_bitwise": all(torch.equal(a, c) for a, c in zip(g0, g1)),
           "state_bitwise": _bitwise(torch, plain, tree_lib.map_structure(
               lambda t: t.to_local(), meshed))}
    del plain, meshed, g1
    bf = build_state(cfg, opt, 0, device, mesh, rules)
    bf, _, g2 = steps.make_train_step(
        cfg, opt, mesh=mesh, rules=rules, grad_dtype=torch.bfloat16)(
            bf, batch, return_grads=True)
    out["bf16_grads_bitwise"] = all(
        torch.equal(a.to(torch.bfloat16), c)
        for a, c in zip(g0, tree_lib.leaves(g2)))
    del bf, g2
    worst = 0.0
    for g in g0:
        pad = (-g.numel()) % QBLOCK
        blocks = torch.nn.functional.pad(g.reshape(-1), (0, pad))
        blocks = blocks.reshape(-1, QBLOCK)
        err = torch.nn.functional.pad(
            (compressed_psum(g, group) - g).reshape(-1), (0, pad))
        top = blocks.abs().amax(dim=1, keepdim=True)
        half = top / 127 / 2 + top * 2.0 ** -23   # + f32 rounding
        ratio = torch.where(half > 0, err.reshape(-1, QBLOCK).abs() / half,
                            err.reshape(-1, QBLOCK).abs() * float("inf"))
        worst = max(worst, float(torch.nan_to_num(ratio, nan=0.0).max()))
    out["compressed_worst_ratio_to_half_scale"] = worst
    out.update(reduce_costs(torch, g0, group, device))
    out["flash_launches"] = launch_counts(mods)["flash_attention"]
    out["nvidia_smi"] = smi
    out["ok"] = (out["loss_bitwise"] and out["grads_bitwise"]
                 and out["state_bitwise"] and out["bf16_grads_bitwise"]
                 and worst <= 1.0 and out["flash_launches"] == 0)
    del g0
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _bitwise(torch, a, b) -> bool:
    from repro_torch import tree as tree_lib
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def train_resume_cut(torch, configs, mods, cfg=None, shape=CUT_TRAIN,
                     device="cuda", state_root=STATE_ROOT) -> dict:
    """H2O-Danube-1.8B at full width cut to ``CUT_LAYERS`` layers (built
    with `dataclasses.replace`): ten steps through `run_resilient` with a
    `CheckpointManager` checkpointing at step 6 (and at its end); the
    checkpoint restored and steps 6..9 replayed must end bitwise in the
    uninterrupted run's state; then a run whose ``fault_hook`` raises at
    step 4, checkpointing every 4 steps, recovers through ``on_restore``
    (the step-4 checkpoint, written just before the fault, restored) and
    ends in the same state.  The uninterrupted state is kept on the
    device for the comparisons.  The state directory is removed after."""
    import shutil

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import policy, steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                     run_resilient)
    cfg = cfg or dataclasses.replace(configs.get("h2o_danube_1_8b"),
                                     num_layers=CUT_LAYERS)
    b, s = shape
    opt = adamw.AdamWConfig(peak_lr=1e-4, warmup_steps=2,
                            total_steps=CUT_STEPS,
                            moment_dtype=policy.moment_dtype(cfg))
    step = steps.make_train_step(cfg, opt)
    root = state_root / "train_resume_danube_cut"
    shutil.rmtree(root, ignore_errors=True)

    def fresh():
        p = transformer.init(cfg, torch.Generator(device=device)
                             .manual_seed(0), dtype=policy.param_dtype(cfg))
        return {"params": p, "opt": adamw.init_state(p, opt)}

    def batch_fn(t):
        return _train_batch(torch, cfg, b, s, t, device)

    out = {"arch": cfg.name, "layers": cfg.num_layers, "params":
           cfg.param_count(), "batch": b, "seq": s, "device": str(device)}
    try:
        reset_launch_counts(mods)
        ckpt = CheckpointManager(root / "run", keep=2)
        t0 = time.time()
        state, history, _ = run_resilient(
            step, fresh(), CUT_STEPS, ckpt, batch_fn,
            config=ResilienceConfig(checkpoint_every=CUT_CKPT))
        out["run_s"] = round(time.time() - t0, 3)
        out["losses"] = [h["loss"] for h in history]
        want = state
        del state
        # `restore` reads only a template's keys
        like = tree_lib.map_structure(lambda _: None, want)
        meta_dir = root / "run" / f"step_{CUT_CKPT:010d}"
        out["checkpoint_bytes"] = sum(f.stat().st_size
                                      for f in meta_dir.glob("*.npy"))
        t0 = time.time()
        restored, meta = ckpt.restore(CUT_CKPT, like, device)
        out["restore_s"] = round(time.time() - t0, 3)
        for t in range(meta["step"], CUT_STEPS):
            restored, _ = step(restored, batch_fn(t))
        out["replay_bitwise"] = _bitwise(torch, restored, want)
        del restored
        gc.collect()

        ckpt2 = CheckpointManager(root / "fault", keep=1)
        fired = []

        def fault_hook(t):
            if t == CUT_FAULT and not fired:
                fired.append(t)
                raise RuntimeError("injected fault")

        restored_at = []

        def on_restore(_t):
            st, m = ckpt2.restore(None, like, device)
            restored_at.append(m["step"])
            return st, m["step"]

        t0 = time.time()
        state, history, _ = run_resilient(
            step, fresh(), CUT_STEPS, ckpt2, batch_fn,
            config=ResilienceConfig(checkpoint_every=CUT_FAULT_EVERY),
            fault_hook=fault_hook, on_restore=on_restore)
        out["fault_run_s"] = round(time.time() - t0, 3)
        out["fault_fired_at"] = fired
        out["restored_at"] = restored_at
        out["fault_steps_run"] = [h["step"] for h in history]
        out["fault_bitwise"] = _bitwise(torch, state, want)
        out["final_ckpt"] = ckpt2.latest_step()
        del state, want
        out["flash_launches"] = launch_counts(mods)["flash_attention"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out["ok"] = (out["replay_bitwise"] and out["fault_bitwise"]
                 and fired == [CUT_FAULT] and restored_at == [CUT_FAULT]
                 and out["final_ckpt"] == CUT_STEPS
                 and out["flash_launches"] == 0
                 and all(math.isfinite(x) for x in out["losses"]))
    return out


def train_cli(torch, cli=(), state_root=STATE_ROOT) -> dict:
    """`repro_torch.launch.train` in two processes: ``TRAIN_CLI`` for 30
    steps, then ``--resume`` to 40.  Each must exit 0 and print the
    reference's JSON keys; the second must say it resumed from step 30,
    run 10 steps and end at checkpoint 40, its first loss below the first
    run's first (it continues a trained state).  Tokens/s from each run's
    ``wall_s``.  The checkpoint directory is removed after."""
    import os
    import shutil
    root = state_root / "train_cli"
    shutil.rmtree(root, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = []
    try:
        for n, extra in zip(TRAIN_CLI_STEPS, ([], ["--resume"])):
            argv = [sys.executable, "-m", "repro_torch.launch.train",
                    *TRAIN_CLI, "--steps", str(n), "--ckpt-dir", str(root),
                    "--ckpt-every", "10", *cli, *extra]
            t0 = time.time()
            p = subprocess.run(argv, capture_output=True, text=True,
                               env=env, cwd=ROOT, timeout=600)
            lines = p.stdout.strip().splitlines()
            rec = json.loads(lines[-1]) if p.returncode == 0 else {}
            runs.append({"rc": p.returncode, "process_s":
                         round(time.time() - t0, 3), "summary": rec,
                         "first_line": lines[0] if lines else None,
                         "stderr_tail": p.stderr[-2000:]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batch, seq = int(_flag(TRAIN_CLI, "--batch", 8)), int(
        _flag(TRAIN_CLI, "--seq", 64))
    for r in runs:
        s = r["summary"]
        if s.get("wall_s"):
            r["tokens_per_s"] = s["steps"] * batch * seq / s["wall_s"]
    a, b = (r["summary"] for r in runs)
    keys = {"arch", "steps", "wall_s", "first_loss", "last_loss",
            "stragglers", "final_ckpt"}
    ok = (all(r["rc"] == 0 for r in runs) and set(a) == keys
          and set(b) == keys and a["steps"] == TRAIN_CLI_STEPS[0]
          and a["final_ckpt"] == TRAIN_CLI_STEPS[0]
          and runs[1]["first_line"] == f"resumed from step "
                                       f"{TRAIN_CLI_STEPS[0]}"
          and b["steps"] == TRAIN_CLI_STEPS[1] - TRAIN_CLI_STEPS[0]
          and b["final_ckpt"] == TRAIN_CLI_STEPS[1]
          and b["first_loss"] < a["first_loss"]
          and a["last_loss"] < a["first_loss"])
    return {"runs": runs, "ok": ok}


def train_lm_phase(torch, argv=TRAIN_LM_ARGV, state_root=STATE_ROOT
                   ) -> dict:
    """`examples.train_lm` (``--hundred-m --steps 200`` on the card): its
    JSON, the loss falling by 10 % (``loss_last < 0.9 loss_first``, as the
    reference's test of its trainer), tokens/s."""
    import shutil

    from repro_torch.examples import train_lm
    root = state_root / "train_lm"
    shutil.rmtree(root, ignore_errors=True)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = train_lm.main([*argv, "--ckpt-dir", str(root)])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = {**res, "first_line": buf.getvalue().splitlines()[0]}
    res["ok"] = (res["loss_last"] < 0.9 * res["loss_first"]
                 and res["steps"] == int(_flag(argv, "--steps", 200)))
    return res


def training_phases(torch, configs, mods, smi, counts) -> dict:
    """The design flow's and training's phases in order, one after
    another, each emitted with its seconds and checked; returns B6-B8's
    launches by design-flow phase.  A phase's ``dryrun_counts`` goes to
    ``counts`` under the phase's name, not to its line."""
    phases = [
        ("quickstart", lambda: design_flow_phase(torch, mods, "quickstart")),
        ("spmv_pipeline",
         lambda: design_flow_phase(torch, mods, "spmv_pipeline")),
        ("train_step_parity", lambda: train_step_parity(torch, configs,
                                                        mods)),
        ("train_danube", lambda: train_danube(torch, configs, mods, smi)),
        ("train_mesh_parity",
         lambda: train_mesh_parity(torch, configs, mods, smi)),
        ("train_resume_danube_cut",
         lambda: train_resume_cut(torch, configs, mods)),
        ("train_cli", lambda: train_cli(torch)),
        ("train_lm", lambda: train_lm_phase(torch)),
    ]
    flow = {}
    for phase, run in phases:
        t0 = time.time()
        res = run()
        if "dryrun_counts" in res:
            counts[phase] = res.pop("dryrun_counts")
        emit(phase, phase_s=round(time.time() - t0, 3), **res)
        check(res["ok"], f"{phase} failed: " + json.dumps(
            {k: v for k, v in res.items() if k != "kernels"}))
        if "launches" in res:
            flow[phase] = res["launches"]
    return {kernel: {phase: n[kernel] for phase, n in flow.items()}
            for kernel in ("blocked_matmul", "ell_spmv", "ell_spmv_blocked")}


# --------------------------------------------------------------------------
# Tensor and expert parallelism over the model axis: two ranks on one card
# --------------------------------------------------------------------------

TP_RANKS = 2                         # ranks of the (1, 2) mesh, one card
TP_LAYERS = 2                        # the depth cut of the models
TP_TRAIN = (2, 256)                  # batch x sequence of a train step
TP_PREFILL = 1024                    # tokens of the per-rank-heads prefill
TP_DECODE_LENGTHS = [0, 100, 127, 130]   # slots straddling the segments
TP_DECODE_ROWS = 256                 # cache rows, two segments of 128
TP_DECODE_STEPS = 16
# Phi-3.5-MoE: 16 experts, top 2, 512 tokens a step.  At a capacity
# factor of 4 an expert takes 256 items on one rank (64 on average), and
# on two ranks a shard's send buffer takes every item a rank routes and
# its experts 1,024 each: the phase counts the drops, which must be 0.
TP_MOE_CAPACITY = 4.0
TP_TIMEOUT = 600                     # seconds for both ranks
TP_REL = 1e-5                        # f32: of the largest |value|
TP_PAGE = 16                         # tokens a page of the paged pools
# Mamba alone at Jamba-1.5-Large's width: batch x sequence of its forward
TP_MAMBA = (2, 256)
# Mamba's gradients through the scan pass through the bf16 rounding of B
# and C (the reference's scan streams, ROADMAP queue C): the split sums
# B's and C's gradients over d_in in another f32 order, and a sum near a
# rounding boundary rounds one bf16 ulp apart.  At Jamba-1.5-Large's
# width on an H100 (700 W) the split reads 3.7e-5 and 5.8e-5 of the
# largest gradient on its two ranks (x's 1.2e-5; x_proj's 1.6e-4 and
# 1.8e-4 of its own largest), and a split that rounds each rank's part of
# those gradients before the ranks' sum 7.6e-4 and 6.1e-4 (x's 1.5e-4;
# x_proj's 3.3e-3 and 2.8e-3): the limits lie between.  At SMOKE width
# that fault shows only on x_proj (4.9e-3 and 1.2e-3 of its own largest
# against 2.7e-5 and 9.4e-6 on the CPU), hence the limit on each leaf
# (`test_mamba_parallel_fails_gradients_rounded_on_each_rank`).  out_proj's and D's
# gradients do not pass through the scan: TP_REL of their own largest.
TP_MAMBA_GRAD = 2.5e-4               # every gradient, of the largest of all
TP_MAMBA_DX = 4e-5                   # x's gradient, of its largest
TP_MAMBA_LEAF = 5e-4                 # each gradient, of its own largest
MAMBA_OUTSIDE_SCAN = ("out_proj", "D")


def _rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|, over trees of tensors."""
    from repro_torch import tree as tree_lib
    got, want = tree_lib.leaves(got), tree_lib.leaves(want)
    top = max(float(w.abs().max()) for w in want)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    return err / max(top, 1e-30)


def _timed_collectives(torch, fn) -> dict:
    """``fn()`` with each `torch.distributed` collective the step calls
    timed alone (the card synchronised around it, so the step itself runs
    slower): ms and calls per operation."""
    import torch.distributed as dist
    names = ("all_reduce", "all_gather", "all_to_all_single")
    real = {n: getattr(dist, n) for n in names}
    spent = {n: [0.0, 0] for n in names}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            spent[name][0] += (time.perf_counter() - t0) * 1e3
            spent[name][1] += 1
            return out
        return run

    for n in names:
        setattr(dist, n, timed(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(dist, n, real[n])
    return {n: {"ms": round(ms, 3), "calls": c}
            for n, (ms, c) in spent.items() if c}


def _counted_drops(moe):
    """A wrapper of `moe._dispatch_indices` that counts the real items it
    drops, by its number of groups (the local stage's last group is the
    phantom one of invalid slots, whose items are not counted)."""
    real = moe._dispatch_indices
    dropped: dict = {}

    def run(flat_e, num_groups, capacity):
        slot, keep = real(flat_e, num_groups, capacity)
        lost = ~keep
        if getattr(run, "phantom", None) == num_groups:
            lost = lost & (flat_e != num_groups - 1)
        dropped[num_groups] = dropped.get(num_groups, 0) + int(lost.sum())
        return slot, keep

    return run, dropped


def _split_aux(moe, b: int, s: int, n: int):
    """A wrapper of `moe.route` for the one-rank step held to the step over
    ``n`` model ranks: the aux of a batch of ``b`` x ``s`` tokens is the
    mean of the aux of its ``n`` sequence blocks, which is what
    `moe.apply_sharded` computes where the tokens split by sequence over
    the model axis (the reference's ``pmean`` of each shard's aux); the
    load-balancing aux of the whole batch is another number.  The routing
    is the real one's."""
    real = moe.route

    def run(params, x, cfg):
        idx, weights, aux = real(params, x, cfg)
        if x.shape[0] != b * s:
            return idx, weights, aux
        blocks = x.reshape(b, n, s // n, x.shape[-1])
        return idx, weights, sum(
            real(params, blocks[:, r].reshape(-1, x.shape[-1]), cfg)[2]
            for r in range(n)) / n

    return run


def _tp_state(torch, cfg, opt, mesh, rules, params) -> dict:
    """`launch.train.build_state`'s state on ``mesh`` from its whole
    ``params``, leaf by leaf: each moment is drawn whole and cut to this
    rank's block one leaf at a time, so the whole moments never exist at
    once."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import specs
    from repro_torch.parallel import sharding as shd
    _, pspecs = specs.state_pspecs(cfg, opt, mesh, rules)
    dev = tree_lib.leaves(params)[0].device

    def zeros(p, spec):
        return shd.distribute(torch.zeros(p.shape, dtype=torch.float32,
                                          device=dev), spec, mesh)

    blocks = tree_lib.map_structure(
        lambda t, spec: shd.distribute(t, spec, mesh), params,
        pspecs["params"])
    return {"params": blocks,
            "opt": {"step": shd.distribute(torch.zeros(
                        (), dtype=torch.int32, device=dev), (), mesh),
                    "m": tree_lib.map_structure(zeros, blocks,
                                                pspecs["opt"]["m"]),
                    "v": tree_lib.map_structure(zeros, blocks,
                                                pspecs["opt"]["v"])}}


def tp_decode_run(torch, mods, cfg, params, mesh, dev, kv_dtype=None,
                  paged=False) -> dict:
    """``TP_DECODE_STEPS`` greedy decode steps of ``cfg`` under
    `decode_rules` on ``mesh`` from this rank's block of a random cache
    (`transformer.cache_block`) against the one-rank decode of the whole
    cache, tokens equal.  ``kv_dtype`` (f32 by default) is the attention
    cache's type; ``paged`` makes it a pool of ``TP_PAGE``-token pages
    through a shuffled page table.  Records whether the rows split, the
    decode kernels' launches in the split run (``mods``: the `decode` and
    `decode_int8` modules) and, for the paged kernels, whether every call
    read a view of the cache's own pool and a strided one (no copy)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import specs, steps
    from repro_torch.models import transformer
    from repro_torch.runtime.paging import PageSpec
    decode, decode_int8 = mods
    f32 = torch.float32
    kv_dtype = kv_dtype or f32
    counters = {"decode_attention": (decode, "launches"),
                "paged_decode_attention": (decode, "paged_launches"),
                "quantized_decode_attention": (decode_int8, "launches"),
                "paged_quantized_decode_attention": (decode_int8,
                                                     "paged_launches")}

    def launched():
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    lengths = TP_DECODE_LENGTHS
    nb = len(lengths)
    spec = (PageSpec(TP_PAGE, nb * TP_DECODE_ROWS // TP_PAGE,
                     TP_DECODE_ROWS // TP_PAGE) if paged else None)
    cache = transformer.cache_init(cfg, nb, TP_DECODE_ROWS, dtype=kv_dtype,
                                   device=dev, paged=spec)
    g = torch.Generator(device=dev).manual_seed(3)
    for leaf in tree_lib.leaves(cache["blocks"]):
        leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g,
                                 device=dev)
                   if leaf.dtype == torch.int8 else
                   torch.randn(leaf.shape, generator=g, device=dev))
    if paged:
        cache["pages"].copy_(torch.randperm(
            spec.num_pages, generator=torch.Generator().manual_seed(3))
            .reshape(nb, -1))
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tok0 = torch.randint(0, cfg.vocab_size, (nb, 1), generator=g,
                         device=dev, dtype=torch.int32)
    drules = specs.rules_for(mesh, ShapeSpec("d", "decode", TP_DECODE_ROWS,
                                             nb))
    mine = transformer.cache_block(cfg, cache, drules, mesh)
    one = steps.make_serve_step(cfg, f32, paged=spec)
    split = steps.make_serve_step(cfg, f32, paged=spec, mesh=mesh,
                                  rules=drules)
    pools = {leaf.untyped_storage().data_ptr()
             for leaf in tree_lib.leaves(mine["blocks"])}
    views = []                         # (a view of the pool, strided)
    wrapped = ((decode, "paged_gqa_decode_attention"),
               (decode_int8, "paged_quantized_gqa_decode_attention"))
    real = [getattr(m, n) for m, n in wrapped]

    def seen_pool(fn):
        def run(q, k_pool, *rest, **kw):
            views.append((k_pool.untyped_storage().data_ptr() in pools,
                          not k_pool.is_contiguous()))
            return fn(q, k_pool, *rest, **kw)
        return run

    seen = {"one": [], "split": []}
    n0 = launched()
    for (m, n), fn in zip(wrapped, real):
        setattr(m, n, seen_pool(fn))
    try:
        tok = tok0
        for _ in range(TP_DECODE_STEPS):
            tok, mine = split(params, mine, tok)
            seen["split"].append(tok)
    finally:
        for (m, n), fn in zip(wrapped, real):
            setattr(m, n, fn)
    n1 = launched()
    tok = tok0
    for _ in range(TP_DECODE_STEPS):
        tok, cache = one(params, cache, tok)
        seen["one"].append(tok)
    _sync(torch, dev)
    t0 = time.perf_counter()
    split(params, mine, tok0)
    _sync(torch, dev)
    a, c_ = (torch.cat(seen[k], 1) for k in ("split", "one"))
    return {"arch": cfg.name, "slots": nb, "rows": TP_DECODE_ROWS,
            "kv_dtype": str(kv_dtype).removeprefix("torch."),
            "paged": paged, "kv_split": bool(mine.get("kv_split")),
            "segment_rows": (int(mine["blocks"]["k"].shape[2])
                             if mine.get("kv_split") else None),
            "steps": TP_DECODE_STEPS, "equal": bool(torch.equal(a, c_)),
            "launches": {k: n1[k] - n0[k] for k in n0 if n1[k] - n0[k]},
            "pool_views": {"calls": len(views),
                           "of_the_pool": all(v[0] for v in views),
                           "strided": all(v[1] for v in views)},
            "step_ms": round((time.perf_counter() - t0) * 1e3, 3)}


def tp_decode_layouts(torch, mods, cfg, params, mesh, dev, peak, free
                      ) -> dict:
    """`tp_decode_run` of ``cfg`` (Qwen3-14B) in each cache layout under
    `decode_rules`: its contiguous f32 cache split by sequence (B1 with
    its statistics), its int8 cache so split (B3 with them), its paged
    bf16 and int8 pools whole (B2 and B4 at the rank's query heads, on
    the strided view of the KV heads they read).  Each part records its
    kernel's launches and launches no other; ``peak`` records each part's
    peak."""
    out = {}
    for part, kernel, kv_dtype, paged in (
            ("qwen3_decode", "decode_attention", torch.float32, False),
            ("qwen3_decode_int8", "quantized_decode_attention",
             torch.int8, False),
            ("qwen3_decode_paged_bf16", "paged_decode_attention",
             torch.bfloat16, True),
            ("qwen3_decode_paged_int8", "paged_quantized_decode_attention",
             torch.int8, True)):
        res = tp_decode_run(torch, mods, cfg, params, mesh, dev, kv_dtype,
                            paged)
        res["kernel"] = kernel
        res["decode_launches"] = res["launches"].get(kernel, 0)
        res["ok"] = (res["equal"] and res["kv_split"] != paged
                     and set(res["launches"]) <= {kernel})
        if paged:
            res["ok"] = res["ok"] and res["pool_views"] == {
                "calls": cfg.num_layers * TP_DECODE_STEPS,
                "of_the_pool": True, "strided": True}
        out[part] = peak(res)
        free()
    return out


def tp_rwkv(torch, mods, cfg, opt, mesh, rules, dev, peak, free,
            shape=TP_TRAIN, prefill=TP_PREFILL) -> dict:
    """RWKV6 (at full width: its time mix over its 64 heads, 32 a rank,
    its channel mix over d_ff): one f32 train step of ``shape`` on
    ``mesh`` against the one-rank step from the same state and batch
    (loss, every gradient whole on each rank and their norm within
    ``TP_REL`` of the largest |value|), a ``prefill``-token prefill's
    greedy token and `tp_decode_run` (its ``wkv`` state over the heads)
    against one rank's; ``peak`` records each part's peak."""
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_state
    f32 = torch.float32
    b, s = shape
    out = {}
    batch = _train_batch(torch, cfg, b, s, 0, dev)
    plain = build_state(cfg, opt, 0, dev)
    plain, m0, g0 = steps.make_train_step(cfg, opt, compute_dtype=f32)(
        plain, batch, return_grads=True)
    del plain
    free()
    state = build_state(cfg, opt, 0, dev, mesh, rules)
    step = steps.make_train_step(cfg, opt, compute_dtype=f32, mesh=mesh,
                                 rules=rules)
    _sync(torch, dev)
    t0 = time.perf_counter()
    state, m1, g1 = step(state, batch, return_grads=True)
    _sync(torch, dev)
    res = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
           "seq": s, "loss": float(m1["loss"]),
           "loss_rel_err": abs(float(m1["loss"]) - float(m0["loss"]))
           / abs(float(m0["loss"])),
           "grad_rel_err": _rel_err(torch, g1, g0),
           "grad_norm_rel_err": abs(float(m1["grad_norm"])
                                    - float(m0["grad_norm"]))
           / float(m0["grad_norm"]),
           "grads_compared": "every leaf whole on each rank",
           "first_step_ms": round((time.perf_counter() - t0) * 1e3, 3)}
    res["ok"] = (res["loss_rel_err"] <= TP_REL
                 and res["grad_rel_err"] <= TP_REL
                 and res["grad_norm_rel_err"] <= TP_REL)
    out["rwkv_train"] = peak(res)
    del state, g0, g1
    free()
    params = build_state(cfg, opt, 0, dev)["params"]
    tokens = torch.randint(0, cfg.vocab_size, (1, prefill),
                           generator=torch.Generator(device=dev)
                           .manual_seed(7), device=dev)
    want = steps.make_prefill_step(cfg, f32)(params, {"tokens": tokens})
    got = steps.make_prefill_step(cfg, f32, mesh=mesh, rules=rules)(
        params, {"tokens": tokens})
    out["rwkv_prefill"] = peak({"tokens": prefill,
                                "equal": bool(torch.equal(got, want)),
                                "ok": bool(torch.equal(got, want))})
    res = tp_decode_run(torch, mods, cfg, params, mesh, dev)
    res["ok"] = res["equal"] and not res["kv_split"] and not res["launches"]
    out["rwkv_decode"] = peak(res)
    del params
    free()
    return out


def mamba_parallel(torch, configs, mesh, rules, dev, cfg=None) -> dict:
    """`ssm.mamba_apply` alone at Jamba-1.5-Large's width (d_model 8,192,
    d_in 16,384, state 16, conv 4, dt_rank 512; the whole model does not
    fit one card; ``cfg`` another config), f32, on ``TP_MAMBA`` tokens:
    forward and the gradients
    of ``sum(y * cot)`` on this rank's blocks (`transformer.compute_specs`:
    ``d_in`` over the model axis, ``in_proj`` its columns of each half)
    against one rank's, each rank's block of every gradient, then 16
    decode steps from this rank's block of a random state against one
    rank's steps: outputs and this rank's block of the final state.  The
    outputs and states within ``TP_REL`` of their largest |value|; the
    gradients within ``TP_MAMBA_GRAD`` of the largest of all, each within
    ``TP_MAMBA_LEAF`` of its own largest (``MAMBA_OUTSIDE_SCAN``'s within
    ``TP_REL``), and the input's within ``TP_MAMBA_DX`` of its largest
    (B's and C's bf16 rounding)."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import ssm, transformer
    from repro_torch.parallel import sharding as shd
    cfg = cfg or configs.get("jamba_1_5_large_398b")
    key = next(str(l) for l in range(cfg.attn_period)
               if not cfg.is_attn_layer(l))
    cspec = tree_lib.map_structure(
        lambda c: c[1:],
        transformer.compute_specs(cfg, rules)["blocks"][key]["mixer"])
    gen = torch.Generator(device=dev).manual_seed(5)
    params = ssm.mamba_init(gen, cfg, torch.float32)
    b, s = TP_MAMBA
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    cot = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    state = ssm.mamba_cache_init(cfg, b, torch.float32, dev)
    for leaf in state.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev))
    xs = torch.randn((TP_DECODE_STEPS, b, 1, cfg.d_model), generator=gen,
                     device=dev)
    st_spec = {k: shd.fitted(rules.spec(*v[1:]), tuple(state[k].shape),
                             rules)
               for k, v in transformer.cache_specs(cfg)["blocks"][
                   key].items()}

    def run(p, x, split):
        p = tree_lib.map_structure(lambda t: t.requires_grad_(), p)
        x = x.clone().requires_grad_()
        y = shd.leave(ssm.mamba_apply(p, shd.enter(x, split), cfg)[0],
                      split)
        y.backward(cot)
        return y.detach(), tree_lib.map_structure(lambda t: t.grad, p), \
            x.grad

    def decode(p, st, split):
        ys = []
        with torch.no_grad():
            for t in range(TP_DECODE_STEPS):
                y, st = ssm.mamba_apply(p, shd.enter(xs[t], split), cfg, st)
                ys.append(shd.leave(y, split))
        return torch.cat(ys, 1), st

    t0 = time.time()
    with set_mesh(mesh), shd.use_rules(rules):
        split = ssm.mamba_split(cfg)
        blocks = tree_lib.map_structure(
            lambda t, c: shd.compute_block(t, c, mesh).clone(), params,
            cspec)
        y1, g1, dx1 = run(blocks, x, split)
        d1, s1 = decode(blocks, {k: shd.local_shard(v, st_spec[k], mesh)
                                 .clone() for k, v in state.items()}, split)
    del blocks
    y0, g0, dx0 = run(params, x, None)
    mine0 = tree_lib.map_structure(
        lambda t, c: shd.compute_block(t, c, mesh), g0, cspec)
    d0, s0 = decode(params, state, None)
    s0 = {k: shd.local_shard(v, st_spec[k], mesh) for k, v in s0.items()}
    res = {"d_model": cfg.d_model, "d_in": ssm.d_inner(cfg),
           "rank_d_in": int(s1["h"].shape[1]), "batch": b, "seq": s,
           "split": None if split is None else split.n,
           "y_rel_err": _rel_err(torch, y1, y0),
           "dx_rel_err": _rel_err(torch, dx1, dx0),
           "grad_rel_err": _rel_err(torch, g1, mine0),
           "grad_rel_err_by_leaf": {k: _rel_err(torch, g1[k], mine0[k])
                                    for k in g1},
           "grads_compared": "this rank's block of every leaf",
           "tolerance": (f"y, decode outputs and states {TP_REL} of the "
                         f"largest |value|; gradients {TP_MAMBA_GRAD} of "
                         f"the largest of all and {TP_MAMBA_LEAF} of each "
                         f"leaf's own ({', '.join(MAMBA_OUTSIDE_SCAN)}: "
                         f"{TP_REL}); dx {TP_MAMBA_DX}"),
           "decode_steps": TP_DECODE_STEPS,
           "decode_y_rel_err": _rel_err(torch, d1, d0),
           "decode_state_rel_err": _rel_err(torch, s1, s0),
           "seconds": round(time.time() - t0, 3)}
    res["ok"] = (split is not None
                 and all(res[k] <= TP_REL for k in (
                     "y_rel_err", "decode_y_rel_err",
                     "decode_state_rel_err"))
                 and res["grad_rel_err"] <= TP_MAMBA_GRAD
                 and res["dx_rel_err"] <= TP_MAMBA_DX
                 and all(e <= (TP_REL if k in MAMBA_OUTSIDE_SCAN
                               else TP_MAMBA_LEAF)
                         for k, e in res["grad_rel_err_by_leaf"].items()))
    return res


def tp_rank_main(rank: int, world: int, workdir: str) -> int:
    """One rank of `tensor_parallel`, all on ``cuda:0`` over a gloo group
    (NCCL refuses two ranks of one card); writes its results as
    ``<workdir>/<rank>.json``."""
    import torch
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch import tree as tree_lib
    from repro_torch.convert import disable_tf32
    from repro_torch.kernels.attention import decode, decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.launch import policy, specs, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.models import moe, transformer
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd

    wd = pathlib.Path(workdir)
    dist.init_process_group("gloo", store=dist.FileStore(str(wd / "store"),
                                                         world),
                            rank=rank, world_size=world)
    dev, f32 = "cuda", torch.float32
    torch.cuda.set_device(0)
    disable_tf32()
    mesh = make_host_mesh(1, world, device_type=dev, backend="gloo")
    rules = specs.rules_for(mesh)
    out = {"rank": rank, "backend": dist.get_backend(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    t_start = time.time()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def peak(res):
        """``res`` with the part's peak bytes on the card, the peak reset
        for the next part."""
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return res

    # 1. H2O-Danube-1.8B, full width, 2 layers: one f32 train step on the
    # mesh against the one-rank step from the same state and batch.
    cfg = dataclasses.replace(configs.get("h2o_danube_1_8b"),
                              num_layers=TP_LAYERS)
    opt = adamw.AdamWConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10)
    b, s = TP_TRAIN
    batch = _train_batch(torch, cfg, b, s, 0, dev)
    plain = build_state(cfg, opt, 0, dev)
    plain, m0, g0 = steps.make_train_step(cfg, opt, compute_dtype=f32)(
        plain, batch, return_grads=True)
    params0 = build_state(cfg, opt, 0, dev)["params"]   # before the step
    state = build_state(cfg, opt, 0, dev, mesh, rules)
    step = steps.make_train_step(cfg, opt, compute_dtype=f32, mesh=mesh,
                                 rules=rules)
    state, m1, g1 = step(state, batch, return_grads=True)
    train = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
             "seq": s, "loss": float(m1["loss"]),
             "loss_rel_err": abs(float(m1["loss"]) - float(m0["loss"]))
             / abs(float(m0["loss"])),
             "grad_rel_err": _rel_err(torch, g1, g0),
             "grad_norm_rel_err": abs(float(m1["grad_norm"])
                                      - float(m0["grad_norm"]))
             / float(m0["grad_norm"])}
    del plain, g0, g1
    free()
    train["step_ms"] = _timed_ms(torch, lambda: step(state, batch), dev,
                                 reps=2)
    train["collectives"] = _timed_collectives(
        torch, lambda: step(state, batch))
    train["ok"] = (train["loss_rel_err"] <= TP_REL
                   and train["grad_rel_err"] <= TP_REL
                   and train["grad_norm_rel_err"] <= TP_REL)
    out["danube_train"] = peak(train)
    del state
    free()

    # 2. Its prefill at the rank's heads (B5, 16 of 32 query heads) against
    # the one-rank prefill: greedy tokens equal.
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (1, TP_PREFILL),
                           generator=gen, device=dev)
    want = steps.make_prefill_step(cfg, f32)(params0, {"tokens": tokens})
    n0 = flash.launches
    got = steps.make_prefill_step(cfg, f32, mesh=mesh, rules=rules)(
        params0, {"tokens": tokens})
    out["danube_prefill"] = peak({
        "tokens": TP_PREFILL, "equal": bool(torch.equal(got, want)),
        "flash_launches": flash.launches - n0,
        "ok": bool(torch.equal(got, want))
        and flash.launches - n0 == TP_LAYERS})

    # 3. Decode under decode_rules, 16 steps each against the one-rank
    # decode: Danube's ring split by sequence (the plain path), then
    # Qwen3-14B's cache in each layout (`tp_decode_layouts`).
    mods = (decode, decode_int8)
    res = tp_decode_run(torch, mods, cfg, params0, mesh, dev)
    res["ok"] = res["equal"] and res["kv_split"]
    out["danube_decode"] = peak(res)
    del params0
    free()
    qcfg = dataclasses.replace(configs.get("qwen3_14b"),
                               num_layers=TP_LAYERS)
    qparams = transformer.init(qcfg, torch.Generator(device=dev)
                               .manual_seed(0), dtype=f32)
    layouts = tp_decode_layouts(torch, mods, qcfg, qparams, mesh, dev, peak,
                                free)
    for res in layouts.values():      # the kernel once a layer a step
        res["ok"] = res["ok"] and res["launches"] == {
            res["kernel"]: qcfg.num_layers * TP_DECODE_STEPS}
    out.update(layouts)
    del qparams
    free()

    # 4. RWKV6-7B, full width, 2 layers, f32 (`tp_rwkv`).
    rcfg = dataclasses.replace(configs.get("rwkv6_7b"), num_layers=TP_LAYERS)
    out.update(tp_rwkv(torch, mods, rcfg, opt, mesh, rules, dev, peak,
                       free))

    # 5. Mamba alone at Jamba-1.5-Large's width (`mamba_parallel`).
    out["mamba"] = peak(mamba_parallel(torch, configs, mesh, rules, dev))
    free()

    # 6. Phi-3.5-MoE, full width, 2 layers: one train step with the
    # experts over the model axis, at a capacity that drops nothing,
    # against the one-rank step from the same state and batch (its aux
    # the mean over the sequence blocks, `_split_aux`).  Each rank keeps
    # only its block of the step's gradients, then computes the one-rank
    # gradients whole in its turn and compares that block.
    mcfg = dataclasses.replace(configs.get("phi3_5_moe_42b"),
                               num_layers=TP_LAYERS,
                               capacity_factor=TP_MOE_CAPACITY)
    mopt = adamw.AdamWConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10)
    mbatch = _train_batch(torch, mcfg, b, s, 0, dev)

    def moe_params():
        return transformer.init(mcfg, torch.Generator(device=dev)
                                .manual_seed(0),
                                dtype=policy.param_dtype(mcfg))

    real, real_route = moe._dispatch_indices, moe.route
    moe._dispatch_indices, dropped = _counted_drops(moe)
    try:
        # one rank at a time holds the whole weights while it cuts its
        # blocks of the state
        for turn in range(world):
            if rank == turn:
                params = moe_params()
                mstate = _tp_state(torch, mcfg, mopt, mesh, rules, params)
                del params
                free()
            dist.barrier()
        moe._dispatch_indices.phantom = mcfg.num_experts // world + 1
        mstep = steps.make_train_step(mcfg, mopt, compute_dtype=f32,
                                      mesh=mesh, rules=rules)
        _sync(torch, dev)
        t0 = time.perf_counter()
        mstate, mm, g2 = mstep(mstate, mbatch, return_grads=True)
        _sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        model_drops = sum(dropped.values())
        pspecs = tree_lib.map_structure(shd.spec_of, mstate["params"])
        mine = tree_lib.map_structure(
            lambda g, sp: shd.local_shard(g, sp, mesh).clone(), g2, pspecs)
        del mstate, g2
        free()
        dist.barrier()
        dropped.clear()
        moe._dispatch_indices.phantom = None
        moe.route = _split_aux(moe, b, s, world)
        for turn in range(world):
            if rank == turn:
                params = moe_params()
                _, m0, _, g0 = steps.loss_and_grads(mcfg, params, mbatch, f32)
                del params
                loss0 = float(m0["loss"])
                norm0 = float(adamw.global_norm(g0))
                top = max(float(g.abs().max()) for g in tree_lib.leaves(g0))
                err = max(float((shd.local_shard(w, sp, mesh) - g)
                                .abs().max())
                          for w, g, sp in zip(*(tree_lib.leaves(t) for t in (
                              g0, mine, pspecs))))
                del g0
                free()
            dist.barrier()
        one_rank_drops = sum(dropped.values())
    finally:
        moe._dispatch_indices, moe.route = real, real_route
    del mine
    free()
    res = {"arch": mcfg.name, "layers": mcfg.num_layers, "batch": b,
           "seq": s, "capacity_factor": TP_MOE_CAPACITY,
           "items_dropped": {"one_rank": one_rank_drops,
                             "model_axis": model_drops},
           "loss": float(mm["loss"]),
           "loss_rel_err": abs(float(mm["loss"]) - loss0) / abs(loss0),
           "aux_loss": float(mm["aux_loss"]),
           "grad_norm": float(mm["grad_norm"]),
           "grad_norm_rel_err": abs(float(mm["grad_norm"]) - norm0) / norm0,
           "grad_rel_err": err / max(top, 1e-30),
           "grads_compared": "this rank's block of every leaf",
           "first_step_ms": round(step_ms, 3)}
    res["ok"] = (res["loss_rel_err"] <= TP_REL
                 and res["grad_rel_err"] <= TP_REL
                 and res["grad_norm_rel_err"] <= TP_REL
                 and not any(res["items_dropped"].values()))
    out["moe_train"] = peak(res)
    out["seconds"] = round(time.time() - t_start, 3)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["ok"] = all(v["ok"] for v in out.values() if isinstance(v, dict)
                    and "ok" in v)
    (wd / f"{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def tensor_parallel(torch, smi) -> dict:
    """Tensor and expert parallelism over a (1, 2) mesh on the one card:
    ``TP_RANKS`` processes of this script (`tp_rank_main`), each on
    ``cuda:0`` over a gloo group, started at once and waited for
    together (killed past ``TP_TIMEOUT`` seconds).  Each rank:

    - H2O-Danube-1.8B at full width, 2 layers, f32: one train step
      against the one-rank step from the same state and batch (loss,
      gradients and their norm within 1e-5 of the largest |value|), the
      step's ms and its collectives' ms (recorded, not gated: the ranks
      share the card's SMs); its prefill at the rank's 16 query heads
      (B5, one launch a layer) with the one-rank prefill's greedy token;
    - 16 greedy decode steps under `decode_rules` (slots straddling the
      two segments of the cache's rows, one of length 0) against the
      one-rank decode, tokens equal: Danube's ring on the plain path and
      Qwen3-14B (2 layers) in every cache layout (`tp_decode_layouts`):
      its f32 and int8 caches split by sequence through B1 and B3 with
      their statistics, its paged bf16 and int8 pools whole through B2
      and B4 at the rank's 20 query heads, each once a layer a step;
    - RWKV6-7B at full width, 2 layers, f32 (`tp_rwkv`): one train step,
      a 1,024-token prefill and 16 decode steps against one rank's;
    - Mamba alone at Jamba-1.5-Large's width (`mamba_parallel`): forward,
      gradients and 16 decode steps of its state against one rank's
      (the gradients through the scan held between the sound split's
      readings and those of one that rounds each rank's part of B's and
      C's gradients to bf16 before the ranks' sum: ``TP_MAMBA_GRAD``);
    - Phi-3.5-MoE at full width, 2 layers: one train step with its
      experts over the model axis at capacity factor ``TP_MOE_CAPACITY``,
      where neither side drops an item (counted), against the one-rank
      step from the same state and batch, its aux taken over the two
      sequence blocks as the split step takes it (`_split_aux`): loss,
      gradients (each rank's block of every leaf) and their norm within
      1e-5 of the largest |value|.
    Each part records the rank's peak bytes on the card.  A collective
    gloo cannot carry for CUDA tensors fails the phase with gloo's
    error."""
    import os
    import shutil
    wd = STATE_ROOT / "tensor_parallel"
    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           # two processes share the card: keep freed blocks reusable
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    env.pop("WORLD_SIZE", None)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", str(r),
         str(TP_RANKS), str(wd)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(TP_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(TP_TIMEOUT - (time.time() - t0), 1))[0])
    except subprocess.TimeoutExpired:
        logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {"ranks": [], "seconds": round(time.time() - t0, 3),
           "nvidia_smi": smi,
           "this_process_reserved_bytes": torch.cuda.memory_reserved()}
    for r, p in enumerate(procs):
        f = wd / f"{r}.json"
        if p.returncode != 0 or not f.exists():
            res["ranks"].append({"rank": r, "rc": p.returncode, "ok": False,
                                 "log_tail": (logs[r] if r < len(logs)
                                              else "")[-3000:]})
        else:
            res["ranks"].append(json.loads(f.read_text()))
    shutil.rmtree(wd, ignore_errors=True)
    res["ok"] = all(r["ok"] for r in res["ranks"])
    return res


# --------------------------------------------------------------------------
# Compile analysis (ROADMAP A14 items 6-10): the dry run's counts held to
# the card's, and dry-run cells through the module's CLI
# --------------------------------------------------------------------------

COUNT_BYTES_REL = 0.01               # card against meta: bytes within 1 %
DIFFERING_OPS_SHOWN = 20
# (arch, shape) cells of `launch.dryrun` on the single-pod mesh, each
# of which must come out ok (the MoE train cell trains its experts over
# the model axis)
DRYRUN_CELLS = [("qwen3_14b", "train_4k"), ("qwen3_14b", "prefill_32k"),
                ("qwen3_14b", "decode_32k"), ("qwen3_moe_235b", "decode_32k"),
                ("jamba_1_5_large_398b", "long_500k"),
                ("qwen3_moe_235b", "train_4k")]
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT = 600                 # seconds a cell
PREFILL_COUNT_SEED = 3               # the counted prefill's tokens


def meta_like(torch, *trees) -> tuple:
    """``trees`` (dicts of tensors) with every tensor replaced by an
    empty meta tensor of its shape, strides and dtype."""
    from repro_torch import tree as tree_lib

    def meta(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty_strided(tuple(t.shape), t.stride(),
                                   dtype=t.dtype, device="meta")

    return tuple(tree_lib.map_structure(meta, t) for t in trees)


def count_record(counts) -> dict:
    """A `hlo_stats.StepCounts` as JSON: its totals and its operators."""
    return {**counts.row(), "ops": counts.ops}


def counted(torch, fn, *args) -> dict:
    """`count_record` of ``fn(*args)`` counted where its tensors lie; on a
    card with the peak of `torch.cuda.max_memory_allocated` over the call
    beside the counter's tracked peak."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import hlo_stats
    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
               for a in args for t in tree_lib.leaves(a))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = count_record(hlo_stats.count_step(fn, *args))
    if cuda:
        torch.cuda.synchronize()
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return rec


def compare_counts(card: dict, meta: dict) -> dict:
    """The card's counts against meta's: FLOPs and collectives (counts
    and bytes) equal, bytes within ``COUNT_BYTES_REL``; the operators
    whose ``[calls, flops, bytes]`` differ are named."""
    ops = sorted(set(card["ops"]) | set(meta["ops"]))
    differ = {op: {"card": card["ops"].get(op), "meta": meta["ops"].get(op)}
              for op in ops if card["ops"].get(op) != meta["ops"].get(op)}
    rel = (abs(card["bytes_accessed"] - meta["bytes_accessed"])
           / max(meta["bytes_accessed"], 1.0))
    res = {"flops_equal": card["flops"] == meta["flops"],
           "collectives_equal": (
               card["collective_counts"] == meta["collective_counts"]
               and card["collectives"] == meta["collectives"]),
           "bytes_rel_diff": rel, "differing_ops": len(differ),
           "differing": dict(list(differ.items())[:DIFFERING_OPS_SHOWN])}
    res["ok"] = (res["flops_equal"] and res["collectives_equal"]
                 and rel <= COUNT_BYTES_REL)
    return res


def count_summary(rec: dict) -> dict:
    """What the ``dryrun_counts`` line prints of one side's counts."""
    keys = ("flops", "bytes_accessed", "collective_counts", "collectives",
            "argument_bytes", "peak_bytes", "kernels",
            "max_memory_allocated")
    return {k: rec[k] for k in keys if k in rec}


def step_bound(cfg, rec: dict, *, kind: str, batch: int, seq: int,
               param_bytes: int, moment_bytes: float = 4.0,
               cache_len: int = 0) -> dict:
    """The roofline of one counted step on one card, a model of the
    H100 SXM data sheet: the counted FLOPs at the bf16 peak, the memory
    term of `estimate.bytes_model`, the counted collective bytes at
    NVLink's rate (a one-rank group moves nothing); and the counted
    bytes at the memory rate, an unfused upper bound."""
    from repro_torch.core import cost_model, estimate
    bm = estimate.bytes_model(cfg, batch=batch, seq=seq, kind=kind,
                              param_bytes=param_bytes,
                              moment_bytes=moment_bytes,
                              cache_len=cache_len)
    roof = cost_model.roofline(rec["flops"], bm["total"],
                               rec["collective_bytes"], 1)
    return {"roofline": roof.row(), "bound_ms": roof.bound_s * 1e3,
            "counted_bytes_ms": rec["bytes_accessed"] / HBM_BYTES_PER_S
            * 1e3}


def count_pair(torch, fn, args, meta_args) -> dict:
    """``fn`` counted on the card's ``args`` and on their ``meta_args``
    mirror, and the two compared."""
    card = counted(torch, fn, *args)
    meta = counted(torch, fn, *meta_args)
    return {"card": card, "meta": meta, "compare": compare_counts(card, meta)}


def with_bound(pair: dict, measured_ms, bound: dict, launches: dict) -> dict:
    """One entry of the ``dryrun_counts`` line."""
    ms = bound["bound_ms"]
    return {"card": count_summary(pair["card"]),
            "meta": count_summary(pair["meta"]), **pair["compare"],
            "launches": launches, "measured_ms": measured_ms,
            "bound_ms": ms, "measured_over_bound":
            None if not (measured_ms and ms) else measured_ms / ms,
            "counted_bytes_ms": bound["counted_bytes_ms"],
            "roofline": bound["roofline"],
            "tracked_peak_bytes": pair["card"]["peak_bytes"],
            "max_memory_allocated": pair["card"].get(
                "max_memory_allocated")}


def prefill_counts(torch, steps, mods, cfg, params, measured_ms,
                   seq=None) -> dict:
    """One more `make_prefill_step` forward of the ``prefill`` phase's
    shape (1 x ``seq``, by default ``prefill_32k``'s length) counted on
    the card (B5 must launch once per layer) and on meta."""
    from repro_torch.configs import shapes
    seq = seq or shapes.SHAPES["prefill_32k"].seq_len
    dev = params["final_norm"]["scale"].device
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(PREFILL_COUNT_SEED))
    batch = {"tokens": tokens}
    step = steps.make_prefill_step(cfg)
    reset_launch_counts(mods)
    pair = count_pair(torch, step, (params, batch),
                      meta_like(torch, params, batch))
    launches = {"flash_attention": launch_counts(mods)["flash_attention"]}
    pbytes = params["embed"]["table"].element_size()
    entry = with_bound(pair, measured_ms, step_bound(
        cfg, pair["card"], kind="prefill", batch=1, seq=seq,
        param_bytes=pbytes), launches)
    entry["ok"] = (entry["ok"] and launches["flash_attention"]
                   == cfg.num_layers)
    return entry


def decode_counts(torch, mods, server, measured_ms) -> dict:
    """One more guarded decode step of the `decode_step` server (every
    slot active) counted on the card (B1 must launch once per layer) and
    on meta.  It writes the cache's next rows but not its lengths: the
    server is done with after it."""
    dev = server.device
    tokens = torch.as_tensor(server.last_tok, device=dev)
    active = torch.ones((server.batch,), dtype=torch.bool, device=dev)
    args = (server.params, server.cache, tokens, active)
    meta_args = meta_like(torch, *args)
    reset_launch_counts(mods)
    pair = count_pair(torch, server.serve_step, args, meta_args)
    launches = {"decode_attention": launch_counts(mods)["decode_attention"]}
    pbytes = server.params["embed"]["table"].element_size()
    entry = with_bound(pair, measured_ms, step_bound(
        server.cfg, pair["card"], kind="decode", batch=server.batch, seq=1,
        param_bytes=pbytes, cache_len=server.max_len), launches)
    entry["ok"] = (entry["ok"] and launches["decode_attention"]
                   == server.cfg.num_layers)
    return entry


def meta_train_count(torch, cfg, shape, opt) -> dict:
    """`count_record` of the ``train_danube`` step on meta: the state of
    `specs.state_pspecs` on the trainer CLI's (1, 1) mesh over a one-rank
    ``fake`` group, a meta mirror of the step's batch."""
    from repro_torch.core import hlo_stats
    from repro_torch.launch import dryrun, specs, steps
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device_type="meta")
    rules = specs.rules_for(mesh)
    state_abs, pspecs = specs.state_pspecs(cfg, opt, mesh, rules)
    state = dryrun._placed(state_abs, pspecs, mesh)
    (batch,) = meta_like(torch, _train_batch(torch, cfg, *shape, 0, "cpu"))
    step = steps.make_train_step(cfg, opt, mesh=mesh, rules=rules)
    return count_record(hlo_stats.count_step(step, state, batch))


def meta_count_main(spec: str) -> int:
    """`meta_train_count` of a JSON ``{"cfg", "shape", "opt"}``, printed
    as one JSON line (a process of its own: the card's process holds an
    NCCL group, and a fake one needs the default group)."""
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import adamw
    spec = json.loads(spec)
    rec = meta_train_count(torch, ModelConfig(**spec["cfg"]),
                           tuple(spec["shape"]),
                           adamw.AdamWConfig(**spec["opt"]))
    rec.pop("result", None)
    print(json.dumps(rec))
    return 0


def meta_train_count_process(cfg, shape, opt) -> dict:
    """`meta_count_main` in a process of its own."""
    import os
    spec = json.dumps({"cfg": dataclasses.asdict(cfg), "shape": list(shape),
                       "opt": dataclasses.asdict(opt)})
    p = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--meta-count", spec],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(p.returncode == 0, f"the meta train count failed: "
                             f"{p.stderr[-2000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def dryrun_cells(cells=DRYRUN_CELLS, out=DRYRUN_DIR,
                 timeout=DRYRUN_TIMEOUT) -> dict:
    """`python -m repro_torch.launch.dryrun` for each of ``cells`` on the
    single-pod mesh, all at once, one process each (they need no card);
    then `roofline_report`'s table and CSV lines of their records.  Every
    cell must come out ``ok``."""
    import os
    import shutil

    from repro_torch.benchmarks import roofline_report
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    t0 = time.time()
    for arch, shape in cells:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env))
    rows, ok = [], True
    for (arch, shape), p in zip(cells, procs):
        try:
            stdout, stderr = p.communicate(
                timeout=max(timeout - (time.time() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        f = out / f"{arch}__{shape}__single.json"
        rec = json.loads(f.read_text()) if f.exists() else {}
        good = p.returncode == 0 and rec.get("status") == "ok"
        ok = ok and good
        row = {"arch": arch, "shape": shape, "rc": p.returncode,
               "status": rec.get("status"), "line": stdout.strip()[-400:],
               "ok": good}
        for k in ("reason", "trace_s", "probe_s", "fits", "peak_bytes",
                  "roofline"):
            if k in rec:
                row[k] = rec[k]
        if not good:
            row["stderr_tail"] = stderr[-2000:]
        rows.append(row)
    return {"cells": rows, "seconds": round(time.time() - t0, 3),
            "table": roofline_report.markdown_table("single", out),
            "csv": roofline_report.csv_lines("single", out), "ok": ok}


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

    # B1-B5's sources build in seconds and B6-B8's in minutes: those go on
    # building in a thread of their own (its nvcc processes run to their
    # end even if a phase fails) while the attention phases run, and are
    # joined before the first phase that launches them.
    t0 = time.time()
    late = set(_build.sources()) - {pathlib.Path(src).stem for k, (src, _)
                                    in KERNELS.items()
                                    if k not in PAPER_KERNELS}
    late_built: dict = {}

    def build_late():
        try:
            late_built.update(_build.build(sorted(late)))
        except Exception as e:           # re-raised by the join's check
            late_built["error"] = e
    late_thread = threading.Thread(target=build_late)
    late_thread.start()
    built = _build.build(sorted(set(_build.sources()) - late))
    sources = {pathlib.Path(src).stem for src, _ in KERNELS.values()}
    emit("build", seconds=round(time.time() - t0, 3),
         libraries=sorted(p.name for p in built.values()),
         building_meanwhile=sorted(late),
         kernels=list(KERNELS), flags=" ".join(_build.NVCC_FLAGS))
    check(sources - late <= set(built),
          f"not built: {sources - late - set(built)}")

    # Tensor and expert parallelism over the model axis: two ranks, while
    # this process holds nothing on the card.
    tp = tensor_parallel(torch, smi)
    emit("tensor_parallel", **tp)
    check(tp["ok"], "tensor_parallel failed: " + json.dumps(tp)[-4000:])
    tp_launches = {
        "flash_attention": sum(r["danube_prefill"]["flash_launches"]
                               for r in tp["ranks"]),
        **{r0["kernel"]: sum(r[part]["decode_launches"] for r in tp["ranks"])
           for part, r0 in tp["ranks"][0].items()
           if part.startswith("qwen3_decode")}}
    del tp

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
    # B1 with its statistics on one rank's segment of a cache split over
    # 2 ranks: the serve shape (bf16 q, f32 cache) and an f32 and a bf16
    # cache of 2 x 16,384 rows
    cases.append(stats_case(torch, mods, flush, name=TP_STATS_CASE,
                            lengths=SERVE_LENGTHS, q_dtype=f32,
                            kv_dtype=f32, cache_len=SERVE_LEN // 2))
    for kv_dtype in (f32, bf16):
        cases.append(stats_case(
            torch, mods, flush, name="segment_of_2_l16384",
            lengths=[0, 16000, 20000, 32768], q_dtype=f32,
            kv_dtype=kv_dtype, cache_len=16384))
    # B3 with its statistics on one rank's segment of an int8 cache at the
    # serve shape (f32 q, as the layers pass it)
    cases.append(stats_case(torch, mods, flush, name=TP_INT8_STATS_CASE,
                            lengths=SERVE_LENGTHS, q_dtype=f32,
                            kv_dtype=torch.int8, cache_len=SERVE_LEN // 2))
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

    prefill_launches, counts = {}, {}
    for phase, arch, seq_len, check_len in PREFILL_PHASES:
        cfg = configs.get(arch)
        params = transformer.init(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            dtype=torch.bfloat16)
        res = prefill_phase(torch, shapes, steps, transformer, mods, cfg,
                            params, seq_len)
        emit(phase, **res)
        check(res["ok"], f"{phase} failed: {res}")
        prefill_launches[phase] = res["flash_launches"]
        if phase == "prefill":
            counts["prefill"] = prefill_counts(
                torch, steps, mods, cfg, params, res["host_median_ms"])
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
    # The last dense configurations: Phi-3-mini-3.8B, InternVL2-2B's token
    # stream and Qwen2.5-32B at full width.
    dense = dense_phases(torch, serve, configs, check_serve, steps,
                         transformer, lifecycle, mods, smi)
    for name, by_phase in dense.items():
        family_launches.setdefault(name, {}).update(by_phase)

    pvc = paged_vs_contiguous(torch, configs, serve, paging, lifecycle)
    emit("paged_vs_contiguous", **pvc)
    check(pvc["ok"], f"paged and contiguous token streams differ: {pvc}")

    step = decode_step_breakdown(torch, configs, serve, mods)
    counts["decode_step"] = step.pop("dryrun_counts")
    emit("decode_step", **step)
    check(step["decode_attention_ms_per_step"] > 0,
          "decode_step found no device time of the decode kernel")

    late_thread.join()
    emit("build_late", seconds=round(time.time() - t0, 3),
         libraries=sorted(p.name for k, p in late_built.items()
                          if k != "error"))
    check("error" not in late_built and late <= set(late_built),
          f"B6-B8 did not build: {late_built.get('error')}")
    paper_cases, paper_launches, (t1, t2) = paper_phases(torch, mods)
    cases += paper_cases
    launches.update(paper_launches)
    rep = attention_report(torch, mods, t1, t2)
    emit("attention_report", **rep)
    check(rep["ok"], "attention_report failed: " + json.dumps(
        {"problems": rep["check_bench_problems"],
         "launches": rep["launches"]}))
    del t1, t2

    # The paper's design flow (A15) and training on one card (A13).
    flow_launches = training_phases(torch, configs, mods, smi, counts)

    # Compile analysis (A14 items 6-10): the dry run's counter on the
    # card against meta, then dry-run cells through the module's CLI.
    counts = {k: counts[k] for k in ("train_danube", "prefill",
                                     "decode_step")}
    emit("dryrun_counts", nvidia_smi=smi, phases=counts,
         ok=all(c["ok"] for c in counts.values()))
    check(all(c["ok"] for c in counts.values()),
          "the card's counts and meta's disagree: " + json.dumps(
              {k: {f: c[f] for f in ("flops_equal", "collectives_equal",
                                     "bytes_rel_diff", "differing",
                                     "launches")}
               for k, c in counts.items() if not c["ok"]}))
    cells = dryrun_cells()
    print(cells["table"], flush=True)
    for line in cells["csv"]:
        print(line, flush=True)
    emit("dryrun_cells", **cells)
    check(cells["ok"], "a dry-run cell failed: " + json.dumps(
        [c for c in cells["cells"] if not c["ok"]]))

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
        if name in flow_launches:
            entry["launches_by_phase"] = flow_launches[name]
        if name in tp_launches:
            entry.setdefault("launches_by_phase", {})["tensor_parallel"] = \
                tp_launches[name]
            rank_case = next((c for c in mine if c["name"] in (
                TP_FLASH_CASE, TP_STATS_CASE, TP_INT8_STATS_CASE,
                TP_PAGED_CASE, TP_PAGED_INT8_CASE)), None)
            if rank_case is not None:
                entry["per_rank"] = {k: rank_case.get(k) for k in (
                    "name", "ms", "no_stats_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "max_abs_err", "design")
                    if k in rank_case}
        if name == "blocked_matmul":
            entry["launches_by_design"] = launches["blocked_matmul_by_design"]
        entries.append(entry)
    emit("total", seconds=round(time.time() - STARTED, 3))
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--meta-count"]:      # `meta_count_main`
            sys.exit(meta_count_main(sys.argv[2]))
        if sys.argv[1:2] == ["--tp-rank"]:         # `tp_rank_main`
            sys.exit(tp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4]))
        sys.exit(main())
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
