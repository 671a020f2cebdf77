"""KernelSpecs of the attention families.  Counterpart of
`repro.kernels.attention.spec`.

Three families, with the JAX package's names and cache keys:

- ``attention``: prefill flash attention (B5, `kernel.flash_attention`),
  knobs (block_q, block_k).
- ``decode``: single-query decode over a float cache (B1,
  `decode.gqa_decode_attention`), knob block_k.
- ``decode_int8``: the same over an int8 cache with f32 scales (B3,
  `decode_int8.quantized_gqa_decode_attention`), knob block_k.

The rankers `rank_attention_blocks`, `rank_decode_blocks` and
`rank_quantized_decode_blocks` are the JAX package's laws over its
candidate sets, with ``Chip.smem_bytes`` as the budget where the JAX
package takes the TPU's VMEM; they are held to the JAX rankers in the
parity tests.  The specs offer the tuner only what the CUDA kernels take:

- B5 is built for one tile per design (`kernel.TILES`), so the
  ``attention`` spec offers that tile alone, scored by
  `cost_model.attention_time_model`.
- B1 and B3 take any span of keys per split at run time
  (``csrc/decode_body.cuh``), so the ``decode`` and ``decode_int8`` specs
  offer every span of `DECODE_BLOCKS` (clamped to the cache depth, as the
  JAX enumeration clamps it: at 624 rows 1024 and 2048 become 624, which
  the kernels take as they are).  The laws' ``vmem_bytes`` is the TPU
  kernel's staging of ``block_k`` rows; the CUDA kernels stage 8-key warp
  tiles in a shared memory that does not grow with the span (under
  150 KB at head_dim 128 and a group of 16), so the specs hold no span to
  that term: every span is feasible on the card.

The laws charge a coarse span's rounding up of each row, which the CUDA
kernels do not pay (a split stops at its row's length), and nothing per
block of the grid, which they do pay; so the span the model prefers is
not always the card's fastest (PERF.md).
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cost_model, dse, hardware
from repro_torch.kernels import registry
from repro_torch.kernels.attention import decode as attn_decode
from repro_torch.kernels.attention import decode_int8 as attn_decode_int8
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.runtime import quantize

ATTENTION_BLOCKS = (128, 256, 512, 1024)
DECODE_BLOCKS = (128, 256, 512, 1024, 2048)
# The specs' budget for the laws' TPU staging term: none (see above).
NO_BUDGET = sys.maxsize


# ---------------------------------------------------------------------------
# Prefill flash attention
# ---------------------------------------------------------------------------

def rank_attention_blocks(
    bh: int, sq: int, sk: int, dh: int,
    smem_bytes: int | None = None,
    dtype_bytes: int = 2,
    causal: bool = True,
    window: int | None = None,
    block_cands: Sequence[int] = ATTENTION_BLOCKS,
    top: int = 8,
    chip: hardware.Chip = hardware.H100_SXM,
) -> list[dse.Candidate]:
    """(block_q, block_k) pairs of ``block_cands``, clamped to the
    sequences and deduped, scored by `cost_model.attention_time_model`
    within ``smem_bytes`` (default ``chip.smem_bytes``): model time, then
    the deeper block_q, then the smaller block_k.  Never empty: if the
    budget rejects every pair, the smallest is scored and returned.  Each
    ``Candidate.detail`` carries the blocks and the model row."""
    budget = smem_bytes if smem_bytes is not None else chip.smem_bytes
    pairs, seen = [], set()
    for bq in block_cands:
        for bk in block_cands:
            ebq, ebk = min(bq, sq), min(bk, sk)
            if (ebq, ebk) in seen:
                continue
            seen.add((ebq, ebk))
            pairs.append({"block_q": ebq, "block_k": ebk})

    def model(knobs: dict) -> dict:
        return cost_model.attention_time_model(
            bh, sq, sk, dh, knobs["block_q"], knobs["block_k"],
            causal=causal, window=window, chip=chip, dtype_bytes=dtype_bytes)

    def evaluate(knobs: dict) -> tuple[float, dict]:
        res = model(knobs)
        if res["vmem_bytes"] > budget:
            return float("inf"), {}
        return res["time_s"], {**knobs, **res}

    # Score every pair before cutting, so the tie-break decides ties.
    ranked = dse.explore(pairs, evaluate, top=len(pairs))
    ranked = [c for c in ranked if c.detail and "block_q" in c.detail]
    ranked.sort(key=lambda c: (c.score, -c.detail["block_q"],
                               c.detail["block_k"]))
    if not ranked:
        knobs = min(pairs, key=lambda p: (p["block_q"], p["block_k"]))
        res = model(knobs)
        ranked = [dse.Candidate(knobs, res["time_s"], {**knobs, **res})]
    return ranked[:top]


def _attn_key_fn(problem: dict, dtype: str, backend: str) -> str:
    window = problem["window"]
    return (f"{problem['bh']}x{problem['sq']}x{problem['sk']}"
            f"x{problem['dh']}:c{int(problem['causal'])}"
            f":w{'none' if window is None else window}:{dtype}:{backend}")


def _attn_tile(problem: dict, dtype_bytes: int) -> tuple[int, int]:
    dtype = torch.float32 if dtype_bytes > 2 else torch.bfloat16
    return attn_kernel.tile(dtype, problem["dh"])


def _attn_enumerate(problem: dict, dtype_bytes: int,
                    smem_bytes: int | None, top: int) -> list[dse.Candidate]:
    # B5 runs the one tile of its design; the kernel clamps nothing.
    bq, bk = _attn_tile(problem, dtype_bytes)
    knobs = {"block_q": bq, "block_k": bk}
    res = _attn_cost_fn(problem, knobs, dtype_bytes)
    return [dse.Candidate(knobs, res["time_s"], {})]


def _attn_cost_fn(problem: dict, knobs: dict, dtype_bytes: int = 2) -> dict:
    return cost_model.attention_time_model(
        problem["bh"], problem["sq"], problem["sk"], problem["dh"],
        knobs["block_q"], knobs["block_k"], causal=problem["causal"],
        window=problem["window"], dtype_bytes=dtype_bytes)


def _randn(shape, dtype, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _attn_make_inputs(problem: dict, dtype, device) -> tuple:
    # The (bh, s, dh) fold of the JAX spec as B5's (1, s, bh, dh).
    bh, sq, sk, dh = (problem["bh"], problem["sq"], problem["sk"],
                      problem["dh"])
    return (_randn((1, sq, bh, dh), dtype, device, 0),
            _randn((1, sk, bh, dh), dtype, device, 1),
            _randn((1, sk, bh, dh), dtype, device, 2))


def _attn_build_launcher(problem: dict, knobs: dict):
    return lambda q, k, v: attn_ops.mha_attention(
        q, k, v, causal=problem["causal"], window=problem["window"],
        block_q=knobs["block_q"], block_k=knobs["block_k"])


def _attn_problem_fn(q, k, v, causal=True, window=None):
    b, sq, hq, dh = q.shape
    return {"bh": b * hq, "sq": sq, "sk": k.shape[1], "dh": dh,
            "causal": causal, "window": window}, q.dtype


def _attn_run_fn(plan: registry.Plan, q, k, v, *, causal=True, window=None):
    return attn_ops.mha_attention(q, k, v, causal=causal, window=window,
                                  block_q=plan.knobs["block_q"],
                                  block_k=plan.knobs["block_k"])


def _attn_reference_fn(q, k, v, causal=True, window=None):
    return attn_ref.attention_ref(q, k, v, scale=q.shape[3] ** -0.5,
                                  causal=causal, window=window)


registry.register(registry.KernelSpec(
    name="attention",
    key_fn=_attn_key_fn,
    enumerate_candidates=_attn_enumerate,
    cost_fn=_attn_cost_fn,
    make_inputs=_attn_make_inputs,
    build_launcher=_attn_build_launcher,
    reference_fn=_attn_reference_fn,
    problem_fn=_attn_problem_fn,
    run_fn=_attn_run_fn,
    tie_break=lambda knobs: (-knobs["block_q"], knobs["block_k"]),
))


# ---------------------------------------------------------------------------
# Single-query decode attention, float and int8 caches
# ---------------------------------------------------------------------------

def _rank_spans(kv_len: int, block_cands: Sequence[int], budget: int,
                model) -> list[dse.Candidate]:
    """The rankers' shared walk: candidates clamped to the cache depth,
    scored by ``model(block_k)`` within ``budget``, then the larger span
    on ties; never empty."""
    cands = sorted({min(bk, max(kv_len, 1)) for bk in block_cands})

    def evaluate(knobs: dict) -> tuple[float, dict]:
        res = model(knobs["block_k"])
        if res["vmem_bytes"] > budget:
            return float("inf"), {}
        return res["time_s"], {**knobs, **res}

    ranked = dse.explore([{"block_k": bk} for bk in cands], evaluate,
                         top=len(cands))
    ranked = [c for c in ranked if c.detail and "block_k" in c.detail]
    ranked.sort(key=lambda c: (c.score, -c.detail["block_k"]))
    if not ranked:
        res = model(cands[0])
        ranked = [dse.Candidate({"block_k": cands[0]}, res["time_s"],
                                {"block_k": cands[0], **res})]
    return ranked


def rank_decode_blocks(
    bkv: int, g: int, kv_len: int, dh: int,
    smem_bytes: int | None = None,
    dtype_bytes: int = 2,
    block_cands: Sequence[int] = DECODE_BLOCKS,
    top: int = 8,
    lengths: Sequence[int] | None = None,
    chip: hardware.Chip = hardware.H100_SXM,
) -> list[dse.Candidate]:
    """Spans of ``block_cands`` (clamped to ``kv_len``) for ``bkv =
    batch*kv_heads`` rows of a ``g``-row query group, scored by
    `cost_model.decode_time_model` within ``smem_bytes`` (default
    ``chip.smem_bytes``): model time, then the larger span.  ``lengths``
    (one per sequence) prices each row's own prefix instead of the whole
    cache.  Never empty."""
    budget = smem_bytes if smem_bytes is not None else chip.smem_bytes
    return _rank_spans(kv_len, block_cands, budget, lambda bk:
                       cost_model.decode_time_model(
                           bkv, g, kv_len, dh, bk, chip=chip,
                           dtype_bytes=dtype_bytes, lengths=lengths))[:top]


def rank_quantized_decode_blocks(
    bkv: int, g: int, kv_len: int, dh: int,
    smem_bytes: int | None = None,
    block_cands: Sequence[int] = DECODE_BLOCKS,
    top: int = 8,
    lengths: Sequence[int] | None = None,
    chip: hardware.Chip = hardware.H100_SXM,
) -> list[dse.Candidate]:
    """`rank_decode_blocks` for an int8 cache, scored by
    `cost_model.quantized_decode_time_model` (the JAX package's
    ``decode_int8`` enumeration)."""
    budget = smem_bytes if smem_bytes is not None else chip.smem_bytes
    return _rank_spans(kv_len, block_cands, budget, lambda bk:
                       cost_model.quantized_decode_time_model(
                           bkv, g, kv_len, dh, bk, chip=chip,
                           lengths=lengths))[:top]


def _lengths_tag(problem: dict) -> str:
    # A plan tuned for a ragged workload must not shadow the batch-max one.
    lengths = problem.get("lengths")
    return ("" if not lengths
            else ":l" + "-".join(str(int(l)) for l in lengths))


def _decode_key_fn(problem: dict, dtype: str, backend: str) -> str:
    return (f"{problem['bkv']}x{problem['g']}x{problem['cache_len']}"
            f"x{problem['dh']}{_lengths_tag(problem)}:{dtype}:{backend}")


def _decode_int8_key_fn(problem: dict, dtype: str, backend: str) -> str:
    # `q8` tags the int8 layout; `dtype` is the activation dtype of q.
    return (f"{problem['bkv']}x{problem['g']}x{problem['cache_len']}"
            f"x{problem['dh']}{_lengths_tag(problem)}:q8:{dtype}:{backend}")


def _decode_lengths(problem: dict) -> list[int] | None:
    lengths = problem.get("lengths")
    return list(lengths) if lengths else None


def _spans_only(ranked) -> list[dse.Candidate]:
    return [dse.Candidate({"block_k": c.detail["block_k"]}, c.score, {})
            for c in ranked]


def _decode_enumerate(problem: dict, dtype_bytes: int,
                      smem_bytes: int | None, top: int) -> list[dse.Candidate]:
    # Every span, whatever the budget: the kernels' shared memory does
    # not grow with it.  The engine's tie-break makes the final cut.
    return _spans_only(rank_decode_blocks(
        problem["bkv"], problem["g"], problem["cache_len"], problem["dh"],
        smem_bytes=NO_BUDGET, dtype_bytes=dtype_bytes,
        top=len(DECODE_BLOCKS), lengths=_decode_lengths(problem)))


def _decode_int8_enumerate(problem: dict, dtype_bytes: int,
                           smem_bytes: int | None,
                           top: int) -> list[dse.Candidate]:
    return _spans_only(rank_quantized_decode_blocks(
        problem["bkv"], problem["g"], problem["cache_len"], problem["dh"],
        smem_bytes=NO_BUDGET, top=len(DECODE_BLOCKS),
        lengths=_decode_lengths(problem)))


def _decode_cost_fn(problem: dict, knobs: dict, dtype_bytes: int = 2) -> dict:
    return cost_model.decode_time_model(
        problem["bkv"], problem["g"], problem["cache_len"], problem["dh"],
        knobs["block_k"], dtype_bytes=dtype_bytes,
        lengths=_decode_lengths(problem))


def _decode_int8_cost_fn(problem: dict, knobs: dict,
                         dtype_bytes: int = 1) -> dict:
    # The layout fixes the bytes (int8 codes and f32 scales); the
    # engine's dtype_bytes is accepted and ignored.
    return cost_model.quantized_decode_time_model(
        problem["bkv"], problem["g"], problem["cache_len"], problem["dh"],
        knobs["block_k"], lengths=_decode_lengths(problem))


def _fold_shapes(problem: dict) -> tuple[tuple, tuple]:
    # The JAX spec's (bkv, g, dh) / (bkv, L, dh) fold as B = bkv
    # sequences of one KV head each.
    bkv, g, cache_len, dh = (problem["bkv"], problem["g"],
                             problem["cache_len"], problem["dh"])
    return (bkv, g, dh), (bkv, cache_len, 1, dh)


def _decode_make_inputs(problem: dict, dtype, device) -> tuple:
    q_shape, kv_shape = _fold_shapes(problem)
    return (_randn(q_shape, dtype, device, 0),
            _randn(kv_shape, dtype, device, 1),
            _randn(kv_shape, dtype, device, 2))


def _decode_int8_make_inputs(problem: dict, dtype, device) -> tuple:
    q_shape, kv_shape = _fold_shapes(problem)
    kq, ks = quantize.quantize_rows(
        _randn(kv_shape, torch.float32, device, 1))
    vq, vs = quantize.quantize_rows(
        _randn(kv_shape, torch.float32, device, 2))
    return _randn(q_shape, dtype, device, 0), kq, ks, vq, vs


def _measured_length(problem: dict):
    """The depths a plan is timed at: each row's ragged length when the
    problem carries a distribution (each sequence's length repeated over
    its KV heads), else the whole cache."""
    lengths = _decode_lengths(problem)
    if lengths:
        rep = problem["bkv"] // len(lengths)
        return np.repeat(np.asarray(lengths, np.int32), rep)
    return problem["cache_len"]


def _with_lengths(problem: dict, fn):
    """``fn(*inputs, length=...)`` with the lengths made once on the
    inputs' device, so a timed call holds no host-to-device copy."""
    length = _measured_length(problem)
    held = {}

    def call(q, *cache):
        if q.device not in held:
            held[q.device] = torch.as_tensor(
                np.broadcast_to(length, (q.shape[0],)).copy(),
                dtype=torch.int32, device=q.device)
        return fn(q, *cache, length=held[q.device])
    return call


def _decode_build_launcher(problem: dict, knobs: dict):
    scale = problem["dh"] ** -0.5
    return _with_lengths(problem, lambda q, k, v, length:
                         attn_decode.gqa_decode_attention(
                             q, k, v, length=length, scale=scale,
                             block_k=knobs["block_k"]))


def _decode_int8_build_launcher(problem: dict, knobs: dict):
    scale = problem["dh"] ** -0.5
    return _with_lengths(problem, lambda q, kq, ks, vq, vs, length:
                         attn_decode_int8.quantized_gqa_decode_attention(
                             q, kq, ks, vq, vs, length=length, scale=scale,
                             block_k=knobs["block_k"]))


def _decode_problem_fn(q, k, v, length=None):
    b, hq, dh = q.shape
    _, kl, hkv, _ = k.shape
    # Keyed and priced on the *cache* dtype the kernel streams.
    return {"bkv": b * hkv, "g": hq // hkv, "cache_len": kl,
            "dh": dh}, k.dtype


def _decode_int8_problem_fn(q, kq, ks, vq, vs, length=None):
    b, hq, dh = q.shape
    _, kl, hkv, _ = kq.shape
    # The layout is fixed (`q8` in the key): keyed on q's dtype.
    return {"bkv": b * hkv, "g": hq // hkv, "cache_len": kl,
            "dh": dh}, q.dtype


def _full(length, cache: torch.Tensor):
    """``length``, or the whole cache's depth when None."""
    return cache.shape[1] if length is None else length


def _decode_run_fn(plan: registry.Plan, q, k, v, *, length=None):
    return attn_decode.gqa_decode_attention(
        q, k, v, length=_full(length, k), block_k=plan.knobs["block_k"])


def _decode_reference_fn(q, k, v, length=None):
    return attn_decode.decode_ref(q, k, v, length=_full(length, k))


def _decode_int8_run_fn(plan: registry.Plan, q, kq, ks, vq, vs, *,
                        length=None):
    return attn_decode_int8.quantized_gqa_decode_attention(
        q, kq, ks, vq, vs, length=_full(length, kq),
        block_k=plan.knobs["block_k"])


def _decode_int8_reference_fn(q, kq, ks, vq, vs, length=None):
    return attn_decode_int8.quantized_decode_ref(
        q, kq, ks, vq, vs, length=_full(length, kq))


def _span_tie_break(knobs: dict) -> tuple:
    return (-knobs["block_k"],)


registry.register(registry.KernelSpec(
    name="decode",
    key_fn=_decode_key_fn,
    enumerate_candidates=_decode_enumerate,
    cost_fn=_decode_cost_fn,
    make_inputs=_decode_make_inputs,
    build_launcher=_decode_build_launcher,
    reference_fn=_decode_reference_fn,
    problem_fn=_decode_problem_fn,
    run_fn=_decode_run_fn,
    tie_break=_span_tie_break,
))

registry.register(registry.KernelSpec(
    name="decode_int8",
    key_fn=_decode_int8_key_fn,
    enumerate_candidates=_decode_int8_enumerate,
    cost_fn=_decode_int8_cost_fn,
    make_inputs=_decode_int8_make_inputs,
    build_launcher=_decode_int8_build_launcher,
    reference_fn=_decode_int8_reference_fn,
    problem_fn=_decode_int8_problem_fn,
    run_fn=_decode_int8_run_fn,
    tie_break=_span_tie_break,
))
