"""The attention rows of the kernel report on the H100: prefill flash
attention (B5) and single-query decode (B1, B3) through the tuner.
Counterpart of ``benchmarks/attention_prefill.py`` of the JAX package,
with its rows and keys:

- `tuned_vs_fixed`: model rows.  At the serving prefill shapes of real
  configs, the law's best (block_q, block_k) over the JAX package's
  candidates (`spec.rank_attention_blocks`, without the law's TPU staging
  term as a budget: B5's shared memory is fixed per design) against the
  JAX package's fixed (512, 512), and the tile B5 runs (``kernel_block``,
  the one tile of its design, which is what `tune` returns) priced beside
  them.
- `tuned_vs_fixed_measured`: B5 timed at its tuned tile against the
  fixed tile.  B5 is built for one tile per design, so the two are one
  tile and the speedup is 1.0 by construction; the row says so.
- `causal_skip_measured`: the causal kernel's K-steps against the dense
  grid's (`cost_model.attention_active_block_pairs` at B5's tile), and
  B5 causal timed against B5 without the mask, whose work is every block
  pair: the dense kernel's.
- `decode_step_measured`: B1 at the tuner's span (ranked by the model,
  as the server runs it) against the fixed `decode.SPLIT_KEYS`.
- `decode_ragged_measured`: B1 at one span with per-slot lengths against
  the whole cache for every slot.
- `decode_int8_measured`: B3 at its tuned span against B1 over a bf16
  cache at the same span, the bytes per token of each, and B3's error
  against the float cache's plain version.

On the card every time is `autotune.measure`'s (CUDA events behind a spin
of the card), the best of interleaved trials.  With ``--device cpu``
nothing is measured: the times are None and each row says
``"measured": false``; the counts, the model rows and the int8 error (of
the plain versions, which the CPU runs) are computed all the same.

    python -m repro_torch.benchmarks.attention_prefill [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import cost_model
from repro_torch.kernels import autotune, registry
from repro_torch.kernels.attention import decode as attn_decode
from repro_torch.kernels.attention import decode_int8 as attn_decode_int8
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.attention import spec as attn_spec
from repro_torch.runtime import quantize

# (arch, serving batch, prompt length): the prefill folds a server tunes.
PREFILL_POINTS = [
    ("qwen3_14b", 8, 2048),
    ("qwen3_14b", 8, 8192),
    ("phi3_mini_3_8b", 16, 4096),
    ("h2o_danube_1_8b", 32, 2048),
]
FIXED_BLOCK = 512           # the JAX package's pre-tuner prefill block
# The declared accuracy budget of the int8 KV stream, the JAX package's
# (`tools/check_bench.py` caps it).
INT8_ERR_BUDGET = 0.05


def _measured(device) -> bool:
    return resolve_device(device).type == "cuda"


def _best_us(device, keys, make_thunks, reps: int, trials: int) -> dict:
    """Best-of-``trials`` time of each of ``make_thunks()`` (a dict by
    ``keys``), interleaved so drift hits them alike.  On the CPU, which
    measures no kernel, None for each key, and no operand is made."""
    if not _measured(device):
        return {key: None for key in keys}
    device = resolve_device(device)
    thunks = make_thunks()
    best = {key: float("inf") for key in thunks}
    for _ in range(trials):
        for key, fn in thunks.items():
            best[key] = min(best[key],
                            autotune.measure(fn, device, reps=reps))
    return best


def _ratio(a, b):
    return None if a is None or b is None else a / b


def _randn(shape, device, dtype=torch.float32, seed: int = 0):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def prefill_shapes() -> list[dict]:
    out = []
    for arch, batch, prompt in PREFILL_POINTS:
        cfg = configs.get(arch)
        out.append({
            "arch": cfg.name, "batch": batch, "prompt": prompt,
            "bh": batch * cfg.num_heads, "sq": prompt, "sk": prompt,
            "dh": cfg.head_dim, "causal": cfg.causal,
            "window": cfg.sliding_window,
        })
    return out


def tuned_vs_fixed(device="cuda") -> list[dict]:
    """Model rows at the serving prefill shapes, bf16: the law's best
    pair over the JAX package's candidates against the fixed (512, 512),
    both by `cost_model.attention_time_model` for the H100, so
    ``speedup_model >= 1``; and the tile the tuner gives B5 (``kernel_
    block``), priced by the same law."""
    recs = []
    for s in prefill_shapes():
        problem = {k: s[k] for k in ("bh", "sq", "sk", "dh", "causal",
                                     "window")}
        fq, fk = min(FIXED_BLOCK, s["sq"]), min(FIXED_BLOCK, s["sk"])
        fixed = cost_model.attention_time_model(
            s["bh"], s["sq"], s["sk"], s["dh"], fq, fk, causal=s["causal"],
            window=s["window"])
        best = attn_spec.rank_attention_blocks(
            s["bh"], s["sq"], s["sk"], s["dh"], smem_bytes=attn_spec.NO_BUDGET,
            causal=s["causal"], window=s["window"], top=1)[0]
        plan = autotune.tune("attention", problem, torch.bfloat16,
                             device=device, measure_k=0)
        kernel = registry.get("attention").cost_fn(problem, plan.knobs)
        recs.append({
            "arch": s["arch"], "batch": s["batch"], "prompt": s["prompt"],
            "shape": [s["bh"], s["sq"], s["sk"], s["dh"]],
            "fixed_block": [fq, fk],
            "tuned_block": [best.knobs["block_q"], best.knobs["block_k"]],
            "tuned_source": "model",
            "tuned_measured_us": None,
            "gflops_fixed_model": fixed["gflops"],
            "gflops_tuned_model": best.detail["gflops"],
            "speedup_model": fixed["time_s"] / best.score,
            "kernel_block": [plan.knobs["block_q"], plan.knobs["block_k"]],
            "kernel_source": plan.source,
            "kernel_speedup_model": fixed["time_s"] / kernel["time_s"],
        })
    return recs


def tuned_vs_fixed_measured(device="cuda", b: int = 1, seq: int = 4096,
                            hq: int = 40, hkv: int = 8, dh: int = 128,
                            dtype=torch.bfloat16, reps: int = 5,
                            trials: int = 3) -> dict:
    """B5 at the tuned tile against the fixed tile: one causal prefill of
    ``b`` x ``seq`` tokens (default Qwen3-14B's heads).  B5 runs one tile
    per design, so tuned and fixed are that tile and one time serves
    both: ``speedup_vs_fixed`` is 1.0 by construction."""
    spec = registry.get("attention")
    problem = {"bh": b * hq, "sq": seq, "sk": seq, "dh": dh, "causal": True,
               "window": None}
    plan = autotune.tune("attention", problem, dtype, device=device,
                         measure_k=0)
    tuned = (plan.knobs["block_q"], plan.knobs["block_k"])
    fixed = attn_kernel.tile(dtype, dh)

    def thunks():
        q, k, v = _prefill_operands(device, b, seq, hq, hkv, dh, dtype)
        return {tuned: lambda: spec.run_fn(plan, q, k, v)}
    us = _best_us(device, [tuned], thunks, reps, trials)
    return {
        "shape": [b * hq, seq, seq, dh],
        "dtype": str(dtype).removeprefix("torch."),
        "tuned_block": list(tuned),
        "tuned_source": plan.source,
        "tuned_us": us[tuned],
        "fixed_block": list(fixed),
        "fixed_us": us[tuned],
        "speedup_vs_fixed": 1.0,
        "note": ("B5 is built for one tile per design: the tuned and the "
                 "fixed tile are that tile, timed once; the speedup is "
                 "1.0 by construction"),
        "measured": _measured(device),
    }


def _prefill_operands(device, b, seq, hq, hkv, dh, dtype):
    return (_randn((b, seq, hq, dh), device, dtype, 0),
            _randn((b, seq, hkv, dh), device, dtype, 1),
            _randn((b, seq, hkv, dh), device, dtype, 2))


def causal_skip_measured(device="cuda", b: int = 1, seq: int = 4096,
                         hq: int = 40, hkv: int = 8, dh: int = 128,
                         dtype=torch.bfloat16, reps: int = 5,
                         trials: int = 3) -> dict:
    """Block skipping at B5's tile: ``kstep_speedup`` is the dense grid's
    block pairs over the causal kernel's active ones (a count, the same
    on any device); ``wall_speedup`` is B5 without the mask (every block
    pair, the dense kernel's work) over B5 causal, on the card."""
    bq, bk = attn_kernel.tile(dtype, dh)

    def thunks():
        q, k, v = _prefill_operands(device, b, seq, hq, hkv, dh, dtype)
        return {causal: (lambda causal=causal: attn_kernel.flash_attention(
            q, k, v, scale=dh ** -0.5, causal=causal))
            for causal in (True, False)}
    us = _best_us(device, [True, False], thunks, reps, trials)
    active, total = cost_model.attention_active_block_pairs(
        seq, seq, bq, bk, causal=True)
    return {
        "shape": [b * hq, seq, seq, dh],
        "block": [bq, bk],
        "k_steps_dense": total,
        "k_steps_skip": active,
        "kstep_speedup": total / active,
        "skip_us": us[True],
        "dense_us": us[False],
        "wall_speedup": _ratio(us[False], us[True]),
        "dense_is": "B5 without the mask: every block pair streamed",
        "measured": _measured(device),
    }


def _decode_problem(b, hq, hkv, dh, cache_len) -> dict:
    return {"bkv": b * hkv, "g": hq // hkv, "cache_len": cache_len, "dh": dh}


def _decode_operands(device, b, hq, hkv, dh, cache_len):
    """f32 q (B, Hq, dh) and an f32 cache (B, L, Hkv, dh)."""
    return (_randn((b, hq, dh), device, seed=0),
            _randn((b, cache_len, hkv, dh), device, seed=1),
            _randn((b, cache_len, hkv, dh), device, seed=2))


def decode_step_measured(device="cuda", b: int = 4, hq: int = 40,
                         hkv: int = 8, dh: int = 128, cache_len: int = 32768,
                         length: int | None = None, reps: int = 5,
                         trials: int = 3) -> dict:
    """One decode-attention call over an f32 cache (default Qwen3-14B's
    heads at its 32k context): B1 at the span the tuner ranks first by
    the model (what the server runs) against the fixed
    `decode.SPLIT_KEYS`.  ``length`` defaults to a ragged 3/4 of the
    cache, so a coarse span's rounding occurs."""
    if length is None:
        length = cache_len * 3 // 4 + 1
    problem = _decode_problem(b, hq, hkv, dh, cache_len)
    plan = autotune.tune("decode", problem, torch.float32, device=device,
                         measure_k=0)
    tuned_bk, fixed_bk = plan.knobs["block_k"], attn_decode.SPLIT_KEYS
    spans = sorted({tuned_bk, fixed_bk})

    def thunks():
        q, k, v = _decode_operands(device, b, hq, hkv, dh, cache_len)
        lv = torch.full((b,), length, dtype=torch.int32, device=q.device)
        return {bk: (lambda bk=bk: attn_decode.gqa_decode_attention(
            q, k, v, length=lv, block_k=bk)) for bk in spans}
    us = _best_us(device, spans, thunks, reps, trials)
    return {
        "shape": [b * hkv, hq // hkv, cache_len, dh],
        "length": length,
        "tuned_block_k": tuned_bk,
        "tuned_source": plan.source,
        "tuned_us": us[tuned_bk],
        "fixed_block_k": fixed_bk,
        "fixed_us": us[fixed_bk],
        "speedup_vs_fixed": _ratio(us[fixed_bk], us[tuned_bk]),
        "model_time_us": plan.model_time_us,
        "measured": _measured(device),
    }


def decode_ragged_measured(device="cuda", b: int = 4, hq: int = 40,
                           hkv: int = 8, dh: int = 128,
                           cache_len: int = 32768,
                           block_k: int = attn_decode.SPLIT_KEYS,
                           reps: int = 5, trials: int = 3) -> dict:
    """Per-slot lengths against the whole cache for every slot, through
    B1 at one span: ``fetched_speedup`` is the keys the law streams for
    the broadcast over the ragged batch (a count), ``wall_speedup`` the
    two calls' times on the card.  The lengths are a continuous batch's
    steady state: slot i at (2i+1)/(2b) of the cache."""
    lengths = [max(1, ((2 * i + 1) * cache_len) // (2 * b))
               for i in range(b)]
    def thunks():
        q, k, v = _decode_operands(device, b, hq, hkv, dh, cache_len)
        lens = {"ragged": torch.tensor(lengths, dtype=torch.int32,
                                       device=q.device),
                "broadcast": torch.full((b,), cache_len, dtype=torch.int32,
                                        device=q.device)}
        return {key: (lambda lv=lv: attn_decode.gqa_decode_attention(
            q, k, v, length=lv, block_k=block_k))
            for key, lv in lens.items()}
    us = _best_us(device, ["ragged", "broadcast"], thunks, reps, trials)
    g = hq // hkv
    ragged = cost_model.decode_time_model(b * hkv, g, cache_len, dh,
                                          block_k, dtype_bytes=4,
                                          lengths=lengths)
    broadcast = cost_model.decode_time_model(b * hkv, g, cache_len, dh,
                                             block_k, dtype_bytes=4)
    return {
        "shape": [b, hq, hkv, cache_len, dh],
        "lengths": lengths,
        "block_k": block_k,
        "fetched_ragged": ragged["fetched_k"],
        "fetched_broadcast": broadcast["fetched_k"],
        "fetched_speedup": broadcast["fetched_k"] / ragged["fetched_k"],
        "model_speedup": broadcast["time_s"] / ragged["time_s"],
        "ragged_us": us["ragged"],
        "broadcast_us": us["broadcast"],
        "wall_speedup": _ratio(us["broadcast"], us["ragged"]),
        "measured": _measured(device),
    }


def decode_int8_measured(device="cuda", b: int = 4, hq: int = 40,
                         hkv: int = 8, dh: int = 128, cache_len: int = 32768,
                         length: int | None = None, reps: int = 5,
                         trials: int = 3) -> dict:
    """The int8 KV stream against the bf16 one at one decode shape: B3 at
    its tuned span (by the model) against B1 over a bf16 cache at the same
    span, on the card; ``bytes_ratio`` is bf16's bytes per token and KV
    head over int8's (``4 dh`` over ``2 (dh + 4)``); ``max_abs_err`` is the
    int8 path's output against the float cache's plain version
    (`decode.decode_ref`) on the values before quantization, which must
    stay within ``err_budget``.  bf16 q, the serving loop's."""
    if length is None:
        length = cache_len * 3 // 4 + 1
    problem = _decode_problem(b, hq, hkv, dh, cache_len)
    plan = autotune.tune("decode_int8", problem, torch.bfloat16,
                         device=device, measure_k=0)
    bk = plan.knobs["block_k"]
    q, k, v = _decode_operands(device, b, hq, hkv, dh, cache_len)
    q = q.to(torch.bfloat16)
    (kq, ks), (vq, vs) = quantize.quantize_rows(k), quantize.quantize_rows(v)
    lv = torch.full((b,), length, dtype=torch.int32, device=q.device)
    out_q = attn_decode_int8.quantized_gqa_decode_attention(
        q, kq, ks, vq, vs, length=lv, block_k=bk)
    out_f = attn_decode.decode_ref(q.float(), k, v, length=lv)
    max_abs_err = float((out_q.float() - out_f).abs().max())
    del out_f

    def thunks():
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        return {
            "int8": lambda: attn_decode_int8.quantized_gqa_decode_attention(
                q, kq, ks, vq, vs, length=lv, block_k=bk),
            "bf16": lambda: attn_decode.gqa_decode_attention(
                q, kb, vb, length=lv, block_k=bk)}
    us = _best_us(device, ["int8", "bf16"], thunks, reps, trials)
    bpt_int8 = quantize.bytes_per_token(dh)
    bpt_bf16 = 2 * dh * 2                        # K + V rows at 2 B each
    return {
        "shape": [b * hkv, hq // hkv, cache_len, dh],
        "length": length,
        "tuned_block_k": bk,
        "tuned_source": plan.source,
        "tuned_us": us["int8"],
        "bf16_us": us["bf16"],
        "bytes_per_token_int8": bpt_int8,
        "bytes_per_token_bf16": bpt_bf16,
        "bytes_ratio": bpt_bf16 / bpt_int8,
        "max_abs_err": max_abs_err,
        "err_budget": INT8_ERR_BUDGET,
        "model_time_us": plan.model_time_us,
        "measured": _measured(device),
    }


def _us(x) -> str:
    return "0.0" if x is None else f"{x:.1f}"


def _x(x) -> str:
    return "not_measured" if x is None else f"{x:.3f}"


def main(argv=None, tuned_recs=None, measured_rec=None, skip_rec=None,
         decode_rec=None, ragged_rec=None, int8_rec=None) -> list[str]:
    """``attn.*`` CSV lines of the six rows (each computed unless given)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv or [])
    device = resolve_device(args.device)
    lines = []
    for r in (tuned_recs if tuned_recs is not None
              else tuned_vs_fixed(device)):
        lines.append(
            f"attn.tuned_{r['arch']}_b{r['batch']}_p{r['prompt']},0.0,"
            f"speedup_model={r['speedup_model']:.3f};"
            f"block={r['tuned_block'][0]}/{r['tuned_block'][1]};"
            f"kernel_block={r['kernel_block'][0]}/{r['kernel_block'][1]};"
            f"kernel_speedup_model={r['kernel_speedup_model']:.3f}")
    m = (measured_rec if measured_rec is not None
         else tuned_vs_fixed_measured(device))
    lines.append(
        f"attn.measured_bh{m['shape'][0]}_s{m['shape'][1]},"
        f"{_us(m['tuned_us'])},speedup_vs_fixed=1.000 (one tile);"
        f"block={m['tuned_block'][0]}/{m['tuned_block'][1]}")
    s = skip_rec if skip_rec is not None else causal_skip_measured(device)
    lines.append(
        f"attn.causal_skip_s{s['shape'][1]},{_us(s['skip_us'])},"
        f"kstep_speedup={s['kstep_speedup']:.3f};"
        f"wall_speedup={_x(s['wall_speedup'])};"
        f"block={s['block'][0]}/{s['block'][1]}")
    d = decode_rec if decode_rec is not None else decode_step_measured(device)
    lines.append(
        f"attn.decode_bkv{d['shape'][0]}_l{d['shape'][2]},"
        f"{_us(d['tuned_us'])},"
        f"speedup_vs_fixed={_x(d['speedup_vs_fixed'])};"
        f"block_k={d['tuned_block_k']};fixed={d['fixed_block_k']};"
        f"src={d['tuned_source']}")
    rg = (ragged_rec if ragged_rec is not None
          else decode_ragged_measured(device))
    lines.append(
        f"attn.decode_ragged_b{rg['shape'][0]}_l{rg['shape'][3]},"
        f"{_us(rg['ragged_us'])},"
        f"fetched_speedup={rg['fetched_speedup']:.3f};"
        f"wall_speedup={_x(rg['wall_speedup'])};block_k={rg['block_k']}")
    q8 = int8_rec if int8_rec is not None else decode_int8_measured(device)
    lines.append(
        f"attn.decode_int8_bkv{q8['shape'][0]}_l{q8['shape'][2]},"
        f"{_us(q8['tuned_us'])},"
        f"bytes_ratio={q8['bytes_ratio']:.3f};"
        f"max_abs_err={q8['max_abs_err']:.4f};"
        f"block_k={q8['tuned_block_k']};src={q8['tuned_source']}")
    return lines


if __name__ == "__main__":
    print("\n".join(main(sys.argv[1:])))
