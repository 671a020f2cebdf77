"""Closed-form costs the dry run's counts do not give.  Counterpart of
`repro.core.estimate`, with the same formulas.

Two laws:

- The recurrence interiors of the Mamba and RWKV scans
  (`mamba_recurrence_per_token`, `rwkv_recurrence_per_token`,
  `recurrence_correction`).  XLA counts a scanned body once, so the
  reference adds them to its probes.  The port's scans are Python loops
  over time (`models/ssm.py` `_selective_scan`, `models/rwkv.py`
  `_wkv_scan`), every step of which the dry run's counter sees; the dry
  run records this law's figure beside its count and adds nothing.
- The device-memory traffic of one step on the deployed path
  (`bytes_model`), the roofline's memory term.  The counted bytes of a
  traced step are an unfused upper bound: every operation reads its inputs
  from and writes its outputs to device memory.  On Hopper the deployed
  path keeps some streams on chip, and the law charges them accordingly:
  the flash-attention kernel (B5, ``csrc/flash_attention.cu``) holds its
  score tiles and running softmax in registers and shared memory and
  re-reads K and V once per query tile of ``flash_block_q`` rows; a fused
  cross-entropy kernel (``loss_fused_kernel``) would keep the logits'
  chunks in shared memory; a scan's carried state stays in registers or
  shared memory (where the reference's comments say VMEM, read shared
  memory).  The constants are the reference's, deliberately
  conservative.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _bwd_factor(kind: str, remat: str) -> float:
    """fwd=1; backward ~2x fwd; full remat recomputes fwd once more."""
    if kind != "train":
        return 1.0
    return 4.0 if remat == "full" else 3.0


def mamba_recurrence_per_token(cfg: ModelConfig) -> tuple[float, float]:
    """(flops, device-memory bytes) per token per Mamba layer, forward."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    flops = 7.0 * d_in * n            # exp(dA), h update, y contraction
    # streamed per step: delta/x (d_in), B/C (2n), y out (d_in) at f32;
    # the carried state h stays on chip.
    bytes_ = (2 * d_in + 2 * n + d_in) * 4.0
    return flops, bytes_


def rwkv_recurrence_per_token(cfg: ModelConfig) -> tuple[float, float]:
    """(flops, device-memory bytes) per token per RWKV layer, forward."""
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    flops = 5.0 * d * dh              # kv outer, bonus read, state decay+add
    bytes_ = 5 * d * 4.0              # r,k,v,w streams + y out (f32)
    return flops, bytes_


def recurrence_correction(cfg: ModelConfig, tokens: float,
                          kind: str) -> tuple[float, float]:
    """Total (flops, bytes) of the scan interiors of one step call."""
    factor = _bwd_factor(kind, cfg.remat)
    flops = bytes_ = 0.0
    if cfg.family == "ssm":
        f, b = rwkv_recurrence_per_token(cfg)
        flops += f * tokens * cfg.num_layers
        bytes_ += b * tokens * cfg.num_layers
    elif cfg.family == "hybrid":
        n_mamba = sum(1 for l in range(cfg.num_layers)
                      if not cfg.is_attn_layer(l))
        f, b = mamba_recurrence_per_token(cfg)
        flops += f * tokens * n_mamba
        bytes_ += b * tokens * n_mamba
    return flops * factor, bytes_ * factor


def _layer_counts(cfg: ModelConfig):
    n_attn = sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l))
    n_moe = sum(1 for l in range(cfg.num_layers) if cfg.is_moe_layer(l))
    if cfg.family == "ssm":
        n_attn = 0
    n_mamba = (cfg.num_layers - n_attn) if cfg.family == "hybrid" else 0
    return n_attn, n_mamba, n_moe


def bytes_model(cfg: ModelConfig, *, batch: int, seq: int, kind: str,
                param_bytes: int, moment_bytes: float = 4.0,
                cache_len: int = 0, flash_block_q: int = 512,
                loss_fused_kernel: bool = False) -> dict:
    """Whole-cluster device-memory bytes for one step, by stream; the
    ``total`` key is their sum."""
    p = cfg.param_count()
    d, v = cfg.d_model, cfg.vocab_size
    tokens = batch * seq
    act = 2.0  # bf16 activations
    n_attn, n_mamba, n_moe = _layer_counts(cfg)
    l = cfg.num_layers
    out: dict = {}

    if kind == "train":
        # params: fwd read + bwd read (+1 remat re-read); grad write+read;
        # opt: param read+write, 2 moments read+write.
        reads = 3 if cfg.remat == "full" else 2
        out["params"] = p * param_bytes * (reads + 2 + 2) \
            + p * moment_bytes * 4
        # activations: save layer input (write+read) + ~8 intermediate
        # streams per layer during fwd/recompute/bwd.
        out["activations"] = l * tokens * d * act * 10
        # flash attention: K+V re-read once per q block (+bwd ~2x).
        window = cfg.sliding_window or seq
        kv_len = min(seq, window)
        kv_bytes = kv_len * cfg.num_kv_heads * cfg.head_dim * 2 * act
        out["attention_kv"] = n_attn * batch * (seq / flash_block_q) \
            * kv_bytes * 3
        # fused cross entropy: chunk logits write + lse read + bwd
        # recompute, ~3 accesses (0 with a fused kernel keeping them on
        # chip).
        out["loss"] = 0.0 if loss_fused_kernel else tokens * v * 4.0 * 3
        out["embed"] = tokens * d * param_bytes * 3
        # MoE buffers: dispatch gather + expert in/out + combine scatter.
        if n_moe:
            out["moe_buffers"] = n_moe * tokens * cfg.top_k * d * act * 6
    elif kind == "prefill":
        out["params"] = p * param_bytes
        out["activations"] = l * tokens * d * act * 6
        window = cfg.sliding_window or seq
        kv_len = min(seq, window)
        kv_bytes = kv_len * cfg.num_kv_heads * cfg.head_dim * 2 * act
        out["attention_kv"] = n_attn * batch * (seq / flash_block_q) \
            * kv_bytes
        out["loss"] = batch * v * 4.0
        out["embed"] = tokens * d * param_bytes
        if n_moe:
            out["moe_buffers"] = n_moe * tokens * cfg.top_k * d * act * 3
    else:  # decode: one token per sequence, full cache read
        out["params"] = cfg.active_param_count() * param_bytes
        window = cfg.sliding_window or cache_len
        kv_len = min(cache_len, window)
        kv_bytes = kv_len * cfg.num_kv_heads * cfg.head_dim * 2 * act
        out["attention_kv"] = n_attn * batch * kv_bytes
        # ssm/rwkv states: read+write per layer
        if cfg.family == "ssm":
            dh = cfg.rwkv_head_dim
            out["state"] = l * batch * d * dh * 4.0 * 2
        elif cfg.family == "hybrid":
            d_in = cfg.ssm_expand * d
            out["state"] = n_mamba * batch * d_in * cfg.ssm_state * 4.0 * 2
        out["activations"] = l * batch * d * act * 8
        out["loss"] = batch * v * 4.0
    out["total"] = float(sum(out.values()))
    return out
