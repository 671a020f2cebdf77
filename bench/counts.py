"""The benchmark's own arithmetic: the chip's peaks, and the operations
and bytes that the work of a run needs, counted from the model's sizes
and the positions each forward carried, whatever kernels compute them.

A forward's rows are ``(slot, depth, new)``: the slot's cache held
``depth`` rows before the forward and ``new`` of its positions carried a
prompt or riding token.  Padding and idle slots are not counted.
"""

from __future__ import annotations

# The data sheet's NVIDIA H100 SXM (dense rates, at 700 W), keyed by the
# name `torch.cuda.get_device_name` gives.  A card not listed has no peak,
# and the shares of a peak are then not reported.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(device_kind: str) -> dict | None:
    return PEAKS.get(device_kind)


def layer_matmul_params(m: dict) -> int:
    """Weights of one layer that multiply every position: Q, K, V, O and
    the SwiGLU's gate, up and down projections."""
    d, ff, dh = m["hidden_size"], m["intermediate_size"], m["head_dim"]
    q, kv = m["num_attention_heads"] * dh, m["num_key_value_heads"] * dh
    return 2 * d * q + 2 * d * kv + 3 * d * ff


def forward_flops(m: dict, rows, emitted: int) -> float:
    """Useful operations of one forward: 2 per matmul weight per position
    carried, the unembedding of the ``emitted`` positions whose logits
    give a token, and causal attention's QK and PV products (4 per query
    width per key attended) over the keys each carried position sees."""
    layers = m["num_hidden_layers"]
    q = m["num_attention_heads"] * m["head_dim"]
    positions = sum(n for _, _, n in rows)
    # position depth + j (j < n) attends depth + j + 1 keys
    keys = sum(n * depth + n * (n + 1) // 2 for _, depth, n in rows)
    return (2.0 * layers * layer_matmul_params(m) * positions
            + 2.0 * m["vocab_size"] * m["hidden_size"] * emitted
            + 4.0 * layers * q * keys)


def decode_attention_bytes(m: dict, lengths) -> float:
    """The least bytes one layer's single-token attention over a
    contiguous bf16 cache moves: each slot's K and V rows up to its
    length, its bf16 query and output rows, once each."""
    hkv, hq, dh = (m["num_key_value_heads"], m["num_attention_heads"],
                   m["head_dim"])
    rows = sum(int(n) for n in lengths)
    return 2.0 * 2 * (rows * hkv * dh + len(lengths) * hq * dh)


def decode_attention_flops(m: dict, lengths) -> float:
    """One layer's single-token attention: QK and PV, 4 per query width
    per key."""
    return 4.0 * m["num_attention_heads"] * m["head_dim"] * sum(
        int(n) for n in lengths)


def decode_attention_bound_s(m: dict, lengths, chip: dict) -> float:
    """The least time one layer's single-token attention can take: the
    larger of its bytes over the bandwidth and its operations over the
    peak."""
    return max(decode_attention_bytes(m, lengths) / chip["hbm_bytes_s"],
               decode_attention_flops(m, lengths) / chip["bf16_flops"])
