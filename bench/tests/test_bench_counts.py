"""The benchmark's operation and byte counts against hand counts at the
SMOKE sizes of both configurations."""

import json

import pytest

from bench import counts, spec
from conftest import SMOKE


def _model(name):
    with open(spec.BENCH / "configs" / f"{name}.json") as f:
        m = json.load(f)
    m.update(SMOKE[name])
    return m


def test_layer_params_by_hand():
    # d 64, ff 128, 4 heads of 16: q 64; Phi-3 4 KV heads (kv 64),
    # Qwen 2 KV heads (kv 32).
    assert counts.layer_matmul_params(_model("phi3_mini_3_8b")) == \
        64 * 64 + 64 * 64 + 64 * 64 + 64 * 64 + 3 * 64 * 128
    assert counts.layer_matmul_params(_model("qwen2_5_32b")) == \
        64 * 64 + 64 * 32 + 64 * 32 + 64 * 64 + 3 * 64 * 128


@pytest.mark.parametrize("name", ["phi3_mini_3_8b", "qwen2_5_32b"])
def test_forward_flops_by_hand(name):
    m = _model(name)
    p = counts.layer_matmul_params(m)
    # a 3-token prompt into an empty slot and one riding token at depth 5:
    # 4 positions, keys 1 + 2 + 3 and 6, two emitted tokens.
    rows = [(0, 0, 3), (1, 5, 1)]
    want = (2 * 2 * p * 4 + 2 * 128 * 64 * 2 + 4 * 2 * 64 * (6 + 6))
    assert counts.forward_flops(m, rows, 2) == want


def test_decode_attention_bytes_and_bound_by_hand():
    m = _model("qwen2_5_32b")
    lengths = [10, 3, 0, 7]
    # K and V rows: 20 rows x 2 KV heads x 16 x 2 B, twice; q and out:
    # 4 slots x 4 heads x 16 x 2 B, twice.
    kv = 2 * 20 * 2 * 16 * 2
    qo = 2 * 4 * 4 * 16 * 2
    assert counts.decode_attention_bytes(m, lengths) == kv + qo
    assert counts.decode_attention_flops(m, lengths) == 4 * 4 * 16 * 20
    chip = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert counts.decode_attention_bound_s(m, lengths, chip) == \
        (kv + qo) / 3.35e12
    assert counts.peak("cpu") is None
