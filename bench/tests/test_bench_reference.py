"""The reference against the program's forward at the SMOKE sizes of
both configurations, on the same seeded weights: the program's
`transformer.forward` in float32 over a batch of prompts, against the
reference over each prompt alone."""

import copy

import numpy as np
import pytest
import torch

from bench import check, spec, weights
from bench.harness import model_config
from bench.reference.dense import Dense
from conftest import SMOKE


def _model(name):
    m = copy.deepcopy(spec.load(
        {"phi3_mini_3_8b": "phi3mini-chat",
         "qwen2_5_32b": "qwen25-32b-code"}[name]).config)
    m.update(SMOKE[name])
    return m


@pytest.mark.parametrize("name", ["phi3_mini_3_8b", "qwen2_5_32b"])
def test_reference_matches_the_program_forward(name):
    from repro_torch.models import transformer
    m = _model(name)
    seed = 2 ** 31 + 99
    tree = weights.server_tree(m, seed, "cpu")
    f32 = _to_f32(tree)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, m["vocab_size"], (3, 20)))
    logits, _ = transformer.forward(model_config(m), f32, {"tokens": toks},
                                    compute_dtype=torch.float32)
    ref = Dense(m, seed, "cpu").logits(list(toks), [list(range(20))] * 3)
    for b in range(3):
        err = (logits[b] - ref[b]).abs().max() / ref[b].abs().max()
        assert err < 1e-5, float(err)


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def test_qkv_bias_moves_the_logits():
    """Every leaf is drawn on its own, so the model without its QKV
    biases has the same other weights: the biases must move the logits,
    or a reference or a program that dropped them would pass."""
    m = _model("qwen2_5_32b")
    seq = [torch.arange(12) % m["vocab_size"]]
    with_bias = Dense(m, 5, "cpu").logits(seq, [list(range(12))])[0]
    without = Dense({**m, "attention_bias": False}, 5, "cpu").logits(
        seq, [list(range(12))])[0]
    assert (with_bias - without).abs().max() > 1e-2 * with_bias.abs().max()


def test_widest_gap_reads_the_chosen_tokens():
    lg = [torch.tensor([[1.0, 3.0, 2.0], [0.0, -4.0, 2.0]])]
    assert check.widest_gap(lg, [torch.tensor([1, 2])]) == 0.0
    assert check.widest_gap(lg, [torch.tensor([2, 1])]) == \
        pytest.approx(6.0 / 4.0)
    assert check.control_gap(lg, [torch.tensor([[0.0, 1.0, 5.0],
                                                [0.0, 0.0, 1.0]])]) == \
        pytest.approx(1.0 / 3.0)


class _Done:
    def __init__(self, rid, prompt, tokens):
        self.rid, self.prompt, self.tokens = rid, [0] * prompt, [1] * tokens
        self.state = type("S", (), {"value": "completed"})()


def test_the_sample_holds_a_request_of_every_slot():
    """One long request holds more than the tokens sought; the sample
    still takes a finished request of each of the 8 slots, and is the
    same for the same seed."""
    reqs = [_Done(0, 500, 600)] + [_Done(r, 20, 10) for r in range(1, 33)]
    slot_of = {r.rid: r.rid % 8 for r in reqs}
    a = check.sample(reqs, slot_of, 2 ** 31 + 9, 400)
    assert a[0].rid == 0
    assert {slot_of[r.rid] for r in a} == set(range(8)) and len(a) == 8
    assert [r.rid for r in a] == \
        [r.rid for r in check.sample(reqs, slot_of, 2 ** 31 + 9, 400)]
    more = check.sample(reqs, slot_of, 2 ** 31 + 9, 700)
    assert sum(len(r.tokens) for r in more) >= 700
    assert len({r.rid for r in more}) == len(more)
