"""Random weights of a dense decoder, made from a seed.

Every leaf of every layer is drawn by a generator of its own, seeded from
``(seed, leaf, layer)``, in the dtype it is served in.  So the benchmark
can build the whole tree on the card for the server, and the reference can
make any one layer again, bit for bit, without keeping the tree or taking
anything from the program.

Matrices, embeddings and the head are N(0, 0.02^2) in bf16.  The QKV
biases are bf16 with a standard deviation of 0.5 at a width of 5,120,
scaled with the square root of the width as a projection's output is
(0.5 is a third of 0.02 * sqrt(5120)): large enough to move the logits,
too small to drown the projections.  The norm scales are
1 + N(0, 0.05^2) in f32 (the program reads them in f32), so that a norm
that ignored its scale would show.
"""

from __future__ import annotations

import hashlib
import math

import torch

MATRIX_STD = 0.02
SCALE_STD = 0.05


def bias_std(hidden: int) -> float:
    return 0.5 * math.sqrt(hidden / 5120)


def leaf_seed(seed: int, name: str, layer: int) -> int:
    """A 63-bit generator seed for one leaf of one layer."""
    h = hashlib.blake2b(f"{int(seed)}:{name}:{layer}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def draw(out: torch.Tensor, seed: int, name: str, layer: int,
         hidden: int) -> torch.Tensor:
    """Fill ``out`` in place with leaf ``name`` of ``layer`` (-1 for the
    leaves outside the stack) of a model ``hidden`` wide, and return
    it."""
    g = torch.Generator(device=out.device)
    g.manual_seed(leaf_seed(seed, name, layer))
    if name.endswith("scale"):
        out.normal_(1.0, SCALE_STD, generator=g)
    elif name in ("bq", "bk", "bv"):
        out.normal_(0.0, bias_std(hidden), generator=g)
    else:
        out.normal_(0.0, MATRIX_STD, generator=g)
    return out


def layer_shapes(m: dict) -> dict:
    """``{leaf: (shape, dtype)}`` of one layer of the model ``m`` (a
    configuration file's ``model`` block)."""
    d, ff = m["hidden_size"], m["intermediate_size"]
    dh = m["head_dim"]
    q, kv = m["num_attention_heads"] * dh, m["num_key_value_heads"] * dh
    bf = torch.bfloat16
    shapes = {"ln1.scale": ((d,), torch.float32),
              "ln2.scale": ((d,), torch.float32),
              "wq": ((d, q), bf), "wk": ((d, kv), bf), "wv": ((d, kv), bf),
              "wo": ((q, d), bf),
              "w_gate": ((d, ff), bf), "w_up": ((d, ff), bf),
              "w_down": ((ff, d), bf)}
    if m["attention_bias"]:
        shapes.update({"bq": ((q,), bf), "bk": ((kv,), bf),
                       "bv": ((kv,), bf)})
    return shapes


def outer_shapes(m: dict) -> dict:
    """``{leaf: (shape, dtype)}`` of the leaves outside the layer stack."""
    v, d = m["vocab_size"], m["hidden_size"]
    return {"embed": ((v, d), torch.bfloat16),
            "final_norm.scale": ((d,), torch.float32),
            "head": ((v, d), torch.bfloat16)}


def layer(m: dict, seed: int, l: int, device) -> dict:
    """Layer ``l``'s leaves, flat (``"ln1.scale"``, ``"wq"``, ...)."""
    return {n: draw(torch.empty(s, dtype=dt, device=device), seed, n, l,
                    m["hidden_size"])
            for n, (s, dt) in layer_shapes(m).items()}


def outer(m: dict, seed: int, device) -> dict:
    return {n: draw(torch.empty(s, dtype=dt, device=device), seed, n, -1,
                    m["hidden_size"])
            for n, (s, dt) in outer_shapes(m).items()}


def server_tree(m: dict, seed: int, device) -> dict:
    """The whole model in the parameter tree the server takes (stacked
    leaves with a leading layer axis), every leaf drawn in place."""
    n = m["num_hidden_layers"]
    stack = {name: torch.empty((n, *s), dtype=dt, device=device)
             for name, (s, dt) in layer_shapes(m).items()}
    for name, t in stack.items():
        for l in range(n):
            draw(t[l], seed, name, l, m["hidden_size"])
    top = outer(m, seed, device)
    mixer = {k: stack[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
             if k in stack}
    return {"embed": {"table": top["embed"]},
            "blocks": {"ln1": {"scale": stack["ln1.scale"]},
                       "ln2": {"scale": stack["ln2.scale"]},
                       "mixer": mixer,
                       "mlp": {k: stack[k]
                               for k in ("w_gate", "w_up", "w_down")}},
            "final_norm": {"scale": top["final_norm.scale"]},
            "head": {"table": top["head"]}}
