"""Carry parameter and cache trees across from the JAX package, every
family's: stacked expert leaves (L, E, D, F), a hybrid's group dicts,
the RWKV and Mamba leaves, a frontend's ``proj``.

The JAX side hands over its trees as numpy (``jax.tree.map(np.asarray,
tree)``, done by the caller); these functions map such a nested dict to
torch tensors with the same keys, shapes and dtypes, and back.  bfloat16
arrives as numpy's ``ml_dtypes.bfloat16``, which torch cannot read
directly, so it crosses as its raw 16-bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import pool_zeros


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """Nested dict of numpy arrays (JAX params) -> same tree of tensors."""
    return _tree(tree, lambda a: _to_torch(a, device))


POOL_LEAVES = ("k", "v", "k_scale", "v_scale")


def cache_from_numpy(tree: dict, device="cpu") -> dict:
    """A JAX cache tree (``blocks``/``index``/``lengths``, and ``pages``
    when paged) -> the same tree of tensors, every leaf in its own dtype:
    int8 codes stay int8, scales and recurrent states f32, the page table
    int32, the 0-d ``index`` a 0-d int32 tensor; a hybrid's group dicts
    and the RWKV and Mamba leaves come across as they are.  The attention
    page pools of a paged cache (the leaves named in ``POOL_LEAVES``) are
    re-allocated with the port's trash page (`layers.pool_zeros`), values
    unchanged, so the port's layers can write through them."""
    cache = params_from_numpy(tree, device)

    def repool(blocks: dict) -> None:
        for name, a in blocks.items():
            if isinstance(a, dict):
                repool(a)
            elif name in POOL_LEAVES:
                pool = pool_zeros(a.shape, a.dtype, a.device, axis=1)
                pool.copy_(a)
                blocks[name] = pool

    if "pages" in cache:
        repool(cache["blocks"])
    return cache


def to_numpy(tree: dict) -> dict:
    """Tensors -> numpy, bfloat16 widened to float32 (for comparisons)."""
    def one(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _tree(tree, one)


def disable_tf32() -> None:
    """Pin float32 matrix products and convolutions to full float32: the
    parity tests compare against an f32 reference and TF32 keeps only
    about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
