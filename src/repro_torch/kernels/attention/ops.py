"""Public flash-attention entry.  Counterpart of
`repro.kernels.attention.ops.mha_attention`.

Unlike the JAX wrapper, which repeats K/V along the folded batch axis
(so its query head ``h`` reads KV head ``h % Hkv``), this entry does no
repeat at all: the kernel maps query head ``h`` to KV head ``h // g`` in
its own index math, the grouping of `models.layers.attention_core`, of
the decode kernels and of training.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention import kernel


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  block_q: int | None = None, block_k: int | None = None
                  ) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh) in
    q's dtype, scaled by 1/sqrt(dh).  ``block_q``/``block_k`` as in
    `kernel.flash_attention`: the design's tile or None."""
    return kernel.flash_attention(q, k, v, scale=1.0 / math.sqrt(q.shape[3]),
                                  causal=causal, window=window,
                                  block_q=block_q, block_k=block_k)
