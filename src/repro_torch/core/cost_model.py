"""The block-skip law of the flash-attention kernel.  A copy of three
functions of `repro.core.cost_model` (`attention_step_bounds`,
`attention_active_block_pairs`, `attention_max_k_steps`), kept here
because this package never imports the JAX one.

The CUDA kernel ``csrc/flash_attention.cu`` mirrors `attention_step_bounds`
in its own index math; `attention_active_block_pairs` counts the (q tile,
K tile) pairs it streams and multiplies.
"""

from __future__ import annotations


def attention_step_bounds(
    i: int, block_q: int, block_k: int, k_steps: int,
    causal: bool = True, window: int | None = None,
) -> tuple[int, int]:
    """[first, last] K-step bounds for q-block ``i`` under the causal /
    sliding-window mask.

    A K-block j is *active* iff some (q, k) pair inside the
    (block_q, block_k) tile survives the mask: causal caps ``last`` at the
    block holding the deepest row's diagonal, the window floors ``first``
    at the block still inside the band of the shallowest row.
    """
    q_lo, q_hi = i * block_q, (i + 1) * block_q - 1
    last = k_steps - 1
    if causal:
        last = min(last, q_hi // block_k)
    first = 0
    if window is not None:
        # active iff the block's deepest k reaches past q_lo - window
        first = max(0, (q_lo - window + 1) // block_k)
    return min(first, last), last


def attention_active_block_pairs(
    sq: int, sk: int, block_q: int, block_k: int,
    causal: bool = True, window: int | None = None,
) -> tuple[int, int]:
    """(active, total) (q_block, k_block) pair counts for the mask.
    ``total`` is the dense grid; the skipping kernel streams and
    multiplies only ``active`` pairs (causal ≈ triangle, window ≈ band)."""
    q_blocks = max(1, -(-sq // block_q))
    k_steps = max(1, -(-sk // block_k))
    active = 0
    for i in range(q_blocks):
        first, last = attention_step_bounds(i, block_q, block_k, k_steps,
                                            causal=causal, window=window)
        active += last - first + 1
    return active, q_blocks * k_steps


def attention_max_k_steps(
    sq: int, sk: int, block_q: int, block_k: int,
    causal: bool = True, window: int | None = None,
) -> int:
    """The widest per-q-block active range over the K axis.  Causal
    prefill at sq=sk keeps the full depth (the last row needs every
    block); a sliding window shrinks it to ~window/block_k."""
    q_blocks = max(1, -(-sq // block_q))
    k_steps = max(1, -(-sk // block_k))
    widest = 1
    for i in range(q_blocks):
        first, last = attention_step_bounds(i, block_q, block_k, k_steps,
                                            causal=causal, window=window)
        widest = max(widest, last - first + 1)
    return widest
