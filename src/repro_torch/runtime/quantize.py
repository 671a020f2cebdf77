"""Symmetric int8 quantization of KV-cache rows.  Counterpart of
`repro.runtime.quantize`, with the same laws and the same bits.

The block is one token row: each written token's (dh,)-vector per KV head
gets one f32 scale, ``absmax / 127``, and codes ``round(x / scale)`` in
[-127, 127] (-128 is unused, so negation is exact).  Tokens are quantized
once, when they enter the cache; a per-row scale keeps every write
idempotent, so re-quantizing dequantized rows gives the same codes.

Codes and scales equal the JAX package's bit for bit on the CPU: the
scale is the same f32 division, the codes divide by ``max(scale,
SCALE_FLOOR)`` (not a multiply by its reciprocal), `torch.round` rounds
half to even like `jnp.round`, and the clamp to +-127 comes before the
cast to int8.
"""

from __future__ import annotations

import torch

QMAX = 127
SCALE_FLOOR = 1e-12


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (..., dh) float -> (codes int8 (..., dh), scale f32 (...))``.

    The row element of largest magnitude maps to exactly +-QMAX.  A zero
    row gets scale 0 (the floor only guards the division) and zero codes.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / QMAX
    q = torch.round(xf / torch.clamp(scale[..., None], min=SCALE_FLOOR))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``q * scale`` in f32."""
    return q.float() * scale[..., None].float()


def quantized_zeros(shape: tuple[int, ...], device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, scale) of an empty cache of ``shape`` token rows (last axis
    dh): the image of `quantize_rows` of zeros, so a reset slot is bitwise
    a fresh one."""
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def bytes_per_token(dh: int, *, kv: int = 2) -> int:
    """Bytes per token per KV head of the int8 layout: dh codes and one f32
    scale, for each of K and V (``kv = 2``)."""
    return kv * (dh + 4)


def max_abs_error_bound(x: torch.Tensor) -> torch.Tensor:
    """Per-row round-trip error bound: half a quantization step,
    ``absmax(row) / QMAX / 2``."""
    return x.float().abs().amax(dim=-1) / QMAX / 2.0
