"""Plain PyTorch version of the blocked matmul kernel and its fused
epilogue.  Counterpart of `repro.kernels.matmul.ref.matmul_ref` and of
the activations of `repro.kernels.matmul.kernel.ACTIVATIONS`.

On the card an f32 product here must run with TF32 off
(`convert.disable_tf32`), as the parity checks set it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# jax.nn.gelu's default is the tanh approximation, and so is this one.
ACTIVATIONS = {
    None: lambda v: v,
    "relu": torch.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               bias: torch.Tensor | None = None,
               activation: str | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(a @ b + bias): the product of f32 copies of the operands, the
    bias in f32, the activation, then one cast to ``out_dtype`` (default:
    a's dtype)."""
    out_dtype = out_dtype or a.dtype
    y = a.float() @ b.float()
    if bias is not None:
        y = y + bias.float()
    return ACTIVATIONS[activation](y).to(out_dtype)


def row_tolerance(ref: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """How far a kernel's result may lie from this plain version, per
    element, as a column broadcast over each row: in f32 (summation order
    only) 1e-5 of the row's largest |ref|; in bf16, where each side
    rounds its f32 sum once, one bf16 ulp of the row's largest |ref|,
    2^-7 of it."""
    rel = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    return rel * ref.float().abs().amax(-1, keepdim=True)
