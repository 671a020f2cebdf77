"""Blocked dense matmul with a fused epilogue.  Counterpart of the Pallas
kernel `repro.kernels.matmul.kernel.blocked_matmul` (body
``_matmul_kernel``).

The work is done by the hand-written CUDA kernel
``csrc/blocked_matmul.cu``; `ref.matmul_ref` is its plain PyTorch
version.  The wrapper takes the plain version only when every operand
lies on the CPU; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches.

Unlike the Pallas kernel, the CUDA one masks ragged M, N and K itself,
so operands are never padded.  It is built for the tiles of
`core.tiling.HOPPER_TILES`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import ref

ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
TILES = tiling.HOPPER_TILES
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def _check(a, b, bias, activation, out_dtype) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError(f"empty product: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if bias is not None and tuple(bias.shape) != (1, b.shape[1]):
        raise ValueError(f"bias {tuple(bias.shape)} is not (1, {b.shape[1]})")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"activation {activation!r} not supported "
                         f"(supported: {list(ACTIVATION_CODES)})")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"dtypes a={a.dtype}, b={b.dtype}: both float32 or "
                         f"both bfloat16")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not supported "
                         f"(float32 or bfloat16)")


def _entry():
    fn = _build.library("blocked_matmul").blocked_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def blocked_matmul(a: torch.Tensor, b: torch.Tensor, tile: tiling.Tile,
                   bias: torch.Tensor | None = None,
                   activation: str | None = None,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """act(a @ b + bias) for a (M, K), b (K, N), bias (1, N), in
    ``out_dtype`` (default: a's dtype), accumulated in f32 with the
    (y, x, z) ``tile``.  a and b are float32 or both bfloat16; bias is
    added in f32.  On the card a and b are read in place and must have a
    contiguous last axis."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, bias, activation, out_dtype)
    operands = (a, b) if bias is None else (a, b, bias)
    if all(t.device.type == "cpu" for t in operands):
        return ref.matmul_ref(a, b, bias=bias, activation=activation,
                              out_dtype=out_dtype)
    if not all(t.is_cuda and t.device == a.device for t in operands):
        raise ValueError("a, b and bias must lie on one CUDA device (got "
                         + ", ".join(str(t.device) for t in operands) + ")")
    if tile not in TILES:
        raise ValueError(f"tile {tile} not built (supported: "
                         f"{[(t.y, t.x, t.z) for t in TILES]})")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("a and b need a contiguous last axis")
    m, k = a.shape
    n = b.shape[1]
    elt = a.element_size()
    vec = all(t.data_ptr() % 16 == 0 and t.stride(0) * elt % 16 == 0
              for t in (a, b)) and k * elt % 16 == 0 and n * elt % 16 == 0
    bias_f32 = None if bias is None else bias.reshape(n).float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _entry()(a.data_ptr(), b.data_ptr(),
                   None if bias_f32 is None else bias_f32.data_ptr(),
                   out.data_ptr(), m, n, k, a.stride(0), b.stride(0), n,
                   tile.y, tile.x, tile.z, int(a.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16),
                   ACTIVATION_CODES[activation], int(vec),
                   torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blocked_matmul kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
