"""Blocked dense matmul with a fused epilogue.  Counterpart of the Pallas
kernel `repro.kernels.matmul.kernel.blocked_matmul` (body
``_matmul_kernel``).

The work is done by hand-written CUDA kernels; `ref.matmul_ref` is their
plain PyTorch version.  The wrapper takes the plain version only when
every operand lies on the CPU; a CUDA tensor launches the kernel that
`design` names or raises.  Three designs:

- ``"wgmma+TMA"`` (``csrc/blocked_matmul_wgmma.cu``): bf16 operands that
  TMA can read, a 16-byte aligned base and row strides of a multiple of
  16 bytes.  A ring of TMA-fed stages, a producer warpgroup and one or two
  consumer warpgroups on ``wgmma``; a persistent grid of one block per
  SM walks the output tiles (measured faster on the H100 than one block
  a tile: PERF.md, B6).
- ``"mma.sync"`` (``csrc/blocked_matmul.cu``): any other bf16 operands,
  such as a strided view, on ``mma.sync`` fed by ``cp.async``.
- ``"cuda cores"`` (``csrc/blocked_matmul.cu``): f32 operands, exact FMAs,
  never TF32.

``launches`` counts kernel launches, ``design_launches`` the same by
design.  Unlike the Pallas kernel the CUDA ones mask ragged M, N and K
themselves, so operands are never padded.  They are built for the tiles
of `core.tiling.HOPPER_TILES`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import ref

ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
TILES = tiling.HOPPER_TILES
DESIGNS = ("wgmma+TMA", "mma.sync", "cuda cores")
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0
design_launches = dict.fromkeys(DESIGNS, 0)


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


def _tma_readable(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` by rows: a contiguous last axis, and a
    base address and row stride that are multiples of 16 bytes."""
    return (t.stride(1) == 1 and t.data_ptr() % 16 == 0
            and t.stride(0) * t.element_size() % 16 == 0)


def design(a: torch.Tensor, b: torch.Tensor,
           tile: tiling.Tile | None = None) -> str:
    """The kernel that computes ``a @ b`` on the card: "wgmma+TMA" for
    bf16 operands TMA can read, "mma.sync" for any other bf16 operands,
    "cuda cores" for f32.  Every built tile runs on each design, so
    ``tile`` does not move the choice."""
    if a.dtype != torch.bfloat16:
        return "cuda cores"
    return "wgmma+TMA" if _tma_readable(a) and _tma_readable(b) \
        else "mma.sync"


def _lib():
    lib = _build.library("blocked_matmul")
    if lib.blocked_matmul.argtypes is None:
        lib.blocked_matmul.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        lib.blocked_matmul.restype = ctypes.c_int
        lib.blocked_matmul_smem.argtypes = [ctypes.c_int] * 4
        lib.blocked_matmul_smem.restype = ctypes.c_longlong
    return lib


def _wgmma_lib():
    lib = _build.library("blocked_matmul_wgmma")
    if lib.blocked_matmul_wgmma.argtypes is None:
        lib.blocked_matmul_wgmma.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.blocked_matmul_wgmma.restype = ctypes.c_int
        lib.blocked_matmul_wgmma_smem.argtypes = [ctypes.c_int] * 3
        lib.blocked_matmul_wgmma_smem.restype = ctypes.c_longlong
    return lib


def launch_smem_bytes(tile: tiling.Tile, kind: str) -> int:
    """Dynamic shared memory a launch of design ``kind`` takes at
    ``tile``, as the built kernel reports it (needs the CUDA build)."""
    if kind == "wgmma+TMA":
        return _wgmma_lib().blocked_matmul_wgmma_smem(tile.y, tile.x, tile.z)
    return _lib().blocked_matmul_smem(tile.y, tile.x, tile.z,
                                      int(kind == "mma.sync"))


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
    kind = design(a, b, tile)
    bias_f32 = None if bias is None else bias.reshape(n).float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    bias_ptr = None if bias_f32 is None else bias_f32.data_ptr()
    if kind == "wgmma+TMA":
        sms = torch.cuda.get_device_properties(a.device) \
            .multi_processor_count
        err = _wgmma_lib().blocked_matmul_wgmma(
            a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), n, tile.y, tile.x, tile.z,
            int(out_dtype == torch.bfloat16), ACTIVATION_CODES[activation],
            sms, stream)
    else:
        elt = a.element_size()
        vec = all(t.data_ptr() % 16 == 0 and t.stride(0) * elt % 16 == 0
                  for t in (a, b)) and k * elt % 16 == 0 \
            and n * elt % 16 == 0
        err = _lib().blocked_matmul(
            a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), n, tile.y, tile.x, tile.z,
            int(a.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            ACTIVATION_CODES[activation], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"blocked_matmul kernel ({kind}) launch failed: "
                           f"CUDA error {err}")
    global launches
    launches += 1
    design_launches[kind] += 1
    return out
