"""Forward flash attention for prefill.  Counterpart of the Pallas kernel
`repro.kernels.attention.kernel.flash_attention` (body ``_flash_kernel``).

The work is done by the hand-written CUDA kernels of
``csrc/flash_attention.cu``; `ref.attention_ref` is their plain PyTorch
version.  A wrapper takes the plain version only for tensors that lie on
the CPU; a CUDA tensor launches a kernel or raises.  `design` picks the
kernel from the dtype and head_dim: bf16 at head_dim 128 (Qwen3-14B's
prefill) runs on TMA and ``wgmma`` in tiles of 128 query rows by 128
keys; bf16 at the other head dims on ``mma.sync`` and f32 on CUDA cores,
both in tiles of 64 by 64 (`TILES`).  ``launches`` counts kernel
launches, so a run can show that its prefill went through a kernel.

The JAX prefill picks ``(block_q, block_k)`` through the tuner.  Each
CUDA kernel here is built for one tile, so `flash_attention` takes
``block_q``/``block_k`` only when they are that tile (`tile`) and refuses
any other; the attention spec (`kernels.attention.spec`) offers the tuner
that one tile per design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import ref

# Every head_dim of the configs this path runs and of their SMOKE
# variants (16); the bf16 kernels' products take dh in steps of 16.
HEAD_DIMS = (16, 80, 96, 128)
_DTYPES = (torch.float32, torch.bfloat16)
# (query rows, keys) of each kernel's tile
TILES = {"wgmma": (128, 128), "mma.sync": (64, 64), "f32": (64, 64)}

launches = 0


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a (dtype, head_dim) runs on the card: "wgmma" (TMA,
    warp-specialised, bf16 at head_dim 128), "mma.sync" (bf16 at the
    other head dims) or "f32" (CUDA cores)."""
    if dtype == torch.bfloat16:
        return "wgmma" if head_dim == 128 else "mma.sync"
    return "f32"


def tile(dtype: torch.dtype, head_dim: int) -> tuple[int, int]:
    """(query rows, keys) of the tile the kernel of (dtype, head_dim) is
    built for."""
    return TILES[design(dtype, head_dim)]


def _check_tile(q, block_q, block_k) -> None:
    """Refuse a (block_q, block_k) that is not the tile of q's design;
    None takes the design's own."""
    want = tile(q.dtype, q.shape[3])
    got = (want[0] if block_q is None else block_q,
           want[1] if block_k is None else block_k)
    if got != want:
        raise ValueError(
            f"flash_attention is built for the {want[0]} x {want[1]} tile "
            f"of its {design(q.dtype, q.shape[3])} design ({q.dtype}, "
            f"head_dim {q.shape[3]}); got block_q={block_q}, "
            f"block_k={block_k}")


def _check(q, k, v, window) -> None:
    """Shapes of q (B, Sq, Hq, dh), k and v (B, Sk, Hkv, dh), and the
    window."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch and head_dim")
    if min(b, sq, k.shape[1], hq) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _check_cuda(q, k, v) -> None:
    """What the CUDA kernel needs: one card, one float type, a supported
    head_dim, and rows copied in 16-byte pieces (contiguous last axis,
    address and every other stride a multiple of 16 bytes)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k and v must lie on one CUDA device (got "
                         f"{q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q={q.dtype}, k={k.dtype}, v={v.dtype}: "
                         f"all three must be float32 or all bfloat16")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not supported by the CUDA "
                         f"flash kernel (supported: {HEAD_DIMS})")
    for t in (q, k, v):
        elt = t.element_size()
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s * elt % 16 for s in t.stride()[:3])):
            raise ValueError("the kernel copies rows in 16-byte pieces: q, "
                             "k and v need a contiguous last axis and "
                             "addresses and strides that are multiples of "
                             "16 bytes")


def _entry(name: str):
    fn = getattr(_build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int | None = None, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh) in
    q's dtype, contiguous.

    Query row ``i`` of head ``h`` attends to key ``j`` of KV head
    ``h // g`` when ``i >= j`` (``causal``), ``i - j < window``
    (``window``) and ``j < Sk``, positions counted from 0 in each
    sequence; a row with no such key outputs 0.  K tiles outside a query
    tile's band (`core.cost_model.attention_step_bounds` at the tile of
    `design`) are never read.  Operands are read in place through their
    strides.  ``block_q``/``block_k`` may name the design's tile (`tile`)
    and nothing else; the plain version on the CPU holds them to the same
    rule.
    """
    _check(q, k, v, window)
    _check_tile(q, block_q, block_k)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.attention_ref(q, k, v, scale=scale, causal=causal,
                                 window=window)
    _check_cuda(q, k, v)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    entry = ("flash_attention_wgmma" if design(q.dtype, dh) == "wgmma"
             else "flash_attention")
    err = _entry(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, sq, sk, hq, hkv, dh, int(causal),
        0 if window is None else int(window), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
