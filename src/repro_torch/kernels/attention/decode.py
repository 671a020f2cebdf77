"""Single-query GQA decode attention over a contiguous KV cache.

Counterpart of `repro.kernels.attention.decode` (the Pallas kernel
``decode_attention`` and its GQA wrapper ``gqa_decode_attention``).  The
work is done by the hand-written CUDA kernel ``csrc/decode_attention.cu``;
``decode_ref`` is its plain PyTorch version, a port of the JAX oracle.

`gqa_decode_attention` takes the plain version only for tensors that lie
on the CPU.  A CUDA tensor launches the kernel or raises: there is no
fallback.  ``launches`` counts kernel launches, so a run can show that its
decode steps went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# Every head_dim of the configs and their SMOKE variants, plus the tiny
# test configs' 8.  The kernel gives one thread to each of dh <= 128
# output columns and copies K/V rows in 16-byte pieces.
HEAD_DIMS = (8, 16, 80, 96, 128)
MAX_GROUP = 16                      # query heads per KV head (kMaxGroup)
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def _lengths(length, b: int, kl: int, device) -> torch.Tensor:
    """``length`` (int, 0-d or (B,) tensor) as a clamped (B,) int32 tensor
    on ``device`` — `_row_lengths` of the JAX kernel, before the fold."""
    lv = torch.as_tensor(length, dtype=torch.int32, device=device)
    if lv.ndim == 0:
        lv = lv.expand(b)
    elif lv.shape != (b,):
        raise ValueError(f"length must be a scalar or a ({b},) per-sequence "
                         f"vector, got shape {tuple(lv.shape)}")
    return torch.clamp(lv, 0, kl).to(torch.int32)


def _kernel():
    """The C entry of ``csrc/decode_attention.cu`` (built on first use)."""
    fn = _build.library("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               length, scale: float | None = None) -> torch.Tensor:
    """Plain version (materialized logits), a port of the JAX
    ``decode_ref``.  q: (B, Hq, dh); k, v: (B, L, Hkv, dh); ``length`` a
    scalar or (B,).  Computes in f32 and returns q's dtype; a slot with
    length 0 returns zeros."""
    b, hq, dh = q.shape
    _, kl, hkv, _ = k.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    qr = q.reshape(b, hkv, g, dh).float()
    kr = k.transpose(1, 2).float()                       # (b, hkv, kl, dh)
    vr = v.transpose(1, 2).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qr, kr) * scale
    lv = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    if lv.ndim == 0:
        lv = lv.expand(b)
    valid = torch.arange(kl, device=q.device)[None, :] < lv[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, vr)
    out = torch.where((lv > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, hq, dh).to(q.dtype)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, length, scale: float | None = None
                         ) -> torch.Tensor:
    """q: (B, Hq, dh); k, v: (B, L, Hkv, dh) -> (B, Hq, dh) in q's dtype.

    ``length`` is a scalar or a (B,) vector of valid cache prefixes,
    clamped to L.  Keys at or past a slot's length are never read; a slot
    of length 0 gets zeros.  The cache is read in place through its
    strides (no transpose or fold copies), which needs its last axis
    contiguous.
    """
    b, hq, dh = q.shape
    _, kl, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lengths = _lengths(length, b, kl, q.device)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return decode_ref(q, k, v, length=lengths, scale=scale)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must all lie on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    g = hq // hkv
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the CUDA decode "
                         f"kernel (supported: {HEAD_DIMS})")
    if g > MAX_GROUP:
        raise ValueError(f"GQA group {g} > {MAX_GROUP} query heads per KV "
                         f"head is not supported by the CUDA decode kernel")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"dtypes q={q.dtype}, k={k.dtype}, v={v.dtype}: "
                         f"q and the cache must be float32 or bfloat16")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a contiguous last (dh) axis")
    elt = k.element_size()
    if any(t.data_ptr() % 16 or any(s * elt % 16 for s in t.stride()[:3])
           for t in (k, v)):
        raise ValueError("the kernel copies K/V rows in 16-byte pieces: "
                         "their address and strides must be multiples of "
                         "16 bytes")
    lengths = lengths.contiguous()
    out = torch.empty((b, hq, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), int(q.dtype == torch.bfloat16),
             int(k.dtype == torch.bfloat16), b, hkv, g, dh, kl,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
