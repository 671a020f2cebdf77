"""Single-query GQA decode attention over a contiguous or a paged KV cache.

Counterpart of `repro.kernels.attention.decode`: the Pallas kernels
``decode_attention`` (GQA wrapper ``gqa_decode_attention``) and
``paged_gqa_decode_attention``.  The work is done by the hand-written
CUDA kernels ``csrc/decode_attention.cu`` and
``csrc/paged_decode_attention.cu``; ``decode_ref`` and ``paged_decode_ref``
are their plain PyTorch versions, ports of the JAX oracles.

A wrapper takes the plain version only for tensors that lie on the CPU.
A CUDA tensor launches the kernel or raises: there is no fallback.
``launches`` and ``paged_launches`` count kernel launches, so a run can
show that its decode steps went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# Every head_dim of the configs and their SMOKE variants, plus the tiny
# test configs' 8.  The kernels give one thread to each of dh <= 128
# output columns and copy K/V rows in 16-byte pieces.
HEAD_DIMS = (8, 16, 80, 96, 128)
MAX_GROUP = 16                      # query heads per KV head (kMaxGroup)
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # decode_attention.cu
paged_launches = 0    # paged_decode_attention.cu


def _lengths(length, b: int, kl: int, device) -> torch.Tensor:
    """``length`` (int, 0-d or (B,) tensor) as a clamped (B,) int32 tensor
    on ``device`` — `_row_lengths` of the JAX kernel, before the fold."""
    lv = torch.as_tensor(length, dtype=torch.int32, device=device)
    if lv.ndim == 0:
        lv = lv.expand(b)
    elif lv.shape != (b,):
        raise ValueError(f"length must be a scalar or a ({b},) per-sequence "
                         f"vector, got shape {tuple(lv.shape)}")
    return torch.clamp(lv, 0, kl).to(torch.int32).contiguous()


def _entry(name: str, n_ptrs: int, n_ints: int, n_strides: int):
    """The C entry ``name`` of ``csrc/<name>.cu`` (built on first use): its
    pointers, ints and 64-bit strides, then the f32 scale and the stream."""
    fn = getattr(_build.library(name), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_gqa(q: torch.Tensor, hkv: int, dh: int) -> int:
    """The group size g = Hq / Hkv of ``q`` (B, Hq, dh) against a cache of
    ``hkv`` heads of ``dh``; raises on a mismatch."""
    hq = q.shape[1]
    if q.shape[2] != dh:
        raise ValueError(f"q head_dim {q.shape[2]} != cache head_dim {dh}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    return hq // hkv


def check_cuda(q: torch.Tensor, tensors, g: int) -> None:
    """What every CUDA decode kernel needs of its operands: one card, a
    supported head_dim and group, a contiguous last axis of q, and cache
    rows copied in 16-byte pieces (address and every stride but the last a
    multiple of 16 bytes).  ``tensors`` are the cache arrays of (.., dh)
    rows."""
    dh = q.shape[2]
    if not (q.is_cuda and all(t.is_cuda for t in tensors)):
        raise ValueError("q and the cache must all lie on one CUDA device "
                         f"(got {q.device}, "
                         f"{', '.join(str(t.device) for t in tensors)})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the CUDA decode "
                         f"kernels (supported: {HEAD_DIMS})")
    if g > MAX_GROUP:
        raise ValueError(f"GQA group {g} > {MAX_GROUP} query heads per KV "
                         f"head is not supported by the CUDA decode kernels")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: must be float32 or bfloat16")
    if q.stride(2) != 1 or any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("q and the cache need a contiguous last (dh) axis")
    for t in tensors:
        elt = t.element_size()
        if t.data_ptr() % 16 or any(s * elt % 16 for s in t.stride()[:-1]):
            raise ValueError(
                "the kernels copy cache rows in 16-byte pieces: their "
                "address and strides must be multiples of 16 bytes"
                + (" (int8 rows: head_dim a multiple of 16)"
                   if t.dtype == torch.int8 else ""))


def page_table(pages: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``pages`` as the contiguous (B, max_pages) int32 table on q's card
    that the kernels read."""
    if pages.ndim != 2 or pages.shape[0] != q.shape[0]:
        raise ValueError(f"pages must be ({q.shape[0]}, max_pages), got "
                         f"{tuple(pages.shape)}")
    if pages.device != q.device:
        raise ValueError(f"pages lie on {pages.device}, q on {q.device}")
    return pages.to(torch.int32).contiguous()


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Each slot's pages of ``pool`` (num_pages, page_size, ...) copied
    into a (B, max_pages * page_size, ...) tensor, as a contiguous cache
    would hold them; entries are clamped to [0, num_pages), as the kernels
    clamp them."""
    b, mp = pages.shape
    safe = pages.long().clamp(0, pool.shape[0] - 1)
    g = pool[safe]                           # (B, mp, page_size, ...)
    return g.reshape(b, mp * pool.shape[1], *pool.shape[2:])


def paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, pages: torch.Tensor, *, length,
                     scale: float | None = None) -> torch.Tensor:
    """Plain version of `paged_gqa_decode_attention`, a port of the JAX
    ``paged_decode_ref``: gather each slot's pages back into a contiguous
    view, then `decode_ref`."""
    lv = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    if lv.ndim == 0:
        lv = lv.expand(q.shape[0])
    return decode_ref(q, gather_pages(k_pool, pages),
                      gather_pages(v_pool, pages), length=lv, scale=scale)


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
    b, _, dh = q.shape
    _, kl, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    g = check_gqa(q, hkv, dh)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lengths = _lengths(length, b, kl, q.device)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return decode_ref(q, k, v, length=lengths, scale=scale)
    check_cuda(q, (k, v), g)
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"cache dtypes k={k.dtype}, v={v.dtype}: the cache "
                         f"must be float32 or bfloat16")
    out = torch.empty((b, q.shape[1], dh), dtype=q.dtype, device=q.device)
    fn = _entry("decode_attention", 5, 7, 8)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), int(q.dtype == torch.bfloat16),
             int(k.dtype == torch.bfloat16), b, hkv, g, dh, kl,
             q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
             float(scale), _stream(q))
    _raise_on(err, "decode_attention")
    global launches
    launches += 1
    return out


def paged_gqa_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, pages: torch.Tensor, *,
                               length, scale: float | None = None
                               ) -> torch.Tensor:
    """Decode attention through a paged KV cache.

    q: (B, Hq, dh); k_pool, v_pool: (num_pages, page_size, Hkv, dh), the
    layer's page pools shared by every slot; pages: (B, max_pages) int32
    page table, -1 = no page; ``length`` a scalar or (B,) vector of valid
    prefixes, clamped to max_pages * page_size.  Key t of slot b is row
    t % page_size of pool page pages[b, t // page_size] (clamped to the
    pool); keys at or past a slot's length, and so the -1 entries past its
    last page, are never read.  Returns (B, Hq, dh) in q's dtype.
    """
    b, _, dh = q.shape
    num_pages, page_size, hkv, _ = k_pool.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}")
    g = check_gqa(q, hkv, dh)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    max_pages = pages.shape[1]
    lengths = _lengths(length, b, max_pages * page_size, q.device)
    if q.device.type == "cpu" and k_pool.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, pages, length=lengths,
                                scale=scale)
    check_cuda(q, (k_pool, v_pool), g)
    if k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes k={k_pool.dtype}, v={v_pool.dtype}: "
                         f"the pools must be float32 or bfloat16")
    table = page_table(pages, q)
    out = torch.empty((b, q.shape[1], dh), dtype=q.dtype, device=q.device)
    fn = _entry("paged_decode_attention", 6, 9, 8)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16),
             int(k_pool.dtype == torch.bfloat16), b, hkv, g, dh, num_pages,
             page_size, max_pages, q.stride(0), q.stride(1),
             *k_pool.stride()[:3], *v_pool.stride()[:3], float(scale),
             _stream(q))
    _raise_on(err, "paged_decode_attention")
    global paged_launches
    paged_launches += 1
    return out
