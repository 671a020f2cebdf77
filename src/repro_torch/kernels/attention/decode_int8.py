"""Single-query GQA decode attention over an int8 KV cache, contiguous or
paged.

Counterpart of `repro.kernels.attention.decode_int8`: the Pallas kernels
``quantized_decode_attention`` (GQA wrapper
``quantized_gqa_decode_attention``) and
``paged_quantized_gqa_decode_attention``.  The cache holds int8 codes with
one f32 scale per (token, KV head) (`runtime.quantize`), written once at
cache-write time; the kernels only read and dequantize.  q stays in f32
and every product accumulates in f32; the output has q's dtype.

The work is done by the hand-written CUDA kernels
``csrc/quantized_decode_attention.cu`` and
``csrc/paged_quantized_decode_attention.cu``; ``quantized_decode_ref`` and
``paged_quantized_decode_ref`` are their plain PyTorch versions, ports of
the JAX oracles.  A wrapper takes the plain version only for tensors that
lie on the CPU; a CUDA tensor launches the kernel or raises.
``launches`` and ``paged_launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import decode as _d
from repro_torch.runtime import quantize

launches = 0          # quantized_decode_attention.cu
paged_launches = 0    # paged_quantized_decode_attention.cu


def quantized_decode_ref(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor, *, length,
                         scale: float | None = None) -> torch.Tensor:
    """Plain version, a port of the JAX ``quantized_decode_ref``:
    dequantize the whole cache, then `decode_ref` with q in f32."""
    k = quantize.dequantize_rows(kq, ks)
    v = quantize.dequantize_rows(vq, vs)
    return _d.decode_ref(q.float(), k, v, length=length,
                         scale=scale).to(q.dtype)


def paged_quantized_decode_ref(q: torch.Tensor, kq_pool: torch.Tensor,
                               ks_pool: torch.Tensor, vq_pool: torch.Tensor,
                               vs_pool: torch.Tensor, pages: torch.Tensor, *,
                               length, scale: float | None = None
                               ) -> torch.Tensor:
    """Plain version of the paged variant, a port of the JAX
    ``paged_quantized_decode_ref``: gather each slot's pages (codes and
    scales) into a contiguous view, then `quantized_decode_ref`."""
    lv = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    if lv.ndim == 0:
        lv = lv.expand(q.shape[0])
    g = _d.gather_pages
    return quantized_decode_ref(q, g(kq_pool, pages), g(ks_pool, pages),
                                g(vq_pool, pages), g(vs_pool, pages),
                                length=lv, scale=scale)


def _check_int8(codes, scales, rows_shape) -> None:
    for c in codes:
        if c.dtype != torch.int8 or tuple(c.shape) != tuple(codes[0].shape):
            raise ValueError(f"codes must be int8 of one shape, got "
                             f"{c.dtype} {tuple(c.shape)}")
    for s in scales:
        if s.dtype != torch.float32 or tuple(s.shape) != rows_shape:
            raise ValueError(f"scales must be float32 {rows_shape}, got "
                             f"{s.dtype} {tuple(s.shape)}")


def _on_cpu(q, tensors) -> bool:
    return q.device.type == "cpu" and all(t.device.type == "cpu"
                                          for t in tensors)


def _check_cuda_scales(scales) -> None:
    if not all(s.is_cuda for s in scales):
        raise ValueError("the scales must lie on the CUDA device of q")


def quantized_gqa_decode_attention(q: torch.Tensor, kq: torch.Tensor,
                                   ks: torch.Tensor, vq: torch.Tensor,
                                   vs: torch.Tensor, *, length,
                                   scale: float | None = None,
                                   block_k: int | None = None
                                   ) -> torch.Tensor:
    """q: (B, Hq, dh) float; kq, vq: (B, L, Hkv, dh) int8; ks, vs: (B, L,
    Hkv) f32 -> (B, Hq, dh) in q's dtype.  ``length`` and ``block_k`` as
    in `gqa_decode_attention`."""
    b, _, dh = q.shape
    _, kl, hkv, _ = kq.shape
    _check_int8((kq, vq), (ks, vs), tuple(kq.shape[:3]))
    g = _d.check_gqa(q, hkv, dh)
    if kq.shape[0] != b:
        raise ValueError(f"cache batch {kq.shape[0]} != q batch {b}")
    span = _d.split_span(block_k)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lengths = _d._lengths(length, b, kl, q.device)
    if _on_cpu(q, (kq, ks, vq, vs)):
        return quantized_decode_ref(q, kq, ks, vq, vs, length=lengths,
                                    scale=scale)
    _d.check_cuda(q, (kq, vq), g)
    _check_cuda_scales((ks, vs))
    out = _d._launch(
        "quantized_decode_attention", q,
        (q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
         vs.data_ptr(), lengths.data_ptr()),
        (int(q.dtype == torch.bfloat16), b, hkv, g, dh, kl),
        (q.stride(0), q.stride(1), *kq.stride()[:3], *ks.stride(),
         *vq.stride()[:3], *vs.stride()),
        batch=b, hkv=hkv, g=g, dh=dh, rows=kl, span=span, scale=scale)
    global launches
    launches += 1
    return out


def paged_quantized_gqa_decode_attention(
        q: torch.Tensor, kq_pool: torch.Tensor, ks_pool: torch.Tensor,
        vq_pool: torch.Tensor, vs_pool: torch.Tensor, pages: torch.Tensor, *,
        length, scale: float | None = None,
        block_k: int | None = None) -> torch.Tensor:
    """Decode attention through an int8 paged KV cache.

    q: (B, Hq, dh) float; kq_pool, vq_pool: (num_pages, page_size, Hkv, dh)
    int8; ks_pool, vs_pool: (num_pages, page_size, Hkv) f32; pages: (B,
    max_pages) int32, -1 = no page; ``length`` a scalar or (B,), clamped to
    max_pages * page_size; ``block_k`` as in `gqa_decode_attention`.  The
    page walk is `paged_gqa_decode_attention`'s.
    Returns (B, Hq, dh) in q's dtype.
    """
    b, _, dh = q.shape
    num_pages, page_size, hkv, _ = kq_pool.shape
    _check_int8((kq_pool, vq_pool), (ks_pool, vs_pool),
                tuple(kq_pool.shape[:3]))
    g = _d.check_gqa(q, hkv, dh)
    span = _d.split_span(block_k)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    max_pages = pages.shape[1]
    lengths = _d._lengths(length, b, max_pages * page_size, q.device)
    if _on_cpu(q, (kq_pool, ks_pool, vq_pool, vs_pool)):
        return paged_quantized_decode_ref(q, kq_pool, ks_pool, vq_pool,
                                          vs_pool, pages, length=lengths,
                                          scale=scale)
    _d.check_cuda(q, (kq_pool, vq_pool), g)
    _check_cuda_scales((ks_pool, vs_pool))
    table = _d.page_table(pages, q)
    out = _d._launch(
        "paged_quantized_decode_attention", q,
        (q.data_ptr(), kq_pool.data_ptr(), ks_pool.data_ptr(),
         vq_pool.data_ptr(), vs_pool.data_ptr(), table.data_ptr(),
         lengths.data_ptr()),
        (int(q.dtype == torch.bfloat16), b, hkv, g, dh, num_pages, page_size,
         max_pages),
        (q.stride(0), q.stride(1), *kq_pool.stride()[:3], *ks_pool.stride(),
         *vq_pool.stride()[:3], *vs_pool.stride()),
        batch=b, hkv=hkv, g=g, dh=dh, rows=max_pages * page_size,
        span=span, scale=scale)
    global paged_launches
    paged_launches += 1
    return out
