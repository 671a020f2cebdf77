"""Shared layers on plain tensors: norms, RoPE, GQA attention, SwiGLU
and GELU MLPs, embeddings.  Counterpart of `repro.models.layers`.

Parameters are plain dicts of tensors with the JAX package's keys; a
layer stack holds stacked leaves with a leading layer axis, and the model
indexes one layer's views out of them.  Matrices are consumed through
``.to(x.dtype)`` exactly where the JAX code writes ``.astype(x.dtype)``.

The KV cache of a layer is contiguous, ``{"k", "v": (B, L, Hkv, dh)}``,
or paged, ``{"k", "v": (num_pages, page_size, Hkv, dh)}`` pools shared by
every slot through a page table; either may be int8, with codes in "k"
and "v" and one f32 scale per (token, KV head) in "k_scale" and "v_scale".
A sliding-window model's contiguous cache is a ring buffer of at most
``window`` rows per slot: position t lives in row ``t % L``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.attention import decode, decode_int8, ops
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import quantize, trace

Params = dict
DEFAULT_INIT_SCALE = 0.02
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

# Leaves of this module the forward reads in their own dtype, never through
# ``.to(compute dtype)``: the norm scales (read in f32).
OWN_DTYPE_LEAVES = frozenset({"scale"})


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """Computed in f32, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.

    Rotate-half: the two halves of head_dim are the pair coordinates and
    are concatenated back, not interleaved."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (half,)
    angles = positions[..., :, None].float() * freqs             # (.., s, half)
    cos = torch.cos(angles)[..., :, None, :]                     # (.., s, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(generator: torch.Generator, cfg, dtype=torch.float32
                   ) -> Params:
    """One layer's attention weights, drawn from ``generator`` (on its
    device) as N(0, 0.02^2) in f32 and cast to ``dtype``."""
    p = {
        "wq": _dense_init(generator, (cfg.d_model, cfg.q_dim), dtype),
        "wk": _dense_init(generator, (cfg.d_model, cfg.kv_dim), dtype),
        "wv": _dense_init(generator, (cfg.d_model, cfg.kv_dim), dtype),
        "wo": _dense_init(generator, (cfg.q_dim, cfg.d_model), dtype),
    }
    dev = generator.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, dtype, dev)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, dtype, dev)
    return p


def _dense_init(generator, shape, dtype, scale=DEFAULT_INIT_SCALE):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)


def _mask_block(q_pos, k_pos, causal: bool, window: int | None = None,
                k_valid=None) -> torch.Tensor:
    """Boolean mask from position vectors: ``(Sq, Sk)`` when every operand
    is shared across the batch (1-D), ``(B, Sq, Sk)`` when any carries a
    leading batch axis (ragged continuous batching).  A ``window`` keeps
    keys less than ``window`` positions behind the query."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok = ok & (diff >= 0)
    if window is not None:
        ok = ok & (diff < window)
    if k_valid is not None:
        ok = ok & k_valid[..., None, :]
    return ok


def attention_core(q, k, v, q_pos, k_pos, *, causal: bool, scale: float,
                   window: int | None = None, k_valid=None,
                   chunk_q: int | None = None,
                   remat_chunks: bool = False, seg=None) -> torch.Tensor:
    """Masked multi-head attention with GQA grouping (no cache repeat):
    query head h reads KV head h // g.

    q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh); ``q_pos`` (Sq,) or (B, Sq),
    ``k_pos`` (Sk,) or (B, Sk), ``k_valid`` (Sk,) or (B, Sk).  Operands
    enter the products in f32, which is the JAX code's "operands in their
    dtype, f32 accumulation" (a product of two bf16 values is exact in
    f32); probabilities are rounded to v's dtype first, as there.  Masked
    logits are filled with -1e30.  When ``chunk_q`` divides Sq the query
    blocks run one after another, so the (Sq, Sk) logits never exist at
    once; with ``remat_chunks`` (training under ``remat="full"``) each
    block runs under `torch.utils.checkpoint`, so the backward recomputes
    its logits and probabilities instead of keeping them.  With ``seg``
    (a `parallel.sharding.Split`, forward only) the keys are this rank's
    part of the sequence over the ``seg`` group: the softmax's max and
    sum are reduced over the group before the probabilities are rounded
    (`_split_softmax`) and the ranks' products are summed, so each rank
    holds the whole row's attention as the unsplit core computes it, up
    to summation order.  Returns f32 (B, Sq, Hq, dh).
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qr = q.reshape(b, sq, hkv, g, dh).float()
    kf = k.float()

    def blk(q_blk, qp_blk):
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, kf) * scale
        mask = _mask_block(qp_blk, k_pos, causal, window, k_valid)
        mask = (mask[None, None, None] if mask.ndim == 2
                else mask[:, None, None])
        logits = torch.where(mask, logits, NEG_INF)
        probs = (torch.softmax(logits, dim=-1) if seg is None
                 else _split_softmax(logits, seg))
        return torch.einsum("bhgqk,bkhd->bqhgd",
                            probs.to(v.dtype).float(), v.float())

    if chunk_q and sq > chunk_q and sq % chunk_q == 0:
        fn = blk
        if remat_chunks and torch.is_grad_enabled():
            fn = functools.partial(checkpoint, blk, use_reentrant=False)
        outs = []
        for i in range(0, sq, chunk_q):
            qp = q_pos[..., i:i + chunk_q]
            outs.append(fn(qr[:, i:i + chunk_q], qp))
        out = torch.cat(outs, dim=1)
    else:
        out = blk(qr, q_pos)
    return shd.reduce_out(out, seg).reshape(b, sq, hq, dh)


def _split_softmax(logits, seg) -> torch.Tensor:
    """`torch.softmax` over the last dim of ``logits`` split over
    ``seg``: the max and the sum of exponentials reduced over the group.
    A row masked everywhere comes out uniform over the whole row, as
    `torch.softmax` gives it."""
    m = shd.reduce_max(logits.amax(dim=-1, keepdim=True), seg)
    e = torch.exp(logits - m)
    return e / shd.reduce_out(e.sum(dim=-1, keepdim=True), seg)


def _write_cache(c: torch.Tensor, new: torch.Tensor, t_abs: torch.Tensor,
                 ok: torch.Tensor) -> None:
    """In place: ``c[b, t_abs[b, j]] = new[b, j]`` where ``ok[b, j]``.

    Rows that must not be written (inactive, or past the cache) are aimed
    at ``t_abs % L`` and rewritten with the value already there; with
    S <= L the targets of one slot are distinct, so the scatter has no
    duplicate indices and needs no host synchronisation."""
    b, s = t_abs.shape
    idx = t_abs % c.shape[1]
    b_idx = torch.arange(b, device=c.device)[:, None].expand(b, s)
    cur = c[b_idx, idx]
    keep = ok.reshape(ok.shape + (1,) * (new.ndim - 2))
    c[b_idx, idx] = torch.where(keep, new.to(c.dtype), cur)


def pool_zeros(shape, dtype, device, axis: int = 0) -> torch.Tensor:
    """A zeroed page pool of ``shape`` (pages along ``axis``), allocated
    with one more page past its end: the trash page, which the page table
    never names and the kernels never read.  The returned tensor is the
    view of the first ``shape[axis]`` pages; `with_trash_page` reaches the
    whole allocation."""
    full = list(shape)
    full[axis] += 1
    return torch.zeros(full, dtype=dtype, device=device).narrow(
        axis, 0, shape[axis])


def with_trash_page(pool: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``pool`` (a view made by `pool_zeros`, or a slice of one along
    another axis) widened by its trash page along ``axis``.  Torch checks
    the view against its storage, so a pool allocated without the trash
    page raises instead of reaching past it."""
    size = list(pool.shape)
    size[axis] += 1
    return pool.as_strided(size, pool.stride())


def _write_pages(pool: torch.Tensor, new: torch.Tensor, page_w: torch.Tensor,
                 row: torch.Tensor) -> None:
    """In place: ``pool[page_w[b, j], row[b, j]] = new[b, j]``.  Rows that
    must not be written are aimed at the trash page (``page_w`` =
    num_pages), where duplicate targets do no harm; live rows of the same
    scatter never share a target, since each pool page belongs to one
    slot."""
    with_trash_page(pool)[page_w, row] = new.to(pool.dtype)


def _kv_heads_read(cfg, hs) -> tuple[int, int]:
    """``(first, count)``: the KV heads this rank's query heads read
    (query head h reads KV head h // g) where ``hs`` splits the query
    heads and the KV heads stay whole; local query head i reads local KV
    head i // (Hq_loc / count).  Raises where the rank's query heads do
    not fall into equal groups (no config splits so)."""
    g = cfg.num_heads // cfg.num_kv_heads
    hq = cfg.num_heads // hs.n
    if hq % g and g % hq:
        raise ValueError(f"{hq} query heads a rank do not fall into equal "
                         f"groups of {g} per KV head")
    return hs.index * hq // g, max(hq // g, 1)


def _combine_segments(out, m, l, seg) -> torch.Tensor:
    """The whole row's attention from each rank's part of the keys over
    the ``seg`` group: `decode.combine_partials` in ascending rank
    order."""
    parts = shd.gather_dim(torch.stack([m, l])[None], 0, seg, False)
    accs = shd.gather_dim((out * l[..., None])[None], 0, seg, False)
    return decode.combine_partials(parts[:, 0], parts[:, 1], accs)


def attention_apply(params: Params, x: torch.Tensor, cfg,
                    positions: torch.Tensor, cache: Params | None = None,
                    lengths: torch.Tensor | None = None,
                    active: torch.Tensor | None = None,
                    chunk_q: int | None = None,
                    pages: torch.Tensor | None = None, paged=None,
                    prefill: bool = False, block_k: int | None = None,
                    kv_split: bool = False):
    """GQA self-attention of x (B, S, D) at ``positions`` ((S,) or (B, S)).

    Without a cache: attention over the sequence itself, causal and
    windowed as ``cfg`` says.  The forward-only serving prefill
    (``prefill``, set by `transformer.forward` for ``last_only`` without a
    cache) goes through the flash kernel (`ops.mha_attention`: CUDA on a
    card); any other cache-free call runs `attention_core`.  With a
    cache, each slot writes its new K/V rows at ``lengths[b] + j`` for the
    columns ``active`` allows (``(B,)`` or ``(B, S)``) — **in place**,
    where the JAX code builds a new array — then attends over its own
    valid prefix.  A sliding-window model's cache is a ring buffer: row
    ``t % L`` of the slot, each row's absolute position recovered from the
    slot's newest one, attended under the window mask on the plain path
    (the JAX code keeps the ring off its fused kernels).  An int8 cache
    (``"k_scale"`` in it) stores
    `quantize.quantize_rows` of the new rows.  With ``paged`` (a
    `runtime.paging.PageSpec`) the cache leaves are page pools and the
    (B, max_pages) ``pages`` table maps each slot's logical page to its
    pool page; rows are scattered through the table, and masked rows go to
    the pool's trash page (`pool_zeros`) where JAX drops them, so the write
    needs no host synchronisation.  A single-token step (S == 1) goes
    through the decode kernel of its layout (`decode`, `decode_int8`: CUDA
    on a card) at ``block_k`` keys per split (None: the kernels'
    default); longer chunks gather and dequantize the cache and run
    `attention_core`.  Returns ``(y, cache)`` where ``cache`` holds the same
    (updated) tensors.

    Over the model axis (`parallel.sharding.split` of ``heads``): each
    rank projects its block of query heads (its columns of ``wq``, of
    ``wk``/``wv`` where ``kv_heads`` splits too, else the KV heads its
    query heads read), runs the core on them and multiplies by its rows
    of ``wo``; `sharding.leave` sums the ranks' parts.  With
    ``kv_split`` the contiguous cache, f32, bf16 or int8, is this rank's
    segment of the rows over the ``kv_seq`` axes (`decode_rules`): the
    step's query is gathered over the heads, each rank writes the new
    rows that fall in its segment (an int8 cache its codes and scales)
    and attends over it: the decode kernel of its type (B1 or B3) with
    its softmax statistics, the segments combined in rank order
    (`_combine_segments`), or for the ring and for chunks
    `attention_core` over the dequantized segment with the softmax
    reduced over the segments.  A paged pool never splits by sequence:
    it stays whole under `decode_rules`, and each rank's query heads
    attend it through the strided view of the KV heads they read.

    The attention itself, after any cache write and up to its output
    before ``wo``, runs in a ``model.attn`` span (`runtime.trace`),
    whichever path computes it.
    """
    dh = cfg.head_dim
    hs = shd.split("heads", cfg.num_heads)
    kvs = shd.split("kv_heads", cfg.num_kv_heads) if hs else None
    seg = shd.split("kv_seq", None) if cache is not None and kv_split \
        else None
    x_in = shd.enter(x, hs)           # the whole sequence
    b, s, _ = x_in.shape
    names = ("k", "v")
    w = {"q": shd.block(params["wq"], 1, cfg.q_dim, hs)}
    bias = {"q": shd.block(params["bq"], 0, cfg.q_dim, hs)} \
        if cfg.qkv_bias else {}
    pick = None                  # the KV heads the query heads read
    if hs is not None and kvs is None and seg is None:
        pick = _kv_heads_read(cfg, hs)
    for n in names:
        if pick is not None and cache is None:   # train, prefill: project
            first, count = pick                  # only the heads read
            w[n] = shd.copy_in(params["w" + n], hs).narrow(
                1, first * dh, count * dh)
            if cfg.qkv_bias:
                bias[n] = shd.copy_in(params["b" + n], hs).narrow(
                    0, first * dh, count * dh)
        else:
            w[n] = shd.block(params["w" + n], 1, cfg.kv_dim, kvs)
            if cfg.qkv_bias:
                bias[n] = shd.block(params["b" + n], 0, cfg.kv_dim, kvs)
    if cache is None:
        pick = None
    q = x_in @ w["q"].to(x.dtype)
    k = x_in @ w["k"].to(x.dtype)
    v = x_in @ w["v"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + bias["q"].to(x.dtype)
        k = k + bias["k"].to(x.dtype)
        v = v + bias["v"].to(x.dtype)
    q = q.reshape(b, s, -1, dh)
    k = k.reshape(b, s, -1, dh)
    v = v.reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm({"scale": shd.copy_in(params["q_norm"]["scale"], hs)},
                    q, cfg.norm_eps)
        k = rmsnorm({"scale": shd.copy_in(params["k_norm"]["scale"], hs)},
                    k, cfg.norm_eps)
    pos_b = positions if positions.ndim == 2 else positions[None]
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    scale = 1.0 / math.sqrt(dh)
    if chunk_q is None:
        if cfg.attn_chunk > 0:
            chunk_q = cfg.attn_chunk
        elif cfg.attn_chunk < 0 and s > 2048:
            chunk_q = 512
    wo = shd.block(params["wo"], 0, cfg.q_dim, hs).to(x.dtype)

    if cache is None:
        with trace.span("model.attn"):
            if prefill:
                out = ops.mha_attention(q, k, v, causal=cfg.causal,
                                        window=cfg.sliding_window)
            else:
                out = attention_core(q, k, v, positions, positions,
                                     causal=cfg.causal, scale=scale,
                                     window=cfg.sliding_window,
                                     chunk_q=chunk_q,
                                     remat_chunks=cfg.remat == "full")
        out = out.reshape(b, s, -1).to(x.dtype)
        return shd.leave(out @ wo, hs), cache

    quantized = "k_scale" in cache
    paged_cache = paged is not None and pages is not None
    new = {"k": k, "v": v}                   # the rows to write, per leaf
    if quantized:
        new["k"], new["k_scale"] = quantize.quantize_rows(k)
        new["v"], new["v_scale"] = quantize.quantize_rows(v)
    if lengths is None:
        lengths = torch.zeros((b,), dtype=torch.int32, device=x.device)
    if active is None:
        act2d = torch.ones((b, s), dtype=torch.bool, device=x.device)
    else:
        act = active.to(torch.bool)
        act2d = act if act.ndim == 2 else act[:, None].expand(b, s)
    t_abs = lengths[:, None] + torch.arange(s, dtype=torch.int32,
                                            device=x.device)
    new_len = lengths + act2d.sum(dim=1, dtype=torch.int32)

    if seg is not None:
        with trace.span("model.attn"):
            out = _segment_attention(cfg, q, cache, new, t_abs, act2d,
                                     new_len, pos_b, seg, hs, scale, block_k)
        return shd.leave(out.to(x.dtype) @ wo, hs), cache

    if paged_cache:
        psz, mp, npg = paged.page_size, paged.max_pages, paged.num_pages
        page_idx = t_abs // psz
        row = (t_abs % psz).long()
        page_id = torch.gather(pages, 1, page_idx.clamp(0, mp - 1).long())
        ok = act2d & (page_idx < mp) & (page_id >= 0) & (page_id < npg)
        page_w = torch.where(ok, page_id, npg).long()
        for name, c in cache.items():
            _write_pages(c, new[name], page_w, row)
    else:
        if s > cache["k"].shape[1]:
            raise ValueError(f"{s} new tokens do not fit a cache of "
                             f"{cache['k'].shape[1]} rows")
        ok = act2d
        if not cfg.sliding_window:
            ok = ok & (t_abs < cache["k"].shape[1])
        for name, c in cache.items():
            _write_cache(c, new[name], t_abs, ok)
    view = cache if pick is None else {
        n: c.narrow(2, *pick) for n, c in cache.items()}
    with trace.span("model.attn"):
        if s == 1 and cfg.causal and not cfg.sliding_window:
            kernel = {(False, False): decode.gqa_decode_attention,
                      (True, False): decode.paged_gqa_decode_attention,
                      (False, True):
                          decode_int8.quantized_gqa_decode_attention,
                      (True, True):
                          decode_int8.paged_quantized_gqa_decode_attention,
                      }[paged_cache, quantized]
            names = (("k", "k_scale", "v", "v_scale") if quantized
                     else ("k", "v"))
            tables = (pages,) if paged_cache else ()
            out = kernel(q[:, 0], *(view[n] for n in names), *tables,
                         length=new_len, scale=scale,
                         block_k=block_k)[:, None]
        else:
            rows = ({n: decode.gather_pages(c, pages)
                     for n, c in view.items()} if paged_cache else view)
            kr, vr = rows["k"], rows["v"]
            if quantized:
                kr = quantize.dequantize_rows(kr, rows["k_scale"])
                vr = quantize.dequantize_rows(vr, rows["v_scale"])
            slots = torch.arange(kr.shape[1], dtype=torch.int32,
                                 device=x.device)
            if cfg.sliding_window:        # contiguous only: the cache's init
                k_pos, k_valid = _ring_positions(slots, kr.shape[1],
                                                 new_len)
            else:
                k_pos, k_valid = slots, slots[None, :] < new_len[:, None]
            out = attention_core(q, kr, vr, pos_b, k_pos, causal=cfg.causal,
                                 scale=scale, window=cfg.sliding_window,
                                 k_valid=k_valid, chunk_q=chunk_q)
    out = out.reshape(b, s, -1).to(x.dtype)
    return shd.leave(out @ wo, hs), cache


def _ring_positions(slots, ring: int, new_len):
    """Absolute positions and validity of ring rows ``slots`` of a ring of
    ``ring`` rows: row j of a slot holds position end - ((end % ring - j)
    % ring), end its newest written position."""
    end = (new_len - 1)[:, None]
    k_pos = end - ((end % ring - slots[None, :]) % ring)
    return k_pos, (k_pos >= 0) & (k_pos < new_len[:, None])


def _segment_attention(cfg, q, cache, new, t_abs, act2d, new_len, pos_b,
                       seg, hs, scale, block_k) -> torch.Tensor:
    """`attention_apply` over a contiguous cache split by sequence: this
    rank holds rows [off, off + L) of ``seg.n * L`` (of the ring, for a
    sliding-window model).  Writes the new rows that fall there (every
    leaf of ``new``: an int8 cache's codes and scales), attends every
    query head over them and combines the segments; returns this rank's
    heads of the output, (B, S, Hq_loc * dh) f32."""
    b, s = t_abs.shape
    rows = cache["k"].shape[1]
    total, off = rows * seg.n, seg.index * rows
    target = (t_abs % total if cfg.sliding_window else t_abs) - off
    ok = act2d & (target >= 0) & (target < rows)
    for name, c in cache.items():
        _write_cache(c, new[name], target, ok)
    qa = shd.gather_dim(q, 2, hs, False)              # every query head
    quantized = "k_scale" in cache
    if s == 1 and cfg.causal and not cfg.sliding_window:
        mine = torch.clamp(new_len - off, 0, rows).to(torch.int32)
        if quantized:
            out, m, l = decode_int8.quantized_gqa_decode_attention(
                qa[:, 0].float(), cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], length=mine, scale=scale, block_k=block_k,
                return_stats=True)
        else:
            out, m, l = decode.gqa_decode_attention(
                qa[:, 0].float(), cache["k"], cache["v"], length=mine,
                scale=scale, block_k=block_k, return_stats=True)
        out = _combine_segments(out[:, None], m[:, None], l[:, None], seg)
    else:
        kr, vr = cache["k"], cache["v"]
        if quantized:
            kr = quantize.dequantize_rows(kr, cache["k_scale"])
            vr = quantize.dequantize_rows(vr, cache["v_scale"])
        slots = off + torch.arange(rows, dtype=torch.int32,
                                   device=q.device)
        if cfg.sliding_window:
            k_pos, k_valid = _ring_positions(slots, total, new_len)
        else:
            k_pos, k_valid = slots, slots[None, :] < new_len[:, None]
        out = attention_core(qa, kr, vr, pos_b, k_pos,
                             causal=cfg.causal, scale=scale,
                             window=cfg.sliding_window, k_valid=k_valid,
                             seg=seg)
    return shd.block(out, 2, cfg.num_heads, hs).reshape(b, s, -1)


def attention_cache_init(cfg, batch: int, cache_len: int,
                         dtype=torch.bfloat16, device=None,
                         paged=None) -> Params:
    """One layer's zeroed KV cache: contiguous ``(batch, cache_len, Hkv,
    dh)`` leaves, or with ``paged`` page pools ``(num_pages, page_size,
    Hkv, dh)`` made by `pool_zeros` (each with its trash page).  A
    sliding-window model's contiguous cache is a ring of at most
    ``window`` rows; it has no paged layout.  An int8 ``dtype`` gives
    codes ``"k"``, ``"v"`` and f32 scales ``"k_scale"``, ``"v_scale"`` of
    one scale per (token row, KV head)."""
    if paged is not None:
        if cfg.sliding_window:
            raise ValueError(
                "paged KV cache does not support sliding-window attention "
                "(the ring-buffer layout is contiguous-only)")
        shape = (paged.num_pages, paged.page_size, cfg.num_kv_heads,
                 cfg.head_dim)
    else:
        if cfg.sliding_window:
            cache_len = min(cache_len, cfg.sliding_window)
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)

    def make(shp, dt):
        if paged is not None:
            return pool_zeros(shp, dt, device)
        return torch.zeros(shp, dtype=dt, device=device)

    if dtype == torch.int8:
        return {"k": make(shape, torch.int8),
                "k_scale": make(shape[:-1], torch.float32),
                "v": make(shape, torch.int8),
                "v_scale": make(shape[:-1], torch.float32)}
    return {"k": make(shape, dtype), "v": make(shape, dtype)}


def attention_param_specs(cfg) -> Params:
    """Logical axes of each `attention_init` leaf (`parallel.sharding`)."""
    p = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        p.update({"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)})
    if cfg.qk_norm:
        p["q_norm"] = {"scale": (None,)}
        p["k_norm"] = {"scale": (None,)}
    return p


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> Params:
    return {
        "w_gate": _dense_init(generator, (d_model, d_ff), dtype),
        "w_up": _dense_init(generator, (d_model, d_ff), dtype),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype),
    }


def swiglu_param_specs() -> Params:
    return {
        "w_gate": ("embed", "ff"),
        "w_up": ("embed", "ff"),
        "w_down": ("ff", "embed"),
    }


def _ff_blocks(params: Params, d_ff: int | None, names):
    """The ``ff`` split and each named weight's block along it: columns
    of the up projections, rows of ``w_down``."""
    fs = shd.split("ff", d_ff) if d_ff else None
    full = d_ff or params["w_down"].shape[0]
    return fs, [shd.block(params[n], 0 if n == "w_down" else 1, full, fs)
                for n in names]


def swiglu_apply(params: Params, x: torch.Tensor, d_ff: int | None = None
                 ) -> torch.Tensor:
    """SwiGLU of x (B, S, D).  With ``d_ff`` (the model's) the hidden
    dim splits over the model axis where the rules map ``ff``: each rank
    its columns of the gate and up projections and rows of the down
    projection, the ranks' parts summed (`sharding.leave`)."""
    fs, (wg, wu, wd) = _ff_blocks(params, d_ff,
                                  ("w_gate", "w_up", "w_down"))
    x = shd.enter(x, fs)
    h = F.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
    return shd.leave(h @ wd.to(x.dtype), fs)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32) -> Params:
    return {
        "w_up": _dense_init(generator, (d_model, d_ff), dtype),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype),
    }


def gelu_mlp_param_specs() -> Params:
    return {"w_up": ("embed", "ff"), "w_down": ("ff", "embed")}


def gelu_mlp_apply(params: Params, x: torch.Tensor,
                   d_ff: int | None = None) -> torch.Tensor:
    """The encoder's MLP; tanh GELU, `jax.nn.gelu`'s default.  Split over
    ``ff`` as `swiglu_apply`."""
    fs, (wu, wd) = _ff_blocks(params, d_ff, ("w_up", "w_down"))
    x = shd.enter(x, fs)
    h = F.gelu(x @ wu.to(x.dtype), approximate="tanh")
    return shd.leave(h @ wd.to(x.dtype), fs)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------

def embedding_init(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32) -> Params:
    return {"table": _dense_init(generator, (vocab, d_model), dtype)}


def embedding_lookup(params: Params, tokens: torch.Tensor,
                     vocab: int | None = None) -> torch.Tensor:
    """The tokens' rows of the table.  With ``vocab`` (the model's) the
    table splits over the model axis where the rules map ``vocab``: each
    rank looks up the tokens its block holds, zeros for the rest, and the
    ranks' rows are summed (one of them nonzero: exact)."""
    vs = shd.split("vocab", vocab) if vocab else None
    if vs is None:
        return params["table"][tokens.long()]
    table = shd.block(params["table"], 0, vocab, vs)
    c = table.shape[0]
    loc = tokens.long() - vs.index * c
    inside = (loc >= 0) & (loc < c)
    rows = table[loc.clamp(0, c - 1)]
    return shd.reduce_out(torch.where(inside[..., None], rows, 0.0), vs)


def unembed(params: Params, x: torch.Tensor, vocab: int | None = None
            ) -> torch.Tensor:
    """Logits in x's dtype; over a ``vocab`` split (as `embedding_lookup`)
    this rank's block of them, which `sharding.vocab_argmax` reads."""
    vs = shd.split("vocab", vocab) if vocab else None
    table = params["table"] if vs is None else shd.block(
        params["table"], 0, vocab, vs)
    return shd.copy_in(x, vs) @ table.T.to(x.dtype)
