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

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import decode, decode_int8, ops
from repro_torch.runtime import quantize

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
                   chunk_q: int | None = None) -> torch.Tensor:
    """Masked multi-head attention with GQA grouping (no cache repeat):
    query head h reads KV head h // g.

    q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh); ``q_pos`` (Sq,) or (B, Sq),
    ``k_pos`` (Sk,) or (B, Sk), ``k_valid`` (Sk,) or (B, Sk).  Operands
    enter the products in f32, which is the JAX code's "operands in their
    dtype, f32 accumulation" (a product of two bf16 values is exact in
    f32); probabilities are rounded to v's dtype first, as there.  Masked
    logits are filled with -1e30.  When ``chunk_q`` divides Sq the query
    blocks run one after another, so the (Sq, Sk) logits never exist at
    once.  Returns f32 (B, Sq, Hq, dh).
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
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd",
                            probs.to(v.dtype).float(), v.float())

    if chunk_q and sq > chunk_q and sq % chunk_q == 0:
        outs = []
        for i in range(0, sq, chunk_q):
            qp = q_pos[..., i:i + chunk_q]
            outs.append(blk(qr[:, i:i + chunk_q], qp))
        out = torch.cat(outs, dim=1)
    else:
        out = blk(qr, q_pos)
    return out.reshape(b, sq, hq, dh)


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


def attention_apply(params: Params, x: torch.Tensor, cfg,
                    positions: torch.Tensor, cache: Params | None = None,
                    lengths: torch.Tensor | None = None,
                    active: torch.Tensor | None = None,
                    chunk_q: int | None = None,
                    pages: torch.Tensor | None = None, paged=None,
                    prefill: bool = False, block_k: int | None = None):
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
    """
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    pos_b = positions if positions.ndim == 2 else positions[None]
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if chunk_q is None:
        if cfg.attn_chunk > 0:
            chunk_q = cfg.attn_chunk
        elif cfg.attn_chunk < 0 and s > 2048:
            chunk_q = 512

    if cache is None:
        if prefill:
            out = ops.mha_attention(q, k, v, causal=cfg.causal,
                                    window=cfg.sliding_window)
        else:
            out = attention_core(q, k, v, positions, positions,
                                 causal=cfg.causal, scale=scale,
                                 window=cfg.sliding_window, chunk_q=chunk_q)
        out = out.reshape(b, s, cfg.q_dim).to(x.dtype)
        return out @ params["wo"].to(x.dtype), cache

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

    if s == 1 and cfg.causal and not cfg.sliding_window:
        kernel = {(False, False): decode.gqa_decode_attention,
                  (True, False): decode.paged_gqa_decode_attention,
                  (False, True): decode_int8.quantized_gqa_decode_attention,
                  (True, True):
                      decode_int8.paged_quantized_gqa_decode_attention,
                  }[paged_cache, quantized]
        names = ("k", "k_scale", "v", "v_scale") if quantized else ("k", "v")
        tables = (pages,) if paged_cache else ()
        out = kernel(q[:, 0], *(cache[n] for n in names), *tables,
                     length=new_len, scale=scale,
                     block_k=block_k)[:, None]
    else:
        rows = ({n: decode.gather_pages(c, pages) for n, c in cache.items()}
                if paged_cache else cache)
        kr, vr = rows["k"], rows["v"]
        if quantized:
            kr = quantize.dequantize_rows(kr, rows["k_scale"])
            vr = quantize.dequantize_rows(vr, rows["v_scale"])
        slots = torch.arange(kr.shape[1], dtype=torch.int32, device=x.device)
        if cfg.sliding_window:        # contiguous only: the cache's init
            # Ring slot j of a slot holds absolute position
            # end - ((end % L - j) % L), end its newest written position.
            ring = kr.shape[1]
            end = (new_len - 1)[:, None]
            k_pos = end - ((end % ring - slots[None, :]) % ring)
            k_valid = (k_pos >= 0) & (k_pos < new_len[:, None])
        else:
            k_pos, k_valid = slots, slots[None, :] < new_len[:, None]
        out = attention_core(q, kr, vr, pos_b, k_pos, causal=cfg.causal,
                             scale=scale, window=cfg.sliding_window,
                             k_valid=k_valid, chunk_q=chunk_q)
    out = out.reshape(b, s, cfg.q_dim).to(x.dtype)
    return out @ params["wo"].to(x.dtype), cache


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


def swiglu_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"].to(x.dtype)) * (
        x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32) -> Params:
    return {
        "w_up": _dense_init(generator, (d_model, d_ff), dtype),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype),
    }


def gelu_mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The encoder's MLP; tanh GELU, `jax.nn.gelu`'s default."""
    h = F.gelu(x @ params["w_up"].to(x.dtype), approximate="tanh")
    return h @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------

def embedding_init(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32) -> Params:
    return {"table": _dense_init(generator, (vocab, d_model), dtype)}


def embedding_lookup(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in x's dtype."""
    return x @ params["table"].T.to(x.dtype)
