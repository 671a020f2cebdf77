"""Model assembly: embeddings -> stacked layers -> head.  Counterpart of
`repro.models.transformer`, every family:

- dense / moe / encoder: uniform layers (a GQA attention mixer, then a
  SwiGLU, MoE or GELU MLP), stacked leaves with a leading layer axis;
- ssm (RWKV6): uniform RWKV layers, the same stacking;
- hybrid (Jamba): ``num_layers / attn_period`` groups of ``attn_period``
  different sub-layers (Mamba or attention mixer, SwiGLU or MoE MLP),
  keyed ``"0"`` ... ``str(period - 1)``, each with a leading group axis.

The parameter tree is the JAX package's: ``{"embed": {"table"},
["frontend": {"proj"},] "blocks": {...}, "final_norm": {"scale"},
"head": {"table"}}``.  `lax.scan` over the layer axis becomes a Python
loop over views of the stacked leaves (no copies).  A ``frame`` or
``patch`` frontend maps precomputed features (``inputs["frames"]`` or
``inputs["patches"]``) into the residual stream ahead of the tokens.

The decode state is ``{"blocks": ..., "index": 0-d int32, "lengths": (B,)
int32}``; each layer's leaves are an attention KV cache (`layers`: (B, L,
Hkv, dh), a ring of at most ``window`` rows for a sliding-window model,
int8 with f32 scale leaves, or paged pools ``(num_pages, page_size, Hkv,
dh)`` with one ``"pages"`` table (B, max_pages) int32 for the whole
stack), an RWKV state (`rwkv`) or a Mamba state (`ssm`), stacked like
the parameters.  A contiguous cache may carry ``"decode_span"``, a Python
int: the keys per split of its single-token decode (the span the decode
tuner picked when the server was built), handed to every attention layer.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers, moe, rwkv, ssm
from repro_torch.models.config import ModelConfig

Params = dict
# Every leaf name the forward reads in f32 or in its own dtype, never
# through ``.to(compute dtype)``: each model module owns its part.
OWN_DTYPE_LEAVES = (layers.OWN_DTYPE_LEAVES | moe.OWN_DTYPE_LEAVES
                    | rwkv.OWN_DTYPE_LEAVES | ssm.OWN_DTYPE_LEAVES)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Per-layer init / apply / cache init, keyed by the layer's kind
# ---------------------------------------------------------------------------

def _layer_init(generator, cfg: ModelConfig, l: int, dtype) -> Params:
    dev = generator.device
    p: Params = {"ln1": layers.rmsnorm_init(cfg.d_model, device=dev),
                 "ln2": layers.rmsnorm_init(cfg.d_model, device=dev)}
    if cfg.family == "ssm":
        p["mixer"] = rwkv.rwkv_time_init(generator, cfg, dtype)
        p["mlp"] = rwkv.rwkv_channel_init(generator, cfg, dtype)
        return p
    if cfg.is_attn_layer(l):
        p["mixer"] = layers.attention_init(generator, cfg, dtype)
    else:
        p["mixer"] = ssm.mamba_init(generator, cfg, dtype)
    if cfg.is_moe_layer(l):
        p["mlp"] = moe.moe_init(generator, cfg, dtype)
    elif cfg.family == "encoder":
        p["mlp"] = layers.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff,
                                        dtype)
    else:
        p["mlp"] = layers.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                      dtype)
    return p


def _keep_inactive(new: Params, old: Params, active) -> None:
    """Write a recurrent layer's new state into its cache leaves, in
    place; slots that ``active`` ((B,), or (B, S): any column) leaves out
    keep their old state.  The attention cache needs no such pass: its
    inactive rows are masked at the write itself."""
    if active is not None and active.ndim == 2:
        active = active.any(dim=1)
    for name, n in new.items():
        o = old[name]
        if active is None:
            o.copy_(n)
        else:
            m = active.reshape((-1,) + (1,) * (n.ndim - 1))
            o.copy_(torch.where(m, n, o))


def _layer_apply(p: Params, x, cfg: ModelConfig, l: int, positions, cache,
                 lengths, active, pages, paged, prefill, span):
    """Pre-norm block ``l`` (its index within a hybrid group, 0 for the
    uniform families).  Returns ``(x, aux)``; ``cache`` (the layer's
    leaves, or None) is updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        h, new_t = rwkv.rwkv_time_mix(p["mixer"], h, cfg, cache)
        x = x + h
        h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        h2, new_c = rwkv.rwkv_channel_mix(p["mlp"], h2, cfg, cache)
        if cache is not None:
            _keep_inactive({**new_t, **new_c}, cache, active)
        return x + h2, aux

    if cfg.is_attn_layer(l):
        h, _ = layers.attention_apply(
            p["mixer"], h, cfg, positions, cache=cache, lengths=lengths,
            active=active, pages=pages, paged=paged, prefill=prefill,
            block_k=span)
    else:
        h, new_mix = ssm.mamba_apply(p["mixer"], h, cfg, cache=cache)
        if cache is not None:
            _keep_inactive(new_mix, cache, active)
    x = x + h
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe_layer(l):
        h2, aux = moe.apply_sharded(p["mlp"], h2, cfg)
    elif cfg.family == "encoder":
        h2 = layers.gelu_mlp_apply(p["mlp"], h2)
    else:
        h2 = layers.swiglu_apply(p["mlp"], h2)
    return x + h2, aux


def _layer_cache_init(cfg: ModelConfig, l: int, batch: int, cache_len: int,
                      dtype, device, paged) -> Params:
    if cfg.family == "ssm":
        return rwkv.rwkv_cache_init(cfg, batch, dtype, device)
    if cfg.is_attn_layer(l):
        return layers.attention_cache_init(cfg, batch, cache_len, dtype,
                                           device, paged=paged)
    return ssm.mamba_cache_init(cfg, batch, dtype, device)


def _groups(cfg: ModelConfig) -> list[tuple[str | None, int, int]]:
    """``(key, layer index of its kind, stacked count)`` of the block
    tree: one uniform stack (key None, kind of layer 0), or a hybrid's
    ``attn_period`` sub-layer stacks of ``num_layers / period`` groups."""
    if cfg.family == "hybrid":
        period = cfg.attn_period
        return [(str(i), i, cfg.num_layers // period) for i in range(period)]
    return [(None, 0, cfg.num_layers)]


# ---------------------------------------------------------------------------
# Init / cache init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator,
         dtype=torch.float32) -> Params:
    """Random parameters on ``generator.device``, in the JAX init's
    shapes and dtypes: matrices N(0, 0.02^2) drawn in f32 and cast to
    ``dtype`` (Mamba's conv taps at 0.1 and step projection at
    rank^-1/2), norm scales ones (f32, the qk-norm scales in ``dtype``),
    and the leaves the JAX init keeps in f32 (the MoE router, the RWKV
    decay and bonus, Mamba's A_log and D) in f32.

    Each stacked leaf is filled one layer at a time, so at full width the
    peak is the stacked tree plus one layer's f32 draw."""
    dev = generator.device
    params: Params = {"embed": layers.embedding_init(
        generator, cfg.vocab_size, cfg.d_model, dtype)}
    if cfg.frontend:
        params["frontend"] = {"proj": layers._dense_init(
            generator, (cfg.frontend_dim, cfg.d_model), dtype)}
    blocks: Params = {}
    for key, l, n in _groups(cfg):
        stack = None
        for g in range(n):
            period = cfg.attn_period if key is not None else 0
            layer = _layer_init(generator, cfg, g * period + l, dtype)
            if stack is None:
                stack = _tree_map(
                    lambda a: torch.empty((n, *a.shape), dtype=a.dtype,
                                          device=dev), layer)
            _copy_layer(stack, layer, g)
        if key is None:
            blocks = stack
        else:
            blocks[key] = stack
    params["blocks"] = blocks
    params["final_norm"] = layers.rmsnorm_init(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["head"] = layers.embedding_init(generator, cfg.vocab_size,
                                               cfg.d_model, dtype)
    return params


def _copy_layer(stacked: dict, layer: dict, l: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, l)
        else:
            stacked[k][l].copy_(v)


def cache_init(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, index: int = 0, device="cuda",
               paged=None, decode_span: int | None = None) -> Params:
    """A zeroed cache on ``device`` (``cuda`` unless the caller asks for
    ``cpu``; raises without a card).  ``dtype`` is the attention cache's
    storage type and that of the recurrent shift and conv leaves (their
    states are f32).  With ``paged`` (a `runtime.paging.PageSpec`) the
    attention leaves are page pools, each allocated with the trash page
    of `layers.pool_zeros`, the recurrent leaves keep their batch axis,
    and ``cache["pages"]`` is the (B, max_pages) page table, all -1:
    logical page j of slot b is the same pool page in every attention
    layer's K and V pool.  ``decode_span`` (a contiguous cache only;
    None: the kernels' default) is the keys per split of the decode
    kernel over this cache."""
    if paged is not None and decode_span is not None:
        # The JAX package's paged kernels take no knob: a paged cache
        # decodes at the kernels' default span.
        raise ValueError("a paged cache decodes at the kernels' default "
                         "span; decode_span is for a contiguous cache")
    device = resolve_device(device)
    blocks: Params = {}
    for key, l, n in _groups(cfg):
        layer = _layer_cache_init(cfg, l, batch, cache_len, dtype, "meta",
                                  paged)
        pool = (paged is not None and cfg.family != "ssm"
                and cfg.is_attn_layer(l))
        stack = {name: (layers.pool_zeros((n, *a.shape), a.dtype, device,
                                          axis=1) if pool
                        else torch.zeros((n, *a.shape), dtype=a.dtype,
                                         device=device))
                 for name, a in layer.items()}
        if key is None:
            blocks = stack
        else:
            blocks[key] = stack
    cache = {"blocks": blocks,
             "index": torch.full((), index, dtype=torch.int32, device=device),
             "lengths": torch.full((batch,), index, dtype=torch.int32,
                                   device=device)}
    if paged is not None:
        cache["pages"] = torch.full((batch, paged.max_pages), -1,
                                    dtype=torch.int32, device=device)
    if decode_span is not None:
        cache["decode_span"] = int(decode_span)
    return cache


def _is_pool_leaf(a: torch.Tensor, paged) -> bool:
    """A stacked paged attention pool leaf, (L, num_pages, page_size,
    ...), told from a batched recurrent leaf by its shape, as the JAX
    package tells them."""
    return (a.ndim >= 3 and a.shape[1] == paged.num_pages
            and a.shape[2] == paged.page_size)


def cache_reset_slot(cache: Params, slot: int, paged=None) -> Params:
    """Zero one slot's rows in every layer's cache leaves (KV rows, Mamba
    conv tails and states, RWKV shifts and states) and reset its length
    to 0, **in place** (the JAX version returns a new tree); returns
    ``cache``.

    A recycled slot must start from a state identical to a fresh one: the
    length masks already hide the stale prefix, the zeroing makes a
    refilled slot reproduce single-sequence decode bitwise and resets the
    recurrent states no mask reaches.  Paged: a pool leaf's rows are the
    pool pages the slot's row of ``cache["pages"]`` names; they are zeroed
    (entries of -1 aim at the trash page, so the device table is read
    with no host synchronisation) and the row is set to -1; the batched
    recurrent leaves beside the pools are zeroed at the slot.  The host
    allocator frees the pages separately."""
    if paged is not None:
        row = cache["pages"][slot]
        idx = torch.where(row >= 0, row.clamp(max=paged.num_pages - 1),
                          paged.num_pages).long()
        for a in _leaves(cache["blocks"]):
            if _is_pool_leaf(a, paged):
                layers.with_trash_page(a, axis=1)[:, idx] = 0
            else:
                a[:, slot] = 0
        cache["pages"][slot] = -1
    else:
        for a in _leaves(cache["blocks"]):
            a[:, slot] = 0
    cache["lengths"][slot] = 0
    return cache


def cache_poison_slot(cache: Params, slot: int, paged=None) -> Params:
    """Overwrite one slot's float cache leaves with NaN, **in place**
    (the chaos harness's ``kv_corrupt`` fault); returns ``cache``.

    Only float leaves are poisoned: the f32 or bf16 K/V rows, or in the
    int8 layout the f32 scales (the codes stay), and the recurrent
    shifts, conv tails and states.  ``lengths``, ``index`` and the page
    table are untouched: the fault corrupts data, not control state.
    Paged: a pool leaf's rows are the pool pages the slot's row of
    ``cache["pages"]`` names; entries of -1 name no page, and the trash
    page past the pool (`layers.pool_zeros`), where other slots' masked
    writes land, is never poisoned."""
    leaves = [a for a in _leaves(cache["blocks"]) if a.is_floating_point()]
    if paged is not None:
        row = cache["pages"][slot]
        idx = row[row >= 0].long()
        for a in leaves:
            if _is_pool_leaf(a, paged):
                a[:, idx] = float("nan")
            else:
                a[:, slot] = float("nan")
    else:
        for a in leaves:
            a[:, slot] = float("nan")
    return cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params: Params, inputs: dict
                  ) -> torch.Tensor:
    """The residual stream's input: the frontend's features projected to
    d_model (prompts only; decode steps are tokens), then the tokens'
    embeddings, concatenated along the sequence."""
    parts = []
    key = "frames" if cfg.frontend == "frame" else "patches"
    if cfg.frontend in ("frame", "patch") and key in inputs:
        feats = inputs[key]
        parts.append(feats @ params["frontend"]["proj"].to(feats.dtype))
    if "tokens" in inputs:
        parts.append(layers.embedding_lookup(params["embed"],
                                             inputs["tokens"]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def forward(cfg: ModelConfig, params: Params, inputs: dict,
            cache: Params | None = None, compute_dtype=torch.bfloat16,
            last_only: bool = False, active: torch.Tensor | None = None,
            paged=None, return_aux: bool = False):
    """Returns ``(logits, new_cache)``, and with ``return_aux`` also the
    MoE load-balance loss summed over the MoE layers (0-d f32; 0 without
    them), the JAX forward's third value.

    ``inputs`` holds ``"tokens"`` (B, S) and, for a model with a frontend,
    ``"frames"`` or ``"patches"`` (B, P, frontend_dim) ahead of them.
    With a ``cache``, each slot continues from its own depth
    ``cache["lengths"][b]``; ``active`` ((B,) or (B, S) bool) masks which
    slots (or which columns of a packed chunk) write cache rows, change
    their recurrent state and advance.  The cache's tensors are updated
    **in place**; ``new_cache`` holds them with the new ``index`` and
    ``lengths``.  ``last_only`` unembeds only the final position; without
    a cache it is the forward-only serving prefill, whose attention runs
    the flash kernel (`layers.attention_apply`'s ``prefill``).  ``paged``
    (a `runtime.paging.PageSpec`) marks the cache as paged; its
    ``cache["pages"]`` table is threaded to every attention layer, as is
    a contiguous cache's ``"decode_span"``.
    """
    x = _embed_inputs(cfg, params, inputs).to(compute_dtype)
    b, s, _ = x.shape
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    lengths = act = None
    pages = cache.get("pages") if (cache is not None and paged is not None) \
        else None
    span = cache.get("decode_span") if cache is not None else None
    if cache is not None:
        lengths = cache["lengths"]
        positions = lengths[:, None] + ar[None]
        if active is not None:
            act = active.to(torch.bool)
    else:
        positions = ar

    prefill = last_only and cache is None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = _groups(cfg)
    for g in range(groups[0][2]):
        for key, l, _ in groups:
            pblk = params["blocks"] if key is None else params["blocks"][key]
            gp = _tree_map(lambda a: a[g], pblk)
            gc = None
            if cache is not None:
                cblk = (cache["blocks"] if key is None
                        else cache["blocks"][key])
                gc = _tree_map(lambda a: a[g], cblk)
            x, a = _layer_apply(gp, x, cfg, l, positions, gc, lengths, act,
                                pages, paged, prefill, span)
            aux = aux + a

    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        if act is None:
            adv = s
        elif act.ndim == 2:
            adv = act.sum(dim=1, dtype=torch.int32)
        else:
            adv = s * act.to(torch.int32)
        new_cache = {"blocks": cache["blocks"], "index": cache["index"] + s,
                     "lengths": lengths + adv}
        for key in ("pages", "decode_span"):
            if key in cache:
                new_cache[key] = cache[key]
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    if last_only:
        x = x[:, -1:]
    logits = layers.unembed(head, x)
    if return_aux:
        return logits, new_cache, aux
    return logits, new_cache
