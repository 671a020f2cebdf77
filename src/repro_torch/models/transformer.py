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

import contextvars

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.models import layers, moe, rwkv, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shd

Params = dict
# Every leaf name the forward reads in f32 or in its own dtype, never
# through ``.to(compute dtype)``: each model module owns its part.
OWN_DTYPE_LEAVES = (layers.OWN_DTYPE_LEAVES | moe.OWN_DTYPE_LEAVES
                    | rwkv.OWN_DTYPE_LEAVES | ssm.OWN_DTYPE_LEAVES)


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


def _norm(p: Params, x, cfg: ModelConfig):
    """rmsnorm of the residual stream; over a sequence-split stream its
    scale's gradient is summed over the split (`sharding.seq_weight`)."""
    return layers.rmsnorm({"scale": shd.seq_weight(p["scale"])}, x,
                          cfg.norm_eps)


def _layer_apply(p: Params, x, cfg: ModelConfig, l: int, positions, cache,
                 lengths, active, pages, paged, prefill, span, kv_split):
    """Pre-norm block ``l`` (its index within a hybrid group, 0 for the
    uniform families).  Returns ``(x, aux)``; ``cache`` (the layer's
    leaves, or None) is updated in place.  The RWKV and Mamba mixers run
    on the whole sequence (`sharding.enter` gathers a sequence-split
    stream: the scans and the token shift read every position), split
    over the model axis where the rules split their heads or inner dim
    (`rwkv.time_split`, `rwkv.channel_split`, `ssm.mamba_split`), each
    rank on its blocks of the weights and states, the ranks' parts
    summed by `sharding.leave`."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(p["ln1"], x, cfg)
    if cfg.family == "ssm":
        ts, cs = rwkv.time_split(cfg), rwkv.channel_split(cfg)
        h, new_t = rwkv.rwkv_time_mix(p["mixer"], shd.enter(h, ts), cfg,
                                      cache)
        x = x + shd.leave(h, ts)
        h2 = _norm(p["ln2"], x, cfg)
        h2, new_c = rwkv.rwkv_channel_mix(p["mlp"], shd.enter(h2, cs),
                                          cfg, cache)
        if cache is not None:
            _keep_inactive({**new_t, **new_c}, cache, active)
        return x + shd.leave(h2, cs), aux

    if cfg.is_attn_layer(l):
        h, _ = layers.attention_apply(
            p["mixer"], h, cfg, positions, cache=cache, lengths=lengths,
            active=active, pages=pages, paged=paged, prefill=prefill,
            block_k=span, kv_split=kv_split)
    else:
        ms = ssm.mamba_split(cfg)
        h, new_mix = ssm.mamba_apply(p["mixer"], shd.enter(h, ms), cfg,
                                     cache=cache)
        h = shd.leave(h, ms)
        if cache is not None:
            _keep_inactive(new_mix, cache, active)
    x = x + h
    h2 = _norm(p["ln2"], x, cfg)
    if cfg.is_moe_layer(l):
        h2, aux = moe.apply_sharded(p["mlp"], h2, cfg)
    elif cfg.family == "encoder":
        h2 = layers.gelu_mlp_apply(p["mlp"], h2, cfg.d_ff)
    else:
        h2 = layers.swiglu_apply(p["mlp"], h2, cfg.d_ff)
    return x + h2, aux


def _in_context(ctx: contextvars.Context, fn, *args):
    """``fn(*args)`` inside ``ctx``: a checkpointed layer recomputes under
    the rules, mesh and sequence split of its forward, whichever thread
    runs the backward."""
    return ctx.run(fn, *args)


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
# Logical sharding specs (the init and cache trees' structure exactly)
# ---------------------------------------------------------------------------

def _mlp_specs(cfg: ModelConfig, l: int):
    if cfg.family == "ssm":
        return rwkv.rwkv_channel_param_specs(cfg)
    if cfg.is_moe_layer(l):
        return moe.moe_param_specs()
    if cfg.family == "encoder":
        return layers.gelu_mlp_param_specs()
    return layers.swiglu_param_specs()


def _layer_specs(cfg: ModelConfig, l: int):
    p = {"ln1": {"scale": (None,)}, "ln2": {"scale": (None,)}}
    if cfg.family == "ssm":
        p["mixer"] = rwkv.rwkv_time_param_specs(cfg)
    elif cfg.is_attn_layer(l):
        p["mixer"] = layers.attention_param_specs(cfg)
    else:
        p["mixer"] = ssm.mamba_param_specs(cfg)
    p["mlp"] = _mlp_specs(cfg, l)
    return p


def _prepend_layer_axis(tree):
    return tree_lib.map_structure(lambda axes: (None, *axes), tree)


def _uniform_or_grouped(cfg: ModelConfig, layer_specs):
    if cfg.family == "hybrid":
        return _prepend_layer_axis({str(i): layer_specs(i)
                                    for i in range(cfg.attn_period)})
    return _prepend_layer_axis(layer_specs(0))


def param_specs(cfg: ModelConfig):
    """A tree of logical-axis tuples of `init`'s structure."""
    specs: dict = {"embed": {"table": ("vocab", "embed")}}
    if cfg.frontend:
        specs["frontend"] = {"proj": (None, "embed")}
    specs["blocks"] = _uniform_or_grouped(
        cfg, lambda l: _layer_specs(cfg, l))
    specs["final_norm"] = {"scale": (None,)}
    if not cfg.tie_embeddings:
        specs["head"] = {"table": ("vocab", "embed")}
    return specs


def compute_specs(cfg: ModelConfig, rules) -> Params:
    """A tree of `init`'s structure: the mesh axes each leaf's layer
    computes it split over (`sharding.compute_block`), the model-axis
    half of `param_specs` as the forward splits it.  A dim splits where
    the rules keep its logical axis for the activation it makes
    (`sharding.kept` of ``heads`` at the query heads, ``ff`` at d_ff,
    ``vocab``, ``experts``); ``kv_heads`` only with ``heads``.  The
    recurrent mixers split at their own sizes: RWKV6's time mix over its
    ``d_model / rwkv_head_dim`` heads (whole heads a rank), its channel
    mix over d_ff, Mamba over ``d_in = ssm_expand * d_model``, its
    ``in_proj`` as a `sharding.Parts` of the x and gate halves; each
    leaf they name ``embed`` or None stays whole."""
    sizes = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "ff": cfg.d_ff, "vocab": cfg.vocab_size,
             "experts": cfg.num_experts}
    heads = shd.kept(rules, "heads", cfg.num_heads)

    def entry(ax, at=sizes):
        if ax not in at or (ax == "kv_heads" and not heads):
            return None
        axes = shd.kept(rules, ax, at[ax])
        return None if not axes else axes[0] if len(axes) == 1 else axes

    def cut(tree, at=sizes):
        return tree_lib.map_structure(
            lambda axes: tuple(entry(a, at) for a in axes), tree)

    def layer(l):
        p = _layer_specs(cfg, l)
        if cfg.family == "ssm":
            return {"ln1": cut(p["ln1"]), "ln2": cut(p["ln2"]),
                    "mixer": cut(p["mixer"], {"heads": cfg.d_model
                                              // cfg.rwkv_head_dim}),
                    "mlp": cut(p["mlp"], {"ff": cfg.d_ff})}
        out = cut(p)
        if not cfg.is_attn_layer(l):
            out["mixer"] = cut(p["mixer"], {"ff": ssm.d_inner(cfg)})
            e = out["mixer"]["in_proj"][1]
            if e is not None:
                out["mixer"]["in_proj"] = (None, shd.Parts(e))
        return out

    specs = cut(param_specs(cfg))
    specs["blocks"] = _prepend_layer_axis(
        {str(i): layer(i) for i in range(cfg.attn_period)}
        if cfg.family == "hybrid" else layer(0))
    return specs


def _layer_cache_specs(cfg: ModelConfig, l: int, paged=None,
                       quantized: bool = False):
    if cfg.family == "ssm":
        return {"shift_t": ("batch", None, "embed"),
                "wkv": ("batch", "heads", None, None),
                "shift_c": ("batch", None, "embed")}
    if cfg.is_attn_layer(l):
        if paged is not None:
            # pools (num_pages, page_size, Hkv, dh): no batch axis, pages
            # interleaved across slots, so only the heads shard
            specs = {"k": (None, None, "kv_heads", None),
                     "v": (None, None, "kv_heads", None)}
            if quantized:
                specs["k_scale"] = (None, None, "kv_heads")
                specs["v_scale"] = (None, None, "kv_heads")
            return specs
        specs = {"k": ("batch", "kv_seq", "kv_heads", None),
                 "v": ("batch", "kv_seq", "kv_heads", None)}
        if quantized:
            specs["k_scale"] = ("batch", "kv_seq", "kv_heads")
            specs["v_scale"] = ("batch", "kv_seq", "kv_heads")
        return specs
    return {"conv": ("batch", None, "ff"), "h": ("batch", "ff", None)}


def cache_specs(cfg: ModelConfig, paged=None, kv_dtype=None):
    """A tree of logical-axis tuples of `cache_init`'s structure; an int8
    ``kv_dtype`` adds the scale leaves, as `cache_init` does."""
    quantized = kv_dtype is not None and kv_dtype == torch.int8
    specs = {"blocks": _uniform_or_grouped(
        cfg, lambda l: _layer_cache_specs(cfg, l, paged, quantized)),
        "index": (), "lengths": ("batch",)}
    if paged is not None:
        specs["pages"] = ("batch", None)
    return specs


def cache_block(cfg: ModelConfig, cache: Params, rules, mesh) -> Params:
    """This rank's block of a cache laid out whole (the same on every
    rank, or on ``meta``): each leaf cut by its `cache_specs` fitted to
    its shape under ``rules`` (a copy), the layout (paged: ``"pages"`` in
    it; int8: ``"k_scale"`` in an attention layer) read from the cache
    itself.  So a contiguous cache's K/V rows and an int8 cache's scales
    split over ``kv_seq`` (`decode_rules`), a paged pool only over
    ``kv_heads`` (whole under `decode_rules`) with its page table by
    slot, the RWKV ``wkv`` state over its heads and Mamba's ``conv`` and
    ``h`` over ``d_in``, as the mixers compute them.  ``"kv_split"`` is
    set where a contiguous attention cache's rows split; the attention
    layers read it."""
    paged = "pages" in cache
    attn = [cache["blocks"] if key is None else cache["blocks"][key]
            for key, l, _ in _groups(cfg)
            if cfg.family != "ssm" and cfg.is_attn_layer(l)]
    quantized = any("k_scale" in c for c in attn)
    specs = cache_specs(cfg, paged=True if paged else None,
                        kv_dtype=torch.int8 if quantized else None)

    def cut(t, axes, pool=False):
        if pool:                 # the copy keeps the trash page past it
            return cut(layers.with_trash_page(t, axis=1), axes).narrow(
                1, 0, t.shape[1])
        return shd.local_shard(t, shd.fitted(rules.spec(*axes),
                                             tuple(t.shape), rules),
                               mesh).clone()

    blocks: Params = {}
    for key, l, _ in _groups(cfg):
        pool = paged and cfg.family != "ssm" and cfg.is_attn_layer(l)
        src, sp = ((cache["blocks"], specs["blocks"]) if key is None else
                   (cache["blocks"][key], specs["blocks"][key]))
        blk = {n: cut(t, sp[n], pool) for n, t in src.items()}
        if key is None:
            blocks = blk
        else:
            blocks[key] = blk
    out = {"blocks": blocks, "index": cache["index"],
           "lengths": cut(cache["lengths"], specs["lengths"])}
    if paged:
        out["pages"] = cut(cache["pages"], specs["pages"])
    if "decode_span" in cache:
        out["decode_span"] = cache["decode_span"]
    if attn and not paged:
        out["kv_split"] = bool(shd.kept(rules, "kv_seq",
                                        attn[0]["k"].shape[2]))
    return out


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
                stack = tree_lib.map_structure(
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
    # "meta": an abstract cache (shapes and dtypes, `launch.specs`)
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
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


def cache_rows(cache: Params, start: int, stop: int, paged=None) -> Params:
    """The cache of slots ``start`` to ``stop`` alone, as views: every
    batch-major leaf (K/V rows and int8 scales, a ring, RWKV and Mamba
    states), ``lengths`` and the page table cut on their batch axis; page
    pools (`_is_pool_leaf`), ``index``, ``decode_span`` and ``kv_split``
    whole.  A forward over the view writes its rows into ``cache``'s
    tensors in place; the ``lengths`` and ``index`` it returns are new
    tensors, which the caller writes back."""
    def cut(a):
        if paged is not None and _is_pool_leaf(a, paged):
            return a
        return a[:, start:stop]
    out = {"blocks": tree_lib.map_structure(cut, cache["blocks"]),
           "index": cache["index"],
           "lengths": cache["lengths"][start:stop]}
    if "pages" in cache:
        out["pages"] = cache["pages"][start:stop]
    for key in ("decode_span", "kv_split"):
        if key in cache:
            out[key] = cache[key]
    return out


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
        for a in tree_lib.leaves(cache["blocks"]):
            if _is_pool_leaf(a, paged):
                layers.with_trash_page(a, axis=1)[:, idx] = 0
            else:
                a[:, slot] = 0
        cache["pages"][slot] = -1
    else:
        for a in tree_lib.leaves(cache["blocks"]):
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
    leaves = [a for a in tree_lib.leaves(cache["blocks"])
              if a.is_floating_point()]
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
                                             inputs["tokens"],
                                             cfg.vocab_size))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def forward(cfg: ModelConfig, params: Params, inputs: dict,
            cache: Params | None = None, compute_dtype=torch.bfloat16,
            last_only: bool = False, active: torch.Tensor | None = None,
            paged=None, return_aux: bool = False,
            return_hidden: bool = False):
    """Returns ``(logits, new_cache)``, and with ``return_aux`` also the
    MoE load-balance loss summed over the MoE layers (0-d f32; 0 without
    them), the JAX forward's third value.  ``return_hidden`` returns the
    final-norm hidden states (B, S, D) in place of the logits (the
    training step fuses the unembedding into its chunked loss).

    Training (no cache, autograd on) with ``cfg.remat == "full"`` runs
    each layer, a hybrid's each sub-layer, under
    `torch.utils.checkpoint`, as the reference's `jax.checkpoint`: the
    backward recomputes a layer's activations from its input.  The stack's
    leaves are split into per-layer views once (`torch.unbind`), whose
    backward stacks the layers' gradients in one operation.

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
    a contiguous cache's ``"decode_span"`` and ``"kv_split"``
    (`cache_block`).

    Over the model axis of the active rules and mesh the weights may be
    this rank's blocks (`compute_specs`) or whole (cut here).  The
    residual stream is whole on every rank, or split by sequence where
    the rules map ``res_seq`` (`sharding.sequence_split`), gathered
    again after the final norm; the frontends and the final norm see
    the stream as it is.  Under a ``vocab`` split the logits are this
    rank's block (`sharding.vocab_argmax`).
    """
    x = _embed_inputs(cfg, params, inputs).to(compute_dtype)
    b, s, _ = x.shape
    seq = shd.split("res_seq", s)
    x = shd.split_dim(x, 1, seq)
    with shd.sequence_split(seq):
        x, aux = _blocks(cfg, params, x, s, cache, active, paged,
                         prefill=last_only and cache is None)
        x = _norm(params["final_norm"], x, cfg)
    x = shd.gather_dim(x, 1, seq, reduce_grad=False)
    new_cache = None
    if cache is not None:
        act = None if active is None else active.to(torch.bool)
        if act is None:
            adv = s
        elif act.ndim == 2:
            adv = act.sum(dim=1, dtype=torch.int32)
        else:
            adv = s * act.to(torch.int32)
        new_cache = {"blocks": cache["blocks"], "index": cache["index"] + s,
                     "lengths": cache["lengths"] + adv}
        for key in ("pages", "decode_span", "kv_split"):
            if key in cache:
                new_cache[key] = cache[key]
    if return_hidden:
        out = x
    else:
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        out = layers.unembed(head, x[:, -1:] if last_only else x,
                             cfg.vocab_size)
    if return_aux:
        return out, new_cache, aux
    return out, new_cache


def _blocks(cfg: ModelConfig, params: Params, x, s: int, cache, active,
            paged, prefill: bool):
    """The layer stack over the residual stream ``x`` (``s`` positions):
    ``(x, summed MoE aux)``."""
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

    kv_split = bool(cache is not None and cache.get("kv_split"))
    remat = (cfg.remat == "full" and cache is None
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = _groups(cfg)
    per_layer = {key: tree_lib.map_structure(lambda a: a.unbind(0),
                                params["blocks"] if key is None
                                else params["blocks"][key])
                 for key, _, _ in groups}
    for g in range(groups[0][2]):
        for key, l, _ in groups:
            gp = tree_lib.map_structure(lambda a: a[g], per_layer[key])
            gc = None
            if cache is not None:
                cblk = (cache["blocks"] if key is None
                        else cache["blocks"][key])
                gc = tree_lib.map_structure(lambda a: a[g], cblk)
            args = (gp, x, cfg, l, positions, gc, lengths, act, pages,
                    paged, prefill, span, kv_split)
            if remat:
                x, a = checkpoint(_in_context, contextvars.copy_context(),
                                  _layer_apply, *args, use_reentrant=False)
            else:
                x, a = _layer_apply(*args)
            aux = aux + a
    return x, aux
