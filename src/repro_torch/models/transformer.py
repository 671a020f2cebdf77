"""Model assembly: embeddings -> stacked layers -> head.  Counterpart of
`repro.models.transformer`, dense family.

The parameter tree is the JAX package's: ``{"embed": {"table"},
"blocks": {...stacked leaves with a leading layer axis...},
"final_norm": {"scale"}, "head": {"table"}}``.  `lax.scan` over the layer
axis becomes a Python loop over views of the stacked leaves (no copies).
The decode state is ``{"blocks": {"k", "v": (layers, B, L, Hkv, dh)},
"index": 0-d int32, "lengths": (B,) int32}``; a paged cache holds page
pools ``(layers, num_pages, page_size, Hkv, dh)`` instead and one
``"pages"`` table ``(B, max_pages)`` int32 for the whole stack, and an
int8 cache adds the f32 scale leaves ``"k_scale"``, ``"v_scale"``.  A
contiguous cache may carry ``"decode_span"``, a Python int: the keys per
split its single-token decode runs (the span the decode tuner picked for
this cache when the server was built), handed to every layer.

Only the dense family is ported; the others raise `NotImplementedError`
naming ROADMAP A12.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = dict


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with a ' + cfg.frontend + ' frontend' if cfg.frontend else ''}"
            f" is not ported to repro_torch yet (ROADMAP A12)")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer_init(generator, cfg: ModelConfig, dtype) -> Params:
    dev = generator.device
    return {"ln1": layers.rmsnorm_init(cfg.d_model, device=dev),
            "ln2": layers.rmsnorm_init(cfg.d_model, device=dev),
            "mixer": layers.attention_init(generator, cfg, dtype),
            "mlp": layers.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                      dtype)}


def init(cfg: ModelConfig, generator: torch.Generator,
         dtype=torch.float32) -> Params:
    """Random parameters on ``generator.device``: matrices N(0, 0.02^2)
    drawn in f32 and cast to ``dtype``, norm scales ones (f32, and the
    qk-norm scales in ``dtype``, as the JAX init makes them).

    Each stacked leaf is filled one layer at a time, so at full width the
    peak is the stacked tree plus one layer's f32 draw (about 30 GB for
    Qwen3-14B in bf16, not twice that)."""
    _check_family(cfg)
    dev = generator.device
    params: Params = {"embed": layers.embedding_init(
        generator, cfg.vocab_size, cfg.d_model, dtype)}
    blocks = None
    for l in range(cfg.num_layers):
        layer = _layer_init(generator, cfg, dtype)
        if blocks is None:
            blocks = _tree_map(
                lambda a: torch.empty((cfg.num_layers, *a.shape),
                                      dtype=a.dtype, device=dev), layer)
        _copy_layer(blocks, layer, l)
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
    ``cpu``; raises without a card).  With ``paged`` (a
    `runtime.paging.PageSpec`) the leaves are page pools, each allocated
    with the trash page of `layers.pool_zeros`, and ``cache["pages"]`` is
    the (B, max_pages) page table, all -1: logical page j of slot b is the
    same pool page in every layer's K and V pool.  ``decode_span`` (a
    contiguous cache only; None: the kernels' default) is the keys per
    split of the decode kernel over this cache."""
    _check_family(cfg)
    if paged is not None and decode_span is not None:
        # The JAX package's paged kernels take no knob: a paged cache
        # decodes at the kernels' default span.
        raise ValueError("a paged cache decodes at the kernels' default "
                         "span; decode_span is for a contiguous cache")
    device = resolve_device(device)
    layer = layers.attention_cache_init(cfg, batch, cache_len, dtype, "meta",
                                        paged=paged)
    if paged is not None:
        blocks = {k: layers.pool_zeros((cfg.num_layers, *a.shape), a.dtype,
                                       device, axis=1)
                  for k, a in layer.items()}
    else:
        blocks = {k: torch.zeros((cfg.num_layers, *a.shape), dtype=a.dtype,
                                 device=device) for k, a in layer.items()}
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


def cache_reset_slot(cache: Params, slot: int, paged=None) -> Params:
    """Zero one slot's rows in every layer's cache leaves and reset its
    length to 0, **in place** (the JAX version returns a new tree);
    returns ``cache``.

    A recycled slot must start from a state identical to a fresh one: the
    length masks already hide the stale prefix, the zeroing makes a
    refilled slot reproduce single-sequence decode bitwise.  Paged: the
    slot's rows are the pool pages its row of ``cache["pages"]`` names;
    they are zeroed (entries of -1 aim at the trash page, so the device
    table is read with no host synchronisation) and the row is set to -1.
    The host allocator frees the pages separately."""
    if paged is not None:
        row = cache["pages"][slot]
        idx = torch.where(row >= 0, row.clamp(max=paged.num_pages - 1),
                          paged.num_pages).long()
        for a in cache["blocks"].values():
            layers.with_trash_page(a, axis=1)[:, idx] = 0
        cache["pages"][slot] = -1
    else:
        for a in cache["blocks"].values():
            a[:, slot] = 0
    cache["lengths"][slot] = 0
    return cache


def cache_poison_slot(cache: Params, slot: int, paged=None) -> Params:
    """Overwrite one slot's float cache leaves with NaN, **in place**
    (the chaos harness's ``kv_corrupt`` fault); returns ``cache``.

    Only float leaves are poisoned: the f32 or bf16 K/V rows, or in the
    int8 layout the f32 scales (the codes stay).  ``lengths``, ``index``
    and the page table are untouched: the fault corrupts data, not
    control state.  Paged: the slot's rows are the pool pages its row of
    ``cache["pages"]`` names; entries of -1 name no page, and the trash
    page past the pool (`layers.pool_zeros`), where other slots' masked
    writes land, is never poisoned."""
    leaves = [a for a in cache["blocks"].values() if a.is_floating_point()]
    if paged is not None:
        row = cache["pages"][slot]
        idx = row[row >= 0].long()
        for a in leaves:
            a[:, idx] = float("nan")
    else:
        for a in leaves:
            a[:, slot] = float("nan")
    return cache


def _layer_apply(p: Params, x, cfg: ModelConfig, positions, cache, lengths,
                 active, pages, paged, prefill, span):
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, _ = layers.attention_apply(p["mixer"], h, cfg, positions, cache=cache,
                                  lengths=lengths, active=active,
                                  pages=pages, paged=paged, prefill=prefill,
                                  block_k=span)
    x = x + h
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.swiglu_apply(p["mlp"], h2)


def forward(cfg: ModelConfig, params: Params, inputs: dict,
            cache: Params | None = None, compute_dtype=torch.bfloat16,
            last_only: bool = False, active: torch.Tensor | None = None,
            paged=None):
    """Returns ``(logits, new_cache)``.

    ``inputs["tokens"]`` is (B, S).  With a ``cache``, each slot continues
    from its own depth ``cache["lengths"][b]``; ``active`` ((B,) or (B, S)
    bool) masks which slots (or which columns of a packed chunk) write
    cache rows and advance.  The cache's K/V tensors are updated **in
    place**; ``new_cache`` holds them with the new ``index`` and
    ``lengths``.  ``last_only`` unembeds only the final position; without a
    cache it is the forward-only serving prefill, whose attention runs the
    flash kernel (`layers.attention_apply`'s ``prefill``).
    ``paged`` (a `runtime.paging.PageSpec`) marks the cache as paged; its
    ``cache["pages"]`` table is threaded to every layer, as is a
    contiguous cache's ``"decode_span"``.
    """
    _check_family(cfg)
    tokens = inputs["tokens"]
    x = layers.embedding_lookup(params["embed"], tokens).to(compute_dtype)
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
    blocks = params["blocks"]
    for l in range(cfg.num_layers):
        gp = _tree_map(lambda a: a[l], blocks)
        gc = (None if cache is None
              else {k: a[l] for k, a in cache["blocks"].items()})
        x = _layer_apply(gp, x, cfg, positions, gc, lengths, act, pages,
                         paged, prefill, span)

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
    return layers.unembed(head, x), new_cache
