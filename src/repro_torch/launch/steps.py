"""Step functions.  Counterpart of `repro.launch.steps`: the train step
(forward, backward, AdamW), the eval step, and the serving steps
(`make_prefill_step`, `_last_valid_logits`, `make_serve_step`,
`make_guarded_serve_step`).  The train step updates the state in place;
the serve steps update the cache's K/V in place."""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel.loss import cross_entropy, fused_cross_entropy

AUX_WEIGHT = 1e-2


def loss_and_grads(cfg: ModelConfig, params, batch,
                   compute_dtype=torch.bfloat16, denominator=None,
                   aux_weight: float = AUX_WEIGHT):
    """The train step's loss and its gradient: ``(total, metrics, aux,
    grads)``.  ``total`` is the fused chunked cross entropy of the final
    hidden states plus ``aux_weight`` (`AUX_WEIGHT`) times the MoE aux;
    ``metrics`` the loss's (``loss``, ``tokens``); ``grads`` a tree of
    ``params``'s structure (zeros for a leaf the loss does not read, as
    JAX's).  ``denominator`` replaces the loss's count of labelled tokens
    (`parallel.loss.fused_cross_entropy`).  Under rules and a mesh the
    leaves may be this rank's blocks (`transformer.compute_specs`), and
    so are their gradients."""
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    leaves = tree_lib.leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        p = tree_lib.unflatten_like(params, live)
        hidden, _, aux = transformer.forward(
            cfg, p, inputs, compute_dtype=compute_dtype,
            return_hidden=True, return_aux=True)
        head = p["embed" if cfg.tie_embeddings else "head"]["table"]
        loss, metrics = fused_cross_entropy(hidden, head, batch["labels"],
                                            chunk=cfg.loss_chunk,
                                            denominator=denominator,
                                            vocab=cfg.vocab_size)
        total = loss + aux_weight * aux
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for g, leaf in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics, aux.detach(),
            tree_lib.unflatten_like(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    compute_dtype=torch.bfloat16, grad_dtype=None,
                    mesh=None, rules=None):
    """``train_step(state, batch) -> (state, metrics)``: `loss_and_grads`,
    the gradients cast to ``grad_dtype`` if given (the reference's
    compressed all-reduce: moments still accumulate in f32), then
    `adamw.update`, in place on ``state`` (``{"params", "opt"}``).
    ``batch`` holds the model's inputs and ``"labels"``.  The metrics are
    the reference's: ``loss``, ``tokens``, ``grad_norm``, ``lr``,
    ``total_loss``, ``aux_loss`` (0-d tensors).  ``compute_dtype`` is the
    forward's (the reference's is bf16).  ``train_step(...,
    return_grads=True)`` also returns the gradients the update used.

    With ``mesh`` (and ``rules``, by default `specs.rules_for(mesh)`)
    the step is `data_parallel_step`'s on a state of DTensors."""
    if mesh is not None:
        return data_parallel_step(cfg, opt_cfg, mesh, rules, compute_dtype,
                                  grad_dtype)

    def train_step(state, batch, return_grads=False):
        total, metrics, aux, grads = loss_and_grads(
            cfg, state["params"], batch, compute_dtype)
        if grad_dtype is not None:
            grads = tree_lib.map_structure(lambda g: g.to(grad_dtype), grads)
        _, _, opt_metrics = adamw.update(state["params"], grads,
                                         state["opt"], opt_cfg)
        out = {**metrics, **opt_metrics, "total_loss": total,
               "aux_loss": aux}
        return (state, out, grads) if return_grads else (state, out)

    return train_step


def rank_params(cfg: ModelConfig, params, mesh, rules):
    """The blocks of ``params`` (DTensors, or whole tensors the same on
    every rank) this rank's forward computes with under ``rules``:
    `sharding.compute_block` of each leaf by `transformer.compute_specs`
    (the RWKV mixes over their heads and d_ff, Mamba over its inner
    width, its ``in_proj`` moved to the rank's columns of each half
    without a gather)."""
    from repro_torch.parallel import sharding as shd
    return tree_lib.map_structure(
        lambda t, c: shd.compute_block(t, c, mesh), params,
        transformer.compute_specs(cfg, rules))


def data_parallel_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                       rules=None, compute_dtype=torch.bfloat16,
                       grad_dtype=None):
    """The train step over ``mesh`` under ``rules``, on a state whose
    leaves are DTensors placed by `specs.param_pspecs` and
    `specs.opt_pspecs` (`launch.train.build_state`).  Each rank, under
    the mesh and the rules:

    - takes its rows of the global ``batch`` (the batch axes' split);
    - takes each parameter's block its layer computes with
      (`rank_params`: heads, ff, vocab and experts split over the model
      axis where the rules keep them, RWKV6's and Mamba's at their own
      widths, whole elsewhere; an FSDP-stored leaf gathered over the data
      axes), so the forward is tensor and expert parallel (`models.layers`, `models.moe.apply_sharded`, the
      vocab-parallel loss), and with `sharding.sequence_parallel` rules
      its residual stream is split by sequence;
    - divides its shard's summed loss by the global batch's count of
      labelled tokens (and the aux weight by the data-parallel degree),
      so that the gradients' SUM over the batch axes, one `all_reduce`
      per leaf in ``grad_dtype`` if given, is the global batch's
      gradient (a mean of per-rank means would weigh shards with fewer
      labels up);
    - updates its block of each moment (the parameter's model block, cut
      again where ZeRO shards it) and the same block of the parameter,
      with the whole gradient's norm; then gathers the parameter over the
      moment's data axes, or keeps only its own block where the
      parameter is stored sharded.  An int8 moment is updated on its
      block where its blocks of 128 fall whole in it (`_int8_aligned`),
      else whole on every rank, from the leaf's gradient and parameter
      gathered whole.

    Nothing sums a gradient over the model axis here: a leaf replicated
    over it gets its whole gradient on every rank inside the forward.
    Where the model ranks compute it from the same input, that gradient
    is the same on each; where each uses it on its own part (the MoE
    router on its token split, a norm scale on its part of a
    sequence-split stream, the qk-norm scales and the KV projections a
    rank reads for its query heads) the layer passes it through
    `sharding.copy_in`, whose backward sums the parts.  Summing such a
    gradient again over the model axis would count it once a rank.  The
    gradient norm adds the blocks' square sums over the model axis.  On a
    mesh of one card the step is bitwise the plain one."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import (axis_group, axis_index,
                                         axis_sizes, set_mesh)
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.loss import IGNORE
    rules = rules if rules is not None else specs.rules_for(mesh)
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in (rules.table.get("batch") or ())
                       if a in sizes)
    dp = math.prod(sizes[a] for a in batch_axes)
    group = axis_group(mesh, batch_axes)
    cspecs = transformer.compute_specs(cfg, rules)
    split_axes = {shd._axes(e) for spec in tree_lib.leaves(cspecs)
                  for e in spec if e}
    if len(split_axes) > 1:
        raise ValueError(f"leaves split over several axes: {split_axes}")
    model = axis_group(mesh, split_axes.pop()) if split_axes else None

    def whole(x, c):
        return shd.gather_full(x, c, mesh) if any(c) else x

    def _int8_aligned(p_dt, m, c) -> bool:
        """Whether an int8 moment's blocks of ``QBLOCK`` along the last
        dim fall whole in this rank's block of the parameter: the last
        dim unsplit, or split with no padding into blocks of a multiple
        of ``QBLOCK``, the scales split alike; and the layer computes
        each dim split as the moment is, or whole."""
        q_spec, s_spec = shd.spec_of(m["q"]), shd.spec_of(m["scale"])
        last = shd._axes(q_spec[-1])
        if last:
            n = math.prod(sizes[a] for a in last)
            if (shd._axes(s_spec[-1]) != last
                    or p_dt.shape[-1] != m["q"].shape[-1]
                    or (p_dt.shape[-1] // n) % adamw.QBLOCK):
                return False
        return all(e is None or shd._axes(e) == shd._axes(q)
                   for e, q in zip(c, q_spec))

    def update(state, params, grads, gnorm):
        """AdamW on this rank's blocks, in place on ``params`` (views of
        the stored blocks, or what the forward gathered); returns its
        metrics."""
        after = []                     # what each leaf does after the update

        def block(p_dt, p_c, c, spec):
            """The moment's block of the parameter, and the axes the
            moment splits beyond the stored parameter (ZeRO's data axes),
            over which the updated block is gathered again; such a block
            is a copy, so the gather never copies it again."""
            p_spec = list(shd.spec_of(p_dt)) + [None] * len(spec)
            extra = tuple(None if shd._axes(a) == shd._axes(b) else a
                          for a, b in zip(spec, p_spec))
            blk = shd.block_of(p_c, c, spec, mesh)
            after.append((p_dt, blk.clone() if any(extra) else blk, extra,
                          None, None))
            return after[-1][1]

        def prepare(p_dt, p_c, g, m, v, c):
            if isinstance(m, dict) and _int8_aligned(p_dt, m, c):
                spec = shd.spec_of(m["q"])
                return (block(p_dt, p_c, c, spec),
                        shd.block_of(g, c, spec, mesh),
                        {k: t.to_local() for k, t in m.items()},
                        {k: t.to_local() for k, t in v.items()})
            if isinstance(m, dict):    # int8: the whole leaf on every rank
                mw = {k: shd.full_tensor(t) for k, t in m.items()}
                vw = {k: shd.full_tensor(t) for k, t in v.items()}
                pw = whole(p_c, c)
                after.append((p_dt, pw, None, (m, mw), (v, vw)))
                return pw, whole(g, c), mw, vw
            spec = shd.spec_of(m)
            return block(p_dt, p_c, c, spec), \
                shd.block_of(g, c, spec, mesh), m.to_local(), v.to_local()

        work = tree_lib.map_structure(prepare, state["params"], params,
                                      grads, state["opt"]["m"],
                                      state["opt"]["v"], cspecs)
        p_tree, g_tree, m_tree, v_tree = (
            tree_lib.map_structure(lambda w, i=i: w[i], work)
            for i in range(4))
        opt = {"step": state["opt"]["step"].to_local(), "m": m_tree,
               "v": v_tree}
        _, _, metrics = adamw.update(p_tree, g_tree, opt, opt_cfg,
                                     grad_norm=gnorm)
        for p_dt, blk, extra, *int8 in after:
            if extra is None:          # int8: whole leaf and moments
                for moment, full in int8:
                    for k, t in moment.items():
                        t.to_local().copy_(shd.local_shard(
                            full[k], shd.spec_of(t), mesh))
                p_dt.to_local().copy_(shd.local_shard(
                    blk, shd.spec_of(p_dt), mesh))
                continue
            p_dt.to_local().copy_(whole(blk, extra))
        return metrics

    def train_step(state, batch, return_grads=False):
        with set_mesh(mesh), shd.use_rules(rules):
            b = batch["labels"].shape[0]
            if b % dp:
                raise ValueError(f"a global batch of {b} does not split over "
                                 f"{dp} data-parallel ranks")
            r = axis_index(mesh, batch_axes) if batch_axes else 0
            rows = slice(r * (b // dp), (r + 1) * (b // dp))
            local = {k: v[rows] for k, v in batch.items()}
            count = torch.sum(batch["labels"] != IGNORE).to(torch.float32)
            params = tree_lib.map_structure(
                lambda t, c: shd.compute_block(t, c, mesh),
                state["params"], cspecs)
            _, metrics, aux, grads = loss_and_grads(
                cfg, params, local, compute_dtype,
                denominator=torch.clamp(count, min=1.0),
                aux_weight=AUX_WEIGHT / dp)
            if grad_dtype is not None:
                grads = tree_lib.map_structure(lambda g: g.to(grad_dtype),
                                               grads)
            for g in tree_lib.leaves(grads):
                dist.all_reduce(g, group=group)
            loss = metrics["loss"].clone()
            dist.all_reduce(loss, group=group)
            gnorm = _grad_norm(grads, cspecs, model)
            opt_metrics = update(state, params, grads, gnorm)
            if return_grads and model is not None:
                grads = tree_lib.map_structure(whole, grads, cspecs)
        out = {"loss": loss, "tokens": count, **opt_metrics,
               "total_loss": loss + AUX_WEIGHT * aux, "aux_loss": aux}
        return (state, out, grads) if return_grads else (state, out)

    return train_step


def _grad_norm(grads, cspecs, model) -> torch.Tensor:
    """The whole gradient's global norm from this rank's blocks: the split
    leaves' square sums added over ``model`` (the model axis's group),
    the replicated ones' once; `adamw.global_norm` itself where nothing
    splits."""
    if model is None:
        return adamw.global_norm(grads)
    split, whole = [], []
    for g, c in zip(tree_lib.leaves(grads), tree_lib.leaves(cspecs)):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        (split if any(c) else whole).append(sq)
    total = torch.sum(torch.stack(split))
    dist.all_reduce(total, group=model)
    if whole:
        total = total + torch.sum(torch.stack(whole))
    return torch.sqrt(total)


def make_eval_step(cfg: ModelConfig, compute_dtype=torch.bfloat16):
    """``eval_step(params, batch) -> metrics`` of `cross_entropy` over
    the full forward's logits (``loss``, ``tokens``,
    ``accuracy_proxy``)."""

    @torch.no_grad()
    def eval_step(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = transformer.forward(cfg, params, inputs,
                                        compute_dtype=compute_dtype)
        _, metrics = cross_entropy(logits, batch["labels"])
        return metrics

    return eval_step


def _under(mesh, rules, fn):
    """``fn`` run under ``mesh`` and ``rules`` (by default
    `specs.rules_for(mesh)`); ``fn`` itself without a mesh."""
    if mesh is None:
        return fn
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.parallel import sharding as shd
    rules = rules if rules is not None else specs.rules_for(mesh)

    def run(*args, **kw):
        with set_mesh(mesh), shd.use_rules(rules):
            return fn(*args, **kw)

    return run


def make_prefill_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                      mesh=None, rules=None):
    """Forward-only prefill over a prompt without a cache: ``batch``
    ({"tokens": (B, S)}, and for a model with a frontend its
    ``"frames"`` or ``"patches"`` (B, P, frontend_dim) instead of or ahead
    of the tokens; a "labels" entry ignored) in, the greedy next token
    (B,) int32 out.  Only the final position is unembedded, and attention
    runs the flash kernel (`kernels.attention.ops`), causal or not as the
    model is.  With ``mesh`` the step runs under it and ``rules`` on this
    rank's rows of the batch and on the weights whole or as its blocks
    (`rank_params`), the greedy token taken across a vocab split
    (`sharding.vocab_argmax`)."""
    from repro_torch.parallel import sharding as shd

    def prefill_step(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = transformer.forward(cfg, params, inputs,
                                        compute_dtype=compute_dtype,
                                        last_only=True)
        return shd.vocab_argmax(logits[:, -1], cfg.vocab_size).to(
            torch.int32)

    return _under(mesh, rules, prefill_step)


def _last_valid_logits(logits: torch.Tensor, active, s: int) -> torch.Tensor:
    """Final-position logits per slot.  With a (B, S) chunked-prefill
    ``active`` each slot's final position is the last one it wrote;
    everywhere else it is the last column."""
    if active is not None and active.ndim == 2:
        idx = torch.clamp(active.sum(dim=1) - 1, 0, s - 1)
        return logits[torch.arange(logits.shape[0], device=logits.device),
                      idx]
    return logits[:, -1]


def make_serve_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                    paged=None, mesh=None, rules=None):
    """One step: tokens (B, S) in, ``(next_token (B, 1) int32, cache)``
    out.  ``active`` ((B,) or (B, S) bool, optional) is the ragged
    continuous-batching mask; ``None`` advances every slot.  ``paged`` (a
    `runtime.paging.PageSpec`) switches the cache to the paged layout.
    With ``mesh`` the step runs under it and ``rules`` (for a decode,
    `specs.rules_for` of a decode shape: `decode_rules`) on this rank's
    slots, the weights whole or as its blocks (`rank_params`) and its
    block of the cache (`transformer.cache_block`, a segment of the rows
    under ``kv_seq``)."""
    from repro_torch.parallel import sharding as shd

    def serve_step(params, cache, tokens, active=None):
        logits, new_cache = transformer.forward(
            cfg, params, {"tokens": tokens}, cache=cache,
            compute_dtype=compute_dtype, active=active, paged=paged)
        last = _last_valid_logits(logits, active, tokens.shape[1])
        nxt = shd.vocab_argmax(last, cfg.vocab_size).to(torch.int32)
        return nxt[:, None], new_cache

    return _under(mesh, rules, serve_step)


def make_guarded_serve_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                            paged=None):
    """`make_serve_step` plus the per-slot NaN/Inf logits guard.

    Returns ``(next_token, ok, cache)``; ``ok`` (B,) bool is True iff the
    slot's final-position logits are all finite.  ``poison`` ((B,) bool)
    overwrites a slot's logits with NaN after the forward, to exercise the
    guard without corrupting model state.  ``return_logits`` appends the
    final-position logits (B, V).  ``paged`` as in `make_serve_step`."""

    def serve_step(params, cache, tokens, active=None, poison=None,
                   return_logits=False):
        logits, new_cache = transformer.forward(
            cfg, params, {"tokens": tokens}, cache=cache,
            compute_dtype=compute_dtype, active=active, paged=paged)
        last = _last_valid_logits(logits, active, tokens.shape[1])
        if poison is not None:
            last = torch.where(poison[:, None], float("nan"), last)
        ok = torch.isfinite(last).all(dim=-1)
        nxt = last.argmax(dim=-1).to(torch.int32)
        if return_logits:
            return nxt[:, None], ok, new_cache, last
        return nxt[:, None], ok, new_cache

    return serve_step
