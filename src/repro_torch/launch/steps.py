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


class NotInPort(NotImplementedError):
    """A step the port does not form; its message names the ROADMAP
    item that records it."""


def loss_and_grads(cfg: ModelConfig, params, batch,
                   compute_dtype=torch.bfloat16, denominator=None,
                   aux_weight: float = AUX_WEIGHT):
    """The train step's loss and its gradient: ``(total, metrics, aux,
    grads)``.  ``total`` is the fused chunked cross entropy of the final
    hidden states plus ``aux_weight`` (`AUX_WEIGHT`) times the MoE aux;
    ``metrics`` the loss's (``loss``, ``tokens``); ``grads`` a tree of
    ``params``'s structure (zeros for a leaf the loss does not read, as
    JAX's).  ``denominator`` replaces the loss's count of labelled tokens
    (`parallel.loss.fused_cross_entropy`)."""
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
                                            denominator=denominator)
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


def data_parallel_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                       rules=None, compute_dtype=torch.bfloat16,
                       grad_dtype=None):
    """The train step over ``mesh`` under ``rules``, on a state whose
    leaves are DTensors placed by `specs.param_pspecs` and
    `specs.opt_pspecs` (`launch.train.build_state`).  Each rank, under
    the mesh and the rules (so MoE layers take `moe.apply_sharded`):

    - takes its rows of the global ``batch`` (the batch axes' split);
    - gathers each parameter whole for the forward (an FSDP-stored leaf
      by `all_gather`);
    - divides its shard's summed loss by the global batch's count of
      labelled tokens (and the aux weight by the data-parallel degree),
      so that the gradients' SUM over the batch axes, one `all_reduce`
      per leaf in ``grad_dtype`` if given, is the global batch's
      gradient (a mean of per-rank means would weigh shards with fewer
      labels up);
    - updates its block of each moment where ZeRO shards it, and the
      same block of the parameter, with the whole gradient's norm; then
      gathers the parameter over the moment's axes, or keeps only its
      own block where the parameter is stored sharded.  An int8 moment
      is updated whole on every rank (its blocks of 128 need not align
      with a shard).

    Ranks of other axes (the model axis) repeat their data rank's work;
    an MoE layer splits its tokens over the model axis, whose gradients
    this step does not reduce, so an MoE model trains on a model axis of
    1 only.  On a mesh of one card the step is bitwise the plain one."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import (axis_group, axis_index,
                                         axis_names, axis_sizes, set_mesh)
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.loss import IGNORE
    rules = rules if rules is not None else specs.rules_for(mesh)
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in (rules.table.get("batch") or ())
                       if a in sizes)
    dp = math.prod(sizes[a] for a in batch_axes)
    other = [a for a in axis_names(mesh)
             if a not in batch_axes and sizes[a] > 1]
    if other and any(cfg.is_moe_layer(l) for l in range(cfg.num_layers)):
        raise NotInPort(
            f"an MoE model trains data parallel on a model axis of 1; axes "
            f"{other} have sizes {[sizes[a] for a in other]} (ROADMAP A14: "
            f"no MoE training over a model axis > 1)")
    group = axis_group(mesh, batch_axes)

    def update(state, params, grads, gnorm):
        """AdamW on this rank's blocks; returns its metrics."""
        after = []                     # what each leaf does after the update

        def prepare(p_dt, p_full, g, m, v):
            if isinstance(m, dict):    # int8: the whole leaf on every rank
                mw = {k: shd.full_tensor(t) for k, t in m.items()}
                vw = {k: shd.full_tensor(t) for k, t in v.items()}
                after.append((p_dt, p_full, None, None, (m, mw), (v, vw)))
                return p_full, g, mw, vw
            spec = shd.spec_of(m)
            block = p_full[shd.shard_slices(p_full.shape, spec, mesh)]
            after.append((p_dt, p_full, block, spec, None, None))
            return block, g[shd.shard_slices(g.shape, spec, mesh)], \
                m.to_local(), v.to_local()

        work = tree_lib.map_structure(prepare, state["params"], params,
                                      grads, state["opt"]["m"],
                                      state["opt"]["v"])
        p_tree, g_tree, m_tree, v_tree = (
            tree_lib.map_structure(lambda w, i=i: w[i], work)
            for i in range(4))
        opt = {"step": state["opt"]["step"].to_local(), "m": m_tree,
               "v": v_tree}
        _, _, metrics = adamw.update(p_tree, g_tree, opt, opt_cfg,
                                     grad_norm=gnorm)
        for p_dt, p_full, block, m_spec, *int8 in after:
            for pair in int8:
                if pair is not None:   # store this rank's blocks back
                    moment, whole = pair
                    for k, t in moment.items():
                        t.to_local().copy_(shd.local_shard(
                            whole[k], shd.spec_of(t), mesh))
            p_spec = shd.spec_of(p_dt)
            sharded = any(e is not None for e in p_spec)
            if m_spec is not None and any(e is not None for e in m_spec):
                if p_spec == m_spec:   # FSDP: the block is the stored one
                    p_dt.to_local().copy_(block)
                    continue
                p_full.copy_(shd.gather_full(block, m_spec, mesh))
            if sharded:
                p_dt.to_local().copy_(shd.local_shard(p_full, p_spec, mesh))
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
            params = tree_lib.map_structure(shd.full_tensor, state["params"])
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
            gnorm = adamw.global_norm(grads)
            opt_metrics = update(state, params, grads, gnorm)
        out = {"loss": loss, "tokens": count, **opt_metrics,
               "total_loss": loss + AUX_WEIGHT * aux, "aux_loss": aux}
        return (state, out, grads) if return_grads else (state, out)

    return train_step


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


def make_prefill_step(cfg: ModelConfig, compute_dtype=torch.bfloat16):
    """Forward-only prefill over a prompt without a cache: ``batch``
    ({"tokens": (B, S)}, and for a model with a frontend its
    ``"frames"`` or ``"patches"`` (B, P, frontend_dim) instead of or ahead
    of the tokens; a "labels" entry ignored) in, the greedy next token
    (B,) int32 out.  Only the final position is unembedded, and attention
    runs the flash kernel (`kernels.attention.ops`), causal or not as the
    model is."""

    def prefill_step(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = transformer.forward(cfg, params, inputs,
                                        compute_dtype=compute_dtype,
                                        last_only=True)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    return prefill_step


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
                    paged=None):
    """One step: tokens (B, S) in, ``(next_token (B, 1) int32, cache)``
    out.  ``active`` ((B,) or (B, S) bool, optional) is the ragged
    continuous-batching mask; ``None`` advances every slot.  ``paged`` (a
    `runtime.paging.PageSpec`) switches the cache to the paged layout."""

    def serve_step(params, cache, tokens, active=None):
        logits, new_cache = transformer.forward(
            cfg, params, {"tokens": tokens}, cache=cache,
            compute_dtype=compute_dtype, active=active, paged=paged)
        last = _last_valid_logits(logits, active, tokens.shape[1])
        return last.argmax(dim=-1).to(torch.int32)[:, None], new_cache

    return serve_step


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
