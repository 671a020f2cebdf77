"""Step functions.  Counterpart of `repro.launch.steps`: the train step
(forward, backward, AdamW), the eval step, and the serving steps
(`make_prefill_step`, `_last_valid_logits`, `make_serve_step`,
`make_guarded_serve_step`).  The train step updates the state in place;
the serve steps update the cache's K/V in place."""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel.loss import cross_entropy, fused_cross_entropy

AUX_WEIGHT = 1e-2


def loss_and_grads(cfg: ModelConfig, params, batch,
                   compute_dtype=torch.bfloat16):
    """The train step's loss and its gradient: ``(total, metrics, aux,
    grads)``.  ``total`` is the fused chunked cross entropy of the final
    hidden states plus ``AUX_WEIGHT`` times the MoE aux; ``metrics`` the
    loss's (``loss``, ``tokens``); ``grads`` a tree of ``params``'s
    structure (zeros for a leaf the loss does not read, as JAX's)."""
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
                                            chunk=cfg.loss_chunk)
        total = loss + AUX_WEIGHT * aux
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for g, leaf in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics, aux.detach(),
            tree_lib.unflatten_like(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    compute_dtype=torch.bfloat16):
    """``train_step(state, batch) -> (state, metrics)``: `loss_and_grads`
    then `adamw.update`, which updates ``state`` (``{"params", "opt"}``)
    in place.  ``batch`` holds the model's inputs and ``"labels"``.  The
    metrics are the reference's: ``loss``, ``tokens``, ``grad_norm``,
    ``lr``, ``total_loss``, ``aux_loss`` (0-d tensors).
    ``compute_dtype`` is the forward's (the reference's is bf16).  The
    reference's ``grad_dtype`` (a compressed gradient all-reduce) is not
    here: its only caller, `repro.launch.dryrun`, is among the scale-out
    modules still to port (ROADMAP A14)."""

    def train_step(state, batch):
        total, metrics, aux, grads = loss_and_grads(
            cfg, state["params"], batch, compute_dtype)
        _, _, opt_metrics = adamw.update(state["params"], grads,
                                         state["opt"], opt_cfg)
        return state, {**metrics, **opt_metrics, "total_loss": total,
                       "aux_loss": aux}

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
