"""Serving step functions.  Counterpart of the serving part of
`repro.launch.steps` (`make_prefill_step`, `_last_valid_logits`,
`make_serve_step`, `make_guarded_serve_step`).  The serve steps update the
cache's K/V in place."""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


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
