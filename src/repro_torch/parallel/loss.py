"""Cross entropy.  Counterpart of `repro.parallel.loss`.

The reference keeps the logits sharded over the vocab axis.  Where the
rules split ``vocab`` over the model axis (`fused_cross_entropy`'s
``vocab``), each rank computes its block of a chunk's logits; the
chunk's max, sum of exponentials and label logit are reduced over the
split, and each rank's gradient stays in its vocab block.  The label's
logit is taken with a gather where the reference sums a masked iota over
the vocab: both give the one logit exactly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import sharding as shd

IGNORE = -1


def _chunk_stats(xi: torch.Tensor, li: torch.Tensor, table: torch.Tensor,
                 vs=None):
    """(summed nll over the chunk's counted tokens, their count); over a
    vocab split ``vs`` the table is this rank's block."""
    logits = (xi @ table.T.to(xi.dtype)).to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    label = li.clamp(min=0).long()
    if vs is None:
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
        ll = torch.gather(logits, 1, label[:, None])[:, 0]
    else:
        m = shd._all_reduce(m, vs.group, dist.ReduceOp.MAX)
        se = shd.reduce_out(torch.sum(torch.exp(logits - m), dim=-1), vs)
        lse = torch.log(se) + m[..., 0]
        c = logits.shape[1]
        loc = label - vs.index * c
        inside = (loc >= 0) & (loc < c)
        own = torch.gather(logits, 1, loc.clamp(0, c - 1)[:, None])[:, 0]
        ll = shd.reduce_out(torch.where(inside, own, 0.0), vs)
    mask = (li != IGNORE).to(torch.float32)
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def fused_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                        labels: torch.Tensor, chunk: int = 2048,
                        denominator: torch.Tensor | None = None,
                        vocab: int | None = None):
    """Cross entropy with the unembedding folded in and chunked over
    tokens, so the (tokens, V) logits never exist at once.

    x: (B, S, D) final hidden states; table: (V, D) unembedding; labels
    (B, S).  Each chunk runs under `torch.utils.checkpoint` (the
    reference's `jax.checkpoint`): the backward recomputes the chunk's
    logits, the bf16 product cast to f32, instead of keeping them.  The
    chunks' sums are added in order from zero, as the reference's scan
    carries them (the reference's ``unroll``, a switch for XLA's cost
    analysis, has no use here).  Returns ``(loss, {"loss", "tokens"})``.
    The loss divides the summed nll by the count of labelled tokens, or
    by ``denominator`` where given (a data-parallel rank divides its
    shard's sum by the global batch's count).  ``vocab`` (the model's)
    splits the table over the model axis where the rules map ``vocab``;
    ``x`` then enters through `sharding.copy_in`, so its gradient is the
    sum of every vocab block's.  A tied table used by the embedding too
    gets one gradient, autograd's sum of both uses.
    """
    vs = shd.split("vocab", vocab) if vocab else None
    if vs is not None:
        table = shd.block(table, 0, vocab, vs)
        x = shd.copy_in(x, vs)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    lf = labels.reshape(b * s)
    n = b * s
    if chunk <= 0 or n <= chunk:
        chunk = n
    pad = (-n) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
        lf = torch.cat([lf, lf.new_full((pad,), IGNORE)])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll, cnt = zero, zero
    for i in range(0, n + pad, chunk):
        xi, li = xf[i:i + chunk], lf[i:i + chunk]
        if torch.is_grad_enabled():
            nll_c, cnt_c = checkpoint(_chunk_stats, xi, li, table, vs,
                                      use_reentrant=False)
        else:
            nll_c, cnt_c = _chunk_stats(xi, li, table, vs)
        nll, cnt = nll + nll_c, cnt + cnt_c
    loss = nll / (torch.clamp(cnt, min=1.0) if denominator is None
                  else denominator)
    return loss, {"loss": loss, "tokens": cnt}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """logits: (B, S, V); labels: (B, S) int (IGNORE = masked out).

    Returns ``(mean_nll, metrics)`` with ``loss``, ``tokens`` and
    ``accuracy_proxy`` (the share of counted tokens whose label's logit
    is within 1e-6 of the log-sum-exp)."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != IGNORE).to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    metrics = {
        "loss": loss,
        "tokens": torch.sum(mask),
        "accuracy_proxy": torch.sum((ll >= lse - 1e-6) * mask) / denom,
    }
    return loss, metrics
