"""Mixture-of-Experts with capacity-bounded dispatch.  Counterpart of
`repro.models.moe`.

- `apply_dense`: every token through every expert, weighted combine; the
  correctness oracle.
- `apply_grouped`: sort-based dispatch into a static (E, capacity, D)
  buffer, one batched SwiGLU over the expert axis, a gathered combine.
  Items over an expert's capacity are dropped (combine weight 0) and
  scatter out of bounds, so they never clobber a kept item's slot.
- `apply_sharded`: the expert-parallel entry of the model.  With no mesh,
  which is every run of the port today, it is `apply_grouped` over the
  flattened tokens, as the JAX code falls back to it without sharding
  rules.

Two choices keep a card's results fixed from run to run and equal to the
JAX code's on the CPU: the router runs in float32 and picks the top k by a stable descending sort (equal probabilities: the
lower expert first, as `jax.lax.top_k`); and a token's k contributions are
added one after another in ascending k, as the reference's scatter-add
adds them on the CPU, not by atomics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.loadbalance import expert_capacity
from repro_torch.models import layers

Params = dict
# Leaves the forward reads in f32 whatever the compute dtype: the router.
OWN_DTYPE_LEAVES = frozenset({"router"})


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32) -> Params:
    """The router is f32 whatever ``dtype`` is, as in the JAX init."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": layers._dense_init(generator, (d, e), torch.float32),
        "w_gate": layers._dense_init(generator, (e, d, f), dtype),
        "w_up": layers._dense_init(generator, (e, d, f), dtype),
        "w_down": layers._dense_init(generator, (e, f, d), dtype),
    }


def route(params: Params, x: torch.Tensor, cfg):
    """x: (T, D) -> (idx (T, k) int64, weights (T, k) in x's dtype,
    aux 0-d f32): the top-k experts of each token, their renormalised
    probabilities and the Switch-style load-balance loss E * sum_e f_e P_e
    over each token's first choice."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[:, :cfg.top_k], order[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    e = cfg.num_experts
    hot = F.one_hot(idx[:, 0], e).float()
    aux = e * torch.sum(hot.mean(dim=0) * probs.mean(dim=0))
    return idx, weights.to(x.dtype), aux


def _expert_ffn(params: Params, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D), a batched SwiGLU over the expert
    axis."""
    dt = buf.dtype
    h = F.silu(torch.bmm(buf, params["w_gate"].to(dt)))
    h = h * torch.bmm(buf, params["w_up"].to(dt))
    return torch.bmm(h, params["w_down"].to(dt))


def _combine(contrib: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """(T*k, D) contributions, token-major -> (T, D): each token's k rows
    added in ascending k, one rounding per add, from zero."""
    contrib = contrib.reshape(t, k, -1)
    out = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        out = out + contrib[:, j]
    return out


def apply_dense(params: Params, x: torch.Tensor, cfg):
    """(T, D) -> ((T, D), aux); exact: no capacity, no drops."""
    t, d = x.shape
    idx, weights, aux = route(params, x, cfg)
    buf = x[None].expand(cfg.num_experts, t, d)
    out_all = _expert_ffn(params, buf)                          # (E, T, D)
    gate = torch.zeros((t, cfg.num_experts), dtype=x.dtype, device=x.device)
    gate.scatter_(1, idx, weights)
    return torch.einsum("etd,te->td", out_all, gate), aux


def _dispatch_indices(flat_e: torch.Tensor, num_groups: int, capacity: int):
    """flat_e: (N,) destination group of each item -> (slot (N,), keep
    (N,)).  Items keep their order within a group (a stable sort); the
    first ``capacity`` of each group are kept, and ``slot`` is unique
    among the kept items."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(flat_e, minlength=num_groups)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=flat_e.device) - starts[se]
    keep_sorted = pos < capacity
    slot_sorted = se * capacity + torch.clamp(pos, max=capacity - 1)
    inv = torch.argsort(order, stable=True)                    # undo the sort
    return slot_sorted[inv], keep_sorted[inv]


def _scatter_slots(values: torch.Tensor, slot: torch.Tensor,
                   keep: torch.Tensor, num_slots: int, fill) -> torch.Tensor:
    """values (N,) -> (num_slots,) buffer filled with ``fill``; dropped
    items write one past the end, which is cut off."""
    out = torch.full((num_slots + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[torch.where(keep, slot, num_slots)] = values
    return out[:num_slots]


def apply_grouped(params: Params, x: torch.Tensor, cfg,
                  capacity: int | None = None):
    """(T, D) -> ((T, D), aux) through static (E, C, D) buffers; C is
    `expert_capacity` of all T rows unless given."""
    t, d = x.shape
    k, e = cfg.top_k, cfg.num_experts
    if capacity is None:
        capacity = expert_capacity(t, e, k, cfg.capacity_factor)
    idx, weights, aux = route(params, x, cfg)

    flat_e = idx.reshape(-1)                                   # (T*k,)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_w = weights.reshape(-1)
    slot, keep = _dispatch_indices(flat_e, e, capacity)

    slot_token = _scatter_slots(flat_t, slot, keep, e * capacity, t)
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    buf = x_pad[slot_token].reshape(e, capacity, d)
    out_buf = _expert_ffn(params, buf).reshape(e * capacity, d)

    gathered = out_buf[torch.where(keep, slot, 0)]             # (T*k, D)
    contrib = gathered * (flat_w * keep.to(flat_w.dtype))[:, None]
    return _combine(contrib.to(x.dtype), t, k), aux


def apply_sharded(params: Params, x: torch.Tensor, cfg):
    """(B, S, D) -> ((B, S, D), aux).  No mesh exists in the port, so
    this is `apply_grouped` over the B*S rows: capacity counts every row
    of the forward, inactive slots' padding included, as the reference's
    does.  Expert parallelism over cards (the reference's `all_to_all`
    path) is ROADMAP A14."""
    b, s, d = x.shape
    out, aux = apply_grouped(params, x.reshape(b * s, d), cfg)
    return out.reshape(b, s, d), aux
