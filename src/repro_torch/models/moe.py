"""Mixture-of-Experts with capacity-bounded dispatch.  Counterpart of
`repro.models.moe`.

- `apply_dense`: every token through every expert, weighted combine; the
  correctness oracle.
- `apply_grouped`: sort-based dispatch into a static (E, capacity, D)
  buffer, one batched SwiGLU over the expert axis, a gathered combine.
  Items over an expert's capacity are dropped (combine weight 0) and
  scatter out of bounds, so they never clobber a kept item's slot.
- `apply_sharded`: the expert-parallel entry of the model.  Under
  sharding rules that map ``experts`` (the serve CLI's, the trainer's)
  it exchanges tokens with the experts' shards over the model axis of
  the active mesh, two `all_to_all_single` out and one back; without
  them it is `apply_grouped` over the flattened tokens, as the JAX code
  falls back to it.

Two choices keep a card's results fixed from run to run and equal to the
JAX code's on the CPU: the router runs in float32 and picks the top k by a stable descending sort (equal probabilities: the
lower expert first, as `jax.lax.top_k`); and a token's k contributions are
added one after another in ascending k, as the reference's scatter-add
adds them on the CPU, not by atomics.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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


def moe_param_specs() -> Params:
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", None),
        "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
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
    among the kept items.  The groups' sizes are counted into
    ``num_groups`` bins by a scatter-add of fixed size, which needs no
    host read (`torch.bincount` reads the largest group on the host) and
    has a meta kernel."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(num_groups, dtype=torch.int64,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
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


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` of equal splits over ``group``; its gradient is
    the same exchange of the gradient (an equal-split exchange is its own
    transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _MeanOver(torch.autograd.Function):
    """The mean of a tensor over ``group`` (an all-reduce).  Each data
    rank's objective holds the mean once, replicated over the model axis,
    so the gradient of a rank's term is the gradients summed over
    ``grad_group`` (the data ranks; None: this rank alone) over
    ``grad_n``, the ranks whose terms the mean averages (with one model
    rank, the mean of the gradients over the group)."""

    @staticmethod
    def forward(ctx, x, group, grad_group, grad_n):
        ctx.grad_group, ctx.grad_n = grad_group, grad_n
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.grad_group is not None:
            dist.all_reduce(g, group=ctx.grad_group)
        return g / ctx.grad_n, None, None, None


def apply_sharded(params: Params, x: torch.Tensor, cfg, mesh=None):
    """(B, S, D) -> ((B, S, D), aux): expert parallelism over the mesh's
    model axis.  With no active rules, or rules that map no ``experts``,
    it is `apply_grouped` over the B*S rows.

    Under rules the reference's ``shard_map`` body runs on this rank's
    part, with explicit collectives over the active mesh (`launch.mesh`):
    ``x`` is this rank's block over the batch axes (its caller's slice;
    the same on every rank of the model axis).  The tokens split over the
    model axis (by sequence where it divides, else by batch, else every
    model rank routes them all); each item goes to its expert's shard in
    a send buffer of ``c_send`` slots per shard, one `all_to_all_single`
    each for the rows, the local expert ids and the valid flags; the
    shard runs its ``e_loc`` experts over ``c_local`` slots each (invalid
    slots routed to a phantom group ``e_loc`` so they take no capacity,
    and dropped out of bounds), and one more exchange brings the results
    home, where each token adds its k contributions in ascending k.  The
    two capacities compound the capacity factor, as the reference's do.
    ``aux`` is averaged over the batch and model axes.  The split
    outputs are gathered over the model axis.  With one model shard every
    exchange still goes through the group.

    Trained: the expert weights are this rank's block of the experts
    (cut here where whole), gradients flow back through the exchanges,
    the token split cuts with `sharding.split_dim` and gathers with
    `sharding.gather_dim`, and where the tokens split over the model axis
    the router enters through `sharding.copy_in` (its gradient, from
    this rank's tokens, summed over the split) and ``aux``'s gradient
    weighs each rank's term once (`_MeanOver`).  Over a stream already
    split by sequence (`sharding.seq_split`) the rank's tokens are its
    part of the stream, and the output stays split."""
    from repro_torch.launch.mesh import axis_group, axis_index, axis_sizes
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.parallel import sharding as shd
    rules = shd.active_rules()
    b, s, d = x.shape
    if rules is None or rules.table.get("experts") is None:
        out, aux = apply_grouped(params, x.reshape(b * s, d), cfg)
        return out.reshape(b, s, d), aux

    model_axis = rules.table["experts"][0]
    batch_axes = tuple(rules.table.get("batch") or ())
    mesh = mesh if mesh is not None else get_abstract_mesh()
    if mesh is None:
        raise RuntimeError("sharding rules map experts, but no mesh is "
                           "active (launch.mesh.set_mesh)")
    sizes = axis_sizes(mesh)
    n_shards = sizes[model_axis]
    e = cfg.num_experts
    if e % n_shards:
        raise ValueError(f"{e} experts not divisible by model axis "
                         f"{n_shards}")
    e_loc = e // n_shards
    m = axis_index(mesh, model_axis)
    group = axis_group(mesh, model_axis)
    ms = shd.Split((model_axis,), n_shards, m, group)
    data_axes = batch_axes
    # the token split over the model axis
    if shd.seq_split() is not None:
        split, x_loc = "stream", x
    elif s % n_shards == 0:
        split, x_loc = 1, shd.split_dim(x, 1, ms)
    elif b % n_shards == 0:
        split, x_loc = 0, shd.split_dim(x, 0, ms)
    else:
        split, x_loc = None, x
    if split is not None:
        batch_axes = batch_axes + (model_axis,)
    t_loc = x_loc.shape[0] * x_loc.shape[1]
    k = cfg.top_k
    c_send = expert_capacity(t_loc * k, n_shards, 1, cfg.capacity_factor)
    c_local = expert_capacity(n_shards * c_send, e_loc, 1,
                              cfg.capacity_factor)

    xf = x_loc.reshape(t_loc, d)
    router = shd.copy_in(params["router"], ms if split is not None else None)
    idx, weights, aux = route({"router": router}, xf, cfg)
    flat_e = idx.reshape(-1)                                   # global ids
    flat_t = torch.arange(t_loc, device=x.device).repeat_interleave(k)
    flat_w = weights.reshape(-1)
    dest = flat_e // e_loc                                     # its shard
    slot, keep = _dispatch_indices(dest, n_shards, c_send)

    n_send = n_shards * c_send
    send_tok = _scatter_slots(flat_t, slot, keep, n_send, t_loc)
    send_eid = _scatter_slots(flat_e % e_loc, slot, keep, n_send, 0)
    send_valid = _scatter_slots(torch.ones_like(flat_t), slot, keep, n_send,
                                0)
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    recv_x = _AllToAll.apply(x_pad[send_tok], group)           # (n_send, d)
    recv_eid = _all_to_all(send_eid, group)
    recv_valid = _all_to_all(send_valid, group).bool()

    # this shard's e_loc experts over what it received
    r = n_send
    lslot, lkeep = _dispatch_indices(
        torch.where(recv_valid, recv_eid, e_loc), e_loc + 1, c_local)
    lkeep = lkeep & recv_valid
    slot_token = _scatter_slots(torch.arange(r, device=x.device), lslot,
                                lkeep, e_loc * c_local, r)
    rx_pad = torch.cat([recv_x, recv_x.new_zeros((1, d))], dim=0)
    buf = rx_pad[slot_token].reshape(e_loc, c_local, d)
    outb = _expert_ffn({w: shd.block(params[w], 0, e, ms) for w in
                        ("w_gate", "w_up", "w_down")},
                       buf).reshape(e_loc * c_local, d)
    back = outb[torch.where(lkeep, lslot, 0)] * lkeep[:, None].to(outb.dtype)

    res = _AllToAll.apply(back, group)                         # home again
    contrib = res[torch.where(keep, slot, 0)] * \
        (flat_w * keep.to(flat_w.dtype))[:, None]
    out = _combine(contrib.to(xf.dtype), t_loc, k).reshape(x_loc.shape)
    axes = tuple(dict.fromkeys(batch_axes + (model_axis,)))
    dp = 1
    for a in data_axes:
        dp *= sizes[a]
    aux = _MeanOver.apply(
        aux, axis_group(mesh, axes),
        axis_group(mesh, data_axes) if data_axes else None,
        dp * (n_shards if split is not None else 1))
    if split in (0, 1):
        out = shd.gather_dim(out, split, ms, reduce_grad=False)
    return out, aux
