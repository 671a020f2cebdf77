"""Logical-axis sharding rules (DP/TP/EP/SP).  Counterpart of
`repro.parallel.sharding`.

Model code names tensor dims with *logical* axes (``batch``, ``heads``,
``experts`` ...); a `Rules` table maps each to mesh axes.  A spec is a
plain tuple with one entry per dim, each None (replicated), a mesh-axis
name or a tuple of names, where the reference builds a `PartitionSpec`
of the same entries.  `placements` turns a spec into DTensor placements
over a `DeviceMesh`, which are what a `NamedSharding` is.

The port runs each rank's part of a step on local tensors with explicit
collectives (`local_shard`, `gather_full`, the train step, MoE's
`apply_sharded`), so `constrain` and `gather_weight` only act on
DTensors and are the identity on a plain tensor.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (axis_group, axis_index, axis_names,
                                     axis_sizes)

# Logical axes used by the model zoo:
#   batch   - global batch            (data parallel)
#   seq     - sequence                (sequence parallel for long context)
#   embed   - d_model                 (usually replicated)
#   heads   - attention heads         (tensor parallel)
#   kv_heads- kv heads                (tensor parallel when divisible)
#   ff      - feed-forward hidden     (tensor parallel)
#   experts - MoE experts             (expert parallel)
#   vocab   - embedding/logits vocab  (tensor parallel)
#   kv_seq  - cached sequence         (sequence parallel at decode)


@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict
    # mesh axis name -> size; lets `constrain` drop indivisible mappings
    sizes: dict = dataclasses.field(default_factory=dict)

    def spec(self, *logical) -> tuple:
        return tuple(self.table.get(ax) for ax in logical)

    def axis_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        n = 1
        for a in mesh_axes:
            n *= self.sizes.get(a, 1)
        return n

    def with_sizes(self, mesh) -> "Rules":
        return Rules(self.table, axis_sizes(mesh))


def single_pod_rules() -> Rules:
    return Rules({
        "batch": ("data",),
        "seq": None,
        "res_seq": None,          # residual-stream seq (block boundaries)
        "embed": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "kv_seq": ("data",),
        "dp": ("data",),          # optimizer-state (ZeRO) axis
    })


def multi_pod_rules() -> Rules:
    return Rules({
        "batch": ("pod", "data"),
        "seq": None,
        "res_seq": None,
        "embed": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "kv_seq": ("pod", "data"),
        "dp": ("pod", "data"),
    })


def sequence_parallel(base: Rules) -> Rules:
    """Shard the residual stream's sequence over the model axis between
    blocks."""
    t = dict(base.table)
    t["res_seq"] = t["heads"]     # same axis as tensor parallelism
    return Rules(t, base.sizes)


def data_parallel_attention(base: Rules) -> Rules:
    """Attention activations stay batch-sharded (heads unsharded) while
    the attention weights stay model-sharded in the state and are
    gathered at use (`gather_weight`).  For the activation rules only."""
    t = dict(base.table)
    t["heads"] = None
    t["kv_heads"] = None
    t["zero3_attn"] = True
    return Rules(t, base.sizes)


def data_parallel_only(base: Rules) -> Rules:
    """No tensor parallelism: parameters replicated, the batch over every
    axis; the only collective left is the gradient reduction."""
    t = dict(base.table)
    model_axes = tuple(t.get("heads") or ())
    t["batch"] = tuple(t.get("batch") or ()) + model_axes
    t["dp"] = tuple(t.get("dp") or ()) + model_axes
    for ax in ("heads", "kv_heads", "ff", "experts", "vocab", "res_seq"):
        t[ax] = None
    return Rules(t, base.sizes)


def decode_rules(base: Rules, batch_replicated: bool = False) -> Rules:
    """Decode shapes: the cache's sequence dim takes the model axis; with
    a replicated batch (batch-1 long context) it also takes the DP axes."""
    t = dict(base.table)
    if batch_replicated:
        t["batch"] = None
        t["kv_seq"] = tuple(t["dp"]) + tuple(t["heads"])
    else:
        t["kv_seq"] = t["heads"]          # ("model",)
    # the model axis now carries the cache's seq dim, not its kv heads
    t["kv_heads"] = None
    return Rules(t, base.sizes)


def test_rules() -> Rules:
    """One-device tests: everything replicated."""
    return Rules({})


_ACTIVE: contextvars.ContextVar[Rules | None] = contextvars.ContextVar(
    "sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    tok = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def active_rules() -> Rules | None:
    return _ACTIVE.get()


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fitted(spec, shape, rules: Rules) -> tuple:
    """``spec`` with every entry whose mesh-axis product does not divide
    its dim (or is 1) replaced by None."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(e if (rules.axis_size(e) > 1 and dim % rules.axis_size(e)
                       == 0) else None for dim, e in zip(shape, entries))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh axis a dim names, ``Replicate()`` on the others.  A dim split
    over several axes is split row-major over them, which DTensor does
    in the mesh's axis order: an entry naming them in another order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def spec_of(dtensor) -> tuple:
    """The spec a DTensor's placements record (dims split over several
    axes in the mesh's order)."""
    names = axis_names(dtensor.device_mesh)
    entries: list = [[] for _ in range(dtensor.ndim)]
    for name, p in zip(names, dtensor.placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def shard_slices(shape, spec, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``spec`` (even
    splits, as `fitted` specs have): one slice per dim."""
    sizes = axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        axes = _axes(spec[i] if i < len(spec) else None)
        n = math.prod(sizes[a] for a in axes)
        if n == 1:
            out.append(slice(None))
            continue
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"evenly over {axes}")
        c = dim // n
        j = axis_index(mesh, axes)
        out.append(slice(j * c, (j + 1) * c))
    return tuple(out)


def local_shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    return full[shard_slices(full.shape, spec, mesh)]


def gather_full(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block under ``spec``: one
    `all_gather` over each split dim's axes (this rank's group along
    them, row-major as `axis_group` orders it)."""
    out = local
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes or math.prod(axis_sizes(mesh)[a] for a in axes) == 1:
            continue
        group = axis_group(mesh, axes)
        pieces = [torch.empty_like(out)
                  for _ in range(dist.get_world_size(group))]
        dist.all_gather(pieces, out.contiguous(), group=group)
        out = torch.cat(pieces, dim=dim)
    return out


def full_tensor(x) -> torch.Tensor:
    """A DTensor's whole value (`gather_full` of its local block); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return gather_full(x.to_local(), spec_of(x), x.device_mesh)


def distribute(full: torch.Tensor, spec, mesh):
    """``full`` (the same on every rank) as a DTensor of ``spec``'s
    placements, holding this rank's block; no collective."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(full, spec, mesh).contiguous(),
                              mesh, placements(spec, mesh), run_check=False,
                              shape=full.shape, stride=full.stride())


def _redistribute(x, entries):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(entries, x.device_mesh))


def gather_weight(w):
    """Replicate a state-sharded weight right before use when the active
    rules set ``zero3_attn``; otherwise (and on a plain tensor) ``w``."""
    rules = _ACTIVE.get()
    if rules is None or not rules.table.get("zero3_attn"):
        return w
    return _redistribute(w, (None,) * w.ndim)


def constrain(x, *logical):
    """Lay ``x`` out by the active rule table (the identity with none,
    and on a plain tensor).  Unknown logical names map to None; mappings
    whose mesh-axis product does not divide the dim are dropped."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank {x.ndim} vs logical axes {logical}")
    return _redistribute(x, fitted(rules.spec(*logical), x.shape, rules))
