"""Logical-axis sharding rules (DP/TP/EP/SP).  Counterpart of
`repro.parallel.sharding`.

Model code names tensor dims with *logical* axes (``batch``, ``heads``,
``experts`` ...); a `Rules` table maps each to mesh axes.  A spec is a
plain tuple with one entry per dim, each None (replicated), a mesh-axis
name or a tuple of names, where the reference builds a `PartitionSpec`
of the same entries.  `placements` turns a spec into DTensor placements
over a `DeviceMesh`, which are what a `NamedSharding` is.

The port runs each rank's part of a step on local tensors with explicit
collectives, so `constrain` and `gather_weight` only act on DTensors and
are the identity on a plain tensor.  Where the JAX model constrains an
activation, the port's layers call the model axis's region operators
instead, on the split that `split` reads from the active rules and mesh
(a logical dim goes to its mesh axes only where `constrain` would keep
the mapping, `fitted`'s rule):

- `copy_in` (identity forward, all-reduce of the gradient backward) at
  the entry of a region whose tensors are split, and on a replicated
  weight such a region uses on its part of the work;
- `reduce_out` (all-reduce forward, identity backward) at its exit, and
  `copy_in` of it where the sum feeds the split region again (RWKV6's
  norm over every rank's heads);
- `split_dim` (this rank's block forward, all-gather backward) and
  `gather_dim` (all-gather forward; backward a reduce-scatter, or this
  rank's block where the gathered tensor's gradient is already whole)
  move the residual stream between whole and split by sequence
  (``res_seq`` under `sequence_parallel`); `reduce_scatter_dim` leaves a
  split region into a sequence-split stream.

`enter` and `leave` pick among them at a region's edges.  So every tensor
replicated over the model axis carries its whole gradient on every rank,
and every split one its block's.  `compute_block` gives a rank the block
of a stored weight that its layer computes with (a `Parts` block where
the weight is parts laid end to end, each split), and `block_of` maps a
computed block back to a stored one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (axis_group, axis_index, axis_names,
                                     axis_sizes, get_abstract_mesh)

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


class NotInPort(NotImplementedError):
    """A step the port does not form; its message names the ROADMAP
    item that records it."""


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


@dataclasses.dataclass(frozen=True)
class Parts:
    """A compute-spec entry (`compute_block`) of a dim made of ``n`` equal
    parts laid end to end, each split over the mesh-axis entry ``axes``:
    a rank computes with its block of every part, concatenated in part
    order.  Mamba's ``in_proj`` is one: its columns are the x half, then
    the gate half, and its stored spec splits all of them contiguously,
    so the stored block of a rank is not the block it computes with."""

    axes: object
    n: int = 2


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, Parts):
        return _axes(entry.axes)
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
        if isinstance(entry, Parts):     # each part's blocks in turn
            out = torch.cat([p.unflatten(dim, (entry.n, -1))
                             for p in pieces], dim=dim + 1).flatten(
                                 dim, dim + 1)
        else:
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
    placements, holding a copy of this rank's block (so it does not keep
    ``full``'s storage alive); no collective."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(full, spec, mesh).clone(
        memory_format=torch.contiguous_format),
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



# ---------------------------------------------------------------------------
# The model axis: splits and the region operators
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A dim split over mesh ``axes`` into ``n`` blocks, of which this
    rank holds block ``index``; ``group`` holds the ranks of the split,
    row-major over the axes (`launch.mesh.axis_group`)."""

    axes: tuple
    n: int
    index: int
    group: object


def kept(rules: Rules | None, logical: str, size: int) -> tuple:
    """The mesh axes ``logical`` takes for a dim of ``size`` under
    ``rules``: its mapping where the axes' product is above 1 and divides
    ``size`` (as `constrain` keeps it), else ()."""
    if rules is None:
        return ()
    entry = rules.table.get(logical)
    n = rules.axis_size(entry)
    return _axes(entry) if n > 1 and size % n == 0 else ()


def split(logical: str, size: int | None) -> Split | None:
    """The split of a dim of ``size`` named ``logical`` under the active
    rules and mesh (`launch.mesh.set_mesh`), or None where it stays
    whole on every rank.  ``size`` None: a dim already laid out by its
    fitted spec (a cache segment), taken as divisible.  Without rules, or
    where they give ``logical`` one block, it returns before it looks at
    the mesh."""
    rules = _ACTIVE.get()
    if rules is None:
        return None
    if size is None:
        size = rules.axis_size(rules.table.get(logical))
    axes = kept(rules, logical, size)
    if not axes:
        return None
    mesh = get_abstract_mesh()
    if mesh is None:
        return None
    return Split(axes, math.prod(axis_sizes(mesh)[a] for a in axes),
                 axis_index(mesh, axes), axis_group(mesh, axes))


def block(w: torch.Tensor, dim: int, full: int, s: Split | None
          ) -> torch.Tensor:
    """``w``'s block along ``dim`` under ``s``: cut from a whole ``w``
    (``full`` long there), or ``w`` itself if it is the block already."""
    if s is None or w.shape[dim] != full:
        want = full if s is None else full // s.n
        if w.shape[dim] != want:
            raise ValueError(f"dim {dim} of {tuple(w.shape)} is neither "
                             f"{full} nor its block of {want}")
        return w
    c = full // s.n
    return w.narrow(dim, s.index * c, c)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, s: Split) -> torch.Tensor:
    pieces = [torch.empty_like(x) for _ in range(s.n)]
    dist.all_gather(pieces, x.contiguous(), group=s.group)
    return torch.cat(pieces, dim=dim)


def _mine(x: torch.Tensor, dim: int, s: Split) -> torch.Tensor:
    c = x.shape[dim] // s.n
    return x.narrow(dim, s.index * c, c).contiguous()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.s.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        return _all_reduce(x, s.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, s):
        ctx.dim, ctx.s = dim, s
        return _mine(x, dim, s)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.s), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, s, reduce_grad):
        ctx.dim, ctx.s, ctx.reduce = dim, s, reduce_grad
        return _all_gather(x, dim, s)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = _all_reduce(g, ctx.s.group)
        return _mine(g, ctx.dim, ctx.s), None, None, None


class _ReduceScatterDim(torch.autograd.Function):
    """A reduce-scatter as an all-reduce and a cut (gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, s):
        ctx.dim, ctx.s = dim, s
        return _mine(_all_reduce(x, s.group), dim, s)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.s), None, None


def copy_in(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``s`` backward."""
    return x if s is None else _CopyIn.apply(x, s)


def reduce_out(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """All-reduce over ``s`` forward; the gradient as it is backward."""
    return x if s is None else _ReduceOut.apply(x, s)


def reduce_max(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """The elementwise max over ``s`` (forward only)."""
    return x if s is None else _all_reduce(x, s.group, dist.ReduceOp.MAX)


def split_dim(x: torch.Tensor, dim: int, s: Split | None) -> torch.Tensor:
    """This rank's block along ``dim`` forward; all-gather backward."""
    return x if s is None else _SplitDim.apply(x, dim, s)


def gather_dim(x: torch.Tensor, dim: int, s: Split | None,
               reduce_grad: bool) -> torch.Tensor:
    """All-gather along ``dim`` forward.  Backward: this rank's block of
    the gradient, all-reduced first where ``reduce_grad`` (the gathered
    tensor feeds a split region, so each rank holds part of its
    gradient): a reduce-scatter."""
    return x if s is None else _GatherDim.apply(x, dim, s, reduce_grad)


def reduce_scatter_dim(x: torch.Tensor, dim: int, s: Split | None
                       ) -> torch.Tensor:
    """Sum over ``s`` and keep this rank's block along ``dim`` forward;
    all-gather backward."""
    return x if s is None else _ReduceScatterDim.apply(x, dim, s)


_SEQ: contextvars.ContextVar[Split | None] = contextvars.ContextVar(
    "sequence_split", default=None)


@contextlib.contextmanager
def sequence_split(s: Split | None):
    """Mark the residual stream as split by sequence (dim 1) under ``s``
    for the block."""
    tok = _SEQ.set(s)
    try:
        yield
    finally:
        _SEQ.reset(tok)


def seq_split() -> Split | None:
    """The residual stream's sequence split, or None."""
    return _SEQ.get()


def enter(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """The input of a region that computes split under ``s`` (or
    replicated, for None) from the residual stream ``x``: the whole
    sequence gathered where the stream is split, with a reduce-scatter
    of the gradient if the region is split; else `copy_in`."""
    seq = _SEQ.get()
    if seq is not None:
        return gather_dim(x, 1, seq, reduce_grad=s is not None)
    return copy_in(x, s)


def leave(y: torch.Tensor, s: Split | None) -> torch.Tensor:
    """A region's output back into the residual stream: summed over
    ``s`` (`reduce_out`), and cut to this rank's part of the sequence
    where the stream is split."""
    seq = _SEQ.get()
    if seq is not None:
        return (reduce_scatter_dim(y, 1, seq) if s is not None
                else split_dim(y, 1, seq))
    return reduce_out(y, s)


def seq_weight(w: torch.Tensor) -> torch.Tensor:
    """A replicated weight used on the sequence-split stream: its gradient
    summed over the split (`copy_in`)."""
    return copy_in(w, _SEQ.get())


def vocab_argmax(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``argmax(-1)`` of logits whose last dim may be this rank's block
    of ``vocab`` (`split`): each rank's first maximum, then the largest
    over the ranks, ties to the lower rank, so to the lower id as
    `torch.argmax` gives them."""
    s = split("vocab", vocab)
    if s is None or logits.shape[-1] == vocab:
        return logits.argmax(dim=-1)
    i = logits.argmax(dim=-1, keepdim=True)
    v = torch.gather(logits, -1, i)
    vals = _all_gather(v, -1, s)
    ids = _all_gather(i + s.index * logits.shape[-1], -1, s)
    return torch.gather(ids, -1, vals.argmax(dim=-1, keepdim=True))[..., 0]


def _parts_moves(k: int, n: int, me: int, inverse: bool) -> tuple:
    """The chunks rank ``me`` sends and receives in a `Parts` exchange of
    ``n`` parts over ``k`` ranks: two lists of ``(peer, chunk)``, each in
    the order `all_to_all_single` moves them (by peer, then chunk).  The
    dim is ``n * k`` chunks end to end; chunk i is block ``i % k`` of part
    ``i // k``, held at position ``i % n`` of stored rank ``i // n`` and at
    position ``i // k`` of compute rank ``i % k``.  Forward moves the
    stored blocks to the compute ones, ``inverse`` back."""
    stored = [(i % k, i) for i in range(n * me, n * me + n)]
    computed = [(i // n, i) for i in (p * k + me for p in range(n))]
    send, recv = (computed, stored) if inverse else (stored, computed)
    return sorted(send), sorted(recv)


def _exchange_parts(x: torch.Tensor, dim: int, entry: Parts, mesh,
                    inverse: bool = False) -> torch.Tensor:
    """``x``'s stored block along ``dim`` (a contiguous 1/k of the dim)
    moved to this rank's `Parts` block, or back with ``inverse``: one
    `all_to_all_single` of the chunks over the entry's axes (a copy)."""
    axes = _axes(entry.axes)
    k = math.prod(axis_sizes(mesh)[a] for a in axes)
    send, recv = _parts_moves(k, entry.n, axis_index(mesh, axes), inverse)
    xs = x.movedim(dim, 0)
    c = xs.shape[0] // entry.n

    def position(i):                    # of chunk i in the block it is in
        return i // k if inverse else i % entry.n

    def target(i):                      # of chunk i in the block it makes
        return i % entry.n if inverse else i // k

    inp = torch.cat([xs.narrow(0, position(i) * c, c) for _, i in send])
    out = torch.empty_like(inp)
    dist.all_to_all_single(
        out, inp, [c * sum(p == r for p, _ in recv) for r in range(k)],
        [c * sum(p == r for p, _ in send) for r in range(k)],
        group=axis_group(mesh, axes))
    order = sorted(range(entry.n), key=lambda j: target(recv[j][1]))
    return torch.cat([out.narrow(0, j * c, c) for j in order]).movedim(
        0, dim)


def _cut_parts(x: torch.Tensor, dim: int, entry: Parts, mesh
               ) -> torch.Tensor:
    """This rank's `Parts` block of ``x``, whole along ``dim`` (a copy)."""
    y = x.unflatten(dim, (entry.n, -1))
    spec = [None] * y.ndim
    spec[dim + 1] = entry.axes
    return local_shard(y, tuple(spec), mesh).flatten(dim, dim + 1)


def compute_block(t, cspec, mesh) -> torch.Tensor:
    """The block of a weight its layer computes with: split along the
    mesh axes ``cspec`` names, whole along every other dim.  From a
    DTensor, its stored block gathered over each axis ``cspec`` does not
    name (FSDP's data axes, a model split its layer does not compute in),
    then cut where the storage did not split; a plain tensor (the same on
    every rank) is cut.  A plain tensor or a view of the stored block
    where nothing moves.  A `Parts` entry takes the rank's block of each
    part: moved from the stored block by `_exchange_parts` where the
    storage splits the dim over the same axes (the leaf is never gathered
    whole), else cut."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        local, stored = t.to_local(), spec_of(t)
    else:
        local, stored = t, (None,) * t.ndim
    want = list(cspec) + [None] * (t.ndim - len(cspec))
    for d, e in enumerate(want):
        if isinstance(e, Parts):        # the other dims, then the parts
            moved = bool(_axes(stored[d])) and _axes(stored[d]) == _axes(e)
            base = list(want)
            base[d] = stored[d] if moved else None
            out = compute_block(t, tuple(base), mesh)
            return (_exchange_parts(out, d, e, mesh) if moved
                    else _cut_parts(out, d, e, mesh))
    differ = [_axes(a) != _axes(b) for a, b in zip(stored, want)]
    out = local
    if any(differ[d] and stored[d] is not None for d in range(t.ndim)):
        out = gather_full(local, tuple(stored[d] if differ[d] else None
                                       for d in range(t.ndim)), mesh)
    cut = tuple(want[d] if differ[d] else None for d in range(t.ndim))
    return local_shard(out, cut, mesh) if any(cut) else out


def block_of(x: torch.Tensor, cspec, target, mesh) -> torch.Tensor:
    """``x``, laid out as `compute_block` lays out under ``cspec``, cut
    to its block under the spec ``target`` (a view; a copy where a `Parts`
    dim moves back to its stored block, over the same axes)."""
    have = list(cspec) + [None] * (x.ndim - len(cspec))
    target = list(target) + [None] * (x.ndim - len(target))
    for d, e in enumerate(have):
        if isinstance(e, Parts):
            if _axes(e) != _axes(target[d]):
                raise ValueError(f"dim {d}: computed as {e}, stored over "
                                 f"{target[d]}")
            x = _exchange_parts(x, d, e, mesh, inverse=True)
            have[d] = target[d]
    cut = []
    for d, (a, b) in enumerate(zip(have, target)):
        if _axes(a) == _axes(b):
            cut.append(None)
        elif a is None:
            cut.append(b)
        else:
            raise ValueError(f"dim {d}: computed over {a}, stored over {b}")
    return local_shard(x, tuple(cut), mesh) if any(cut) else x
