"""What one rank's step computes, moves and holds.  Counterpart of
`repro.core.hlo_stats`, in two parts.

The reference's reader of XLA's HLO text, as code: `COLLECTIVE_OPS`,
`shape_bytes`, `CollectiveStats` and `collect_collectives`, which map
every instruction to its result shape and sum the bytes of each
collective's *operands*.  It is regex-only and reads an XLA dump
wherever one comes from.

Its counterpart for a PyTorch program, `count_step`, runs the step under
one dispatch mode that sees every operator it dispatches, on the card or
on the ``meta`` device (shapes only, nothing allocated), and returns a
`StepCounts`:

- ``flops``: the matmul-class operators of `torch.utils.flop_counter`
  (`FlopCounterMode`'s registry: mm, bmm, addmm, convolutions, the SDPA
  family), counted as `FlopCounterMode` counts them.  XLA's
  ``cost_analysis`` also counts elementwise work, so a step's
  ``useful_fraction`` (model FLOPs over counted) is not the reference's.
- ``bytes_accessed``: the bytes of every tensor input and output of every
  operator that is not a view (an ``empty`` writes nothing): each
  operator reads its inputs from and writes its outputs to device memory.
  That is an unfused upper bound, the role the reference gives the bytes
  of its CPU-compiled HLO.
- ``collectives``: a `CollectiveStats` of the ``c10d`` and
  ``_c10d_functional`` operators, keyed by the reference's op names, each
  counted by its operand's bytes (an all-gather's input, not its result).
- ``peak_bytes``: the bytes of the arguments' storages plus the most the
  step's own storages held at once.  Each new storage is tracked until
  it is freed (a finalizer on its Python object, which lives as long as
  the storage), so tensors autograd saves for the backward count.
- ``kernels``: the hand-written kernels the step called.  They are
  ``ctypes`` calls that no dispatch mode sees, so each wrapper adds its
  own operations and bytes (`charge`) on a launch and on a meta tensor.

On ``meta`` tensors the mode reuses the output shapes of an operator it
has seen with the same input shapes (an exact cache of the shape rules),
so a scan's thousand identical steps cost one shape computation.
`cost_analysis_stats` reads a `StepCounts` as the reference's reads a
compiled executable.
"""

from __future__ import annotations

import contextvars
import dataclasses
import re
import weakref
from collections import defaultdict
from typing import Any

import torch
import torch.utils._python_dispatch

from repro_torch.core.hardware import DTYPE_BYTES

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# `%name = <shape> opcode(...)` — shape may be a tuple.
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^=]*?\)|[\w\[\],{}\/#:]+)\s+([\w\-]+)")
_SHAPE_RE = re.compile(r"([a-z]\d+|pred|token|bf16|f8e4m3|f8e5m2)\[([\d,]*)\]")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")


def shape_bytes(shape_str: str) -> int:
    """Bytes of an HLO shape string (handles tuples by summing)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype == "token":
            continue
        nbytes = DTYPE_BYTES.get(dtype)
        if nbytes is None:
            # e.g. u16/s16 style "x16" dtypes
            m = re.match(r"[a-z](\d+)", dtype)
            nbytes = int(m.group(1)) // 8 if m else 4
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * nbytes
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def summary(self) -> str:
        parts = [
            f"{op}: n={self.count_by_op.get(op, 0)} bytes={self.bytes_by_op.get(op, 0):,}"
            for op in COLLECTIVE_OPS
            if self.count_by_op.get(op)
        ]
        return "; ".join(parts) if parts else "none"


def collect_collectives(hlo_text: str) -> CollectiveStats:
    """Sum operand bytes of every collective in an HLO module dump."""
    # Pass 1: instruction name -> result shape bytes.
    def_shape: dict[str, int] = {}
    lines = hlo_text.splitlines()
    for ln in lines:
        m = _DEF_RE.match(ln)
        if m:
            name, shape_str, _op = m.groups()
            def_shape[name] = shape_bytes(shape_str)

    bytes_by_op: dict[str, int] = defaultdict(int)
    count_by_op: dict[str, int] = defaultdict(int)
    for ln in lines:
        m = _DEF_RE.match(ln)
        if not m:
            continue
        name, shape_str, opcode = m.groups()
        base = None
        for coll in COLLECTIVE_OPS:
            if opcode == coll or opcode.startswith(coll + "-start"):
                base = coll
                break
        if base is None:
            continue
        # Operand bytes: everything referenced inside the call parens.
        paren = ln.find("(", m.end(3) - len(opcode))
        operand_bytes = 0
        if paren >= 0:
            # First level of parens only (arguments).
            depth, j = 0, paren
            args_end = len(ln)
            for j in range(paren, len(ln)):
                if ln[j] == "(":
                    depth += 1
                elif ln[j] == ")":
                    depth -= 1
                    if depth == 0:
                        args_end = j
                        break
            args = ln[paren + 1 : args_end]
            for opname in _OPERAND_RE.findall(args):
                operand_bytes += def_shape.get(opname, 0)
            if operand_bytes == 0:
                # Operands may be unprefixed (no %) in newer dumps: fall back
                # to inline shapes in the arg list, else the result shape.
                inline = shape_bytes(args)
                operand_bytes = inline if inline else def_shape.get(name, 0)
        else:
            operand_bytes = def_shape.get(name, 0)
        bytes_by_op[base] += operand_bytes
        count_by_op[base] += 1
    return CollectiveStats(dict(bytes_by_op), dict(count_by_op))


# ---------------------------------------------------------------------------
# Counting a PyTorch step
# ---------------------------------------------------------------------------

# c10d operator -> (the reference's op name, index of its operand argument)
_COLLECTIVES = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
}
# operators that allocate without writing
_NO_WRITE = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided"})


def _tensors(x):
    """The tensors of an argument (a tensor, or a list/tuple of them,
    nested)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class StepCounts:
    """What `count_step` counted over one call.  ``ops`` maps an
    operator (or ``kernel:<name>``) to ``[calls, flops, bytes]``;
    ``kernels`` a hand-written kernel to ``{"calls", "flops", "bytes"}``.
    ``result`` is what the step returned."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveStats = dataclasses.field(
        default_factory=lambda: CollectiveStats({}, {}))
    argument_bytes: int = 0
    peak_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)
    result: Any = None

    def row(self) -> dict:
        """The counts as a JSON-able dict (no result)."""
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": float(self.collectives.total_bytes),
                "collectives": {k: float(v) for k, v in
                                self.collectives.bytes_by_op.items()},
                "collective_counts": dict(self.collectives.count_by_op),
                "argument_bytes": self.argument_bytes,
                "peak_bytes": self.peak_bytes, "kernels": self.kernels}


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("step_counter",
                                                         default=None)


def counting() -> bool:
    """Whether a `count_step` is running in this context."""
    return _ACTIVE.get() is not None


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's operations and bytes to the running
    `count_step`, if one runs (the kernel wrappers call this on a launch
    and on meta tensors)."""
    counts = _ACTIVE.get()
    if counts is None:
        return
    counts.flops += flops
    counts.bytes_accessed += nbytes
    k = counts.kernels.setdefault(kernel,
                                  {"calls": 0, "flops": 0.0, "bytes": 0.0})
    k["calls"] += 1
    k["flops"] += flops
    k["bytes"] += nbytes
    op = counts.ops.setdefault("kernel:" + kernel, [0, 0.0, 0.0])
    op[0] += 1
    op[1] += flops
    op[2] += nbytes


def _kind(func) -> str:
    """"view" (returns an alias it does not write), "inplace" (writes an
    argument) or "functional"."""
    schema = func._schema
    if any(r.alias_info is not None and not r.alias_info.is_write
           for r in schema.returns):
        return "view"
    if schema.is_mutable or any(r.alias_info is not None
                                for r in schema.returns):
        return "inplace"
    return "functional"


def _flat(args, kwargs) -> list:
    """The tensors of an operator's arguments, one list deep."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in _tensors(a))
    return out


def _meta_key(x):
    """A hashable key of an argument's shapes and values; raises
    TypeError where it has none."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(y) for y in x)
    hash(x)
    return x


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """The dispatch mode behind `count_step`."""

    def __init__(self, counts: StepCounts, known: set):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.counts = counts
        self.known = known            # storages not the step's own
        self.tracked: set = set()     # ids of the step's live storages
        self.live = 0
        self.peak = 0
        self.info: dict = {}          # func -> what `_info` says of it
        self.shapes: dict = {}
        self.coll_bytes: dict = defaultdict(int)
        self.coll_count: dict = defaultdict(int)

    def _info(self, func) -> tuple:
        """(kind, name, collective entry, counts its bytes, FLOP rule)."""
        packet = func._overloadpacket
        name = str(packet)
        return (_kind(func), name, _COLLECTIVES.get(name),
                packet.__name__ not in _NO_WRITE,
                self.flop_registry.get(packet))

    def _release(self, key: int, nbytes: int) -> None:
        self.tracked.discard(key)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.tracked or st._cdata in self.known:
            return
        n = st.nbytes()
        self.tracked.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key, n)

    def _run(self, func, tensors, args, kwargs):
        """A functional ``func`` on its arguments; on meta tensors its
        outputs come from the cache of its shape rule."""
        if not tensors or any(t.device.type != "meta" for t in tensors):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(tuple(kwargs.items())))
        except TypeError:
            return func(*args, **kwargs)
        spec = self.shapes.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                spec = (out.shape, out.stride(), out.dtype)
            elif isinstance(out, (list, tuple)) and out and all(
                    isinstance(o, torch.Tensor) for o in out):
                spec = (type(out), [(o.shape, o.stride(), o.dtype)
                                    for o in out])
            if spec is not None:
                self.shapes[key] = spec
            return out
        if not isinstance(spec[0], type):
            return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                                       device="meta")
        kind_of, specs = spec
        return kind_of([torch.empty_strided(s, st, dtype=d, device="meta")
                        for s, st, d in specs])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if len(types) != 1 or types[0] is not torch.Tensor:
            if any(t is not torch.Tensor and t is not torch.nn.Parameter
                   for t in types):
                return NotImplemented     # let a subclass (DTensor) unwrap
        kwargs = kwargs or {}
        info = self.info.get(func)
        if info is None:
            info = self.info[func] = self._info(func)
        kind, name, coll, counts_bytes, flop_rule = info
        if coll is not None:
            op, idx = coll
            operand = args[idx] if idx < len(args) else None
            self.coll_bytes[op] += sum(_nbytes(t) for t in _tensors(operand))
            self.coll_count[op] += 1
            return func(*args, **kwargs)
        if kind == "view":
            return func(*args, **kwargs)
        tensors = _flat(args, kwargs)
        if kind == "functional":
            out = self._run(func, tensors, args, kwargs)
        else:
            out = func(*args, **kwargs)
        flops = 0.0
        if flop_rule is not None:
            flops = float(flop_rule(*args, **kwargs, out_val=out))
        outs = [out] if isinstance(out, torch.Tensor) else list(_tensors(out))
        nbytes = 0
        if counts_bytes:
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            nbytes += sum(t.numel() * t.element_size() for t in outs)
        for t in outs:
            self._track(t)
        c = self.counts
        c.flops += flops
        c.bytes_accessed += nbytes
        rec = c.ops.get(name)
        if rec is None:
            rec = c.ops[name] = [0, 0.0, 0.0]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out


def storage_bytes(tree) -> dict:
    """``{storage cdata: nbytes}`` of every tensor in a nest of dicts,
    lists and tuples (a DTensor: its local block)."""
    from torch.distributed.tensor import DTensor
    out: dict = {}

    def walk(x):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def count_step(fn, *args, **kw) -> StepCounts:
    """Run ``fn(*args, **kw)`` once under the counter; its FLOPs, bytes,
    collectives, peak bytes and kernel charges, and its result.  The
    arguments' storages (a DTensor's local block) are the step's
    ``argument_bytes``; storages the step allocates are tracked until
    freed."""
    args_st = storage_bytes((args, kw))
    counts = StepCounts(argument_bytes=sum(args_st.values()))
    mode = _Counter(counts, set(args_st))
    tok = _ACTIVE.set(counts)
    try:
        with mode:
            counts.result = fn(*args, **kw)
    finally:
        _ACTIVE.reset(tok)
    counts.collectives = CollectiveStats(dict(mode.coll_bytes),
                                         dict(mode.coll_count))
    counts.peak_bytes = counts.argument_bytes + mode.peak
    return counts


def cost_analysis_stats(counts: StepCounts) -> tuple[float, float]:
    """(flops, bytes accessed) of a `StepCounts`."""
    return counts.flops, counts.bytes_accessed
