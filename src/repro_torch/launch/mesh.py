"""Meshes of cards.  Counterpart of `repro.launch.mesh`.

A `torch.distributed` `DeviceMesh` is what a `jax.sharding.Mesh` is: a
grid of ranks with named axes (``data``, ``model``, and ``pod`` across
pods).  One rank drives one card.  Defined as functions, so importing
this module starts no process group.

- `make_mesh`, `make_host_mesh`, `make_production_mesh`: the reference's
  three constructors.  Each needs a process group of exactly as many
  ranks as the mesh has cards; without one, a mesh of one card starts a
  one-rank group itself (NCCL on ``cuda``, the default; gloo only when
  the caller asks for the CPU), and a larger mesh raises, naming the
  ranks it needs (`torchrun --nproc-per-node N` starts them).  On the
  ``meta`` device type (the dry run's, `launch.dryrun`) a mesh of any
  size starts a group on the ``fake`` backend instead, in which this
  process is rank 0 and every collective returns at once, moving
  nothing: the counterpart of the reference's forced host devices.
- `set_mesh` / `get_abstract_mesh`: the active mesh, a context variable.
- `MeshShape` and `axis_sizes`: the rules and state specs read only a
  mesh's axis names and sizes, so a plain ``MeshShape(names, shape)``
  stands in for a mesh no host here could build (256 ranks).
- `axis_group`: the process group of the ranks that differ only along
  some axes (a data-parallel reduce, an expert exchange), with its
  members in row-major order over those axes, as JAX orders them.

The reference's ``axis_types_kwargs`` and ``shard_map`` paper over moves
of the JAX API between versions; PyTorch needs neither (a mesh axis has
no type, and the port's code runs each rank's part with explicit
collectives where JAX maps a function over a mesh).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without ranks or cards."""

    axis_names: tuple
    shape: tuple


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a `DeviceMesh` or a `MeshShape`."""
    return dict(zip(axis_names(mesh), (int(n) for n in mesh.shape)))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                         default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` as the active mesh for the block."""
    tok = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(tok)


def get_abstract_mesh():
    """The mesh `set_mesh` installed, or None."""
    return _ACTIVE.get()


def _backend(device_type: str) -> str:
    return {"cuda": "nccl", "meta": "fake"}.get(device_type, "gloo")


def _start_fake_group(ranks: int) -> None:
    """A ``fake`` group of ``ranks`` ranks with this process as rank 0,
    replacing a fake group of another size (it holds nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() == ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def ensure_process_group(device_type: str = "cuda", ranks: int = 1,
                         backend: str | None = None) -> int:
    """The world size of the running process group, started first if
    none runs: from `torchrun`'s environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or, with none, as one rank in an
    in-process store; on ``meta``, as ``ranks`` fake ranks
    (`_start_fake_group`).  ``ranks`` is what the caller's mesh needs: a
    group of another size, or one on another backend than
    ``device_type``'s (or ``backend``, where the caller names one: gloo
    for ranks that share one card, which NCCL refuses), raises."""
    want = backend or _backend(device_type)
    if device_type == "meta":
        _start_fake_group(ranks)
    else:
        resolve_device(device_type)   # cuda without a card raises
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(want)
        elif ranks == 1:
            dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                    world_size=1)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != ranks:
        raise RuntimeError(
            f"a mesh of {ranks} cards needs {ranks} ranks; "
            + ("no process group runs" if world is None else
               f"the process group has {world}")
            + f" (torchrun --nproc-per-node {ranks} starts them)")
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"the running process group is {have}; a mesh on "
                           f"{device_type} needs {want}")
    return world


_MESHES: dict = {}


def make_mesh(axis_shapes, axis_names, device_type: str = "cuda",
              backend: str | None = None):
    """A `DeviceMesh` of ``axis_shapes`` named ``axis_names`` over every
    rank of the process group (started first as `ensure_process_group`
    says, on ``backend`` if given); its size must be the world size.  One
    mesh of a shape is built per process group and handed out again
    after."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(axis_shapes), tuple(axis_names)
    ensure_process_group(device_type, math.prod(shape), backend)
    world = dist.group.WORLD
    key = (shape, names, device_type, id(world))
    if key not in _MESHES:
        _MESHES[key] = (world, init_device_mesh(device_type, shape,
                                                mesh_dim_names=names))
    return _MESHES[key][1]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The pod mesh: (16, 16) over ``data, model``, or (2, 16, 16) over
    ``pod, data, model``; it needs 256 (512) ranks, or ``device_type``
    ``meta`` for a mesh over as many fake ones."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda", backend: str | None = None):
    """A small ``(data, model)`` mesh over the process group's ranks."""
    return make_mesh((data, model), ("data", "model"), device_type, backend)


_GROUPS: dict = {}


def axis_group(mesh, axes):
    """The process group of this rank's line (or plane) along ``axes``
    (a name or a tuple of names), members row-major over ``axes`` in
    their given order, as JAX splits a dim over several axes.  Every
    rank creates every such group, in the same order, the first time
    (`dist.new_group` is collective)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = axis_names(mesh)
    key = (id(mesh), axes)
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims)
        ranks = ranks.reshape(-1, math.prod(ranks.shape[len(rest):]))
        me = dist.get_rank()
        mine = None
        for row in ranks.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def axis_index(mesh, axes) -> int:
    """This rank's row-major index along ``axes``, in their given
    order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[names.index(a)] + coord[names.index(a)]
    return idx
