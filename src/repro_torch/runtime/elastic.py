"""Elastic scaling: rebuild the mesh from the surviving ranks and
reshard.  Counterpart of `repro.runtime.elastic`.

Checkpoints are mesh-agnostic (a whole array per leaf,
`checkpoint.manager`), so scaling down after losing ranks, or up after a
repair, is: pick the largest supported mesh that fits the survivors
(`largest_mesh_shape`), build it (`remesh`), rebuild the specs from the
same logical rules (`launch.specs`) and place the restored leaves
(`reshard_state`).  The data pipeline is (seed, step, shard)
deterministic, so the global batch order is the same on any mesh.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding as shd


def largest_mesh_shape(num_devices: int, model_parallel: int,
                       min_data: int = 1) -> tuple[int, int]:
    """The largest (data, model) grid with the given TP degree that fits."""
    if num_devices < model_parallel:
        # degrade TP to what is there (powers of two)
        mp = 1
        while mp * 2 <= num_devices:
            mp *= 2
        model_parallel = mp
    data = max(num_devices // model_parallel, min_data)
    return data, model_parallel


def remesh(world, model_parallel: int, device_type: str = "cuda"):
    """The ``(data, model)`` `DeviceMesh` over the first ``data * model``
    ranks of ``world`` (a list of ranks, or the number of ranks
    ``0 .. world - 1``), its shape from `largest_mesh_shape`.  Every
    rank of the process group calls it; a rank past the mesh gets a mesh
    without a coordinate."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(range(world)) if isinstance(world, int) else list(world)
    data, model = largest_mesh_shape(len(ranks), model_parallel)
    grid = torch.tensor(ranks[:data * model]).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def reshard_state(state_host, mesh, pspecs):
    """Place a host-restored state on a (new) mesh by its specs: each
    leaf, moved to the mesh's device type, `distribute_tensor` by its
    spec's placements."""
    from torch.distributed.tensor import distribute_tensor
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))

    def put(leaf, spec):
        return distribute_tensor(leaf.to(dev), mesh,
                                 shd.placements(spec, mesh))

    return tree_lib.map_structure(put, state_host, pspecs)
