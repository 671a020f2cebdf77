"""ManyCoreConfig: the paper's system-level parameter set, on NVIDIA cards.
Counterpart of `repro.core.manycore`.

The paper's generator takes {number of cores, local-memory sizes,
interconnect topology, per-core arithmetic repertoire, number formats}
and emits a concrete machine.  Here the same set describes how a PyTorch
program is laid onto cards: mesh geometry (cores and interconnect), the
shared-memory budget of one thread block (local memory; the JAX package
reads it as VMEM), the kernel repertoire (arithmetic) and the dtype
policy (number formats).  The chip is `hardware.H100_SXM`, and the
matmul tile plan comes from `tiling.solve_hopper` where the JAX package
calls ``solve_tpu``.

`make_mesh` builds the mesh over the running ranks (`launch.mesh`).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hardware, tiling


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """The paper's 'number format' parameter."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"

    @property
    def param_bytes(self) -> int:
        return hardware.DTYPE_BYTES[self.param_dtype]

    @property
    def compute_bytes(self) -> int:
        return hardware.DTYPE_BYTES[self.compute_dtype]


# Kernel repertoire: the paper's per-core arithmetic-operation library.
KERNEL_LIBRARY = ("matmul", "spmv", "flash_attention")


@dataclasses.dataclass(frozen=True)
class ManyCoreConfig:
    """System-level description of the machine and how to use it."""

    # interconnect topology: mesh axis sizes and names (paper: bus/ring/NoC).
    mesh_shape: tuple = (16, 16)
    mesh_axes: tuple = ("data", "model")
    # local memory per core (paper's L): one block's shared memory; None =
    # the chip's.
    vmem_bytes: int | None = None
    # arithmetic repertoire each core is configured with.
    kernels: tuple = KERNEL_LIBRARY
    # number formats.
    dtypes: DTypePolicy = DTypePolicy()
    chip: hardware.Chip = hardware.H100_SXM

    @property
    def num_chips(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def usable_vmem(self) -> int:
        return (self.vmem_bytes if self.vmem_bytes is not None
                else self.chip.smem_bytes)

    def make_mesh(self, device_type: str = "cuda"):
        """A `torch.distributed` `DeviceMesh` of this shape and these axes
        (`launch.mesh.make_mesh`): over a one-rank process group it starts
        itself for a mesh of one card, or over the ranks `torchrun`
        started; a shape whose card count is not the world size raises,
        naming both."""
        from repro_torch.launch.mesh import make_mesh
        return make_mesh(self.mesh_shape, self.mesh_axes, device_type)

    def axis(self, name: str) -> int:
        return self.mesh_shape[self.mesh_axes.index(name)]

    def data_axes(self) -> tuple:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    def model_axis(self) -> str:
        return "model"

    def matmul_tile(self, m: int | None = None, n: int | None = None,
                    k: int | None = None) -> tiling.Tile:
        """The eq. 2 tile plan for this config's matmul kernel under its
        shared-memory budget (`tiling.solve_hopper`)."""
        return tiling.solve_hopper(
            smem_bytes=self.usable_vmem,
            dtype_bytes=self.dtypes.compute_bytes,
            m=m, n=n, k=k, chip=self.chip,
        )

    def peak_flops(self) -> float:
        return self.num_chips * self.chip.peak_flops

    def describe(self) -> str:
        lines = [
            f"many-core: {self.num_chips} chips, mesh {dict(zip(self.mesh_axes, self.mesh_shape))}",
            f"local memory (shared-memory budget): {self.usable_vmem / 2**10:.0f} KiB/core",
            f"kernel repertoire: {', '.join(self.kernels)}",
            f"number formats: params={self.dtypes.param_dtype} compute={self.dtypes.compute_dtype} accum={self.dtypes.accum_dtype}",
            f"peak: {self.peak_flops() / 1e12:.0f} TFLOP/s aggregate "
            f"({self.chip.variant})",
        ]
        return "\n".join(lines)


SINGLE_POD = ManyCoreConfig(mesh_shape=(16, 16), mesh_axes=("data", "model"))
MULTI_POD = ManyCoreConfig(mesh_shape=(2, 16, 16),
                           mesh_axes=("pod", "data", "model"))


def host_test_config(data: int = 1, model: int = 1) -> ManyCoreConfig:
    """A 1-chip (or tiny) config for tests: the paper's '1 core' point."""
    return ManyCoreConfig(mesh_shape=(data, model), mesh_axes=("data", "model"))
