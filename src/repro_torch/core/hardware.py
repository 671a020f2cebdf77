"""The card the tuner models: one NVIDIA H100.  Counterpart of
`repro.core.hardware`, which describes the TPU the JAX package targets.

The paper sizes its tiles by a core's local memory ``L``; the TPU package
reads it as VMEM.  On Hopper the counterpart is the shared memory one
thread block may use (227 KB of the SM's 256 KB): the blocked matmul
stages its A and B tiles there and keeps its C tile in registers, and the
ELL SpMV kernels hold x, or a slab of it, there.  So a `Chip` carries both
budgets.

The default `H100_SXM` is the H100 SXM 80GB of NVIDIA's data sheet (dense
rates, no sparsity, at its 700 W limit).  `detect` reads the SM count and
the memory of the card that is present and records its name; the rates
stay the data sheet's, since no property of the device reports them.
"""

from __future__ import annotations

import dataclasses

DTYPE_BYTES = {
    "float32": 4, "f32": 4,
    "bfloat16": 2, "bf16": 2,
    "float16": 2, "f16": 2,
    "int8": 1, "s8": 1, "u8": 1,
    "int32": 4, "s32": 4, "u32": 4,
    "int64": 8, "s64": 8, "u64": 8,
    "float64": 8, "f64": 8,
    "bool": 1, "pred": 1,
    "int16": 2, "s16": 2, "u16": 2,
    "f8e4m3": 1, "f8e5m2": 1,
    "c64": 8, "c128": 16,
}


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator: its peak rates and the budgets the tiles must fit.

    ``peak_flops`` is the rate of 2-byte (bf16) operands on the tensor
    cores, ``peak_flops_f32`` that of f32 on the CUDA cores (the f32
    kernels never use TF32).  ``smem_bytes`` is the shared memory one
    thread block may take (all of it may hold staged tiles: nothing else
    of these kernels lives there), ``regs_bytes`` one SM's register
    file.
    """

    variant: str = "H100 SXM 80GB (data sheet)"
    sms: int = 132
    peak_flops: float = 989e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12
    hbm_bytes: int = 80 * 10**9
    smem_bytes: int = 232_448          # 227 KB
    l2_bytes: int = 50 * 2**20
    regs_bytes: int = 65_536 * 4       # 64K 32-bit registers per SM

    def accum_regs_bytes(self) -> int:
        """Register bytes a block's f32 accumulators may take: half the
        file, leaving the rest to operand fragments and addresses."""
        return self.regs_bytes // 2

    def peak_for(self, dtype_bytes: int) -> float:
        """Peak operations per second for operands of this width."""
        return self.peak_flops if dtype_bytes <= 2 else self.peak_flops_f32


H100_SXM = Chip()


def detect(device=None) -> Chip:
    """`H100_SXM` with the SM count, memory and name of the CUDA card
    ``device`` (default: the current one), when torch sees a card; the
    data sheet's chip otherwise."""
    import torch
    if not torch.cuda.is_available():
        return H100_SXM
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device)
    return dataclasses.replace(
        H100_SXM, variant=f"{props.name} (rates: H100 SXM data sheet)",
        sms=props.multi_processor_count, hbm_bytes=props.total_memory)
