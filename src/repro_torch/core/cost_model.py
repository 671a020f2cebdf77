"""Analytical laws the kernels and the tuner share.  Counterpart of
`repro.core.cost_model`, of which this package keeps its own copy, since
it never imports the JAX one.

- The block-skip law of the flash-attention kernel
  (`attention_step_bounds`, `attention_active_block_pairs`,
  `attention_max_k_steps`): ``csrc/flash_attention.cu`` mirrors
  `attention_step_bounds` in its own index math.
- The three-term roofline of a step (`Roofline`, `roofline`) and the
  useful-FLOP counts (`model_flops_train`, `model_flops_decode`).
- The machine models the tuner ranks candidates by (the paper's Table I
  and Table II, analytically): `matmul_time_model` and `spmv_time_model`;
  and those of the attention families: `attention_time_model` (prefill
  flash attention), `decode_time_model` and
  `quantized_decode_time_model` (single-query decode over a float or an
  int8 cache).

Their formulas are the JAX package's; the chip defaults to the H100,
never to a TPU.  An operation is charged at the peak of its operand width
(`Chip.peak_for`: bf16 on the tensor cores, f32 on the CUDA cores), but
the decode laws charge theirs at the f32 CUDA-core rate, since the decode
kernels (``csrc/decode_body.cuh``) compute in f32 whatever the cache
holds.  The ``vmem_bytes`` each attention law returns is the working set
of the TPU kernel it was written for, kept for parity; the CUDA kernels'
own shared memory is their modules' business.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import hardware, tiling


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three times of a step, each its work over one rate of ``chips``
    cards: compute, device memory and the links between cards.
    ``peak_flops`` is one card's, for `mfu_bound`."""

    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: float = 0.0  # 6*N*D useful flops, if known
    peak_flops: float = hardware.H100_SXM.peak_flops

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline-model step time: the max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much of the compute is useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU implied by the roofline (useful flops over
        the cards' peak)."""
        if self.bound_s <= 0:
            return 0.0
        peak = self.chips * self.peak_flops
        return (self.model_flops / self.bound_s) / peak if self.model_flops else 0.0

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
            "mfu_bound": self.mfu_bound,
        }


def roofline(
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    chips: int,
    model_flops: float = 0.0,
    chip: hardware.Chip = hardware.H100_SXM,
) -> Roofline:
    """The three-term roofline of a step on ``chips`` cards of ``chip``.
    ``flops``, ``bytes_accessed`` and ``collective_bytes`` are
    whole-program (all cards); the collective term runs over one link
    direction (``chip.link_bw``)."""
    return Roofline(
        compute_s=flops / (chips * chip.peak_flops),
        memory_s=bytes_accessed / (chips * chip.hbm_bw),
        collective_s=collective_bytes / (chips * chip.link_bw),
        chips=chips,
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
        peak_flops=chip.peak_flops,
    )


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6*N*D rule of thumb for a train step (fwd + bwd)."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    """2*N per generated token (forward only)."""
    return 2.0 * n_params_active * tokens


def attention_step_bounds(
    i: int, block_q: int, block_k: int, k_steps: int,
    causal: bool = True, window: int | None = None,
) -> tuple[int, int]:
    """[first, last] K-step bounds for q-block ``i`` under the causal /
    sliding-window mask.

    A K-block j is *active* iff some (q, k) pair inside the
    (block_q, block_k) tile survives the mask: causal caps ``last`` at the
    block holding the deepest row's diagonal, the window floors ``first``
    at the block still inside the band of the shallowest row.
    """
    q_lo, q_hi = i * block_q, (i + 1) * block_q - 1
    last = k_steps - 1
    if causal:
        last = min(last, q_hi // block_k)
    first = 0
    if window is not None:
        # active iff the block's deepest k reaches past q_lo - window
        first = max(0, (q_lo - window + 1) // block_k)
    return min(first, last), last


def attention_active_block_pairs(
    sq: int, sk: int, block_q: int, block_k: int,
    causal: bool = True, window: int | None = None,
) -> tuple[int, int]:
    """(active, total) (q_block, k_block) pair counts for the mask.
    ``total`` is the dense grid; the skipping kernel streams and
    multiplies only ``active`` pairs (causal ≈ triangle, window ≈ band)."""
    q_blocks = max(1, -(-sq // block_q))
    k_steps = max(1, -(-sk // block_k))
    active = 0
    for i in range(q_blocks):
        first, last = attention_step_bounds(i, block_q, block_k, k_steps,
                                            causal=causal, window=window)
        active += last - first + 1
    return active, q_blocks * k_steps


def attention_max_k_steps(
    sq: int, sk: int, block_q: int, block_k: int,
    causal: bool = True, window: int | None = None,
) -> int:
    """The widest per-q-block active range over the K axis.  Causal
    prefill at sq=sk keeps the full depth (the last row needs every
    block); a sliding window shrinks it to ~window/block_k."""
    q_blocks = max(1, -(-sq // block_q))
    k_steps = max(1, -(-sk // block_k))
    widest = 1
    for i in range(q_blocks):
        first, last = attention_step_bounds(i, block_q, block_k, k_steps,
                                            causal=causal, window=window)
        widest = max(widest, last - first + 1)
    return widest


def matmul_time_model(
    m: int, n: int, k: int, tile, chip: hardware.Chip = hardware.H100_SXM,
    dtype_bytes: int = 2, p: int = 1,
) -> dict:
    """Analytical time of the blocked matmul, the paper's Table-I
    evaluation: compute and traffic (`tiling.comm_volume_rect`) times,
    the run time their max (perfect overlap, the paper's double
    buffering), and the efficiency compute / run time."""
    flops = 2.0 * m * n * k
    traffic_elems = tiling.comm_volume_rect(m, n, k, tile, p=p)
    compute_s = flops / chip.peak_for(dtype_bytes)
    memory_s = traffic_elems * dtype_bytes / chip.hbm_bw
    total_s = max(compute_s, memory_s)
    return {
        "flops": flops,
        "traffic_bytes": traffic_elems * dtype_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "time_s": total_s,
        "efficiency": compute_s / total_s,
        "gflops": flops / total_s / 1e9,
    }


def spmv_time_model(
    rows: int, width: int, n: int, nnz: int,
    block_rows: int, block_cols: int | None = None,
    waste: float | None = None,
    chip: hardware.Chip = hardware.H100_SXM,
    val_bytes: int = 4, idx_bytes: int = 4,
) -> dict:
    """Bandwidth model of the ELL SpMV kernels (the paper's Table-II
    evaluation, analytically).

    ``waste`` is the fetched/active balance metric
    (`EllMatrix.sliced_waste(block_rows)`): when given, the ELL traffic is
    ``nnz * waste``, else the dense (rows * width) footprint.
    ``block_cols=None`` models x resident (fetched once); an integer the
    blocked kernel, where every row block re-streams all ceil(n /
    block_cols) slabs of x.  ``vmem_bytes`` is the JAX kernel's working
    set (x or a slab, and double-buffered ELL blocks), kept for parity;
    the CUDA kernels' shared memory is `kernels.spmv.kernel.smem_bytes`.
    """
    fetched = nnz * waste if waste is not None else rows * width
    ell_bytes = fetched * (val_bytes + idx_bytes)
    row_blocks = max(1, -(-rows // block_rows))
    if block_cols is None:
        x_bytes = n * val_bytes                      # resident: fetched once
        vmem_bytes = n * val_bytes
    else:
        slabs = max(1, -(-n // block_cols))
        x_bytes = slabs * block_cols * val_bytes * row_blocks
        vmem_bytes = block_cols * val_bytes
    # Double-buffered cols+vals blocks alongside the x working set.
    vmem_bytes += 2 * block_rows * width * (val_bytes + idx_bytes)
    y_bytes = rows * val_bytes
    memory_s = (ell_bytes + x_bytes + y_bytes) / chip.hbm_bw
    flops = 2.0 * nnz
    compute_s = flops / chip.peak_for(val_bytes)
    total_s = max(compute_s, memory_s)
    return {
        "flops": flops,
        "traffic_bytes": ell_bytes + x_bytes + y_bytes,
        "vmem_bytes": vmem_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "time_s": total_s,
        "gflops": flops / total_s / 1e9,
    }


def attention_time_model(
    bh: int, sq: int, sk: int, dh: int,
    block_q: int, block_k: int,
    causal: bool = True,
    window: int | None = None,
    chip: hardware.Chip = hardware.H100_SXM,
    dtype_bytes: int = 2,
    block_skipping: bool = True,
) -> dict:
    """Roofline model of the flash-attention forward for the tuner's
    ranking of (block_q, block_k) tiles.

    Q is read and O written once; each q block streams its *active* K/V
    blocks (`attention_active_block_pairs`):

        traffic = 2*bh*sq*dh  +  2*bh*active*block_k*dh
        flops   = 4*bh*active*block_q*block_k*dh

    Dense (no mask, or ``block_skipping=False``) every block pair is
    active.  ``vmem_bytes`` is the TPU kernel's working set:
    double-buffered Q/K/V blocks, the O block, the f32 online-softmax
    scratch and the f32 logits and probabilities.
    """
    if block_skipping:
        active, total = attention_active_block_pairs(
            sq, sk, block_q, block_k, causal=causal, window=window)
    else:
        q_blocks = max(1, -(-sq // block_q))
        k_steps = max(1, -(-sk // block_k))
        active = total = q_blocks * k_steps
    flops = 4.0 * bh * active * block_q * block_k * dh   # QK^T + PV
    qo_bytes = 2.0 * bh * sq * dh * dtype_bytes
    kv_bytes = 2.0 * bh * active * block_k * dh * dtype_bytes
    memory_s = (qo_bytes + kv_bytes) / chip.hbm_bw
    compute_s = flops / chip.peak_for(dtype_bytes)
    total_s = max(compute_s, memory_s)
    vmem_bytes = (
        2 * (block_q + 2 * block_k) * dh * dtype_bytes   # double-buffered in
        + block_q * dh * dtype_bytes                     # O block
        + (2 * block_q + block_q * dh) * 4               # m, l, acc scratch
        + 2 * block_q * block_k * 4                      # s, p intermediates
    )
    return {
        "flops": flops,
        "traffic_bytes": qo_bytes + kv_bytes,
        "vmem_bytes": vmem_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "time_s": total_s,
        "gflops": flops / total_s / 1e9,
        "causal": causal,
        "window": window,
        "active_block_pairs": active,
        "total_block_pairs": total,
        "skip_fraction": 1.0 - active / total if total else 0.0,
    }


def decode_time_model(
    bkv: int, g: int, kv_len: int, dh: int,
    block_k: int,
    chip: hardware.Chip = hardware.H100_SXM,
    dtype_bytes: int = 2,
    lengths: Sequence[int] | None = None,
) -> dict:
    """Bandwidth model of single-query decode attention for the tuner's
    ranking of ``block_k``.

    ``bkv = batch*kv_heads`` folded rows, each carrying its ``g``-row GQA
    query group.  Each row streams its own valid prefix rounded up to
    ``block_k``; ``waste`` is fetched over active keys.  ``lengths``
    (optional) is a ragged batch's per-sequence prefix; ``bkv`` must be a
    multiple of its size, and each row is charged ceil(len/block_k)
    blocks (at least one), clamped to ``kv_len``.  ``lengths=None``
    charges every row the full ``kv_len``.

    On the port's kernels a span of keys is a block of the grid, not a
    tile the block stages, so this law charges a coarse span's rounding,
    which they do not pay, and nothing per block, which they do.
    """
    if lengths is not None:
        if not lengths or bkv % len(lengths):
            raise ValueError(
                f"bkv={bkv} must be a positive multiple of "
                f"len(lengths)={len(lengths)}")
        rep = bkv // len(lengths)
        clamped = [min(max(int(l), 0), kv_len) for l in lengths]
        # The kernel always executes block 0 even for an idle slot.
        row_steps = [max(1, -(-l // block_k)) for l in clamped]
        fetched_total = rep * sum(s * block_k for s in row_steps)
        active_total = rep * sum(max(l, 1) for l in clamped)
        fetched = fetched_total / bkv        # mean per-row stream
        active = active_total / bkv
    else:
        k_steps = max(1, -(-max(kv_len, 1) // block_k))
        fetched = k_steps * block_k          # block-rounded cache stream
        fetched_total = bkv * fetched
        active = min(kv_len, fetched)
        active_total = bkv * max(kv_len, 1)
    kv_bytes = 2.0 * fetched_total * dh * dtype_bytes
    qo_bytes = 2.0 * bkv * g * dh * dtype_bytes
    flops = 4.0 * g * fetched_total * dh     # qK^T + pV over fetched blocks
    memory_s = (kv_bytes + qo_bytes) / chip.hbm_bw
    compute_s = flops / chip.peak_flops_f32
    total_s = max(compute_s, memory_s)
    vmem_bytes = (
        2 * 2 * block_k * dh * dtype_bytes   # double-buffered K/V blocks
        + 2 * g * dh * dtype_bytes           # q + o rows
        + (2 * g + g * dh) * 4               # m, l, acc scratch
        + 2 * g * block_k * 4                # s, p intermediates
    )
    return {
        "flops": flops,
        "traffic_bytes": kv_bytes + qo_bytes,
        "vmem_bytes": vmem_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "time_s": total_s,
        "gflops": flops / total_s / 1e9,
        "fetched_k": fetched,
        "active_k": active,
        "waste": fetched_total / active_total,
    }


def quantized_decode_time_model(
    bkv: int, g: int, kv_len: int, dh: int,
    block_k: int,
    chip: hardware.Chip = hardware.H100_SXM,
    lengths: Sequence[int] | None = None,
) -> dict:
    """Bandwidth model of decode attention over an int8 cache: 1 byte a
    K/V element **plus** one f32 scale per fetched token row, each for K
    and V (``2 * (dh + 4)`` bytes per token and KV head), f32 q and o
    rows, and one dequantizing multiply per fetched K/V element on top of
    the attention FLOPs."""
    base = decode_time_model(bkv, g, kv_len, dh, block_k, chip=chip,
                             dtype_bytes=1, lengths=lengths)
    fetched_total = base["fetched_k"] * bkv
    # f32 scale per fetched token row, for each of K and V.
    scale_bytes = 2.0 * fetched_total * 4
    # q/o rows stay float (f32 here; decode_time_model charged them at
    # the 1-byte cache width, so re-charge at 4).
    qo_bytes = 2.0 * bkv * g * dh * 4
    kv_bytes = 2.0 * fetched_total * dh * 1
    # One dequant multiply per streamed K/V element.
    flops = base["flops"] + 2.0 * fetched_total * dh
    memory_s = (kv_bytes + scale_bytes + qo_bytes) / chip.hbm_bw
    compute_s = flops / chip.peak_flops_f32
    total_s = max(compute_s, memory_s)
    # VMEM: int8 K/V blocks + f32 scale vectors + f32 q/o/scratch.
    vmem_bytes = (
        2 * 2 * block_k * dh * 1             # double-buffered int8 K/V
        + 2 * 2 * block_k * 4                # double-buffered scale rows
        + 2 * g * dh * 4                     # q + o rows (f32)
        + (2 * g + g * dh) * 4               # m, l, acc scratch
        + 2 * g * block_k * 4                # s, p intermediates
    )
    out = dict(base)
    out.update({
        "flops": flops,
        "traffic_bytes": kv_bytes + scale_bytes + qo_bytes,
        "scale_bytes": scale_bytes,
        "vmem_bytes": vmem_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "time_s": total_s,
        "gflops": flops / total_s / 1e9,
        "bytes_per_token": 2 * (dh + 4),     # per token per KV head
    })
    return out
