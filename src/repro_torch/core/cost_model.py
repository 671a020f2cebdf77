"""Analytical laws the kernels and the tuner share.  Counterpart of
`repro.core.cost_model`, of which this package keeps its own copy, since
it never imports the JAX one.

- The block-skip law of the flash-attention kernel
  (`attention_step_bounds`, `attention_active_block_pairs`,
  `attention_max_k_steps`): ``csrc/flash_attention.cu`` mirrors
  `attention_step_bounds` in its own index math.
- The machine models the tuner ranks candidates by (the paper's Table I
  and Table II, analytically): `matmul_time_model` and `spmv_time_model`.
  Their formulas are the JAX package's; the chip defaults to the H100,
  and an operation is charged at the peak of its operand width
  (`Chip.peak_for`: bf16 on the tensor cores, f32 on the CUDA cores).
"""

from __future__ import annotations

from repro_torch.core import hardware, tiling


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
