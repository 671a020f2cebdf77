"""Plain PyTorch versions of the SpMV kernels.  Counterpart of
`repro.kernels.spmv.ref` (CSR and ELL oracles), plus the slab walk of
the blocked kernel (the body of `repro.kernels.spmv.kernel.
ell_spmv_blocked`) written out in PyTorch."""

from __future__ import annotations

import torch


def spmv_csr_ref(indptr, indices, data, x, num_rows: int) -> torch.Tensor:
    """y = A @ x from CSR arrays (tensors on x's device)."""
    row_ids = torch.repeat_interleave(
        torch.arange(num_rows, device=x.device), torch.diff(indptr).long(),
        output_size=indices.shape[0])
    prods = data * x[indices.long()]
    return torch.zeros(num_rows, dtype=prods.dtype,
                       device=x.device).index_add_(0, row_ids, prods)


def _live(ell_cols, row_lens) -> torch.Tensor:
    """(rows, W) mask of each row's first row_lens[r] entries."""
    width = torch.arange(ell_cols.shape[1], device=ell_cols.device)
    return width < row_lens.to(ell_cols.device)[:, None]


def spmv_ell_ref(ell_cols, ell_vals, x, row_lens=None) -> torch.Tensor:
    """y = A @ x on the padded ELL arrays (pads have value 0).  With
    ``row_lens``, row r sums only its first row_lens[r] products, so a
    pad's 0 * x[0] is never added (it is NaN where x[0] is not finite);
    without, every entry is, as in the JAX package's `spmv_ell_ref`."""
    prods = ell_vals * x[ell_cols.long()]
    if row_lens is not None:
        prods = torch.where(_live(ell_cols, row_lens), prods, 0.0)
    return prods.sum(1)


def spmv_blocked_ref(ell_cols, ell_vals, x, block_cols: int) -> torch.Tensor:
    """The blocked kernel's walk: for each ``block_cols`` slab of x, the
    entries whose column lies in it gather from the slab (the others are
    clamped to 0 and masked), and their products add to an f32 partial
    sum; one cast to vals' dtype at the end."""
    n = x.shape[0]
    acc = torch.zeros(ell_cols.shape[0], dtype=torch.float32,
                      device=x.device)
    for start in range(0, n, block_cols):
        slab = torch.zeros(block_cols, dtype=x.dtype, device=x.device)
        slab[:min(block_cols, n - start)] = x[start:start + block_cols]
        in_slab = (ell_cols >= start) & (ell_cols < start + block_cols)
        local = torch.where(in_slab, ell_cols - start, 0)
        part = torch.where(in_slab, ell_vals * slab[local.long()], 0.0)
        acc += part.float().sum(1)
    return acc.to(ell_vals.dtype)


def row_tolerance(ell_cols, ell_vals, x, row_lens=None) -> torch.Tensor:
    """How far a kernel's y may lie from these plain versions, per row:
    the kernels sum the same f32 products in another order (lanes, then
    a shuffle tree; slab by slab), which moves a sum by a few f32 ulps
    of the sum of the |products| at these widths; 1e-5 of that sum (over
    each row's first row_lens[r] entries, when given), and exact zeros
    for rows with no product."""
    mags = ell_vals.abs() * x.abs()[ell_cols.long()]
    if row_lens is not None:
        mags = torch.where(_live(ell_cols, row_lens), mags, 0.0)
    return 1e-5 * mags.float().sum(1)
