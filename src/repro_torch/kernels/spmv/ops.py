"""Public SpMV entry: packing on the host (row balancing, ELL) and the
kernel call.  Counterpart of `repro.kernels.spmv.ops`.

`pack_csr` is vectorised (no loop over rows or row blocks) and its
output equals the JAX package's bit for bit: the same permutation, the
same ELL arrays, the same waste metrics and layout fingerprint.  The ELL
arrays live on the caller's device.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import loadbalance
from repro_torch.kernels.spmv import kernel


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELL representation with a row permutation for balance."""

    # (rows_padded, W) int32; pads point at column 0
    cols: torch.Tensor = dataclasses.field(repr=False)
    # (rows_padded, W); pads are 0.0
    vals: torch.Tensor = dataclasses.field(repr=False)
    # packed row r holds original row perm[r]
    perm: np.ndarray = dataclasses.field(repr=False)
    shape: tuple           # original (M, N)
    nnz: int
    # packed-row lengths (CSR nnz), int64
    row_lens: np.ndarray = dataclasses.field(repr=False)
    # perm on cols' device, for the scatter back
    perm_index: torch.Tensor = dataclasses.field(repr=False)

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @functools.cached_property
    def lens(self) -> torch.Tensor:
        """`row_lens` as int32 on cols' device, copied there once: the
        length-aware kernel reads each row's entries below it."""
        return torch.from_numpy(np.asarray(self.row_lens, np.int32)).to(
            self.device)

    @property
    def padding_waste(self) -> float:
        """fetched / active — 1.0 is perfect (the balance-quality metric)."""
        total = self.cols.shape[0] * self.cols.shape[1]
        return total / max(self.nnz, 1)

    @functools.cached_property
    def _fingerprint(self) -> str:
        lens = np.asarray(self.row_lens, np.int64)
        return hashlib.sha1(lens.tobytes()).hexdigest()[:12]

    def layout_fingerprint(self) -> str:
        """Digest of the packed row-length layout.  Two packings of one
        matrix fetch differently, so tuning results must not be shared
        between them."""
        return self._fingerprint

    def sliced_waste(self, block_rows: int = 8, align: int = 8) -> float:
        """fetched/active if each row block used its own width (sliced
        ELL): each block of ``block_rows`` packed rows fetches its longest
        row, rounded up to ``align``, for each of its rows."""
        lens = np.asarray(self.row_lens, np.int64)
        count = len(lens)
        if count == 0:
            return 0.0
        blocks = -(-count // block_rows)
        padded = np.zeros(blocks * block_rows, np.int64)
        padded[:count] = lens
        widths = padded.reshape(blocks, block_rows).max(axis=1)
        widths = (widths + align - 1) // align * align
        rows_in = np.full(blocks, block_rows, np.int64)
        rows_in[-1] = count - (blocks - 1) * block_rows
        return int((widths * rows_in).sum()) / max(self.nnz, 1)


def pack_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
             shape: tuple, scheme: str = "round_robin",
             block_rows: int = 8, align: int = 128,
             device="cuda") -> EllMatrix:
    """CSR -> balanced ELL on ``device``.  ``scheme`` is the row law:
    'round_robin' (the paper's, over groups of ``block_rows`` rows),
    'lpt' (greedy), 'sorted' (descending length) or 'none' (natural
    order).  Rows are padded to a multiple of ``block_rows``, the width
    to a multiple of ``align``."""
    device = resolve_device(device)
    m, n = shape
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise ValueError(f"column indices must lie in [0, {n})")
    nnz_per_row = np.diff(indptr)
    if scheme == "none":
        perm = np.arange(m)
    elif scheme == "sorted":
        perm = np.argsort(-nnz_per_row, kind="stable")
    else:
        groups = max(1, int(np.ceil(m / block_rows)))
        if scheme == "round_robin":
            assign = loadbalance.round_robin(nnz_per_row, groups)
        elif scheme == "lpt":
            assign = loadbalance.lpt(nnz_per_row, groups)
        else:
            raise ValueError(scheme)
        perm = np.argsort(assign, kind="stable")
    width = int(max(1, nnz_per_row.max()))
    width = (width + align - 1) // align * align
    rows_padded = (m + block_rows - 1) // block_rows * block_rows

    lens = nnz_per_row[perm].astype(np.int64)
    total = int(lens.sum())
    packed = np.repeat(np.arange(m, dtype=np.int64), lens)
    offset = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    src = np.repeat(indptr[perm].astype(np.int64), lens) + offset
    cols = np.zeros((rows_padded, width), np.int32)
    vals = np.zeros((rows_padded, width), data.dtype)
    cols[packed, offset] = indices[src]
    vals[packed, offset] = data[src]
    row_lens = np.zeros(rows_padded, np.int64)
    row_lens[:m] = lens
    return EllMatrix(torch.from_numpy(cols).to(device),
                     torch.from_numpy(vals).to(device), perm, shape,
                     int(nnz_per_row.sum()), row_lens,
                     torch.from_numpy(np.asarray(perm, np.int64)).to(device))


def packed_spmv(mat: EllMatrix, x: torch.Tensor, block_rows: int = 32,
                block_cols: int | None = None) -> torch.Tensor:
    """y = A @ x in the packed row order (padded rows included): the
    kernel call alone.  ``block_cols=None`` keeps all of x in shared
    memory and reads each row's entries only (`ell_spmv` with the row
    lengths; n bounded by shared memory); an integer streams x in slabs of
    that many columns (`ell_spmv_blocked`).  On CPU tensors the plain
    versions run."""
    if block_cols is None:
        return kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=block_rows,
                               row_lens=mat.lens)
    return kernel.ell_spmv_blocked(x, mat.cols, mat.vals,
                                   block_rows=block_rows,
                                   block_cols=block_cols)


def spmv(mat: EllMatrix, x: torch.Tensor, block_rows: int = 32,
         block_cols: int | None = None) -> torch.Tensor:
    """y = A @ x in the original row order (`packed_spmv`, then the
    scatter back through the permutation)."""
    y_packed = packed_spmv(mat, x, block_rows=block_rows,
                           block_cols=block_cols)
    m = mat.shape[0]
    y = torch.empty(m, dtype=y_packed.dtype, device=y_packed.device)
    y[mat.perm_index] = y_packed[:m]
    return y
