"""The paper's Table II on the H100: sparse matrix-vector products over
the paper's four test matrices, synthesized to their published NNZ / M /
NNZ-per-row statistics.  Counterpart of ``benchmarks/table2_spmv.py`` of
the JAX package.

Columns as the JAX package's: the matrix statistics; "ARM", the dense
mat-vec baseline, a dense torch product on the same device; "HW", this
package's `spmv` with its tuned plan, through the CUDA kernels B7 / B8 on
the card; the paper's balance statistic (largest share of nnz over 4
workers, round-robin and LPT); and the ELL waste metrics.

Each matrix is seeded from a stable digest of its name (`zlib.crc32`);
the JAX package's ``hash(name)`` is salted per process, so its matrices
change from run to run.  Beside the four, two matrices at the scale of a
SuiteSparse matrix (`LARGE`): 1,048,576 rows with LD_pilot87's per-row
range, x narrow enough for shared memory (n = 32,768) or not (n =
1,048,576), built by `synthesize_large` without a loop over rows.

    python -m repro_torch.benchmarks.table2_spmv [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import loadbalance
from repro_torch.kernels import autotune
from repro_torch.kernels.spmv import kernel as spmv_kernel
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import ref as spmv_ref

# Published stats: name -> (NNZ, M(rows), nnz_per_row range)
MATRICES = {
    "Maragal_2": (4_357, 555, (0, 139)),
    "flower_5_4": (43_942, 5_226, (1, 3)),
    "BIBD_14_7": (72_072, 91, (21, 21)),
    "LD_pilot87": (74_949, 2_030, (1, 96)),
}
# name -> (rows, columns, nnz_per_row range): LD_pilot87's range at 1M rows.
LARGE = {
    "spmv_1m_narrow": (1_048_576, 32_768, (1, 96)),
    "spmv_1m_wide": (1_048_576, 1_048_576, (1, 96)),
}


def _seed(name: str, seed: int) -> int:
    return seed + zlib.crc32(name.encode()) % 1000


def synthesize(name: str, seed: int = 0):
    """Random CSR matrix matching (NNZ, M, nnz-per-row range) of one of
    `MATRICES`, as the JAX package builds it, seeded from the name."""
    nnz, m, (lo, hi) = MATRICES[name]
    rng = np.random.default_rng(_seed(name, seed))
    if lo == hi:
        per_row = np.full(m, nnz // m)
    else:
        raw = rng.integers(max(lo, 0), hi + 1, size=m).astype(np.float64)
        per_row = np.maximum((raw / raw.sum() * nnz).astype(int), 0)
    n_cols = max(int(per_row.max()) + 1, 128)
    indptr = np.concatenate([[0], np.cumsum(per_row)]).astype(np.int32)
    indices = np.concatenate([
        rng.choice(n_cols, size=c, replace=False) for c in per_row
    ]).astype(np.int32)
    data = rng.standard_normal(indptr[-1]).astype(np.float32)
    return indptr, indices, data, (m, n_cols)


def synthesize_large(rows: int, n: int, lo: int = 1, hi: int = 96,
                     seed: int = 0):
    """CSR (rows, n) with a uniform lo..hi nonzeros per row and N(0, 1)
    values, vectorised.  Row r's columns are ``(o_r + j * s_r) mod n``,
    j < its count, with a random offset o_r and a random stride s_r in
    [1, n // hi]: distinct within the row, spread over x."""
    if n < hi:
        raise ValueError(f"n={n} is below the {hi} nonzeros a row may hold")
    rng = np.random.default_rng(seed)
    per_row = rng.integers(lo, hi + 1, size=rows)
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(per_row, out=indptr[1:])
    nnz = int(indptr[-1])
    row_of = np.repeat(np.arange(rows, dtype=np.int64), per_row)
    j = np.arange(nnz, dtype=np.int64) - indptr[:-1][row_of]
    offset = rng.integers(0, n, size=rows)
    stride = rng.integers(1, n // hi + 1, size=rows)
    indices = ((offset[row_of] + j * stride[row_of]) % n).astype(np.int32)
    data = rng.standard_normal(nnz, dtype=np.float32)
    return indptr, indices, data, (rows, n)


def synthesize_banded(rows: int, n: int, lo: int = 1, hi: int = 96,
                      half: int = 128, seed: int = 0):
    """CSR (rows, n) with a uniform lo..hi nonzeros a row, all within
    ``half`` columns of the diagonal (the window shifted inward at the
    first and last rows), as in SuiteSparse's finite-element and circuit
    matrices; N(0, 1) values, vectorised.  Row r's columns are ``o_r + j *
    s_r``, j below its count, with a random stride s_r and start o_r that
    keep them distinct and inside its window of 2 * half + 1 columns."""
    width = 2 * half + 1
    if n < width or hi > width:
        raise ValueError(f"n={n} and {hi} nonzeros a row need a window of "
                         f"{width} columns inside the matrix")
    rng = np.random.default_rng(seed)
    per_row = rng.integers(lo, hi + 1, size=rows)
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(per_row, out=indptr[1:])
    nnz = int(indptr[-1])
    r = np.arange(rows, dtype=np.int64)
    base = np.clip(r - half, 0, n - width)
    stride = rng.integers(1, (width - 1) // np.maximum(per_row - 1, 1) + 1)
    start = base + rng.integers(0, width - (per_row - 1) * stride)
    row_of = np.repeat(r, per_row)
    j = np.arange(nnz, dtype=np.int64) - indptr[:-1][row_of]
    indices = (start[row_of] + j * stride[row_of]).astype(np.int32)
    data = rng.standard_normal(nnz, dtype=np.float32)
    return indptr, indices, data, (rows, n)


def build(name: str, seed: int = 0):
    """The CSR arrays of a matrix of `MATRICES` or `LARGE`."""
    if name in LARGE:
        rows, n, (lo, hi) = LARGE[name]
        return synthesize_large(rows, n, lo, hi, seed=_seed(name, seed))
    return synthesize(name, seed)


def _dense(indptr, indices, data, shape) -> np.ndarray:
    dense = np.zeros(shape, np.float32)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    return dense


def bench_one(name: str, device="cuda", reps: int = 5,
              cache: autotune.TuneCache | None = None) -> dict:
    """One row of Table II on ``device``: microseconds of the dense
    baseline and of the tuned sparse path (CUDA events on the card, the
    host clock on the CPU), their largest difference, the balance
    statistics and the ELL waste metrics."""
    device = resolve_device(device)
    indptr, indices, data, shape = synthesize(name)
    m, n = shape
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(device)

    dense = torch.from_numpy(_dense(indptr, indices, data, shape)).to(device)
    y_base = dense @ x
    base_us = autotune.measure(lambda: dense @ x, device, reps=reps)

    mat = spmv_ops.pack_csr(indptr, indices, data, shape,
                            scheme="round_robin", device=device)
    plan = autotune.tune("spmv", {"mat": mat}, device=device, cache=cache)
    y_hw = spmv_ops.spmv(mat, x, **plan.knobs)
    hw_us = autotune.measure(lambda: spmv_ops.spmv(mat, x, **plan.knobs),
                             device, reps=reps)
    err = float((y_hw - y_base).abs().max())

    # the paper's balance statistic for 4 workers
    _, rr = loadbalance.nnz_balanced_row_order(indptr, 4)
    _, greedy = loadbalance.nnz_balanced_row_order(indptr, 4, "lpt")

    # Model HW/baseline ratio at the memory rate (the paper's HW/ARM
    # column): sparse traffic (vals + cols, sliced ELL under the sorted
    # packing) against dense mat-vec traffic, both bandwidth bound.
    sorted_mat = spmv_ops.pack_csr(indptr, indices, data, shape,
                                   scheme="sorted", device="cpu")
    sliced = {"round_robin": mat.sliced_waste(),
              "sorted": sorted_mat.sliced_waste()}
    sparse_bytes = int(indptr[-1]) * sliced["sorted"] * 8
    dense_bytes = m * n * 4
    return {
        "name": name, "device": str(device),
        "nnz": int(indptr[-1]), "m": m, "n": n,
        "base_us": base_us, "hw_us": hw_us,
        "block_rows": plan.knobs["block_rows"],
        "block_cols": plan.knobs["block_cols"], "source": plan.source,
        "ratio_model": dense_bytes / max(sparse_bytes, 1),
        "rr_max_frac": rr.max_fraction,
        "lpt_max_frac": greedy.max_fraction,
        "ell_waste": mat.padding_waste,
        "sliced_rr": sliced["round_robin"],
        "sliced_sorted": sliced["sorted"],
        "err": err,
    }


def tuned_records(device="cuda", names=tuple(MATRICES),
                  cache: autotune.TuneCache | None = None,
                  check_blocked_on: str = "Maragal_2") -> list[dict]:
    """Tuner plans for ``names`` (any of `MATRICES` and `LARGE`), each
    packed under the sorted law.  For ``check_blocked_on`` the blocked
    path (x in two slabs) is also run and compared with the resident one
    and with the plain CSR product (`ref.spmv_csr_ref`)."""
    device = resolve_device(device)
    recs = []
    for name in names:
        indptr, indices, data, shape = build(name)
        mat = spmv_ops.pack_csr(indptr, indices, data, shape,
                                scheme="sorted", device=device)
        plan = autotune.tune("spmv", {"mat": mat}, device=device,
                             cache=cache)
        rec = {
            "matrix": name, "shape": list(shape), "nnz": mat.nnz,
            "width": mat.cols.shape[1], "key": plan.key,
            "block_rows": plan.knobs["block_rows"],
            "block_cols": plan.knobs["block_cols"],
            "source": plan.source, "waste": plan.detail.get("waste"),
            "model_time_us": plan.model_time_us,
            "measured_us": plan.measured_us,
        }
        if name == check_blocked_on:
            n = shape[1]
            x = torch.from_numpy(np.random.default_rng(2).standard_normal(n)
                                 .astype(np.float32)).to(device)
            br = min(r for r in spmv_kernel.BLOCKED_ROWS
                     if spmv_kernel.blocked_fits(mat.cols.shape[1], r))
            y_blk = spmv_ops.spmv(mat, x, block_rows=br,
                                  block_cols=max(128, (n // 2) // 128 * 128))
            y_res = spmv_ops.spmv(mat, x)
            y_ref = spmv_ref.spmv_csr_ref(
                *(torch.from_numpy(a).to(device)
                  for a in (indptr, indices, data)), x, shape[0])
            rec["blocked_vs_resident_err"] = float((y_blk - y_res).abs()
                                                   .max())
            rec["blocked_vs_ref_err"] = float((y_blk - y_ref).abs().max())
        recs.append(rec)
        del mat, indices, data
    return recs


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lines = []
    for name in MATRICES:
        r = bench_one(name, device=args.device)
        lines.append(
            f"table2.{r['name']},{r['hw_us']:.1f},"
            f"base_us={r['base_us']:.1f};ratio_model={r['ratio_model']:.2f};"
            f"rr_frac={r['rr_max_frac']:.3f};lpt_frac={r['lpt_max_frac']:.3f};"
            f"sliced_rr={r['sliced_rr']:.2f};"
            f"sliced_sorted={r['sliced_sorted']:.2f};err={r['err']:.2e};"
            f"device={r['device']}")
    return lines


if __name__ == "__main__":
    print("\n".join(main(sys.argv[1:])))
