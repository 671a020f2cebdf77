"""Sparse matrix-vector pipeline (paper §V-B) through the port's public
API: pack with each balancing law, compare balance and padding, execute
the kernels, and report the Table-II-style summary.  Counterpart of the
JAX package's ``examples/spmv_pipeline.py``, on the same matrix (an
LD_pilot87-like row-length distribution from ``default_rng(87)``).

Every SpMV here runs on the caller's device: on a card each packing goes
through B7 (x resident) and the 256-column slabs through B8; on the CPU
their plain versions run.

Run:  PYTHONPATH=src python -m repro_torch.examples.spmv_pipeline [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import loadbalance
from repro_torch.kernels import autotune
from repro_torch.kernels.spmv.ops import pack_csr, spmv

SCHEMES = ("none", "round_robin", "lpt", "sorted")
SLAB = 256                           # columns of x a B8 slab holds
REL = 1e-5                           # of each row's sum of |products|


def make_matrix(m=2030, n=512, lo=1, hi=96, seed=87):
    """LD_pilot87-like row-length distribution."""
    rng = np.random.default_rng(seed)
    per_row = rng.integers(lo, hi + 1, size=m)
    indptr = np.concatenate([[0], np.cumsum(per_row)]).astype(np.int32)
    indices = np.concatenate(
        [rng.choice(n, size=c, replace=False) for c in per_row]
    ).astype(np.int32)
    data = rng.standard_normal(indptr[-1]).astype(np.float32)
    return indptr, indices, data, (m, n)


def _csr_products(indptr, indices, data, x):
    """The CSR product in f64 and each row's sum of |products|."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    prod = data.astype(np.float64) * x[indices]
    m = len(indptr) - 1
    return (np.bincount(rows, prod, minlength=m),
            np.bincount(rows, np.abs(prod), minlength=m))


def run(device="cuda") -> dict:
    """The pipeline on ``device``; prints it and returns each run's
    largest error against the CSR product in f64 and whether every row is
    within 1e-5 of its sum of |products|."""
    dev = resolve_device(device)
    indptr, indices, data, shape = make_matrix()
    x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    exact, scale = _csr_products(indptr, indices, data, x)
    nnz = int(indptr[-1])
    print(f"matrix: {shape[0]}x{shape[1]}, nnz={nnz}")

    # paper claim: round-robin balances nnz across p workers (~1/p each)
    for p in (2, 4, 8):
        _, st = loadbalance.nnz_balanced_row_order(indptr, p)
        print(f"  round-robin p={p}: max worker share "
              f"{st.max_fraction:.3f} (ideal {1 / p:.3f})")

    def held(y):
        diff = np.abs(y.cpu().numpy().astype(np.float64) - exact)
        return float(diff.max()), bool((diff <= REL * scale).all())

    runs = {}
    print("\npacking law comparison (SIMD padding waste, lower=better):")
    y_ref = None
    for scheme in SCHEMES:
        mat = pack_csr(indptr, indices, data, shape, scheme=scheme,
                       device=dev)
        y = spmv(mat, xt)
        if y_ref is None:
            y_ref = y
        err = float((y - y_ref).abs().max())
        runs[scheme] = held(y)
        print(f"  {scheme:12s} sliced waste {mat.sliced_waste():.2f}x "
              f"(global {mat.padding_waste:.2f}x)  err vs first: {err:.1e}")

    # Close the DSE loop: let the tuner pick the execution config for the
    # sorted packing (the balance metric above is its ranking input), and
    # run the blocked-x kernel that lifts the whole-vector cap of x.
    mat = pack_csr(indptr, indices, data, shape, scheme="sorted", device=dev)
    plan = autotune.tune("spmv", {"mat": mat}, torch.float32, device=dev)
    print(f"\nautotuned execution config: "
          f"block_rows={plan.knobs['block_rows']}, "
          f"block_cols={plan.knobs['block_cols']} (None = whole-x resident), "
          f"source={plan.source}")
    runs["tuned"] = held(autotune.dispatch("spmv", mat, xt))
    y_blk = spmv(mat, xt, block_rows=plan.knobs["block_rows"],
                 block_cols=SLAB)
    runs["blocked"] = held(y_blk)
    print(f"blocked-x kernel ({SLAB}-col slabs) vs oracle: max err "
          f"{runs['blocked'][0]:.1e} — n no longer bounded by shared memory")

    print("\nresult: the paper's balancing law survives the port, but on a "
          "SIMD target the optimal permutation is SORTED (equal widths), "
          "not round-robin — see DESIGN.md §Hardware adaptation.")
    return {name: {"max_abs_err": e, "ok": ok}
            for name, (e, ok) in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
