"""Work balancing: the paper's SpMV row-assignment law.  A copy of
`repro.core.loadbalance` (numpy only), kept here because this package
never imports the JAX one; its results are bit-equal to the reference's.

Section V-B assigns sparse-matrix rows to cores round-robin by row index
and shows the nnz per core converges to ~1/p of the total.  Beside that
law: LPT (longest processing time first), and the MoE capacity rule that
reuses the same balance assumption.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BalanceStats:
    per_worker: np.ndarray          # total weight per worker
    imbalance: float                # max/mean - 1  (0 == perfect)
    max_fraction: float             # heaviest worker's share of total

    @classmethod
    def of(cls, per_worker: np.ndarray) -> "BalanceStats":
        per_worker = np.asarray(per_worker, dtype=np.float64)
        total = per_worker.sum()
        mean = total / per_worker.size if per_worker.size else 0.0
        imb = float(per_worker.max() / mean - 1.0) if mean > 0 else 0.0
        frac = float(per_worker.max() / total) if total > 0 else 0.0
        return cls(per_worker, imb, frac)


def round_robin(weights: np.ndarray, p: int) -> np.ndarray:
    """Paper's scheme: item i -> worker i mod p.  Returns assignment array."""
    n = len(weights)
    return np.arange(n, dtype=np.int32) % p


def lpt(weights: np.ndarray, p: int) -> np.ndarray:
    """Greedy longest-processing-time: heaviest item to the lightest worker."""
    weights = np.asarray(weights)
    order = np.argsort(-weights, kind="stable")
    loads = np.zeros(p, dtype=np.float64)
    assign = np.empty(len(weights), dtype=np.int32)
    for i in order:
        w = int(np.argmin(loads))
        assign[i] = w
        loads[w] += float(weights[i])
    return assign


def stats_for(assign: np.ndarray, weights: np.ndarray, p: int) -> BalanceStats:
    per_worker = np.zeros(p, dtype=np.float64)
    np.add.at(per_worker, assign, np.asarray(weights, dtype=np.float64))
    return BalanceStats.of(per_worker)


def nnz_balanced_row_order(indptr: np.ndarray, p: int, scheme: str = "round_robin"):
    """Partition CSR rows across p workers, balanced by nnz.

    Returns (assign, stats); row i has ``indptr[i+1]-indptr[i]`` nonzeros.
    This is the object the paper measures in Table II ("percentage of
    nonzeros assigned to each processor").
    """
    nnz_per_row = np.diff(indptr)
    if scheme == "round_robin":
        assign = round_robin(nnz_per_row, p)
    elif scheme == "lpt":
        assign = lpt(nnz_per_row, p)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return assign, stats_for(assign, nnz_per_row, p)


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float = 1.25, align: int = 8) -> int:
    """MoE per-expert capacity with the paper's balance assumption:
    each expert sees about ``tokens*k/E``, and the capacity factor absorbs
    residual imbalance as round-robin absorbs nnz skew."""
    cap = int(np.ceil(num_tokens * top_k / num_experts * capacity_factor))
    return max(align, ((cap + align - 1) // align) * align)
