"""Design-space exploration: the paper's flow, automated.  Counterpart of
`repro.core.dse`.

The paper's designer picks a configuration, generates and simulates it
for a cycle count, and iterates.  Here the candidate space is enumerated
and each point scored by the analytical machine model
(`core.cost_model`).  `Candidate`, `grid`, `explore` and
`sharding_candidates` are the JAX package's; the matmul ranking lives
with its kernel (`kernels/matmul/spec.py`), and `rank_matmul_tiles` /
`autotune_matmul_tile` reach it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Sequence


@dataclasses.dataclass
class Candidate:
    knobs: dict
    score: float = float("inf")   # seconds — lower is better
    detail: dict | None = None

    def __repr__(self) -> str:
        return f"Candidate({self.knobs}, score={self.score:.6g})"


def grid(space: dict) -> Iterable[dict]:
    """Cartesian product of a {knob: [values]} space."""
    keys = list(space)
    for combo in itertools.product(*(space[k] for k in keys)):
        yield dict(zip(keys, combo))


def explore(
    space: dict | Sequence[dict],
    evaluate: Callable[[dict], tuple[float, dict]],
    top: int = 5,
) -> list[Candidate]:
    """Score every candidate; return the best `top`, ascending by score."""
    cands = []
    points = grid(space) if isinstance(space, dict) else space
    for knobs in points:
        try:
            score, detail = evaluate(knobs)
        except Exception as e:  # infeasible point (indivisible shard, ...)
            score, detail = float("inf"), {"error": repr(e)}
        cands.append(Candidate(knobs, score, detail))
    cands.sort(key=lambda c: c.score)
    return cands[:top]


def rank_matmul_tiles(m: int, n: int, k: int, smem_bytes: int | None = None,
                      dtype_bytes: int = 2, top: int = 8) -> list[Candidate]:
    """The matmul family's ranking of kernel tiles
    (`kernels.matmul.spec.rank_tiles`)."""
    from repro_torch.kernels.matmul import spec as matmul_spec
    return matmul_spec.rank_tiles(m, n, k, smem_bytes=smem_bytes,
                                  dtype_bytes=dtype_bytes, top=top)


def autotune_matmul_tile(m: int, n: int, k: int,
                         smem_bytes: int | None = None,
                         dtype_bytes: int = 2):
    """Best analytical tile, the `rank_matmul_tiles` winner (the paper's
    flow in one call, no measurement)."""
    ranked = rank_matmul_tiles(m, n, k, smem_bytes=smem_bytes,
                               dtype_bytes=dtype_bytes, top=1)
    return ranked[0].detail["tile"]


def sharding_candidates(num_chips: int, min_model: int = 1) -> list[dict]:
    """Enumerate (data, model) factorizations — the interconnect DSE axis."""
    out = []
    d = 1
    while d <= num_chips:
        if num_chips % d == 0:
            mdl = num_chips // d
            if mdl >= min_model:
                out.append({"data": d, "model": mdl})
        d *= 2
    return out
