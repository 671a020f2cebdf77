"""KernelSpec of the ELL SpMV family.  Counterpart of
`repro.kernels.spmv.spec`.

Candidates are (block_rows, block_cols) pairs of the two CUDA kernels:
``block_cols=None`` (x resident, `ell_spmv`) where all of x fits a
block's shared memory, slabs (`ell_spmv_blocked`) where the row block's
entries fit the registers.  Each is scored by `spmv_time_model` fed with
the packing's fetched/active balance metric (`EllMatrix.sliced_waste`).
The problem carries the live `EllMatrix`; the cache key uses its scalars
and its layout fingerprint.

Only the best-ranked of the resident candidates that launch alike is
kept: `ell_spmv` sizes its launch from the matrix
(`kernel.launch_geometry`), so on few long rows several block_rows give
one launch, and the tuner would time one kernel several times.  On the
card a candidate is timed as the kernel call alone (`ops.packed_spmv`,
without the scatter back to row order; `autotune.measure`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import cost_model, dse, hardware
from repro_torch.kernels import registry
from repro_torch.kernels.spmv import kernel
from repro_torch.kernels.spmv import ops as spmv_ops

# Slabs of x for the blocked kernel, up to about a block's shared memory
# (49152 f32 columns are 192 KB).
BLOCK_COLS = (None, 4096, 16384, 32768, 49152)


def rank_configs(
    mat: spmv_ops.EllMatrix,
    smem_bytes: int | None = None,
    block_cols_cands: Sequence[int | None] = BLOCK_COLS,
    chip: hardware.Chip = hardware.H100_SXM,
) -> list[tuple[float, int, int | None, float]]:
    """(score, block_rows, block_cols, waste) ascending, ties broken by
    `_tie_break`, of every configuration the kernels run within
    ``smem_bytes`` (default: the chip's).  A slab no narrower than x
    (``block_cols >= n + 128``) is left out: it is the resident kernel
    with extra work."""
    budget = smem_bytes if smem_bytes is not None else chip.smem_bytes
    rows, width = mat.cols.shape
    _, n = mat.shape
    out, wastes = [], {}
    for bc in block_cols_cands:
        if bc is not None and bc >= n + 128:
            continue
        if kernel.smem_bytes(n, bc) > budget:
            continue
        if bc is None:
            brs = kernel.RESIDENT_ROWS
        else:
            brs = [br for br in kernel.BLOCKED_ROWS
                   if kernel.blocked_fits(width, br)]
        for br in brs:
            if br not in wastes:
                wastes[br] = mat.sliced_waste(block_rows=br)
            res = cost_model.spmv_time_model(rows, width, n, mat.nnz,
                                             block_rows=br, block_cols=bc,
                                             waste=wastes[br], chip=chip)
            out.append((res["time_s"], br, bc, wastes[br]))
    out.sort(key=lambda r: (r[0], _tie_break({"block_rows": r[1],
                                              "block_cols": r[2]})))
    return out


def _tie_break(knobs: dict) -> tuple:
    # Equal model times: the smaller row block, then the wider slab
    # (fewer passes over each row block, fewer barriers).
    return (knobs["block_rows"], -(knobs["block_cols"] or 0))


def _key_fn(problem: dict, dtype: str, backend: str) -> str:
    mat = problem["mat"]
    rows, width = mat.cols.shape
    _, n = mat.shape
    return (f"{rows}x{width}:n{n}:nnz{mat.nnz}:l{mat.layout_fingerprint()}"
            f":{dtype}:{backend}")


def _enumerate(problem: dict, dtype_bytes: int, smem_bytes: int | None,
               top: int) -> list[dse.Candidate]:
    mat = problem["mat"]
    ranked = rank_configs(mat, smem_bytes=smem_bytes)
    if not ranked:
        # Nothing fits the budget: the smallest slab, scored normally so
        # the cache entry stays finite (the kernel refuses what it cannot
        # hold, naming why).
        rows, width = mat.cols.shape
        _, n = mat.shape
        fb = cost_model.spmv_time_model(rows, width, n, mat.nnz,
                                        block_rows=16, block_cols=4096,
                                        waste=mat.padding_waste)
        ranked = [(fb["time_s"], 16, 4096, mat.padding_waste)]
    rows, width = mat.cols.shape
    _, n = mat.shape
    launched = kernel.distinct_block_rows(
        rows, width, n, hardware.H100_SXM.sms,
        [br for _, br, bc, _ in ranked if bc is None])
    ranked = [r for r in ranked if r[2] is not None or r[1] in launched]
    return [dse.Candidate({"block_rows": br, "block_cols": bc}, score,
                          {"waste": waste})
            for score, br, bc, waste in ranked]


def _cost_fn(problem: dict, knobs: dict, dtype_bytes: int = 4) -> dict:
    mat = problem["mat"]
    rows, width = mat.cols.shape
    _, n = mat.shape
    return cost_model.spmv_time_model(
        rows, width, n, mat.nnz, block_rows=knobs["block_rows"],
        block_cols=knobs["block_cols"],
        waste=mat.sliced_waste(block_rows=knobs["block_rows"]))


def _make_inputs(problem: dict, dtype: torch.dtype, device) -> tuple:
    _, n = problem["mat"].shape
    gen = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(n, generator=gen, device=device).to(dtype),)


def _build_launcher(problem: dict, knobs: dict):
    mat = problem["mat"]
    return lambda x: spmv_ops.packed_spmv(mat, x,
                                          block_rows=knobs["block_rows"],
                                          block_cols=knobs["block_cols"])


def _problem_fn(mat, x) -> tuple[dict, torch.dtype]:
    return {"mat": mat}, x.dtype


def _run_fn(plan: registry.Plan, mat, x):
    return spmv_ops.spmv(mat, x, block_rows=plan.knobs["block_rows"],
                         block_cols=plan.knobs["block_cols"])


registry.register(registry.KernelSpec(
    name="spmv",
    key_fn=_key_fn,
    enumerate_candidates=_enumerate,
    cost_fn=_cost_fn,
    make_inputs=_make_inputs,
    build_launcher=_build_launcher,
    reference_fn=lambda mat, x: spmv_ops.spmv(mat, x),
    problem_fn=_problem_fn,
    run_fn=_run_fn,
    tie_break=_tie_break,
    detail_keys=("waste",),
))
