"""KernelSpec of the blocked dense-matmul family.  Counterpart of
`repro.kernels.matmul.spec`.

The candidates are the tiles the CUDA kernels are built for
(`core.tiling.HOPPER_TILES`) that fit the H100's budgets: the shared
memory a launch takes (`tiling.hopper_smem_bytes`: in bf16 the wgmma
kernel's ring of at least three TMA stages and their mbarriers, 197-231
KB for every built tile; in f32 two padded stages) within a block's, and
the f32 C tile in half an SM's registers.  Each is scored by
`cost_model.matmul_time_model`; the `solve_hopper` seed is always among
them, so the winner is never worse than the eq. 2 tile under the model.
"""

from __future__ import annotations

import torch

from repro_torch.core import cost_model, dse, hardware, tiling
from repro_torch.kernels import registry
from repro_torch.kernels.matmul import ops as matmul_ops


def _tie_break(knobs: dict) -> tuple:
    # Equal model times (a compute-bound shape): the larger tile, which
    # moves fewer bytes, then the deeper step; then the tile itself.
    y, x, z = knobs["tile"]
    return (-y * x, -z, y, x)


def rank_tiles(
    m: int, n: int, k: int,
    smem_bytes: int | None = None,
    dtype_bytes: int = 2,
    top: int = 8,
    chip: hardware.Chip = hardware.H100_SXM,
) -> list[dse.Candidate]:
    """The fitting kernel tiles, ascending by model time, deterministically
    tie-broken.  Each ``Candidate.detail`` holds the `tiling.Tile` and the
    model row."""
    budget = smem_bytes if smem_bytes is not None else chip.smem_bytes
    regs = chip.accum_regs_bytes()
    seed = tiling.solve_hopper(budget, dtype_bytes, m=m, n=n, k=k, chip=chip)
    tiles = [t for t in tiling.HOPPER_TILES
             if tiling.hopper_fits(t, dtype_bytes, budget, regs)]
    if seed not in tiles:
        tiles.append(seed)
    ranked = []
    for t in tiles:
        res = cost_model.matmul_time_model(m, n, k, t, chip=chip,
                                           dtype_bytes=dtype_bytes)
        ranked.append(dse.Candidate({"tile": [t.y, t.x, t.z]}, res["time_s"],
                                    {"tile": t, **res}))
    ranked.sort(key=lambda c: (c.score, _tie_break(c.knobs)))
    return ranked[:top]


def _key_fn(problem: dict, dtype: str, backend: str) -> str:
    return f"{problem['m']}x{problem['n']}x{problem['k']}:{dtype}:{backend}"


def _enumerate(problem: dict, dtype_bytes: int, smem_bytes: int | None,
               top: int) -> list[dse.Candidate]:
    m, n, k = problem["m"], problem["n"], problem["k"]
    # Every fitting tile, clamped to the problem (the engine dedupes
    # tiles that small shapes collapse onto one) and re-scored as run.
    out = []
    for c in rank_tiles(m, n, k, smem_bytes=smem_bytes,
                        dtype_bytes=dtype_bytes,
                        top=len(tiling.HOPPER_TILES) + 1):
        t = matmul_ops.clamp_tile(c.detail["tile"], m, n, k)
        res = _cost_fn(problem, {"tile": [t.y, t.x, t.z]}, dtype_bytes)
        out.append(dse.Candidate({"tile": [t.y, t.x, t.z]}, res["time_s"],
                                 {}))
    return out


def _cost_fn(problem: dict, knobs: dict, dtype_bytes: int = 2) -> dict:
    return cost_model.matmul_time_model(
        problem["m"], problem["n"], problem["k"],
        tiling.Tile(*knobs["tile"]), dtype_bytes=dtype_bytes)


def _make_inputs(problem: dict, dtype: torch.dtype, device) -> tuple:
    m, n, k = problem["m"], problem["n"], problem["k"]
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)
    return a, b


def _build_launcher(problem: dict, knobs: dict):
    tile = tiling.Tile(*knobs["tile"])
    return lambda a, b: matmul_ops.matmul(a, b, tile=tile)


def _problem_fn(a, b, bias=None, activation=None, compute_dtype=None,
                out_dtype=None) -> tuple[dict, torch.dtype]:
    m, k = a.shape
    n = b.shape[1]
    return {"m": m, "n": n, "k": k}, compute_dtype or a.dtype


def _run_fn(plan: registry.Plan, a, b, *, bias=None, activation=None,
            compute_dtype=None, out_dtype=None):
    return matmul_ops.matmul(a, b, tile=tiling.Tile(*plan.knobs["tile"]),
                             bias=bias, activation=activation,
                             compute_dtype=compute_dtype, out_dtype=out_dtype)


def _reference_fn(a, b, bias=None, activation=None, compute_dtype=None,
                  out_dtype=None):
    return matmul_ops.matmul(a, b, bias=bias, activation=activation,
                             compute_dtype=compute_dtype, out_dtype=out_dtype)


registry.register(registry.KernelSpec(
    name="matmul",
    key_fn=_key_fn,
    enumerate_candidates=_enumerate,
    cost_fn=_cost_fn,
    make_inputs=_make_inputs,
    build_launcher=_build_launcher,
    reference_fn=_reference_fn,
    problem_fn=_problem_fn,
    run_fn=_run_fn,
    tie_break=_tie_break,
))
