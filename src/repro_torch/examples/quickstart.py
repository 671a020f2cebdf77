"""Quickstart: the paper's design flow, end to end, in five steps, on an
NVIDIA card.  Counterpart of the JAX package's ``examples/quickstart.py``.

1. Describe the machine at SYSTEM level (`ManyCoreConfig`, the paper's
   parameter set: cores, interconnect, local memory, ops, formats).
2. Let the flow derive the communication-minimizing tile plan (eq. 2).
3. Score candidate configurations with the analytical machine model
   via automated DSE.
4. Execute the generated kernels (`autotune.dispatch`: the blocked matmul
   B6 and the ELL SpMV B7/B8 on a card, their plain PyTorch versions on
   the CPU) and check them against the oracles.
5. Print the plan you would deploy.

Run (on a card; ``--device cpu`` runs the plain versions):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cost_model, dse, manycore
from repro_torch.kernels import autotune
from repro_torch.kernels.matmul.ref import matmul_ref, row_tolerance
from repro_torch.kernels.spmv.ops import pack_csr

MATMUL_SHAPE = (256, 192, 128)       # m, k, n of step 4a, as the JAX flow's
SPMV_SHAPE, SPMV_DENSITY = (555, 300), 0.03
SPMV_REL = 1e-5                      # of each row's sum of |products|


def run(device="cuda") -> dict:
    """The five steps on ``device``; prints the flow and returns step 4's
    results: each kernel's largest error against its oracle and whether
    every row lies within its tolerance (the matmul: `row_tolerance`, 1e-5
    of the row's largest |ref| in f32; the SpMV: 1e-5 of the row's sum of
    |products|), with the plans that ran."""
    dev = resolve_device(device)
    # 1. system-level machine description
    mc = manycore.ManyCoreConfig()
    print("=== machine (system-level parameters) ===")
    print(mc.describe())

    # 2. eq.2 tile plan for a dense matmul workload
    m = n = k = 8192
    tile = mc.matmul_tile(m, n, k)
    print(f"\n=== eq.2 tile plan for {m}x{n}x{k} ===\n{tile}")

    # 3. automated DSE over tiles (the paper's manual loop, automated)
    tuned = dse.autotune_matmul_tile(m, n, k)
    res = cost_model.matmul_time_model(m, n, k, tuned)
    print(f"DSE pick: {tuned}  model-efficiency={res['efficiency']:.1%} "
          f"({res['gflops']:.0f} GFLOP/s model)")

    # 4a. the autotuned matmul kernel on a small f32 instance.
    # dispatch("matmul", ...) closes the loop through the KernelSpec
    # registry: rank tiles with the family's cost model, time the top
    # ones on the card, memoize the winner on disk.
    rng = np.random.default_rng(0)
    am, ak, bn = MATMUL_SHAPE
    a = torch.from_numpy(rng.standard_normal((am, ak), np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((ak, bn), np.float32)).to(dev)
    out = autotune.dispatch("matmul", a, b)
    plan = autotune.tune("matmul", {"m": am, "n": bn, "k": ak}, a.dtype,
                         device=dev)
    ref = matmul_ref(a, b)
    mm_err = float((out - ref).abs().max())
    mm_ok = bool(((out - ref).abs() <= row_tolerance(ref, out.dtype)).all())
    print(f"\ntuned matmul vs oracle: max err {mm_err:.2e} "
          f"(tile {plan.knobs['tile']}, source={plan.source})")

    # 4b. the balanced SpMV (paper §V-B)
    rng = np.random.default_rng(0)
    rows, cols_n = SPMV_SHAPE
    dense = ((rng.random((rows, cols_n)) < SPMV_DENSITY)
             * rng.standard_normal((rows, cols_n)))
    nnz_row = (dense != 0).sum(1)
    indptr = np.concatenate([[0], np.cumsum(nnz_row)]).astype(np.int32)
    cols = np.concatenate([np.nonzero(r)[0] for r in dense]).astype(np.int32)
    vals = dense[dense != 0].astype(np.float32)
    mat = pack_csr(indptr, cols, vals, dense.shape, scheme="sorted",
                   device=dev)
    x = rng.standard_normal(cols_n).astype(np.float32)
    y = autotune.dispatch("spmv", mat, torch.from_numpy(x).to(dev))
    splan = autotune.tune("spmv", {"mat": mat}, torch.float32, device=dev)
    y_np = y.cpu().numpy()
    diff = np.abs(y_np - dense @ x)
    sp_err = float(diff.max())
    sp_ok = bool((diff <= SPMV_REL * (np.abs(dense) @ np.abs(x))).all())
    print(f"tuned spmv vs dense: max err {sp_err:.2e}  "
          f"(block_rows={splan.knobs['block_rows']}, "
          f"block_cols={splan.knobs['block_cols']}, "
          f"active/fetched waste {splan.detail['waste']:.2f}x)")

    # 5. the deployable plan
    print("\n=== deploy plan ===")
    print(f"mesh: {dict(zip(mc.mesh_axes, mc.mesh_shape))}")
    print(f"matmul tile: {tuned}; kernels: {', '.join(mc.kernels)}")
    print("dry-run the full production mesh (no card needed): "
          "python -m repro_torch.launch.sweep --mesh both")
    return {"matmul": {"max_abs_err": mm_err, "ok": mm_ok,
                       "tile": list(plan.knobs["tile"]),
                       "source": plan.source},
            "spmv": {"max_abs_err": sp_err, "ok": sp_ok,
                     "block_rows": splan.knobs["block_rows"],
                     "block_cols": splan.knobs["block_cols"],
                     "source": splan.source}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    return 0 if res["matmul"]["ok"] and res["spmv"]["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
