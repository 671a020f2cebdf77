"""The paper's Table I on the H100: blocked dense matmul against its
configuration.  Counterpart of ``benchmarks/table1_matmul.py`` of the JAX
package.

The paper sweeps the many-core configuration (cores, local memory) and
reports cycles, GFLOP/s and efficiency from its machine model.  Here the
configuration axis is the shared-memory budget a tile may take (the
paper's local memory ``L``; `core.tiling.solve_hopper` picks the tile),
scored by `core.cost_model.matmul_time_model` for the H100
(`rows`).  The tuner is held against the fixed eq. 2 tile at the
Table-1 shapes (`tuned_vs_fixed`), and on the card the kernel B6
(``csrc/blocked_matmul.cu``) is timed at those shapes
(`tuned_vs_fixed_measured`) and checked against its plain version
(`kernel_check`).

    python -m repro_torch.benchmarks.table1_matmul [--device cuda|cpu]

prints ``table1.*`` CSV lines; ``--device cpu`` prints the model rows and
the model-ranked plans only, since nothing on the CPU measures the
kernel.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import resolve_device
from repro_torch.core import cost_model, dse, hardware, tiling
from repro_torch.kernels import autotune, registry
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.matmul import ref as matmul_ref

# The paper's Table-I problem sizes, as the JAX package scaled them.
TABLE1_SHAPES = [(4096, 4096, 4096), (8192, 8192, 8192),
                 (16384, 16384, 16384), (8192, 2048, 8192)]
# (shared-memory budget in KB, n): small budgets reproduce the paper's
# regime where traffic eats into efficiency; 227 KB is a block's all.
SMEM_SWEEP = [(16, 4096), (32, 4096), (48, 4096), (64, 4096), (96, 8192),
              (128, 8192), (227, 8192), (227, 16384)]
# The fixed tile callers used before the tuner, the baseline of the
# measured comparison beside the eq. 2 tile.
FIXED_TILE = tiling.Tile(128, 128, 32)


def rows(chip: hardware.Chip = hardware.H100_SXM) -> list[dict]:
    """Model rows of the shared-memory sweep, and the DSE point."""
    out = []
    for kb, n in SMEM_SWEEP:
        t = tiling.solve_hopper(smem_bytes=kb * 1024, m=n, n=n, k=n,
                                chip=chip)
        res = cost_model.matmul_time_model(n, n, n, t, chip=chip)
        out.append({
            "name": f"matmul_n{n}_smem{kb}KB",
            "tile": f"y{t.y}/x{t.x}/z{t.z}",
            "gflops_model": res["gflops"],
            "efficiency": res["efficiency"],
            "time_model_s": res["time_s"],
        })
    t = dse.autotune_matmul_tile(8192, 8192, 8192)
    res = cost_model.matmul_time_model(8192, 8192, 8192, t, chip=chip)
    out.append({
        "name": "matmul_n8192_dse",
        "tile": f"y{t.y}/x{t.x}/z{t.z}",
        "gflops_model": res["gflops"],
        "efficiency": res["efficiency"],
        "time_model_s": res["time_s"],
    })
    return out


def tuned_vs_fixed(device="cuda", cache: autotune.TuneCache | None = None,
                   measure_k: int = 3) -> list[dict]:
    """The tuner against the fixed eq. 2 tile (`solve_hopper`) at the
    Table-1 shapes in bf16, both scored by the same model.  A plan ranked
    by the model contains the eq. 2 tile, so ``speedup_model >= 1``; a
    plan measured on the card may trade model time for real time, and
    then its ``tuned_measured_us`` is the evidence."""
    recs = []
    spec = registry.get("matmul")
    for m, n, k in TABLE1_SHAPES:
        fixed = tiling.solve_hopper(m=m, n=n, k=k)
        fixed_res = cost_model.matmul_time_model(m, n, k, fixed)
        problem = {"m": m, "n": n, "k": k}
        plan = autotune.tune("matmul", problem, torch.bfloat16,
                             device=device, measure_k=measure_k, cache=cache)
        tuned_res = spec.cost_fn(problem, plan.knobs)
        recs.append({
            "shape": [m, n, k],
            "key": plan.key,
            "fixed_tile": [fixed.y, fixed.x, fixed.z],
            "tuned_tile": list(plan.knobs["tile"]),
            "tuned_source": plan.source,
            "tuned_measured_us": plan.measured_us,
            "gflops_fixed_model": fixed_res["gflops"],
            "gflops_tuned_model": tuned_res["gflops"],
            "speedup_model": fixed_res["time_s"] / tuned_res["time_s"],
        })
    return recs


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("this measures the kernel on the card; the CPU "
                           "runs only its plain version")
    return device


def _operands(m: int, n: int, k: int, dtype, device, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)
    return a, b


def tuned_vs_fixed_measured(device="cuda",
                            cache: autotune.TuneCache | None = None,
                            shapes=TABLE1_SHAPES, reps: int = 5) -> list[dict]:
    """B6 timed on the card at each shape in bf16 with the tuned tile, the
    eq. 2 tile and `FIXED_TILE`, one slot per distinct tile (a baseline
    equal to the tuned tile shares its number), each the mean of ``reps``
    calls between CUDA events; measured TFLOP/s beside the model's."""
    device = _card(device)
    out = []
    for m, n, k in shapes:
        a, b = _operands(m, n, k, torch.bfloat16, device)
        plan = autotune.tune("matmul", {"m": m, "n": n, "k": k},
                             torch.bfloat16, device=device, cache=cache)
        tuned = tiling.Tile(*plan.knobs["tile"])
        baselines = {"eq2": matmul_ops.clamp_tile(
            tiling.solve_hopper(m=m, n=n, k=k), m, n, k),
            "fixed": FIXED_TILE}
        slots = {tuned: None}
        for t in baselines.values():
            slots.setdefault(t, None)
        for t in slots:
            slots[t] = autotune.measure(
                lambda t=t: matmul_ops.matmul(a, b, tile=t), device,
                reps=reps)
        flops = 2.0 * m * n * k
        model = cost_model.matmul_time_model(m, n, k, tuned)
        rec = {"shape": [m, n, k], "tuned_tile": [tuned.y, tuned.x, tuned.z],
               "tuned_source": plan.source, "tuned_us": slots[tuned],
               "tflops_measured": flops / slots[tuned] / 1e6,
               "tflops_model": model["gflops"] / 1e3}
        for name, t in baselines.items():
            rec[f"{name}_tile"] = [t.y, t.x, t.z]
            rec[f"{name}_us"] = slots[t]
            rec[f"speedup_vs_{name}"] = slots[t] / slots[tuned]
        out.append(rec)
        del a, b
    return out


def kernel_check(device="cuda", shape=(4096, 4096, 4096),
                 cache: autotune.TuneCache | None = None,
                 reps: int = 5) -> dict:
    """B6 with its tuned tile (`autotune.tune`, measured on the card)
    against `matmul_ref` on the card, in bf16: the largest error over its
    per-row tolerance (`ref.row_tolerance`), and microseconds per call."""
    device = _card(device)
    m, n, k = shape
    a, b = _operands(m, n, k, torch.bfloat16, device)
    plan = autotune.tune("matmul", {"m": m, "n": n, "k": k}, torch.bfloat16,
                         device=device, cache=cache)
    tile = tiling.Tile(*plan.knobs["tile"])
    out = matmul_ops.matmul(a, b, tile=tile)
    want = matmul_ref.matmul_ref(a, b)
    err = (out.float() - want.float()).abs()
    ratio = (err / matmul_ref.row_tolerance(want, out.dtype)).nan_to_num(0.0)
    us = autotune.measure(lambda: matmul_ops.matmul(a, b, tile=tile),
                          device, reps=reps)
    return {"name": f"matmul_kernel_check_{m}x{n}x{k}", "us_per_call": us,
            "tile": [tile.y, tile.x, tile.z], "max_err": float(err.max()),
            "max_err_over_tol": float(ratio.max())}


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []
    for r in rows():
        lines.append(
            f"table1.{r['name']},{r['time_model_s'] * 1e6:.1f},"
            f"eff={r['efficiency']:.3f};gflops={r['gflops_model']:.0f};"
            f"tile={r['tile']}")
    for r in tuned_vs_fixed(device):
        m, n, k = r["shape"]
        lines.append(
            f"table1.tuned_m{m}n{n}k{k},{r['tuned_measured_us'] or 0.0:.1f},"
            f"speedup_model={r['speedup_model']:.3f};"
            f"tile={'/'.join(map(str, r['tuned_tile']))};"
            f"src={r['tuned_source']}")
    if device.type == "cuda":
        for r in tuned_vs_fixed_measured(device):
            m, n, k = r["shape"]
            lines.append(
                f"table1.measured_m{m}n{n}k{k},{r['tuned_us']:.1f},"
                f"tflops={r['tflops_measured']:.1f};"
                f"tflops_model={r['tflops_model']:.1f};"
                f"speedup_vs_eq2={r['speedup_vs_eq2']:.3f};"
                f"speedup_vs_fixed={r['speedup_vs_fixed']:.3f}")
        kc = kernel_check(device)
        lines.append(f"table1.{kc['name']},{kc['us_per_call']:.1f},"
                     f"max_err={kc['max_err']:.2e};"
                     f"err_over_tol={kc['max_err_over_tol']:.3f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main(sys.argv[1:])))
