"""The kernel report of the paper's slice on the H100: one command for
Table I, Table II, the attention rows and the bandwidth rows.
Counterpart of ``benchmarks/run.py`` of the JAX package.

Prints ``name,us_per_call,derived`` CSV lines (``table1.*``,
``table2.*``, ``attn.*``, ``bandwidth.*``, and ``roofline.*`` from the
dry-run records under ``build/dryrun/`` (`roofline_report`; none when
there are none, as in the JAX package)) and writes
the machine-readable report to ``--out``: this package's own file, never
the root ``BENCH_kernels.json`` of the JAX benchmarks.  Its keys are the
JAX report's, so ``tools/check_bench.py`` gates it unchanged:

- ``matmul_tuned_vs_fixed``, ``spmv_tuned``: Table I's tuned-vs-eq. 2
  rows and Table II's tuned plans (`table1_matmul.tuned_vs_fixed`,
  `table2_spmv.tuned_records`).
- ``matmul_measured``: B6 at 8192^3 in bf16 with the tuned tile.  Its
  ``mxu_*`` keys, named for the TPU's 128^3 tile in the JAX report, hold
  B6 at the fixed tile its callers ran before the tuner
  (`table1_matmul.FIXED_TILE`), timed on the card.
- the attention rows of `attention_prefill`.

The report tunes in a throwaway cache unless ``$REPRO_TORCH_AUTOTUNE_CACHE``
is set.  On the card it measures at full Qwen3-14B shapes; with
``--device cpu`` it measures nothing (times are None, rows say
``"measured": false``) and runs the rows at the ``--smoke`` shapes, which
also keep a card run short.

    python -m repro_torch.benchmarks.run --out report.json \\
        [--device cuda|cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import os
import platform
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.core import ioutil
from repro_torch.kernels import autotune

BENCH_SCHEMA = 3

# Small shapes every kernel of the card takes (B5: head_dim 16 on the
# mma.sync tile of 64; B1 and B3: head_dim 80), so a smoke run holds the
# report's counts: four q blocks give kstep_speedup 1.6, ragged lengths a
# fetched_speedup of 2.
SMOKE_ATTN_MEASURED = dict(seq=256, hq=2, hkv=1, dh=16)
SMOKE_CAUSAL_SKIP = dict(seq=256, hq=2, hkv=1, dh=16)
SMOKE_DECODE = dict(b=1, hq=4, hkv=2, dh=80, cache_len=256)
SMOKE_RAGGED = dict(b=2, hq=4, hkv=2, dh=80, cache_len=128, block_k=32)
SMOKE_INT8 = dict(b=1, hq=4, hkv=2, dh=80, cache_len=256)
MATMUL_MEASURED_SHAPE = (8192, 8192, 8192)


def matmul_measured_row(measured: list[dict] | None) -> dict:
    """The report's ``matmul_measured`` row from
    `table1_matmul.tuned_vs_fixed_measured`'s records (None: nothing was
    measured), the fixed tile's numbers under the JAX report's ``mxu_*``
    keys."""
    from repro_torch.benchmarks import table1_matmul as table1
    if measured is None:
        fixed = table1.FIXED_TILE
        return {"shape": list(MATMUL_MEASURED_SHAPE), "tuned_tile": None,
                "tuned_source": None, "tuned_us": None,
                "mxu_tile": [fixed.y, fixed.x, fixed.z], "mxu_us": None,
                "speedup_vs_mxu": None, "eq2_tile": None, "eq2_us": None,
                "speedup_vs_eq2": None, "measured": False}
    r = next(r for r in measured
             if tuple(r["shape"]) == MATMUL_MEASURED_SHAPE)
    return {"shape": r["shape"], "tuned_tile": r["tuned_tile"],
            "tuned_source": r["tuned_source"], "tuned_us": r["tuned_us"],
            "mxu_tile": r["fixed_tile"], "mxu_us": r["fixed_us"],
            "speedup_vs_mxu": r["speedup_vs_fixed"],
            "eq2_tile": r["eq2_tile"], "eq2_us": r["eq2_us"],
            "speedup_vs_eq2": r["speedup_vs_eq2"], "measured": True}


def attention_rows(device, smoke: bool) -> dict:
    """The six attention rows, at the smoke shapes where ``smoke``."""
    from repro_torch.benchmarks import attention_prefill as attn

    def kw(shapes):
        return shapes if smoke else {}
    return {
        "attention_tuned_vs_fixed": attn.tuned_vs_fixed(device),
        "attention_measured": attn.tuned_vs_fixed_measured(
            device, **kw(SMOKE_ATTN_MEASURED)),
        "attention_causal_skip": attn.causal_skip_measured(
            device, **kw(SMOKE_CAUSAL_SKIP)),
        "attention_decode": attn.decode_step_measured(
            device, **kw(SMOKE_DECODE)),
        "decode_ragged": attn.decode_ragged_measured(
            device, **kw(SMOKE_RAGGED)),
        "decode_int8": attn.decode_int8_measured(device, **kw(SMOKE_INT8)),
    }


def kernel_report(device="cuda", *, smoke: bool = False, tuned_recs=None,
                  matmul_measured=None, spmv_recs=None,
                  attention=None) -> dict:
    """The report.  ``tuned_recs``, ``matmul_measured`` (the records of
    `table1_matmul.tuned_vs_fixed_measured`), ``spmv_recs`` and
    ``attention`` (`attention_rows`) are taken as given where a caller has
    made them, and made here otherwise."""
    from repro_torch.benchmarks import table1_matmul as table1
    from repro_torch.benchmarks import table2_spmv as table2
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if tuned_recs is None:
        tuned_recs = table1.tuned_vs_fixed(device)
    if matmul_measured is None and on_card:
        matmul_measured = table1.tuned_vs_fixed_measured(
            device, shapes=[MATMUL_MEASURED_SHAPE])
    if spmv_recs is None:
        spmv_recs = table2.tuned_records(device)
    if attention is None:
        attention = attention_rows(device, smoke or not on_card)
    return {
        "schema": BENCH_SCHEMA,
        "backend": (f"cuda:{torch.cuda.get_device_name(device)}" if on_card
                    else "cpu"),
        "host": platform.machine(),
        "matmul_tuned_vs_fixed": tuned_recs,
        "matmul_measured": matmul_measured_row(matmul_measured),
        "spmv_tuned": spmv_recs,
        **attention,
    }


def csv_lines(report: dict, device) -> list[str]:
    """The CSV lines of a report (Table II's rows are timed again)."""
    from repro_torch.benchmarks import attention_prefill as attn
    from repro_torch.benchmarks import bandwidth_extrapolation as bandwidth
    from repro_torch.benchmarks import roofline_report
    from repro_torch.benchmarks import table2_spmv as table2
    lines = []
    for r in report["matmul_tuned_vs_fixed"]:
        m, n, k = r["shape"]
        lines.append(
            f"table1.tuned_m{m}n{n}k{k},{r['tuned_measured_us'] or 0.0:.1f},"
            f"speedup_model={r['speedup_model']:.3f};"
            f"tile={'/'.join(map(str, r['tuned_tile']))};"
            f"src={r['tuned_source']}")
    lines += table2.main(["--device", str(device)])
    lines += attn.main(
        ["--device", str(device)], report["attention_tuned_vs_fixed"],
        report["attention_measured"], report["attention_causal_skip"],
        report["attention_decode"], report["decode_ragged"],
        report["decode_int8"])
    lines += bandwidth.main()
    try:
        lines += roofline_report.main()
    except Exception as e:  # the dry-run records may be unreadable
        lines.append(f"roofline.unavailable,0.0,{e!r}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="path of the machine-readable kernel report")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="small measured shapes (the full report's keys)")
    args = ap.parse_args(argv)
    # The report describes the code under test, not an earlier run's
    # tuning: a fresh cache unless the caller pinned one.
    if autotune.CACHE_ENV not in os.environ:
        os.environ[autotune.CACHE_ENV] = os.path.join(
            tempfile.mkdtemp(prefix="repro-torch-bench-"), "autotune.json")
    device = resolve_device(args.device)
    report = kernel_report(device, smoke=args.smoke)
    print("name,us_per_call,derived")
    for line in csv_lines(report, device):
        print(line)
    ioutil.atomic_write_json(args.out, report)
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
