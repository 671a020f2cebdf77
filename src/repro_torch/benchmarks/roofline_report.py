"""Roofline report: aggregates the dry run's ``build/dryrun/*.json``
(`launch.dryrun`, `launch.sweep`) into the §Roofline table (per arch x
shape: 3 terms, dominant, useful fraction, fix note) and the
``roofline.*`` CSV lines.  Counterpart of the JAX package's root
``benchmarks/roofline_report.py``, with the same lines.

Every number in it is a model of the H100 SXM data sheet (989 bf16
TFLOP/s, 3.35 TB/s, NVLink's 450 GB/s for every collective), applied to
the counts of rank 0's traced program: nothing here is measured.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.dryrun import ARTIFACTS

FIX_NOTES = {
    "compute": "raise per-card utilization: tensor-core tiles (wgmma), "
               "fewer remat recompute flops, larger per-card batch",
    "memory": "cut HBM traffic: fuse (flash/xent kernels), bf16 streams, "
              "reuse-friendly tiling (eq.2) in shared memory",
    "collective": "cut NVLink bytes: sequence-parallel reduce-scatter "
                  "instead of all-reduce, bf16 grad sync, overlap a2a with "
                  "expert compute",
}


def load(mesh: str = "single", directory: Path | None = None):
    """The records of ``mesh`` in ``directory`` (by default the dry
    run's ``ARTIFACTS``)."""
    directory = ARTIFACTS if directory is None else directory
    rows = []
    for f in sorted(directory.glob(f"*__{mesh}.json")):
        rec = json.loads(f.read_text())
        rows.append(rec)
    return rows


def markdown_table(mesh: str = "single",
                   directory: Path | None = None) -> str:
    rows = load(mesh, directory)
    out = ["| arch | shape | compute(s) | memory(s) | collective(s) | "
           "dominant | MODEL/HLO | MFU bound | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for rec in rows:
        if rec.get("status") == "skipped":
            out.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                       f"skipped | — | — | {rec['reason']} |")
            continue
        if rec.get("status") != "ok" or "roofline" not in rec:
            out.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                       f"ERROR | — | — | {rec.get('error', '?')[:60]} |")
            continue
        r = rec["roofline"]
        out.append(
            f"| {rec['arch']} | {rec['shape']} | {r['compute_s']:.4g} | "
            f"{r['memory_s']:.4g} | {r['collective_s']:.4g} | "
            f"{r['dominant']} | {r['useful_fraction']:.2f} | "
            f"{r['mfu_bound']:.3f} | {FIX_NOTES[r['dominant']][:52]} |")
    return "\n".join(out)


def csv_lines(mesh: str = "single", directory: Path | None = None):
    lines = []
    for rec in load(mesh, directory):
        if rec.get("status") != "ok" or "roofline" not in rec:
            continue
        r = rec["roofline"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        lines.append(
            f"roofline.{rec['arch']}.{rec['shape']}.{mesh},"
            f"{bound * 1e6:.1f},"
            f"dominant={r['dominant']};mfu_bound={r['mfu_bound']:.3f};"
            f"useful={r['useful_fraction']:.2f}")
    return lines


def main():
    return csv_lines("single")


if __name__ == "__main__":
    print(markdown_table("single"))
