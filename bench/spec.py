"""The benchmark as data: `BENCHMARK.json` and the files it names, found
by name under ``bench/``:

* ``configs/<config>.json``: a model, with its source and its sizes;
* ``traffic/<traffic>.json``: a traffic mix, read by `bench.traffic`,
  with the published length statistics it is set from (``source``) and
  what was changed from them (``fit``);
* ``workloads/<cell>.json``: a cell, the serving set-up (slots, cache)
  it runs the mix on, and its correctness limit;
* ``metrics/<metric>.py``: a metric's reader, ``read(run)``, which
  returns a number or None (nothing to read in this run).

A cell reports the end-to-end metrics (``--trace 0``) or the per-layer
metrics (``--trace 1``) of `BENCHMARK.json` that list it under
``workloads``, or that have no ``workloads`` key.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    mix: dict
    end_to_end: list           # BENCHMARK.json entries this cell reports
    per_layer: list

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for(entries: list, cell: str) -> list:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def load(cell: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``cell`` of ``root``'s BENCHMARK.json."""
    bj = _json(root / "BENCHMARK.json")
    entry = next((w for w in bj["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bj['workloads']]}")
    workload = _json(BENCH / "workloads" / f"{cell}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{cell}: workload file's {key} "
                             f"{workload[key]!r} is not BENCHMARK.json's "
                             f"{entry[key]!r}")
    return Cell(cell, int(entry["chips"]), workload,
                _json(BENCH / "configs" / f"{entry['config']}.json"),
                _json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                _for(bj["end_to_end"], cell), _for(bj["per_layer"], cell))


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
