"""The port's Table I and Table II benchmarks on the CPU
(``--device cpu``): the model rows, the tuner against the fixed eq. 2
tile, one Table-II row per matrix, the tuned plans, and the stable
synthesis of the Table-II matrices across processes.  What measures the
kernels refuses the CPU."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import table1_matmul, table2_spmv  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def cache(tmp_path):
    return autotune.TuneCache(tmp_path / "autotune.json")


def test_table1_rows_sweep_the_shared_memory_budget():
    rows = table1_matmul.rows()
    assert len(rows) == len(table1_matmul.SMEM_SWEEP) + 1
    for r in rows:
        assert 0 < r["efficiency"] <= 1 and r["gflops_model"] > 0
    # more shared memory never moves more bytes at one n
    by_n = {}
    for (kb, n), r in zip(table1_matmul.SMEM_SWEEP, rows):
        by_n.setdefault(n, []).append(r["time_model_s"])
    assert all(t == sorted(t, reverse=True) for t in by_n.values())


def test_table1_tuned_is_never_worse_than_eq2_under_the_model(cache):
    recs = table1_matmul.tuned_vs_fixed(device="cpu", cache=cache)
    assert [r["shape"] for r in recs] == \
        [list(s) for s in table1_matmul.TABLE1_SHAPES]
    for r in recs:
        assert r["speedup_model"] >= 1
        assert r["tuned_source"] == "model" and r["key"].endswith(":cpu:vdflt")


def test_table1_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU refusal")
    for fn in (table1_matmul.tuned_vs_fixed_measured,
               table1_matmul.kernel_check):
        with pytest.raises(RuntimeError):
            fn(device="cpu")


def test_table1_main_prints_its_lines(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "c.json"))
    lines = table1_matmul.main(["--device", "cpu"])
    assert len(lines) == len(table1_matmul.SMEM_SWEEP) + 1 + len(
        table1_matmul.TABLE1_SHAPES)
    assert all(line.startswith("table1.") for line in lines)


@pytest.mark.parametrize("name", list(table2_spmv.MATRICES))
def test_table2_bench_one_on_the_cpu(name, cache):
    r = table2_spmv.bench_one(name, device="cpu", reps=1, cache=cache)
    nnz, m, _ = table2_spmv.MATRICES[name]
    assert r["m"] == m and r["device"] == "cpu"
    assert abs(r["nnz"] - nnz) <= m           # rounding of per-row counts
    assert r["err"] < 1e-3
    assert r["base_us"] > 0 and r["hw_us"] > 0
    assert 0.25 <= r["rr_max_frac"] < 0.3 and r["lpt_max_frac"] >= 0.25
    assert r["sliced_sorted"] <= r["sliced_rr"] + 1e-12
    assert r["ell_waste"] >= 1


def test_table2_tuned_records_on_the_cpu(cache):
    recs = table2_spmv.tuned_records(device="cpu", cache=cache)
    assert [r["matrix"] for r in recs] == list(table2_spmv.MATRICES)
    for r in recs:
        assert r["source"] == "model" and r["block_cols"] is None
    assert recs[0]["blocked_vs_resident_err"] < 1e-4


def test_table2_synthesis_is_the_same_in_two_processes():
    code = ("import hashlib, json\n"
            "from repro_torch.benchmarks import table2_spmv as t\n"
            "print(json.dumps({n: hashlib.sha1(b''.join(a.tobytes() for a in "
            "t.synthesize(n)[:3])).hexdigest() for n in t.MATRICES}))")
    digests = [json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120, env={"PYTHONPATH": str(SRC),
                                      "PYTHONHASHSEED": seed}).stdout)
        for seed in ("1", "2")]
    assert digests[0] == digests[1]


def test_synthesize_large_statistics_at_a_small_size():
    indptr, indices, data, shape = table2_spmv.synthesize_large(
        5000, 700, 1, 96, seed=3)
    per_row = np.diff(indptr)
    assert shape == (5000, 700) and len(per_row) == 5000
    assert per_row.min() >= 1 and per_row.max() <= 96
    assert abs(per_row.mean() - 48.5) < 1.5
    assert indptr[-1] == len(indices) == len(data)
    assert indices.min() >= 0 and indices.max() < 700
    rows = np.repeat(np.arange(5000), per_row)
    assert len(np.unique(rows.astype(np.int64) * 700 + indices)) == \
        len(indices)                           # distinct within each row
    a = table2_spmv.synthesize_large(300, 500, seed=4)
    b = table2_spmv.synthesize_large(300, 500, seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
