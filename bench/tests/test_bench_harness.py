"""Whole runs on the CPU at SMOKE widths: the harness's look for a card
is skipped, the rest of a run is driven, and ``correct`` is decided by
the cell's own limit.  A sound run passes; each fault a serving cell can
have, planted in the program underneath the timed path, fails."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, spec
from conftest import ROOT, small_cell

CELLS = ["phi3mini-chat", "qwen25-32b-code", "phi3mini-code"]
SEED = 2 ** 31 + 77


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 5.0, trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 4 and out["failed"] == 0
    assert set(out["metrics"]) == {
        e["name"] for e in small_cell(name).end_to_end}


def test_a_traced_run_reports_the_per_layer_metrics():
    out = _run(small_cell("phi3mini-code"), trace=True)
    assert out["correct"], out["checks"]
    assert {"admit_pad_share", "admit_ms", "decode_step_ms",
            "device_idle_share"} <= set(out["metrics"])
    # no peak is known for the CPU, and the allocator's peak is the
    # card's: nothing to read
    assert not {"serve_mfu", "b1_roofline", "peak_hbm_gb"} & \
        set(out["metrics"])
    # the trace lasts trace_seconds from the profiler's start, and the
    # steps under it are priced apart
    assert out["device"]["window_s"] >= 0.9
    assert out["window"]["traced_decode_ms_mean"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_tokens(monkeypatch):
    """A served token altered where it is produced."""
    from repro_torch.launch.serve import Server
    orig = Server.decode_step

    def decode_step(self, *a, **k):
        nxt, done, bad = orig(self, *a, **k)
        return (nxt + 1) % self.cfg.vocab_size, done, bad
    monkeypatch.setattr(Server, "decode_step", decode_step)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the cache as it found it."""
    from repro_torch.models import layers
    orig = layers._write_cache

    def write(c, new, t_abs, ok):
        if t_abs.shape[1] != 1:
            orig(c, new, t_abs, ok)
    monkeypatch.setattr(layers, "_write_cache", write)


def _half_batch(monkeypatch):
    """Half of the slots left out of each forward, their tokens taken
    from the rest of the computation as if they had run."""
    from repro_torch.launch.serve import Server
    orig = Server._step

    def step(self, tokens, active, *a, **k):
        active = np.array(active, copy=True)
        active[self.batch // 2:] = False
        return orig(self, tokens, active, *a, **k)
    monkeypatch.setattr(Server, "_step", step)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    out = _run(small_cell(name))
    assert not out["correct"], out["checks"]
    gap = out["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_fails_at_the_cell_size(name, cuda_card,
                                                        monkeypatch):
    """The cell at its own size and window on the card, with half of its
    slots left out of each forward: the sample holds finished requests
    of a quarter of the slots or more, and ``correct`` comes out
    false."""
    _half_batch(monkeypatch)
    cell = spec.load(name)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    out = harness.run_cell(cell, SEED + 5, seconds, False)
    print(name, out["checks"], out["window"])
    assert out["window"]["slots_compared"] >= cell.workload["slots"] // 4
    assert not out["correct"], out["checks"]
    gap = out["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_without_a_card_run_prints_no_result(tmp_path):
    """On a host with no card (this one), and in a directory holding only
    BENCHMARK.json and bench/, the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                            "phi3mini-chat", "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("cache,kv_dtype", [("paged", "bfloat16"),
                                            ("contiguous", "int8")])
def test_a_cell_of_another_cache_layout_is_data_only(cache, kv_dtype):
    """A later cell on the paged or the int8 cache is a workload file:
    the harness builds that server and drives it as any other."""
    cell = small_cell("phi3mini-chat")
    cell.workload.update(cache=cache, kv_dtype=kv_dtype, page_size=4)
    out = _run(cell)
    assert out["checks"]["tokens_compared"]["value"] >= 60
    assert out["failed"] == 0 and out["metrics"]["output_tok_s"]["value"] > 0
