"""Shared fixtures of the benchmark's tests.  They run on the CPU with

    PYTHONPATH=src python -m pytest -q bench/tests

from the root of the repository; the tests marked ``cuda`` need a card
and skip without one (``-m cuda`` runs only them)."""

import copy
import sys
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped on hosts without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# SMOKE widths of the two configurations (the sizes of
# repro_torch.configs.phi3_mini_3_8b.SMOKE and qwen2_5_32b.SMOKE).
SMOKE = {
    "phi3_mini_3_8b": dict(hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=4, head_dim=16,
                           vocab_size=128),
    "qwen2_5_32b": dict(hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16,
                        vocab_size=128),
}


@pytest.fixture(autouse=True)
def _environment(tmp_path, monkeypatch):
    """The tuner's cache in the test's own directory, and a card's
    one-rank NCCL group off /dev/shm, as `bench/run.py` sets them."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("NCCL_SHM_DISABLE", "1")


def small_cell(name: str):
    """The cell ``name`` of BENCHMARK.json cut to run on the CPU in
    seconds, with its own correctness limit: 4 layers 256 wide (8 heads
    of 32; the configuration's KV grouping, 8 or 2 KV heads), a
    vocabulary of 1,024, 4 slots, prompts of 8-24 and outputs of 16-32
    tokens, 100 served tokens sought and 60 needed.  At the SMOKE widths
    a model's tokens hardly depend on their context, and a lost cache
    row would pass."""
    from bench import spec
    cell = copy.deepcopy(spec.load(name))
    g = (cell.config["num_attention_heads"]
         // cell.config["num_key_value_heads"])
    cell.config.update(hidden_size=256, intermediate_size=512,
                       num_hidden_layers=4, num_attention_heads=8,
                       num_key_value_heads=8 // min(g, 4), head_dim=32,
                       vocab_size=1024)
    cell.mix.update(clients=4, prompt={"kind": "uniform", "lo": 8, "hi": 24},
                    output={"kind": "uniform", "lo": 16, "hi": 32})
    cell.workload.update(slots=4, max_len=60, trace_seconds=1)
    cell.workload["check"].update(sample_tokens=100, min_tokens=60)
    return cell
