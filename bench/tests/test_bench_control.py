"""The control of each cell's comparison: the reference with every
product's operands in float8 e4m3, in the program's place, has to come
out as not correct.

On the CPU at `conftest.small_cell`'s widths, over 150 served tokens,
the control's widest gap is held to be three times the program's or
more.  On a card (``-m cuda``) every cell runs at its own size on three
seeds, as `bench/calibrate.py` reads them: each program reading within
the cell's limit, each control reading above it."""

import pytest

from bench import calibrate, spec
from conftest import small_cell

CELLS = ["phi3mini-chat", "qwen25-32b-code", "phi3mini-code"]


def test_the_control_reads_wider_than_the_program():
    cell = small_cell("phi3mini-chat")
    cell.workload["check"]["sample_tokens"] = 150
    r = calibrate.readings(cell, 2 ** 31 + 3, 3.0, "cpu")
    assert r["tokens"] >= 150
    assert r["control_gap"] > 0 and \
        r["control_gap"] >= 3 * r["program_gap"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limit_at_the_cell_size(name, cuda_card):
    cell = spec.load(name)
    limit = cell.workload["check"]["logit_gap_limit"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        r = calibrate.readings(cell, seed, 15.0)
        assert r["program_gap"] <= limit < r["control_gap"], r
