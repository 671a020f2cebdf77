"""`chip_smoke.py` on a host without a card: its per-row tolerance check
and its refusal to run.  The script itself drives the card."""

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from repro_torch.kernels.attention import decode  # noqa: E402


def _bf16_case():
    rng = torch.Generator().manual_seed(0)
    q = torch.randn((3, 4, 16), generator=rng).bfloat16()
    k = torch.randn((3, 40, 2, 16), generator=rng).bfloat16()
    v = torch.randn((3, 40, 2, 16), generator=rng).bfloat16()
    v[:, :1] *= 50                      # row 1 (length 1) has a large scale
    lengths = torch.tensor([0, 1, 40])
    return decode.decode_ref(q, k, v, length=lengths), lengths


def test_row_errors_hold_each_row_to_its_own_scale():
    """An error of 2 % of a long row's own size fails, although it is far
    below 2^-7 of the length-1 row's larger outputs."""
    ref, _ = _bf16_case()
    assert chip_smoke.row_errors(torch, ref, ref, False) == (0.0, 0.0)
    long_row = float(ref[2, 1].float().abs().max())
    assert long_row * 0.02 < 2.0 ** -7 * float(ref.float().abs().max())
    bad = ref.clone()
    bad[2, 1, 3] += 0.02 * long_row
    _, ratio = chip_smoke.row_errors(torch, bad, ref, False)
    assert ratio > 1


def test_row_errors_require_exact_zeros_for_length_0():
    ref, lengths = _bf16_case()
    assert lengths[0] == 0 and not ref[0].any()
    bad = ref.clone()
    bad[0, 0, 0] = 1e-3
    assert chip_smoke.row_errors(torch, bad, ref, False)[1] > 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card exit")
def test_chip_smoke_refuses_a_host_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
