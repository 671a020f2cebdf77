"""`repro_torch.runtime.quantize` against `repro.runtime.quantize`.

Codes and scales must be equal bit for bit (tolerance 0): resume and
snapshot parity rest on them.  The rows mix ordinary values, zero rows,
one-element outliers and exact .5 ties, in f32 and in bf16.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.runtime import quantize as jq  # noqa: E402
from repro_torch.runtime import quantize as tq  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rows(seed, dh=16, tiny=True):
    """``tiny`` adds a row whose scale falls below SCALE_FLOOR: its codes
    round to 0, outside the round-trip and idempotence laws, which hold
    for rows of scale at least the floor."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 2, dh)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # a zero row
    x[0, 1, 1, 3] = 1e4                                # an outlier
    if tiny:
        x[1, 2, 0] *= 1e-30
    ties = np.zeros(dh, np.float32)                    # scale exactly 1:
    ties[:8] = [127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]
    x[2, 3, 1] = ties                                  # .5 ties to even
    return x


def _both(x, dt):
    jx = jnp.asarray(x, JDT[dt])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dt])
    return jx, tx


@pytest.mark.parametrize("dt", list(TDT))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codes_and_scales_bit_equal(seed, dt):
    jx, tx = _both(_rows(seed), dt)
    jcodes, jscale = jq.quantize_rows(jx)
    tcodes, tscale = tq.quantize_rows(tx)
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy().view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))


def test_ties_round_half_to_even_and_zero_rows_stay_zero():
    _, tx = _both(_rows(0), "f32")
    codes, scale = tq.quantize_rows(tx)
    assert codes[2, 3, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]
    assert float(scale[2, 3, 1]) == 1.0
    assert not codes[0, 0, 0].any() and float(scale[0, 0, 0]) == 0.0
    assert codes[0, 1, 1].abs().max() == 127          # the outlier row
    assert codes[0, 1, 0].abs().max() == 127          # its neighbour keeps
    assert (codes.abs() <= tq.QMAX).all()             # full resolution


@pytest.mark.parametrize("dt", list(TDT))
def test_dequantize_bit_equal(dt):
    jx, tx = _both(_rows(3), dt)
    jd = jq.dequantize_rows(*jq.quantize_rows(jx))
    td = tq.dequantize_rows(*tq.quantize_rows(tx))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_requantize_is_idempotent():
    _, tx = _both(_rows(4, tiny=False), "f32")
    codes, scale = tq.quantize_rows(tx)
    again, scale2 = tq.quantize_rows(tq.dequantize_rows(codes, scale))
    assert torch.equal(again, codes) and torch.equal(scale2, scale)


def test_round_trip_error_within_half_a_step():
    _, tx = _both(_rows(5, tiny=False), "f32")
    err = (tq.dequantize_rows(*tq.quantize_rows(tx)) - tx).abs()
    bound = tq.max_abs_error_bound(tx)[..., None]
    assert (err <= bound * (1 + 1e-6) + 1e-30).all()
    np.testing.assert_array_equal(
        bound[..., 0].numpy(), np.asarray(jq.max_abs_error_bound(
            jnp.asarray(tx.numpy()))))


def test_zeros_and_bytes_per_token_match():
    tcodes, tscale = tq.quantized_zeros((2, 3, 4, 16))
    jcodes, jscale = jq.quantized_zeros((2, 3, 4, 16))
    assert tcodes.shape == jcodes.shape and tscale.shape == jscale.shape
    assert tcodes.dtype == torch.int8 and not tcodes.any()
    assert not tscale.any()
    assert tq.bytes_per_token(128) == jq.bytes_per_token(128) == 264
    assert tq.QMAX == jq.QMAX and tq.SCALE_FLOOR == jq.SCALE_FLOOR
