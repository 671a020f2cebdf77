"""The port's matmul entry (`kernels/matmul/ops.py`) on the CPU, where it
runs its plain version, against the JAX package's `matmul` on its jnp
path (``use_kernel=False``) and its oracle `matmul_ref`: the shapes and
tiles of the reference's kernel tests, f32 and bf16, every activation
with and without a bias, ``compute_dtype`` and ``out_dtype``.  (The
Pallas kernel does not build on the installed jax, so its oracle and jnp
path are the reference; the CUDA kernel is held to the port's plain
version on the card, in `tests/test_torch_cuda.py`.)

Tolerance, per output row: f32 within 1e-5 of the row's largest |ref|
(summation order); a bf16 output within 2^-7 of it (each side rounds its
f32 result to bf16 once: one bf16 ulp)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.tiling import Tile as JTile  # noqa: E402
from repro.kernels.matmul import matmul as jmatmul  # noqa: E402
from repro.kernels.matmul.ref import matmul_ref as jmatmul_ref  # noqa: E402

from repro_torch.core import tiling  # noqa: E402
from repro_torch.kernels.matmul import ops, ref  # noqa: E402

SHAPES = [(128, 128, 128), (64, 64, 64), (130, 70, 50), (256, 384, 512),
          (8, 8, 8), (1, 128, 256)]
SWEEP_TILES = [(32, 32, 32), (64, 32, 96), (16, 64, 32)]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _both(a, dt):
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _assert_rows_close(ours: torch.Tensor, theirs, out_dt: str):
    want = torch.from_numpy(np.array(jnp.asarray(theirs, jnp.float32)))
    got = ours.float()
    tol = ref.row_tolerance(want, TDT[out_dt])
    err = (got - want).abs()
    assert bool((err <= tol).all()), (
        f"max err {float(err.max())}, worst err/tol "
        f"{float((err / tol).nan_to_num(0.0).max())}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m, n, k", SHAPES)
def test_matmul_matches_the_reference(m, n, k, dt):
    a, b, _ = _inputs(m + n + k, m, n, k)
    ja, ta = _both(a, dt)
    jb, tb = _both(b, dt)
    out = ops.matmul(ta, tb)
    assert out.dtype == TDT[dt] and out.shape == (m, n)
    _assert_rows_close(out, jmatmul(ja, jb, use_kernel=False), dt)
    _assert_rows_close(out, jmatmul_ref(ja, jb), dt)


@pytest.mark.parametrize("tile", SWEEP_TILES)
def test_matmul_tile_sweep_matches_the_reference(tile):
    a, b, _ = _inputs(0, 96, 96, 96)
    out = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     tile=tiling.Tile(*tile))
    _assert_rows_close(out, jmatmul(jnp.asarray(a), jnp.asarray(b),
                                    tile=JTile(*tile), use_kernel=False),
                       "f32")


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "tanh"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_epilogue_matches_the_reference(dt, activation, with_bias):
    a, b, bias = _inputs(5, 70, 90, 40)
    ja, ta = _both(a, dt)
    jb, tb = _both(b, dt)
    jbias = jnp.asarray(bias) if with_bias else None
    tbias = torch.from_numpy(bias) if with_bias else None
    out = ops.matmul(ta, tb, bias=tbias, activation=activation)
    theirs = jmatmul(ja, jb, bias=jbias, activation=activation,
                     use_kernel=False)
    _assert_rows_close(out, theirs, dt)
    if with_bias:                  # a (1, N) bias is the same as (N,)
        torch.testing.assert_close(
            ops.matmul(ta, tb, bias=tbias[None], activation=activation), out,
            rtol=0, atol=0)


@pytest.mark.parametrize("compute, out", [("bf16", None), ("bf16", "f32"),
                                          (None, "bf16"), ("f32", "bf16")])
def test_compute_and_out_dtype_follow_the_reference(compute, out):
    a, b, bias = _inputs(9, 33, 65, 129)
    kw_j = {"compute_dtype": compute and JDT[compute],
            "out_dtype": out and JDT[out]}
    kw_t = {"compute_dtype": compute and TDT[compute],
            "out_dtype": out and TDT[out]}
    theirs = jmatmul(jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
                     activation="silu", use_kernel=False, **kw_j)
    ours = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      bias=torch.from_numpy(bias), activation="silu", **kw_t)
    # out_dtype defaults to A's dtype before the compute_dtype cast
    assert str(ours.dtype).removeprefix("torch.") == str(theirs.dtype)
    _assert_rows_close(ours, theirs, out or "f32")


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the erf form differs by
    more than the f32 tolerance and must fail the comparison."""
    a, b, _ = _inputs(1, 64, 64, 64)
    theirs = jmatmul_ref(jnp.asarray(a), jnp.asarray(b), activation="gelu")
    ours = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      activation="gelu")
    _assert_rows_close(ours, theirs, "f32")
    erf = torch.nn.functional.gelu(torch.from_numpy(a) @ torch.from_numpy(b))
    with pytest.raises(AssertionError):
        _assert_rows_close(erf, theirs, "f32")


def test_bad_operands_are_refused():
    a, b, _ = _inputs(2, 8, 8, 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.matmul(ta, tb[:4])
    with pytest.raises(ValueError, match="activation"):
        ops.matmul(ta, tb, activation="softplus")
    with pytest.raises(ValueError, match="both float32"):
        ops.matmul(ta, tb.bfloat16())
    with pytest.raises(ValueError, match="bias"):
        ops.matmul(ta, tb, bias=torch.zeros(3))


def test_clamp_and_pick_give_built_tiles():
    for m, n, k in SHAPES + [(4096, 4096, 4096), (1, 1, 1)]:
        t = ops.pick_tile(m, n, k)
        assert t in tiling.HOPPER_TILES
        big = tiling.Tile(256, 128, 64)
        c = ops.clamp_tile(big, m, n, k)
        assert c in tiling.HOPPER_TILES
        assert c.y >= min(m, 64) and c.x >= min(n, 64) and c.z >= min(k, 32)
    assert ops.clamp_tile(tiling.Tile(256, 128, 64), 1, 128, 256) == \
        tiling.Tile(64, 128, 64)


def _strided_bf16(offset: int, row: int) -> torch.Tensor:
    """A (64, 64) bf16 view into a wider matrix: ``offset`` elements past
    a 64-byte aligned base, ``row`` elements a row."""
    wide = torch.zeros((64, row + 8), dtype=torch.bfloat16)
    assert wide.data_ptr() % 16 == 0
    return wide[:, offset:offset + 64]


@pytest.mark.parametrize("a, b, want", [
    (torch.zeros((64, 64), dtype=torch.bfloat16),
     torch.zeros((64, 32), dtype=torch.bfloat16), "wgmma+TMA"),
    (_strided_bf16(0, 72), torch.zeros((64, 8), dtype=torch.bfloat16),
     "wgmma+TMA"),                    # 144-byte rows from an aligned base
    (_strided_bf16(4, 72), torch.zeros((64, 8), dtype=torch.bfloat16),
     "mma.sync"),                     # a base 8 bytes past 16
    (torch.zeros((64, 50), dtype=torch.bfloat16),
     torch.zeros((50, 64), dtype=torch.bfloat16), "mma.sync"),   # 100-byte rows
    (torch.zeros((64, 64), dtype=torch.bfloat16),
     torch.zeros((64, 70), dtype=torch.bfloat16), "mma.sync"),   # B's rows
    (torch.zeros((64, 64)), torch.zeros((64, 32)), "cuda cores"),
], ids=["aligned", "aligned_view", "unaligned_view", "a_rows_100_bytes",
        "b_rows_140_bytes", "f32"])
def test_design_routes_by_dtype_and_alignment(a, b, want):
    """`kernel.design` is the one routing decision of B6 on the card:
    bf16 operands TMA can read run wgmma, other bf16 operands mma.sync,
    f32 the CUDA cores; every built tile takes each route."""
    from repro_torch.kernels.matmul import kernel
    for tile in tiling.HOPPER_TILES:
        assert kernel.design(a, b, tile) == want
    assert want in kernel.DESIGNS
