"""`repro_torch.kernels.attention.decode` against the JAX decode-attention
Pallas kernel (interpret mode) and the plain versions.

Lengths 0, 1, block - 1, block, block + 1 and L are mixed in one batch,
where block is the JAX kernel's key block here and the CUDA kernel's key
tile (64).  Tolerances: with an f32 cache both sides compute in f32 and
differ in summation order only: 1e-5.  With a bf16 cache the output is
bf16 (2^-8 relative per rounding) and the JAX kernel also rounds the
probabilities to bf16 before p @ V: 2e-2 for outputs of order 1.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.attention import decode as jdecode  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.kernels.attention import decode as tdecode  # noqa: E402

BLOCK = 64
L = 160                       # not a multiple of the block: a ragged tail
LENGTHS = np.array([0, 1, BLOCK - 1, BLOCK, BLOCK + 1, L], np.int32)
TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _inputs(seed, b, hq, hkv, dh, kl=L):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, kl, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, kl, hkv, dh)).astype(np.float32)
    return q, k, v


def _t(a, dt):
    return torch.from_numpy(a).to(TDT[dt])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [16, 128])
def test_matches_pallas_kernel_interpret(dh, dt):
    b, hkv, g = LENGTHS.size, 2, 5
    q, k, v = _inputs(0, b, g * hkv, hkv, dh)
    out_t = tdecode.gqa_decode_attention(_t(q, dt), _t(k, dt), _t(v, dt),
                                         length=torch.from_numpy(LENGTHS))
    out_j = jdecode.gqa_decode_attention(
        jnp.asarray(q, JDT[dt]), jnp.asarray(k, JDT[dt]),
        jnp.asarray(v, JDT[dt]), length=jnp.asarray(LENGTHS),
        block_k=BLOCK, interpret=True)
    assert out_t.shape == (b, g * hkv, dh) and out_t.dtype == TDT[dt]
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL[dt],
                               atol=TOL[dt])
    assert not _np(out_t)[0].any(), "length 0 must give zeros"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 2, 5])
def test_decode_ref_matches_jax_decode_ref(g, dt):
    b, hkv, dh = LENGTHS.size, 2, 16
    q, k, v = _inputs(1, b, g * hkv, hkv, dh)
    out_t = tdecode.decode_ref(_t(q, dt), _t(k, dt), _t(v, dt),
                               length=torch.from_numpy(LENGTHS))
    out_j = jdecode.decode_ref(jnp.asarray(q, JDT[dt]),
                               jnp.asarray(k, JDT[dt]),
                               jnp.asarray(v, JDT[dt]),
                               length=jnp.asarray(LENGTHS))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL[dt],
                               atol=TOL[dt])


def test_rows_fold_like_the_pallas_kernel():
    """Row b * Hkv + h of the JAX kernel's (B*Hkv, g, dh) fold is KV head h
    of sequence b: the port reads the unfolded cache through strides and
    must land every row where the fold puts it."""
    b, hkv, g, dh = 3, 4, 2, 16
    q, k, v = _inputs(2, b, g * hkv, hkv, dh, kl=40)
    lengths = np.array([7, 40, 23], np.int32)
    out_t = tdecode.gqa_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        length=torch.from_numpy(lengths))
    qf = q.reshape(b * hkv, g, dh)
    kf = k.transpose(0, 2, 1, 3).reshape(b * hkv, 40, dh)
    vf = v.transpose(0, 2, 1, 3).reshape(b * hkv, 40, dh)
    out_j = jdecode.decode_attention(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf),
        scale=dh ** -0.5, length=jnp.asarray(np.repeat(lengths, hkv)),
        block_k=16, interpret=True)
    np.testing.assert_allclose(_np(out_t).reshape(b * hkv, g, dh),
                               np.asarray(out_j), rtol=1e-5, atol=1e-5)


def test_scalar_length_is_clamped_to_cache():
    b, hkv, dh = 2, 2, 16
    q, k, v = _inputs(3, b, 2 * hkv, hkv, dh, kl=24)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    over = tdecode.gqa_decode_attention(*args, length=100)
    full = tdecode.gqa_decode_attention(*args, length=24)
    torch.testing.assert_close(over, full, rtol=0, atol=0)
    with pytest.raises(ValueError, match="per-sequence"):
        tdecode.gqa_decode_attention(*args, length=torch.tensor([1, 2, 3]))
