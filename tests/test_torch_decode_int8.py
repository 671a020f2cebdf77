"""`repro_torch.kernels.attention.decode_int8` against the JAX int8
decode-attention Pallas kernels (interpret mode) and their jnp oracles.

Both sides take the same int8 codes and f32 scales (quantized once with
the JAX package) and dequantize them in f32, with q in f32.  With f32 q
they differ in summation order only: 1e-5.  With bf16 q each side rounds
its f32 output to bf16 once, so outputs of order 1 may differ by one bf16
ulp (2^-7 relative at most): 1e-2.  Lengths mix 0, one key, and lengths
on both sides of a key block and of a page; paged tables are shuffled
permutations of the pool with -1 past each slot's last page.  The CUDA
kernels' split law (`decode.split_decode_ref` over the dequantized codes)
is held to the JAX `quantized_decode_ref` in f32: 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.attention import decode_int8 as jint8  # noqa: E402
from repro.runtime import quantize as jq  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.kernels.attention import decode as tdecode  # noqa: E402
from repro_torch.kernels.attention import decode_int8 as tint8  # noqa: E402
from repro_torch.runtime import quantize as tquant  # noqa: E402

BLOCK = 64
L = 160
LENGTHS = np.array([0, 1, BLOCK - 1, BLOCK, BLOCK + 1, L], np.int32)
SPLIT_KEYS = tdecode.SPLIT_KEYS
TOL = {"f32": 1e-5, "bf16": 1e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _codes(rng, shape):
    """int8 codes and f32 scales of N(0, 1) rows, as numpy arrays."""
    x = rng.standard_normal(shape).astype(np.float32)
    codes, scale = jq.quantize_rows(jnp.asarray(x))
    return np.array(codes), np.array(scale)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _q(rng, b, hq, dh, dt):
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    jq_ = jnp.asarray(q, JDT[dt])
    return jq_, torch.from_numpy(np.array(jq_.astype(jnp.float32))).to(
        TDT[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dh, g", [(16, 5), (16, 1), (128, 5)])
def test_matches_pallas_kernel_interpret(dh, g, dt):
    rng = np.random.default_rng(0)
    b, hkv = LENGTHS.size, 2
    jqv, tqv = _q(rng, b, g * hkv, dh, dt)
    kq, ks = _codes(rng, (b, L, hkv, dh))
    vq, vs = _codes(rng, (b, L, hkv, dh))
    out_t = tint8.quantized_gqa_decode_attention(
        tqv, *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
        length=torch.from_numpy(LENGTHS))
    out_j = jint8.quantized_gqa_decode_attention(
        jqv, *(jnp.asarray(a) for a in (kq, ks, vq, vs)),
        length=jnp.asarray(LENGTHS), block_k=BLOCK, interpret=True)
    assert out_t.shape == (b, g * hkv, dh) and out_t.dtype == TDT[dt]
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL[dt],
                               atol=TOL[dt])
    assert not _np(out_t)[0].any(), "length 0 must give zeros"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantized_decode_ref_matches_jax(dt):
    rng = np.random.default_rng(1)
    b, hkv, g, dh = LENGTHS.size, 2, 5, 16
    jqv, tqv = _q(rng, b, g * hkv, dh, dt)
    arrs = _codes(rng, (b, L, hkv, dh)) + _codes(rng, (b, L, hkv, dh))
    out_t = tint8.quantized_decode_ref(
        tqv, *(torch.from_numpy(a) for a in arrs),
        length=torch.from_numpy(LENGTHS))
    out_j = jint8.quantized_decode_ref(jqv, *(jnp.asarray(a) for a in arrs),
                                       length=jnp.asarray(LENGTHS))
    assert out_t.dtype == TDT[dt]
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL[dt],
                               atol=TOL[dt])


def _paged(rng, lengths, page_size, hkv, dh):
    b = len(lengths)
    max_pages = -(-max(lengths) // page_size) + 1
    num_pages = b * max_pages + 2
    perm = rng.permutation(num_pages)
    table = -np.ones((b, max_pages), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // page_size)
        table[i, :need] = perm[used:used + need]
        used += need
    pool = (num_pages, page_size, hkv, dh)
    return _codes(rng, pool) + _codes(rng, pool) + (table,)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("page_size", [16, 3])
def test_paged_matches_pallas_kernel_interpret(page_size, dt):
    rng = np.random.default_rng(2)
    lengths = np.array([0, 1, page_size - 1, page_size, page_size + 1,
                        3 * page_size + 2], np.int32)
    hkv, g, dh = 2, 5, 16
    jqv, tqv = _q(rng, lengths.size, g * hkv, dh, dt)
    arrs = _paged(rng, lengths, page_size, hkv, dh)
    out_t = tint8.paged_quantized_gqa_decode_attention(
        tqv, *(torch.from_numpy(a) for a in arrs),
        length=torch.from_numpy(lengths))
    out_j = jint8.paged_quantized_gqa_decode_attention(
        jqv, *(jnp.asarray(a) for a in arrs), length=jnp.asarray(lengths),
        interpret=True)
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL[dt],
                               atol=TOL[dt])
    assert not _np(out_t)[0].any(), "length 0 must give zeros"
    ref_j = jint8.paged_quantized_decode_ref(
        jqv, *(jnp.asarray(a) for a in arrs), length=jnp.asarray(lengths))
    np.testing.assert_allclose(_np(out_t), _np(ref_j), rtol=TOL[dt],
                               atol=TOL[dt])


def test_wrappers_check_their_operands():
    rng = np.random.default_rng(3)
    kq, ks = (torch.from_numpy(a) for a in _codes(rng, (2, 8, 2, 16)))
    q = torch.zeros((2, 4, 16))
    with pytest.raises(ValueError, match="int8"):
        tint8.quantized_gqa_decode_attention(q, kq.float(), ks, kq, ks,
                                             length=8)
    with pytest.raises(ValueError, match="float32"):
        tint8.quantized_gqa_decode_attention(q, kq, ks.double(), kq, ks,
                                             length=8)
    with pytest.raises(ValueError, match="multiple"):
        tint8.quantized_gqa_decode_attention(torch.zeros((2, 3, 16)), kq, ks,
                                             kq, ks, length=8)
    over = tint8.quantized_gqa_decode_attention(q, kq, ks, kq, ks, length=99)
    full = tint8.quantized_gqa_decode_attention(q, kq, ks, kq, ks, length=8)
    torch.testing.assert_close(over, full, rtol=0, atol=0)


# -- the split law of the CUDA kernels over int8 codes -----------------------

SPLIT_L = 4096
SPLIT_LENGTHS = np.array([0, 1, BLOCK - 1, BLOCK, BLOCK + 1, SPLIT_KEYS,
                          SPLIT_KEYS + 1, SPLIT_L], np.int32)


@pytest.mark.parametrize("g", [1, 5, 16])
@pytest.mark.parametrize("dh", [8, 128])
def test_split_then_combine_matches_jax_quantized_decode_ref(dh, g):
    """The codes dequantized in f32, then each split's partial softmax and
    the kernels' combine with q in f32, against the JAX oracle: 1e-5."""
    rng = np.random.default_rng(9)
    b, hkv = SPLIT_LENGTHS.size, 2
    kq, ks = _codes(rng, (b, SPLIT_L, hkv, dh))
    vq, vs = _codes(rng, (b, SPLIT_L, hkv, dh))
    q = rng.standard_normal((b, g * hkv, dh)).astype(np.float32)
    k = tquant.dequantize_rows(torch.from_numpy(kq), torch.from_numpy(ks))
    v = tquant.dequantize_rows(torch.from_numpy(vq), torch.from_numpy(vs))
    out_t = tdecode.split_decode_ref(torch.from_numpy(q), k, v,
                                     length=torch.from_numpy(SPLIT_LENGTHS))
    out_j = jint8.quantized_decode_ref(
        *(jnp.asarray(a) for a in (q, kq, ks, vq, vs)),
        length=jnp.asarray(SPLIT_LENGTHS))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)
    assert not _np(out_t)[0].any(), "length 0 must give zeros"


@pytest.mark.parametrize("g", [1, 4])
def test_quantized_decode_statistics_combine_into_the_unsplit_row(g):
    """B3's plain version with ``return_stats``: its output equals the call
    without them and JAX's `quantized_decode_ref`; its (out, m, l) over
    two halves of the keys, combined by `decode.combine_partials` from
    ``out * l``, equal the row over all of them within 1e-5, lengths in
    the first half, across it, 0 and the whole cache; the whole row's
    statistics are the halves' combined."""
    rng = np.random.default_rng(4)
    b, rows, hkv, dh = 4, 64, 2, 16
    kq, ks = _codes(rng, (b, rows, hkv, dh))
    vq, vs = _codes(rng, (b, rows, hkv, dh))
    _, q = _q(rng, b, hkv * g, dh, "f32")
    t = [torch.from_numpy(a) for a in (kq, ks, vq, vs)]
    length = torch.tensor([0, 20, 33, rows], dtype=torch.int32)
    whole, m, l = tint8.quantized_gqa_decode_attention(
        q, *t, length=length, return_stats=True)
    assert torch.equal(whole, tint8.quantized_gqa_decode_attention(
        q, *t, length=length))
    want = _np(jint8.quantized_decode_ref(
        jnp.asarray(q.numpy()), jnp.asarray(kq), jnp.asarray(ks),
        jnp.asarray(vq), jnp.asarray(vs), length=jnp.asarray(length.numpy())))
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=1e-5)
    assert bool((m[0] == tdecode.NEG_INF).all()) and not bool(l[0].any())
    half = rows // 2
    parts = [tint8.quantized_gqa_decode_attention(
        q, *(a[:, i:i + half] for a in t),
        length=torch.clamp(length - i, 0, half), return_stats=True)
        for i in (0, half)]
    out = tdecode.combine_partials(
        torch.stack([p[1] for p in parts]), torch.stack([p[2] for p in parts]),
        torch.stack([p[0] * p[2][..., None] for p in parts]))
    assert float((out - whole).abs().max()) <= 1e-5 * float(
        whole.abs().max())
    mx = torch.maximum(parts[0][1], parts[1][1])
    lsum = sum(p[2] * torch.exp(p[1] - mx) for p in parts)
    assert torch.allclose(mx, m) and torch.allclose(lsum, l, rtol=1e-5)
