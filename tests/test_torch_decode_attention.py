"""`repro_torch.kernels.attention.decode` against the JAX decode-attention
Pallas kernel (interpret mode) and the plain versions.

Lengths 0, 1, block - 1, block, block + 1 and L are mixed in one batch,
where block is the JAX kernel's key block here and the CUDA kernel's key
tile (64).  Tolerances: with an f32 cache both sides compute in f32 and
differ in summation order only: 1e-5.  With a bf16 cache the output is
bf16 (2^-8 relative per rounding) and the JAX kernel also rounds the
probabilities to bf16 before p @ V: 2e-2 for outputs of order 1.

The CUDA kernels' split law in plain PyTorch (`split_bounds`,
`combine_partials`, `split_decode_ref`) is held to the JAX `decode_ref`
at lengths 0, 1, 63-65, one split, a split plus 1 and 4096, in f32: 1e-5.
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


# -- paged cache (kernel B2) -------------------------------------------------

def _paged(seed, lengths, page_size, hq, hkv, dh):
    """q, K/V pools and a page table filled from a shuffled permutation of
    the pool, -1 past each slot's last page (and a spare page never
    named)."""
    rng = np.random.default_rng(seed)
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
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    pool = (num_pages, page_size, hkv, dh)
    k = rng.standard_normal(pool).astype(np.float32)
    v = rng.standard_normal(pool).astype(np.float32)
    return q, k, v, table


def _paged_lengths(ps):
    """Length 0 and lengths on both sides of page boundaries."""
    return np.array([0, 1, ps - 1, ps, ps + 1, 3 * ps + 2], np.int32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("page_size", [16, 3])
def test_paged_matches_pallas_kernel_interpret(page_size, dt):
    lengths = _paged_lengths(page_size)
    hkv, g, dh = 2, 5, 16
    q, k, v, table = _paged(4, lengths, page_size, g * hkv, hkv, dh)
    out_t = tdecode.paged_gqa_decode_attention(
        _t(q, dt), _t(k, dt), _t(v, dt), torch.from_numpy(table),
        length=torch.from_numpy(lengths))
    out_j = jdecode.paged_gqa_decode_attention(
        jnp.asarray(q, JDT[dt]), jnp.asarray(k, JDT[dt]),
        jnp.asarray(v, JDT[dt]), jnp.asarray(table),
        length=jnp.asarray(lengths), interpret=True)
    assert out_t.shape == q.shape and out_t.dtype == TDT[dt]
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=TOL[dt],
                               atol=TOL[dt])
    assert not _np(out_t)[0].any(), "length 0 must give zeros"


@pytest.mark.parametrize("g", [1, 5])
def test_paged_decode_ref_matches_jax_paged_decode_ref(g):
    lengths = _paged_lengths(4)
    hkv, dh = 2, 8
    q, k, v, table = _paged(5, lengths, 4, g * hkv, hkv, dh)
    out_t = tdecode.paged_decode_ref(
        *(torch.from_numpy(a) for a in (q, k, v, table)),
        length=torch.from_numpy(lengths))
    out_j = jdecode.paged_decode_ref(
        *(jnp.asarray(a) for a in (q, k, v, table)),
        length=jnp.asarray(lengths))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)


def test_paged_equals_contiguous_over_the_same_rows():
    """Gathering each slot's pages gives the contiguous cache the paged
    wrapper reads: the plain versions agree exactly, and a clamped
    out-of-range table entry reads the last pool page, as in JAX."""
    lengths = _paged_lengths(16)
    q, k, v, table = (torch.from_numpy(a) for a in
                      _paged(6, lengths, 16, 10, 2, 16))
    lv = torch.from_numpy(lengths)
    paged = tdecode.paged_gqa_decode_attention(q, k, v, table, length=lv)
    contiguous = tdecode.gqa_decode_attention(
        q, tdecode.gather_pages(k, table), tdecode.gather_pages(v, table),
        length=lv)
    torch.testing.assert_close(paged, contiguous, rtol=0, atol=0)
    wild = table.clone()
    wild[5, 0] = 10 ** 6
    np.testing.assert_array_equal(
        tdecode.gather_pages(k, wild)[5, :16].numpy(), k[-1].numpy())


# -- the split law of the CUDA kernels (plain PyTorch) -----------------------

SPAN = tdecode.SPLIT_KEYS
SPLIT_L = 4096
SPLIT_LENGTHS = np.array([0, 1, BLOCK - 1, BLOCK, BLOCK + 1, SPAN, SPAN + 1,
                          SPLIT_L], np.int32)


@pytest.mark.parametrize("g", [1, 5, 16])
@pytest.mark.parametrize("dh", [8, 128])
def test_split_then_combine_matches_jax_decode_ref(dh, g):
    """Each split's partial softmax, then the kernels' combine, against the
    JAX oracle in f32: summation order only, 1e-5."""
    hkv = 2
    q, k, v = _inputs(7, SPLIT_LENGTHS.size, g * hkv, hkv, dh, kl=SPLIT_L)
    out_t = tdecode.split_decode_ref(
        *(torch.from_numpy(a) for a in (q, k, v)),
        length=torch.from_numpy(SPLIT_LENGTHS))
    out_j = jdecode.decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               length=jnp.asarray(SPLIT_LENGTHS))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)
    assert not _np(out_t)[0].any(), "length 0 must give zeros"


@pytest.mark.parametrize("length", [int(n) for n in SPLIT_LENGTHS])
def test_split_bounds_follow_key_positions_only(length):
    """Spans of SPLIT_KEYS keys from 0, the last cut at the length; the same
    whatever the cache's rows (so its grid) or a pool's page size, as
    bitwise paged == contiguous needs."""
    want = tdecode.split_bounds(length, SPLIT_L)
    assert [lo for lo, _ in want] == list(range(0, length, SPAN))
    assert all(hi - lo == SPAN for lo, hi in want[:-1])
    assert (want[-1][1] if want else 0) == length
    for rows in (length, length + 1, 2 * SPLIT_L, 32768):
        assert tdecode.split_bounds(length, rows) == want
        assert tdecode.num_splits(rows) >= max(len(want), 1)
    for page_size in (1, 3, 16, 48):
        max_pages = -(-length // page_size) + 1
        assert tdecode.split_bounds(length, max_pages * page_size) == want
    assert tdecode.split_bounds(length + 100, length) == want


def test_combine_weighs_an_empty_partial_zero():
    """A split with no key (l = 0, m = -1e30) changes nothing, and a row
    whose splits are all empty gives zeros."""
    rng = np.random.default_rng(8)
    m = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 3, (3, 4)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    base = tdecode.combine_partials(m, l, acc)
    empty = (torch.full((1, 4), tdecode.NEG_INF), torch.zeros((1, 4)),
             torch.zeros((1, 4, 16)))
    with_empty = tdecode.combine_partials(
        *(torch.cat([x[:2], e, x[2:]]) for x, e in zip((m, l, acc), empty)))
    torch.testing.assert_close(with_empty, base, rtol=0, atol=0)
    assert not tdecode.combine_partials(*empty).any()
