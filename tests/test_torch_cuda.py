"""The CUDA kernels on the card, against their plain PyTorch versions:
the decode-attention kernels, contiguous (`decode_attention`), paged
(`paged_decode_attention`), int8 (`quantized_decode_attention`) and paged
int8 (`paged_quantized_decode_attention`), and the prefill flash-attention
kernel (`flash_attention`) against `ref.attention_ref` with every mask
kind, ragged tails and query rows with no key.  Every test here is marked
``cuda`` and skips on a host without a card; this file imports no JAX, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: with an f32 cache and f32 q the kernel and `decode_ref` differ
in summation order only: 1e-5 on outputs of order 1.  With bf16 each side
rounds its f32 result to bf16 once, so an element may land one bf16 ulp
away, at most 2^-7 of its own size.  The bound is taken per (sequence,
query head) row, 2^-7 of that row's largest |ref|, so an error in a long
row or at a tile boundary cannot hide under the scale of another row; a
row of length 0 must be exactly zero.  The int8 kernels and their plain
versions dequantize the same codes in f32, so f32 output differs in
summation order only: 1e-5.  Paged tables are a shuffled permutation of
the pool's pages, -1 past each slot's last page.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.kernels.attention import decode  # noqa: E402
from repro_torch.kernels.attention import decode_int8  # noqa: E402
from repro_torch.kernels.attention import kernel as flash  # noqa: E402
from repro_torch.kernels.attention import ref as flash_ref  # noqa: E402
from repro_torch.runtime import quantize  # noqa: E402

TILE = 64                     # keys per tile of the CUDA kernel
L = 160
LENGTHS = [0, 1, TILE - 1, TILE, TILE + 1, L]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    disable_tf32()
    return torch.device("cuda")


def _inputs(seed, b, hq, hkv, dh, kl, dt, device):
    rng = np.random.default_rng(seed)
    shapes = [(b, hq, dh), (b, kl, hkv, dh), (b, kl, hkv, dh)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=DTYPES[dt]) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dh, g", [(8, 2), (16, 5), (80, 4), (96, 1),
                                   (128, 5), (128, 16)])
def test_kernel_matches_decode_ref(cuda, dh, g, dt):
    hkv = 2
    q, k, v = _inputs(0, len(LENGTHS), g * hkv, hkv, dh, L, dt, cuda)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    out = decode.gqa_decode_attention(q, k, v, length=lengths)
    ref = decode.decode_ref(q, k, v, length=lengths)
    torch.cuda.synchronize()
    out, ref = out.float().cpu(), ref.float().cpu()
    err = (out - ref).abs()
    tol = (torch.full_like(ref[..., :1], 1e-5) if dt == "f32"
           else 2.0 ** -7 * ref.abs().amax(-1, keepdim=True))
    bad = (err > tol).any(-1).nonzero().tolist()
    assert not bad, (f"(sequence, head) rows {bad} exceed their tolerance; "
                     f"worst err/tol {float((err / tol).nan_to_num().max())}")
    assert not out[0].any(), "length 0 must give zeros"


@pytest.mark.cuda
def test_kernel_reads_a_strided_cache_view(cuda):
    """A cache view whose batch, row and head strides are not those of a
    contiguous (B, L, Hkv, dh) tensor is read in place through them."""
    q, k, v = _inputs(1, 3, 10, 2, 128, 40, "f32", cuda)
    wide = torch.cat([k * 2, k, k * 3], dim=2)[:, :, 2:4]   # heads 2..3
    assert not wide.is_contiguous()
    lengths = torch.tensor([40, 7, 0], dtype=torch.int32, device=cuda)
    out = decode.gqa_decode_attention(q, wide, v, length=lengths)
    ref = decode.decode_ref(q, wide, v, length=lengths)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_tensor_launches_the_kernel(cuda):
    q, k, v = _inputs(2, 2, 4, 2, 16, 32, "f32", cuda)
    before = decode.launches
    decode.gqa_decode_attention(q, k, v, length=32)
    torch.cuda.synchronize()
    assert decode.launches == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        decode.gqa_decode_attention(q[..., :12], k[..., :12], v[..., :12],
                                    length=32)
    assert decode.launches == before + 1


def _assert_rows_close(out, ref, f32: bool):
    out, ref = out.float().cpu(), ref.float().cpu()
    err = (out - ref).abs()
    tol = (torch.full_like(ref[..., :1], 1e-5) if f32
           else 2.0 ** -7 * ref.abs().amax(-1, keepdim=True))
    bad = (err > tol).any(-1).nonzero().tolist()
    assert not bad, (f"(sequence, head) rows {bad} exceed their tolerance; "
                     f"worst err/tol {float((err / tol).nan_to_num().max())}")


def _pool(seed, lengths, page_size, hkv, dh, device, spare=3):
    """A pool holding each slot's rows in shuffled pages, its table (-1
    past each slot's last page) and the slot rows laid out contiguously."""
    rng = np.random.default_rng(seed)
    max_pages = -(-max(lengths) // page_size) + 1
    num_pages = len(lengths) * max_pages + spare
    perm = rng.permutation(num_pages)
    table = -np.ones((len(lengths), max_pages), np.int32)
    i = 0
    for b, n in enumerate(lengths):
        need = -(-n // page_size)
        table[b, :need] = perm[i:i + need]
        i += need
    shape = (num_pages, page_size, hkv, dh)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device) for _ in range(2))
    return k, v, torch.from_numpy(table).to(device)


PAGED_CASES = [(16, 128, 5, "f32", "f32"), (16, 128, 5, "bf16", "f32"),
               (16, 128, 5, "bf16", "bf16"), (3, 16, 2, "f32", "f32"),
               (48, 128, 5, "bf16", "f32"), (7, 80, 4, "bf16", "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("page_size, dh, g, q_dt, kv_dt", PAGED_CASES)
def test_paged_kernel_matches_paged_decode_ref(cuda, page_size, dh, g, q_dt,
                                               kv_dt):
    hkv = 2
    k, v, pages = _pool(3, LENGTHS, page_size, hkv, dh, cuda)
    k, v = k.to(DTYPES[kv_dt]), v.to(DTYPES[kv_dt])
    q = torch.randn((len(LENGTHS), g * hkv, dh), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4)
                    ).to(DTYPES[q_dt])
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    before = decode.paged_launches
    out = decode.paged_gqa_decode_attention(q, k, v, pages, length=lengths)
    ref = decode.paged_decode_ref(q, k, v, pages, length=lengths)
    torch.cuda.synchronize()
    assert decode.paged_launches == before + 1
    _assert_rows_close(out, ref, q_dt == "f32")
    assert not out[0].any(), "length 0 must give zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dt", list(DTYPES))
def test_paged_kernel_is_bitwise_the_contiguous_kernel(cuda, kv_dt):
    """The page walk reads the keys of the contiguous kernel in its order,
    so over the same rows the two kernels agree bit for bit."""
    k, v, pages = _pool(5, LENGTHS, 16, 8, 128, cuda)
    k, v = k.to(DTYPES[kv_dt]), v.to(DTYPES[kv_dt])
    q = torch.randn((len(LENGTHS), 40, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    paged = decode.paged_gqa_decode_attention(q, k, v, pages, length=lengths)
    contiguous = decode.gqa_decode_attention(
        q, decode.gather_pages(k, pages).contiguous(),
        decode.gather_pages(v, pages).contiguous(), length=lengths)
    torch.testing.assert_close(paged, contiguous, rtol=0, atol=0)


def _int8(k, v):
    (kq, ks), (vq, vs) = quantize.quantize_rows(k), quantize.quantize_rows(v)
    return kq, ks, vq, vs


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt", list(DTYPES))
@pytest.mark.parametrize("dh, g", [(16, 5), (128, 5), (128, 16), (96, 1)])
def test_quantized_kernel_matches_quantized_decode_ref(cuda, dh, g, q_dt):
    hkv = 2
    q, k, v = _inputs(7, len(LENGTHS), g * hkv, hkv, dh, L, "f32", cuda)
    kq, ks, vq, vs = _int8(k, v)
    q = q.to(DTYPES[q_dt])
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    before = decode_int8.launches
    out = decode_int8.quantized_gqa_decode_attention(q, kq, ks, vq, vs,
                                                     length=lengths)
    ref = decode_int8.quantized_decode_ref(q, kq, ks, vq, vs, length=lengths)
    torch.cuda.synchronize()
    assert decode_int8.launches == before + 1
    assert out.dtype == q.dtype
    _assert_rows_close(out, ref, q_dt == "f32")
    assert not out[0].any(), "length 0 must give zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt", list(DTYPES))
@pytest.mark.parametrize("page_size, dh, g", [(16, 128, 5), (48, 128, 5),
                                              (3, 16, 2)])
def test_paged_quantized_kernel_matches_its_ref(cuda, page_size, dh, g,
                                                q_dt):
    hkv = 2
    k, v, pages = _pool(8, LENGTHS, page_size, hkv, dh, cuda)
    kq, ks, vq, vs = _int8(k, v)
    q = torch.randn((len(LENGTHS), g * hkv, dh), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(9)
                    ).to(DTYPES[q_dt])
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    before = decode_int8.paged_launches
    out = decode_int8.paged_quantized_gqa_decode_attention(
        q, kq, ks, vq, vs, pages, length=lengths)
    ref = decode_int8.paged_quantized_decode_ref(q, kq, ks, vq, vs, pages,
                                                 length=lengths)
    torch.cuda.synchronize()
    assert decode_int8.paged_launches == before + 1
    _assert_rows_close(out, ref, q_dt == "f32")
    assert not out[0].any(), "length 0 must give zeros"


@pytest.mark.cuda
def test_int8_kernels_refuse_rows_of_8_bytes(cuda):
    """16-byte copies of int8 rows need head_dim % 16 == 0."""
    q, k, v = _inputs(10, 2, 4, 2, 8, 32, "f32", cuda)
    kq, ks, vq, vs = _int8(k, v)
    before = decode_int8.launches
    with pytest.raises(ValueError, match="16 bytes"):
        decode_int8.quantized_gqa_decode_attention(q, kq, ks, vq, vs,
                                                   length=32)
    assert decode_int8.launches == before


# name: (Sq, Sk, causal, window); lengths not multiples of the 64-row tile
FLASH_MASKS = {
    "causal": (200, 200, True, None),
    "window": (300, 300, True, 70),
    "non_causal": (150, 230, False, None),
    "window_non_causal": (200, 180, False, 50),
    "window_sq_gt_sk": (300, 140, True, 64),
}


def _flash_inputs(seed, b, sq, sk, hq, hkv, dh, dt, device):
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=DTYPES[dt]) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dh, g", [(128, 5), (80, 4), (128, 1), (16, 5)])
@pytest.mark.parametrize("mask", list(FLASH_MASKS))
def test_flash_kernel_matches_attention_ref(cuda, mask, dh, g, dt):
    sq, sk, causal, window = FLASH_MASKS[mask]
    hkv = 2
    q, k, v = _flash_inputs(11, 2, sq, sk, g * hkv, hkv, dh, dt, cuda)
    scale = dh ** -0.5
    before = flash.launches
    out = flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                window=window)
    ref = flash_ref.attention_ref(q, k, v, scale=scale, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    _assert_rows_close(out, ref, dt == "f32")
    i = torch.arange(sq, device=cuda)[:, None]
    j = torch.arange(sk, device=cuda)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=cuda)
    if causal:
        keep &= i >= j
    if window is not None:
        keep &= i - j < window
    empty = ~keep.any(-1)
    if mask == "window_sq_gt_sk":
        assert empty.any()
    assert not out[:, empty].any(), "rows with no key must be exactly 0"


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda):
    """q, k and v as head slices of one packed (B, S, Hq + 2 Hkv, dh)
    projection are read in place through their strides."""
    b, s, hq, hkv, dh = 2, 130, 10, 2, 128
    qkv = torch.randn((b, s, hq + 2 * hkv, dh), device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    assert not q.is_contiguous()
    out = flash.flash_attention(q, k, v, scale=dh ** -0.5)
    ref = flash_ref.attention_ref(q, k, v, scale=dh ** -0.5)
    torch.cuda.synchronize()
    _assert_rows_close(out, ref, False)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _flash_inputs(12, 1, 40, 40, 4, 2, 128, "bf16", cuda)
    before = flash.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q[..., :48], k[..., :48], v[..., :48],
                              scale=0.1)
    with pytest.raises(ValueError, match="dtypes"):
        flash.flash_attention(q, k.float(), v, scale=0.1)
    wide = torch.zeros((1, 40, 4, 136), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):    # 8-byte offset
        flash.flash_attention(wide[..., 4:132], k, v, scale=0.1)
    assert flash.launches == before
