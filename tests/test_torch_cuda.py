"""The CUDA kernels on the card, against their plain PyTorch versions: the
decode-attention kernels, contiguous (`decode_attention`), paged
(`paged_decode_attention`), int8 (`quantized_decode_attention`) and paged
int8 (`paged_quantized_decode_attention`), also at the edges of their key
splits, at every split span the decode tuner offers (and spans that are
no whole number of the block's 64-key rounds), at 32,768 keys, bitwise
repeatable, one device kernel a call at each span, through
`autotune.dispatch` at the plan's span,
paged bitwise the contiguous kernel whatever the two caches' rows, and
lengths past the rows or below 0 clamped by the kernel; the prefill
flash-attention kernels (`flash_attention`: TMA and `wgmma` for bf16 at
head_dim 128, `mma.sync` and CUDA cores otherwise) against
`ref.attention_ref` with every mask kind, ragged tails and query rows with
no key, the blocked matmul (`blocked_matmul`: wgmma and TMA on every built
tile for bf16 operands TMA can read, mma.sync for other bf16 operands,
CUDA cores for f32, as `kernel.design` routes them) against `matmul_ref`
at ragged shapes with every activation, and the ELL SpMV kernels
(`ell_spmv` with and without the row lengths, `ell_spmv_blocked` with
slabs staged, gathered and skipped) against `spmv_ell_ref`,
`spmv_csr_ref`, the slab walk `spmv_blocked_ref` and each other. Every
test here is marked ``cuda`` and skips on a host without a card; this file
imports no JAX, so it also runs where only the port is installed:

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
the pool's pages, -1 past each slot's last page.  The matmul and SpMV
tolerances are their plain versions' `row_tolerance`: per output row,
1e-5 (f32) or 2^-7 (bf16) of the row's largest |ref| for the matmul, and
1e-5 of the row's sum of |products| for SpMV.
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

TILE = 64                     # keys a decode block's eight warps take a round
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


# -- split keys and the in-kernel combine (B1-B4) -----------------------------

SPAN = decode.SPLIT_KEYS
SPLIT_ROWS = 3 * SPAN + 40
SPLIT_LENGTHS = [0, 1, TILE - 1, TILE, TILE + 1, SPAN - 1, SPAN, SPAN + 1,
                 2 * SPAN + 7, SPLIT_ROWS]
DECODE_KERNELS = ("decode_attention", "paged_decode_attention",
                  "quantized_decode_attention",
                  "paged_quantized_decode_attention")


def _decode_case(kernel, lengths, rows, device, *, q_dt, kv_dt, hkv=2, g=5,
                 dh=128, page_size=16, seed=11):
    """One of B1-B4 with its plain version and operands for ``lengths``: a
    contiguous (B, rows, Hkv, dh) cache, or a shuffled pool (-1 past each
    slot's last page); int8 kernels get the rows' codes and scales."""
    paged = kernel.startswith("paged")
    quant = "quantized" in kernel
    if paged:
        k, v, pages = _pool(seed, lengths, page_size, hkv, dh, device)
    else:
        _, k, v = _inputs(seed, len(lengths), 1, hkv, dh, rows, "f32", device)
    cache = _int8(k, v) if quant else (k.to(DTYPES[kv_dt]),
                                       v.to(DTYPES[kv_dt]))
    del k, v
    q = torch.randn((len(lengths), g * hkv, dh), device=device,
                    generator=torch.Generator(device).manual_seed(seed + 1)
                    ).to(DTYPES[q_dt])
    fn, ref = {
        "decode_attention": (decode.gqa_decode_attention, decode.decode_ref),
        "paged_decode_attention": (decode.paged_gqa_decode_attention,
                                   decode.paged_decode_ref),
        "quantized_decode_attention": (
            decode_int8.quantized_gqa_decode_attention,
            decode_int8.quantized_decode_ref),
        "paged_quantized_decode_attention": (
            decode_int8.paged_quantized_gqa_decode_attention,
            decode_int8.paged_quantized_decode_ref),
    }[kernel]
    args = (q, *cache, *((pages,) if paged else ()))
    lv = torch.tensor(lengths, dtype=torch.int32, device=device)
    return fn, ref, args, lv


def _launch_counts():
    return (decode.launches, decode.paged_launches, decode_int8.launches,
            decode_int8.paged_launches)


# (q dtype, cache dtype) per kernel: the cache type of B1/B2, q of B3/B4
SPLIT_DTYPES = [("f32", "f32"), ("bf16", "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt, kv_dt", SPLIT_DTYPES)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_kernels_match_their_refs_at_split_edges(cuda, kernel, q_dt, kv_dt):
    """Lengths on both sides of a tile and of a split, two splits and a
    ragged third: each kernel against its plain version, one launch."""
    fn, ref, args, lv = _decode_case(kernel, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                     q_dt=q_dt, kv_dt=kv_dt)
    before = sum(_launch_counts())
    out = fn(*args, length=lv)
    want = ref(*args, length=lv)
    torch.cuda.synchronize()
    assert sum(_launch_counts()) == before + 1
    _assert_rows_close(out, want, q_dt == "f32")
    assert not out[0].any(), "length 0 must give zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_kernels_match_their_refs_at_32k_keys(cuda, kernel):
    """Qwen3-14B's 32k context (Hkv 8, g 5, dh 128): 128 splits a row."""
    lengths = [32768, 1, 20000]
    fn, ref, args, lv = _decode_case(kernel, lengths, 32768, cuda,
                                     q_dt="f32", kv_dt="f32", hkv=8)
    out = fn(*args, length=lv)
    want = ref(*args, length=lv)
    torch.cuda.synchronize()
    _assert_rows_close(out, want, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dt", list(DTYPES))
def test_paged_is_bitwise_contiguous_with_more_contiguous_rows(cuda, kv_dt):
    """The split bounds follow key positions alone: a contiguous cache of
    many more rows (so many more splits in its grid) than the pool's pages
    still gives bitwise the paged kernel's output."""
    k, v, pages = _pool(12, SPLIT_LENGTHS, 16, 8, 128, cuda)
    k, v = k.to(DTYPES[kv_dt]), v.to(DTYPES[kv_dt])
    q = torch.randn((len(SPLIT_LENGTHS), 40, 128), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(13))
    lv = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=cuda)
    paged = decode.paged_gqa_decode_attention(q, k, v, pages, length=lv)
    rows = pages.shape[1] * 16
    wide = 4 * SPAN + rows

    def widen(pool):
        x = torch.zeros((len(SPLIT_LENGTHS), wide, 8, 128), dtype=pool.dtype,
                        device=cuda)
        x[:, :rows] = decode.gather_pages(pool, pages)
        return x
    contiguous = decode.gqa_decode_attention(q, widen(k), widen(v), length=lv)
    assert decode.num_splits(wide) > decode.num_splits(rows)
    torch.testing.assert_close(paged, contiguous, rtol=0, atol=0)


# The decode tuner's spans (`spec.DECODE_BLOCKS`), the span it clamps to
# a cache of SPLIT_ROWS rows (808: twelve 64-key rounds and 40 keys), and
# spans of no whole round.
SPANS = (128, 256, 512, 1024, 2048, SPLIT_ROWS, 100, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_kernels_match_their_refs_at_every_span(cuda, kernel, span):
    """Each kernel at each span against its plain version at the split
    edges of the default span, and bitwise its own call at the split law's
    one-span layout: a span at or past the rows is one split a row."""
    fn, ref, args, lv = _decode_case(kernel, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                     q_dt="f32", kv_dt="f32")
    before = sum(_launch_counts())
    out = fn(*args, length=lv, block_k=span)
    want = ref(*args, length=lv)
    torch.cuda.synchronize()
    assert sum(_launch_counts()) == before + 1
    _assert_rows_close(out, want, True)
    assert not out[0].any(), "length 0 must give zeros"
    if span >= SPLIT_ROWS:
        torch.testing.assert_close(
            out, fn(*args, length=lv, block_k=SPLIT_ROWS), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_spans_on_one_stream_leave_the_tickets_zero(cuda, kernel):
    """Calls of different spans in a row on one stream (each with its own
    workspace, sized for its span) leave the ticket counters at zero, and
    a span's call repeats bitwise after the others."""
    fn, _, args, lv = _decode_case(kernel, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                   q_dt="bf16", kv_dt="bf16")
    first = fn(*args, length=lv, block_k=128)
    for span in (2048, 100, 256, 1):
        fn(*args, length=lv, block_k=span)
    again = fn(*args, length=lv, block_k=128)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    key = (cuda.index if cuda.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(cuda).cuda_stream)
    assert not decode._tickets[key].any()
    with pytest.raises(ValueError, match="block_k"):
        fn(*args, length=lv, block_k=0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["decode", "decode_int8"])
def test_dispatch_launches_the_kernel_at_the_plans_span(cuda, family,
                                                        tmp_path):
    """`autotune.dispatch` of the decode families tunes on the card (the
    spans timed, the plan cached) and launches the kernel once, at the
    plan's span: bitwise the direct call at that span."""
    kernel = ("decode_attention" if family == "decode"
              else "quantized_decode_attention")
    fn, _, args, lv = _decode_case(kernel, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                   q_dt="bf16", kv_dt="bf16")
    cache = autotune.TuneCache(tmp_path / "autotune.json")
    before = _launch_counts()
    out = autotune.dispatch(family, *args, length=lv, cache=cache)
    torch.cuda.synchronize()
    counts = _launch_counts()
    which = 0 if family == "decode" else 2
    spec = autotune.registry.get(family)
    problem, dtype = spec.problem_fn(*args, length=lv)
    plan = autotune.tune(family, problem, dtype, device=cuda, cache=cache)
    assert plan.source == "cache" and plan.provenance == "measured"
    # the timed spans launched the kernel too; the call itself once more
    assert counts[which] > before[which]
    assert [c - b for i, (c, b) in enumerate(zip(counts, before))
            if i != which] == [0, 0, 0]
    torch.testing.assert_close(
        out, fn(*args, length=lv, block_k=plan.knobs["block_k"]), rtol=0,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_calls_repeat_bitwise_and_leave_the_tickets_zero(cuda, kernel):
    """The last block of a row resets its ticket: a second call combines as
    the first did, and the counters are zero after each."""
    fn, _, args, lv = _decode_case(kernel, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                   q_dt="bf16", kv_dt="bf16")
    first = fn(*args, length=lv)
    second = fn(*args, length=lv)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    key = (cuda.index if cuda.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(cuda).cuda_stream)
    assert not decode._tickets[key].any()


@pytest.mark.cuda
@pytest.mark.parametrize("span", [None, *SPANS])
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_one_device_kernel_per_call(cuda, kernel, span):
    """With (B,) int32 lengths on the card, a call is one kernel and
    nothing else (no clamp, no second pass for the combine), and it needs
    no host read: captured in a CUDA graph it is one kernel node, at every
    span, and two replays give the direct call's output bit for bit, each
    leaving the ticket counters at zero for the next."""
    import ctypes
    fn, _, args, lv = _decode_case(kernel, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                   q_dt="bf16", kv_dt="bf16")
    want = fn(*args, length=lv, block_k=span)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):      # the capture stream's counters
        fn(*args, length=lv, block_k=span)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        out = fn(*args, length=lv, block_k=span)
    driver = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert driver.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert driver.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert driver.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    assert kinds == [0], f"graph node types {kinds} (0 = kernel)"
    graph.instantiate()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_kernel_clamps_lengths_past_the_rows_and_below_0(cuda):
    """The wrapper hands (B,) int32 lengths to the kernel as they are; the
    kernel clamps them to [0, rows] as `_lengths` does on the CPU."""
    q, k, v = _inputs(14, 3, 10, 2, 128, SPLIT_ROWS, "f32", cuda)
    wild = torch.tensor([-5, SPLIT_ROWS + 100, 3], dtype=torch.int32,
                        device=cuda)
    tame = torch.tensor([0, SPLIT_ROWS, 3], dtype=torch.int32, device=cuda)
    out = decode.gqa_decode_attention(q, k, v, length=wild)
    assert decode._lengths(wild, 3, SPLIT_ROWS, q.device) is wild
    torch.testing.assert_close(
        out, decode.gqa_decode_attention(q, k, v, length=tame), rtol=0,
        atol=0)
    _assert_rows_close(out, decode.decode_ref(q, k, v, length=tame), True)
    assert not out[0].any()


@pytest.mark.cuda
def test_every_decode_library_splits_at_split_keys(cuda):
    """A call without a span splits at `decode.SPLIT_KEYS`: bitwise the
    call that names it, and not the one-split call."""
    for name in DECODE_KERNELS:
        fn, _, args, lv = _decode_case(name, SPLIT_LENGTHS, SPLIT_ROWS, cuda,
                                       q_dt="f32", kv_dt="f32")
        default = fn(*args, length=lv)
        torch.testing.assert_close(
            default, fn(*args, length=lv, block_k=decode.SPLIT_KEYS),
            rtol=0, atol=0)
        assert not torch.equal(default,
                               fn(*args, length=lv, block_k=SPLIT_ROWS))


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


def _keep(sq, sk, causal, window, device):
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= i >= j
    if window is not None:
        keep &= i - j < window
    return keep


WGMMA_LENGTHS = [1, 127, 129, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 5])
@pytest.mark.parametrize("causal, window", [(True, None), (True, 100),
                                            (False, None), (False, 60)])
@pytest.mark.parametrize("sq, sk", [(s, s) for s in WGMMA_LENGTHS]
                         + [(1, 1000), (1000, 1), (127, 129), (129, 127)])
def test_wgmma_flash_kernel_matches_attention_ref(cuda, sq, sk, causal,
                                                  window, g):
    """The TMA/wgmma kernel (bf16, head_dim 128) against `attention_ref`
    by the per-row tolerance, at lengths on both sides of its 128-row and
    128-key tiles; rows with no key exactly 0."""
    assert flash.design(torch.bfloat16, 128) == "wgmma"
    hkv = 2
    q, k, v = _flash_inputs(sq * 7 + sk, 2, sq, sk, g * hkv, hkv, 128,
                            "bf16", cuda)
    before = flash.launches
    out = flash.flash_attention(q, k, v, scale=128 ** -0.5, causal=causal,
                                window=window)
    ref = flash_ref.attention_ref(q, k, v, scale=128 ** -0.5, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    _assert_rows_close(out, ref, False)
    empty = ~_keep(sq, sk, causal, window, cuda).any(-1)
    assert not out[:, empty].any(), "rows with no key must be exactly 0"


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 5])
def test_wgmma_flash_kernel_reads_strided_views(cuda, g):
    """q, k and v as head slices of one packed projection, and a batch of
    sequences, through the tensor maps' strides."""
    b, s, hkv, dh = 3, 300, 2, 128
    hq = g * hkv
    qkv = torch.randn((b, s, hq + 2 * hkv, dh), device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    for causal in (True, False):
        out = flash.flash_attention(q, k, v, scale=dh ** -0.5, causal=causal)
        ref = flash_ref.attention_ref(q, k, v, scale=dh ** -0.5,
                                      causal=causal)
        torch.cuda.synchronize()
        _assert_rows_close(out, ref, False)


@pytest.mark.cuda
def test_wgmma_flash_window_rows_with_no_key_are_zero(cuda):
    """Sq > Sk under a window: rows past Sk + window - 1 see no key, in
    tiles whose keys TMA fills with zeros past Sk."""
    sq, sk, window = 700, 130, 64
    q, k, v = _flash_inputs(5, 1, sq, sk, 10, 2, 128, "bf16", cuda)
    out = flash.flash_attention(q, k, v, scale=0.1, causal=True,
                                window=window)
    ref = flash_ref.attention_ref(q, k, v, scale=0.1, causal=True,
                                  window=window)
    torch.cuda.synchronize()
    empty = ~_keep(sq, sk, True, window, cuda).any(-1)
    assert int(empty.sum()) == sq - (sk + window - 1)
    assert not out[:, empty].any()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dt, dh", [("bf16", 128), ("bf16", 80),
                                    ("f32", 128)])
def test_flash_kernel_refuses_a_tile_it_is_not_built_for(cuda, dt, dh):
    """B5 runs the tile of its design (`kernel.tile`) and refuses any
    other before launching; its own tile, named, is the default call."""
    q, k, v = _flash_inputs(13, 1, 100, 100, 4, 2, dh, dt, cuda)
    bq, bk = flash.tile(q.dtype, dh)
    before = flash.launches
    for tile in [(bq * 2, bk), (bq, bk // 2), (256, 256)]:
        with pytest.raises(ValueError, match="built for"):
            flash.flash_attention(q, k, v, scale=0.1, block_q=tile[0],
                                  block_k=tile[1])
    assert flash.launches == before
    named = flash.flash_attention(q, k, v, scale=0.1, block_q=bq,
                                  block_k=bk)
    torch.testing.assert_close(
        named, flash.flash_attention(q, k, v, scale=0.1), rtol=0, atol=0)
    assert flash.launches == before + 2


# ---------------------------------------------------------------------------
# B6: blocked matmul; B7, B8: ELL SpMV
# ---------------------------------------------------------------------------

from repro_torch.core import tiling  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.matmul import ref as mm_ref  # noqa: E402
from repro_torch.kernels.spmv import kernel as spmv_kernel  # noqa: E402
from repro_torch.kernels.spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.spmv import ref as spmv_ref  # noqa: E402

MM_SHAPES = [(130, 70, 50), (1, 128, 256), (257, 129, 96), (64, 64, 64),
             (300, 520, 200)]
MM_TILES = [tiling.Tile(64, 64, 32), tiling.Tile(128, 256, 64),
            tiling.Tile(256, 128, 32), tiling.Tile(64, 256, 64)]


def _mm_operands(m, n, k, dt, device, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return (a.to(device=device, dtype=DTYPES[dt]),
            b.to(device=device, dtype=DTYPES[dt]), bias.to(device))


def _assert_within_row_tolerance(out, want):
    tol = mm_ref.row_tolerance(want, out.dtype)
    err = (out.float() - want.float()).abs()
    ratio = (err / tol).nan_to_num(0.0)
    assert float(ratio.max()) <= 1, (
        f"worst err/tol {float(ratio.max())}, max err {float(err.max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("tile", MM_TILES, ids=str)
@pytest.mark.parametrize("m, n, k", MM_SHAPES)
def test_matmul_kernel_matches_matmul_ref(cuda, m, n, k, tile, dt):
    a, b, _ = _mm_operands(m, n, k, dt, cuda)
    before = mm_kernel.launches
    out = mm_ops.matmul(a, b, tile=tile)
    want = mm_ref.matmul_ref(a, b)
    torch.cuda.synchronize()
    assert mm_kernel.launches == before + 1
    assert out.dtype == a.dtype and out.shape == (m, n)
    _assert_within_row_tolerance(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dt, out_dt", [("bf16", "bf16"), ("bf16", "f32"),
                                        ("f32", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("activation", list(mm_ref.ACTIVATIONS))
def test_matmul_kernel_epilogue(cuda, activation, dt, out_dt):
    a, b, bias = _mm_operands(130, 200, 72, dt, cuda, seed=3)
    for with_bias in (False, True):
        bb = bias if with_bias else None
        out = mm_ops.matmul(a, b, tile=tiling.Tile(64, 128, 32), bias=bb,
                            activation=activation, out_dtype=DTYPES[out_dt])
        want = mm_ref.matmul_ref(a, b, bias=None if bb is None else bb[None],
                                 activation=activation,
                                 out_dtype=DTYPES[out_dt])
        torch.cuda.synchronize()
        assert out.dtype == DTYPES[out_dt]
        _assert_within_row_tolerance(out, want)


@pytest.mark.cuda
def test_matmul_kernel_reads_a_strided_view(cuda):
    a, b, _ = _mm_operands(96, 80, 64, "bf16", cuda)
    wide = torch.zeros((96, 128), dtype=a.dtype, device=cuda)
    wide[:, :64] = a
    view = wide[:, :64]
    out = mm_ops.matmul(view, b, tile=tiling.Tile(64, 64, 32))
    _assert_within_row_tolerance(out, mm_ref.matmul_ref(a, b))


@pytest.mark.cuda
def test_matmul_kernel_refuses_what_it_cannot_take(cuda):
    a, b, _ = _mm_operands(64, 64, 64, "f32", cuda)
    with pytest.raises(ValueError, match="not built"):
        mm_ops.matmul(a, b, tile=tiling.Tile(256, 256, 64))
    with pytest.raises(ValueError, match="both float32"):
        mm_ops.matmul(a, b.bfloat16(), tile=tiling.Tile(64, 64, 32))
    with pytest.raises(ValueError, match="contiguous last axis"):
        mm_ops.matmul(a.t(), b, tile=tiling.Tile(64, 64, 32))


# B6's three designs: wgmma+TMA for bf16 operands TMA can read, mma.sync
# for other bf16 operands, CUDA cores for f32 (`kernel.design`).
# (m, n, k): ragged M, N and K with rows of a multiple of 16 bytes, M = 1,
# and more 64 x 64 tiles than SMs, so the persistent grid walks.
WGMMA_SHAPES = [(130, 72, 56), (1, 128, 256), (200, 264, 40),
                (1030, 1048, 264)]


def _launched(before):
    return {d: v - before[d] for d, v in mm_kernel.design_launches.items()
            if v != before[d]}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tiling.HOPPER_TILES, ids=str)
@pytest.mark.parametrize("m, n, k", WGMMA_SHAPES)
def test_wgmma_kernel_on_every_tile(cuda, m, n, k, tile):
    a, b, _ = _mm_operands(m, n, k, "bf16", cuda, seed=m + n + k)
    assert mm_kernel.design(a, b, tile) == "wgmma+TMA"
    want = mm_ref.matmul_ref(a, b)
    before = dict(mm_kernel.design_launches)
    out = mm_kernel.blocked_matmul(a, b, tile)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    _assert_within_row_tolerance(out, want)
    assert _launched(before) == {"wgmma+TMA": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("out_dt", ["bf16", "f32"])
@pytest.mark.parametrize("activation", list(mm_ref.ACTIVATIONS))
@pytest.mark.parametrize("tile", [tiling.Tile(128, 256, 64),
                                  tiling.Tile(256, 128, 32),
                                  tiling.Tile(64, 64, 32)], ids=str)
def test_wgmma_kernel_epilogue(cuda, tile, activation, out_dt):
    """Bias, activation and one cast from the accumulators, into f32 and
    bf16, on ragged M, N and K; with an odd N (B a view of a wider
    matrix) the row stride of C is odd and the epilogue stores singly."""
    for m, n, k in [(130, 264, 72), (70, 75, 64)]:
        a, b, bias = _mm_operands(m, n, k, "bf16", cuda, seed=n)
        if n % 2:
            wide = torch.zeros((k, 80), dtype=b.dtype, device=cuda)
            wide[:, :n] = b
            b = wide[:, :n]
        assert mm_kernel.design(a, b, tile) == "wgmma+TMA"
        for bb in (None, bias):
            before = dict(mm_kernel.design_launches)
            out = mm_ops.matmul(a, b, tile=tile, bias=bb,
                                activation=activation,
                                out_dtype=DTYPES[out_dt])
            want = mm_ref.matmul_ref(
                a, b, bias=None if bb is None else bb[None],
                activation=activation, out_dtype=DTYPES[out_dt])
            torch.cuda.synchronize()
            assert _launched(before) == {"wgmma+TMA": 1}
            assert out.dtype == DTYPES[out_dt]
            _assert_within_row_tolerance(out, want)


@pytest.mark.cuda
def test_unaligned_bf16_view_runs_mma_sync(cuda):
    """A view whose base lies 8 bytes past 16 cannot be read by TMA: it
    runs the mma.sync kernel, f32 the CUDA cores."""
    a, b, _ = _mm_operands(96, 80, 64, "bf16", cuda)
    wide = torch.zeros((96, 72), dtype=a.dtype, device=cuda)
    wide[:, 4:68] = a
    view = wide[:, 4:68]
    tile = tiling.Tile(64, 64, 32)
    assert mm_kernel.design(view, b, tile) == "mma.sync"
    before = dict(mm_kernel.design_launches)
    out = mm_ops.matmul(view, b, tile=tile)
    torch.cuda.synchronize()
    assert _launched(before) == {"mma.sync": 1}
    _assert_within_row_tolerance(out, mm_ref.matmul_ref(a, b))
    a32, b32 = a.float(), b.float()
    assert mm_kernel.design(a32, b32, tile) == "cuda cores"
    before = dict(mm_kernel.design_launches)
    out = mm_ops.matmul(a32, b32, tile=tile)
    torch.cuda.synchronize()
    assert _launched(before) == {"cuda cores": 1}
    _assert_within_row_tolerance(out, mm_ref.matmul_ref(a32, b32))


@pytest.mark.cuda
def test_launch_smem_is_hopper_smem_bytes(cuda):
    """The dynamic shared memory each built kernel launches with is what
    `tiling.hopper_smem_bytes` (which the tuner's budget checks read)
    says: the wgmma ring in bf16, two padded stages in f32."""
    from repro_torch.core import hardware
    for t in tiling.HOPPER_TILES:
        assert mm_kernel.launch_smem_bytes(t, "wgmma+TMA") == \
            tiling.hopper_smem_bytes(t, 2)
        assert mm_kernel.launch_smem_bytes(t, "cuda cores") == \
            tiling.hopper_smem_bytes(t, 4)
        assert 0 < mm_kernel.launch_smem_bytes(t, "mma.sync") <= \
            hardware.H100_SXM.smem_bytes


@pytest.mark.cuda
def test_failed_wgmma_launch_raises(cuda, monkeypatch):
    """A launch that fails raises and no other design runs in its place;
    the C entry refuses operands TMA cannot read without launching."""
    a, b, _ = _mm_operands(128, 128, 64, "bf16", cuda)
    tile = tiling.Tile(128, 128, 64)
    entry = mm_kernel._wgmma_lib().blocked_matmul_wgmma
    out = torch.empty((127, 128), dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert entry(a.data_ptr() + 2, b.data_ptr(), None, out.data_ptr(), 127,
                 128, 64, 64, 128, 128, 128, 128, 64, 1, 0, 0, stream) != 0

    class Failing:
        @staticmethod
        def blocked_matmul_wgmma(*args):
            return 700                      # cudaErrorIllegalAddress

    monkeypatch.setattr(mm_kernel, "_wgmma_lib", lambda: Failing)
    before, total = dict(mm_kernel.design_launches), mm_kernel.launches
    with pytest.raises(RuntimeError, match=r"wgmma\+TMA.*700"):
        mm_ops.matmul(a, b, tile=tile)
    assert mm_kernel.design_launches == before
    assert mm_kernel.launches == total


def _ell(seed, m, n, density, device, scheme="round_robin"):
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < density) * rng.standard_normal((m, n))
    lens = (dense != 0).sum(1)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = np.nonzero(dense)[1].astype(np.int32)
    vals = dense[dense != 0].astype(np.float32)
    mat = spmv_ops.pack_csr(indptr, cols, vals, (m, n), scheme=scheme,
                            device=device)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    return mat, x, dense


def _assert_spmv_close(y, want, mat, x):
    tol = spmv_ref.row_tolerance(mat.cols, mat.vals, x)
    err = (y - want).abs()
    assert bool((err <= tol).all()), (
        f"max err {float(err.max())}, worst err/tol "
        f"{float((err / tol).nan_to_num(0.0).max())}")


SPMV_SHAPES = [(555, 300, 0.02), (91, 91, 0.5), (2030, 128, 0.05),
               (3001, 1000, 0.3)]


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", spmv_kernel.RESIDENT_ROWS)
@pytest.mark.parametrize("m, n, density", SPMV_SHAPES)
def test_ell_spmv_matches_spmv_ell_ref(cuda, m, n, density, block_rows):
    mat, x, dense = _ell(m + n, m, n, density, cuda)
    before = spmv_kernel.launches
    y = spmv_kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=block_rows)
    want = spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x)
    torch.cuda.synchronize()
    assert spmv_kernel.launches == before + 1
    _assert_spmv_close(y, want, mat, x)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", spmv_kernel.RESIDENT_ROWS)
@pytest.mark.parametrize("m, n, density", SPMV_SHAPES)
def test_ell_spmv_with_row_lens_matches_both_refs(cuda, m, n, density,
                                                  block_rows):
    mat, x, dense = _ell(m + n, m, n, density, cuda)
    before = spmv_kernel.launches
    y = spmv_kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=block_rows,
                             row_lens=mat.lens)
    torch.cuda.synchronize()
    assert spmv_kernel.launches == before + 1
    _assert_spmv_close(y, spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x), mat,
                       x)
    _assert_spmv_close(y, spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x,
                                                mat.lens), mat, x)
    _assert_csr_close(y, mat, x)


def _assert_csr_close(y, mat, x):
    """y (packed order) against `spmv_csr_ref` in the original order."""
    m = mat.shape[0]
    order = torch.from_numpy(np.argsort(mat.perm)).to(x.device)
    got = y[:m][order]
    tol = spmv_ref.row_tolerance(mat.cols, mat.vals, x, mat.lens)[:m][order]
    rows = np.asarray(mat.perm)
    lens = np.asarray(mat.row_lens[:m])
    indptr = np.zeros(m + 1, np.int64)
    indptr[rows + 1] = lens
    indptr = np.cumsum(indptr)
    cols = mat.cols[:m].cpu().numpy()
    vals = mat.vals[:m].cpu().numpy()
    idx = np.concatenate([cols[r, :lens[r]] for r in np.argsort(rows)])
    dat = np.concatenate([vals[r, :lens[r]] for r in np.argsort(rows)])
    want = spmv_ref.spmv_csr_ref(torch.from_numpy(indptr).to(x.device),
                                 torch.from_numpy(idx).to(x.device),
                                 torch.from_numpy(dat).to(x.device), x, m)
    err = (got - want).abs()
    assert bool((err <= tol).all()), float(err.max())


def _rows_csr(rows, n, seed):
    """CSR of rows given as lists of distinct columns, random values."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate([np.sort(np.asarray(r, np.int64))
                              for r in rows]).astype(np.int32)
    data = rng.standard_normal(len(indices)).astype(np.float32)
    return indptr.astype(np.int32), indices, data, (len(rows), n)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", [32, 128, 1024])
@pytest.mark.parametrize("kind", ["equal_91x793", "empty_and_full"])
def test_ell_spmv_row_lens_on_long_equal_and_empty_rows(cuda, kind,
                                                        block_rows):
    """BIBD_14_7's shape (91 rows of 792 of 793 columns: few long rows,
    spread over the SMs by `launch_geometry`), and rows of length 0 next
    to rows at the full ELL width and rows in between."""
    rng = np.random.default_rng(5)
    if kind == "equal_91x793":
        n = 793
        rows = [rng.choice(n, 792, replace=False) for _ in range(91)]
    else:
        n = 700
        rows = [[] if r % 3 == 0 else
                rng.choice(n, 256 if r % 3 == 1 else int(rng.integers(1, 256)),
                           replace=False) for r in range(300)]
    mat = spmv_ops.pack_csr(*_rows_csr(rows, n, 6), scheme="none",
                            device=cuda)
    width = mat.cols.shape[1]
    lens = mat.row_lens
    if kind == "equal_91x793":
        assert width == 896 and set(lens[:91]) == {792}
        geo = spmv_kernel.launch_geometry(91, width, 1024 // block_rows, n,
                                          132)
        assert geo["grid"] == 91 and geo["lanes"] == 32
    else:
        assert width == 256 and lens.max() == 256 and (lens[:300] == 0).any()
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    y = spmv_kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=block_rows,
                             row_lens=mat.lens)
    torch.cuda.synchronize()
    _assert_spmv_close(y, spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x), mat,
                       x)
    _assert_csr_close(y, mat, x)
    assert bool((y[torch.from_numpy(lens == 0).to(cuda)] == 0).all())


@pytest.mark.cuda
def test_row_lens_kernel_ignores_padding_where_x0_is_inf(cuda):
    """Where x[0] is not finite, the padded reference (`spmv_ell_ref`, as
    the JAX package's) adds a pad's 0 * x[0] = NaN to every row with
    padding; the length-aware kernel uses no pad, so it gives the CSR
    product, finite on the rows that do not hold column 0 (ROADMAP queue
    C).  Without row lengths the kernel walks the pads as the reference
    does."""
    rng = np.random.default_rng(8)
    n = 500
    rows = [rng.choice(np.arange(1, n), int(rng.integers(1, 200)),
                       replace=False) for _ in range(400)]
    mat = spmv_ops.pack_csr(*_rows_csr(rows, n, 9), scheme="sorted",
                            device=cuda)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    x[0] = float("inf")
    padded = torch.from_numpy(mat.row_lens < mat.cols.shape[1]).to(cuda)
    want_padded = spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x)
    assert bool(torch.isnan(want_padded[padded]).all())
    y = spmv_kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=64,
                             row_lens=mat.lens)
    y_full = spmv_kernel.ell_spmv(x, mat.cols, mat.vals, block_rows=64)
    torch.cuda.synchronize()
    live = mat.lens > 0
    assert bool(torch.isfinite(y).all())
    assert bool(torch.isnan(y_full[padded]).all())
    want = spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x, mat.lens)
    tol = spmv_ref.row_tolerance(mat.cols, mat.vals, x, mat.lens)
    assert bool(((y - want).abs() <= tol)[live].all())
    _assert_csr_close(y, mat, x)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lens", [True, False])
def test_ell_spmv_at_a_width_of_no_whole_vectors(cuda, with_lens):
    """A width of 125 entries (`pack_csr`'s align is the caller's) leaves
    rows off 16 bytes: the kernel takes 4-byte loads."""
    mat, x, _ = _ell(11, 300, 200, 0.05, cuda)
    assert int(mat.lens.max()) <= 125
    cols = mat.cols[:, :125].contiguous()
    vals = mat.vals[:, :125].contiguous()
    lens = mat.lens if with_lens else None
    y = spmv_kernel.ell_spmv(x, cols, vals, block_rows=64, row_lens=lens)
    torch.cuda.synchronize()
    _assert_spmv_close(y, spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x), mat,
                       x)


@pytest.mark.cuda
def test_ell_spmv_refuses_bad_row_lens(cuda):
    mat, x, _ = _ell(3, 200, 300, 0.05, cuda)
    lens = mat.lens
    for bad, match in [(lens[:-1], "is not"), (lens.long(), "int32"),
                       (lens.cpu(), "lies on"),
                       (lens + mat.cols.shape[1], "outside"),
                       (lens - 1 - lens.max(), "outside")]:
        with pytest.raises(ValueError, match=match):
            spmv_kernel.ell_spmv(x, mat.cols, mat.vals, row_lens=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", spmv_kernel.BLOCKED_ROWS)
@pytest.mark.parametrize("m, n, density", SPMV_SHAPES)
def test_ell_spmv_blocked_matches_its_ref_and_b7(cuda, m, n, density,
                                                 block_rows):
    mat, x, _ = _ell(m + n, m, n, density, cuda)
    if not spmv_kernel.blocked_fits(mat.cols.shape[1], block_rows):
        with pytest.raises(ValueError, match="not supported"):
            spmv_kernel.ell_spmv_blocked(x, mat.cols, mat.vals,
                                         block_rows=block_rows)
        return
    resident = spmv_kernel.ell_spmv(x, mat.cols, mat.vals)
    for block_cols in (128, 256, max(1, n // 2), 4099):
        before = spmv_kernel.blocked_launches
        y = spmv_kernel.ell_spmv_blocked(x, mat.cols, mat.vals,
                                         block_rows=block_rows,
                                         block_cols=block_cols)
        want = spmv_ref.spmv_blocked_ref(mat.cols, mat.vals, x, block_cols)
        torch.cuda.synchronize()
        assert spmv_kernel.blocked_launches == before + 1
        _assert_spmv_close(y, want, mat, x)
        _assert_spmv_close(y, resident, mat, x)


def _banded_csr(rows, n, per_row, half, seed):
    """CSR with ``per_row`` distinct columns a row within ``half`` of the
    diagonal (clipped to [0, n))."""
    rng = np.random.default_rng(seed)
    indptr, indices = [0], []
    for r in range(rows):
        lo, hi = max(0, r - half), min(n, r + half + 1)
        k = min(per_row, hi - lo)
        indices.extend(sorted(rng.choice(np.arange(lo, hi), k,
                                         replace=False)))
        indptr.append(len(indices))
    data = rng.standard_normal(len(indices)).astype(np.float32)
    return (np.array(indptr, np.int32), np.array(indices, np.int32), data,
            (rows, n))


def _blocked_against_refs(mat, x, block_rows, block_cols):
    before = spmv_kernel.blocked_launches
    y = spmv_kernel.ell_spmv_blocked(x, mat.cols, mat.vals,
                                     block_rows=block_rows,
                                     block_cols=block_cols)
    torch.cuda.synchronize()
    assert spmv_kernel.blocked_launches == before + 1
    _assert_spmv_close(y, spmv_ref.spmv_ell_ref(mat.cols, mat.vals, x), mat,
                       x)
    _assert_spmv_close(y, spmv_ref.spmv_blocked_ref(mat.cols, mat.vals, x,
                                                    block_cols), mat, x)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows, block_cols", [(16, 512), (64, 1024),
                                                    (128, 4099),
                                                    (128, 20_003)])
def test_blocked_kernel_on_a_banded_matrix(cuda, block_rows, block_cols):
    """Columns within 64 of the diagonal in natural row order: a row
    block's entries fall in one or two slabs, which gather, and the
    other slabs are skipped; at 20,003 columns x is one slab, staged."""
    n = 20_003                            # not a multiple of 4
    mat = spmv_ops.pack_csr(*_banded_csr(n, n, 40, 64, 3), scheme="none",
                            device=cuda)
    plan = spmv_kernel.slab_plan(mat.cols, mat.vals, n, block_rows,
                                 block_cols)
    if block_cols >= n:
        assert plan["staged"] == plan["pairs"] == plan["blocks"]
    else:
        assert plan["staged"] == 0
        assert plan["gathered"] > 0 and plan["skipped"] > plan["gathered"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(cuda)
    _blocked_against_refs(mat, x, block_rows, block_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("block_cols", [4096, 1000, 97])
def test_blocked_kernel_gathers_a_scattered_matrix(cuda, block_cols):
    """Every row spread over all of x: each slab holds a few of a block's
    entries, which gather x directly."""
    from repro_torch.benchmarks import table2_spmv
    n = 400_001
    mat = spmv_ops.pack_csr(*table2_spmv.synthesize_large(4000, n, seed=2),
                            scheme="sorted", device=cuda)
    plan = spmv_kernel.slab_plan(mat.cols, mat.vals, n, 64, block_cols)
    assert plan["staged"] == 0 and plan["gathered"] > 0
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n)
                         .astype(np.float32)).to(cuda)
    _blocked_against_refs(mat, x, 64, block_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("block_cols", [1024, 3 * 1024 + 3])
def test_blocked_kernel_skips_empty_slabs_at_32_entries_a_lane(cuda,
                                                                block_cols):
    """One matrix whose first rows are dense in the first slab, middle
    rows spread over x, and whose last slab, ragged at 3 columns, no row
    touches (skipped), at a width that needs 32 entries a lane; and the
    same matrix with x as one slab, staged."""
    rng = np.random.default_rng(9)
    n = 3 * 1024 + 3
    rows = []
    for r in range(512):
        if r < 256:
            cols = rng.choice(1024, 200, replace=False)      # slab 0
        else:
            cols = rng.choice(3 * 1024, 2, replace=False)    # spread
        rows.append(np.sort(cols))
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in rows])])
    indices = np.concatenate(rows).astype(np.int32)
    data = rng.standard_normal(len(indices)).astype(np.float32)
    mat = spmv_ops.pack_csr(indptr.astype(np.int32), indices, data,
                            (512, n), scheme="none", device=cuda)
    assert mat.cols.shape[1] == 256
    block_rows = 64                        # 8 lanes a row: 32 entries each
    assert spmv_kernel.blocked_fits(256, block_rows)
    plan = spmv_kernel.slab_plan(mat.cols, mat.vals, n, block_rows,
                                 block_cols)
    if block_cols >= n:
        assert plan["staged"] == plan["blocks"]
    else:
        assert plan["staged"] == 0 and plan["gathered"] > 0
        assert plan["skipped"] >= plan["blocks"]   # the ragged slab, at least
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    _blocked_against_refs(mat, x, block_rows, block_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["round_robin", "lpt", "sorted", "none"])
def test_spmv_in_original_row_order_matches_dense(cuda, scheme):
    mat, x, dense = _ell(7, 2030, 128, 0.05, cuda, scheme=scheme)
    want = torch.from_numpy((dense @ x.cpu().numpy().astype(np.float64))
                            .astype(np.float32)).to(cuda)
    for kw in ({}, {"block_rows": 32, "block_cols": 64}):
        y = spmv_ops.spmv(mat, x, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_dispatch_on_the_card_launches_the_kernels(cuda, tmp_path):
    cache = autotune.TuneCache(tmp_path / "c.json")
    mat, x, dense = _ell(1, 555, 300, 0.02, cuda)
    before = spmv_kernel.launches + spmv_kernel.blocked_launches
    y = autotune.dispatch("spmv", mat, x, cache=cache)
    torch.cuda.synchronize()
    assert spmv_kernel.launches + spmv_kernel.blocked_launches > before
    want = dense @ x.cpu().numpy().astype(np.float64)
    torch.testing.assert_close(y.cpu(), torch.from_numpy(want).float(),
                               rtol=1e-4, atol=1e-4)
    a, b, _ = _mm_operands(200, 300, 100, "bf16", cuda)
    before = mm_kernel.launches
    out = autotune.dispatch("matmul", a, b, cache=cache)
    torch.cuda.synchronize()
    assert mm_kernel.launches > before
    _assert_within_row_tolerance(out, mm_ref.matmul_ref(a, b))
    plan = autotune.tune("matmul", {"m": 200, "n": 300, "k": 100},
                         torch.bfloat16, device=cuda, cache=cache)
    assert plan.source == "cache" and plan.provenance == "measured"
    assert torch.cuda.get_device_name(cuda) in plan.key


@pytest.mark.cuda
def test_spmv_kernels_refuse_what_they_cannot_take(cuda):
    mat, x, _ = _ell(1, 100, 70000, 0.001, cuda)
    with pytest.raises(ValueError, match="do not fit"):
        spmv_kernel.ell_spmv(x, mat.cols, mat.vals)
    with pytest.raises(ValueError, match="float32"):
        spmv_kernel.ell_spmv(x.double(), mat.cols, mat.vals.double())
    with pytest.raises(ValueError, match="not supported"):
        spmv_kernel.ell_spmv(x[:300], mat.cols % 300, mat.vals, block_rows=7)
    for wrapper in (spmv_kernel.ell_spmv, spmv_kernel.ell_spmv_blocked):
        with pytest.raises(ValueError, match="outside x's"):
            wrapper(x[:300], mat.cols, mat.vals)


# -- faults through the decode kernels (the chaos harness's kv_corrupt) ------

NAN_KEY = 300                 # inside split 1 of 16 at span 256, not the last
NAN_LENGTHS = [4096, 4096, 1000]


def _row_of(args, kernel, seq, key):
    """The (cache leaf index, index tuple) of ``seq``'s token ``key``: the
    contiguous row, or the pool page and row its table names."""
    if kernel.startswith("paged"):
        pages = args[-1]
        page_size = args[1].shape[1]
        return int(pages[seq, key // page_size]), key % page_size
    return seq, key


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["k", "v"])
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_a_nan_row_poisons_exactly_its_kv_group(cuda, kernel, leaf):
    """A NaN in one key or value row (int8: in that row's f32 scale, the
    layout's only float leaf) of one (sequence, KV head), at key 300 of
    4,096: inside split 1 of 16, not the last, so the in-kernel combine
    (`csrc/decode_body.cuh`, where `fmaxf` drops a NaN from a running
    max) must carry it.  That KV head's query group is NaN; every other
    (sequence, query head) row is bitwise the clean call's."""
    quant = "quantized" in kernel
    hkv, g, head = 2, 5, 1
    fn, _, args, lv = _decode_case(kernel, NAN_LENGTHS, 4096, cuda,
                                   q_dt="bf16", kv_dt="f32", hkv=hkv, g=g)
    assert decode.num_splits(4096, decode.SPLIT_KEYS) > NAN_KEY // 256 + 1
    clean = fn(*args, length=lv, block_k=256).float().cpu()
    # operands: (q, k, v) or (q, k codes, k scales, v codes, v scales)
    idx = ({"k": 2, "v": 4} if quant else {"k": 1, "v": 2})[leaf]
    poisoned = list(args)
    poisoned[idx] = args[idx].clone()
    outer, row = _row_of(args, kernel, 0, NAN_KEY)
    poisoned[idx][outer, row, head] = float("nan")
    out = fn(*poisoned, length=lv, block_k=256).float().cpu()
    torch.cuda.synchronize()
    group = torch.zeros(out.shape[:2], dtype=torch.bool)
    group[0, head * g:(head + 1) * g] = True
    assert bool(torch.isnan(out[group]).all()), "the group lost the NaN"
    assert not bool(torch.isnan(out[~group]).any())
    assert torch.equal(out[~group], clean[~group])


@pytest.mark.cuda
def test_cache_poison_slot_spares_the_trash_page_on_the_card(cuda):
    """`transformer.cache_poison_slot` on a paged cache on the card: the
    slot's pages are NaN, every other page and the trash page past the
    pool keep their bytes, and a decode step of the other slot reads no
    NaN."""
    import repro_torch.configs as configs
    from repro_torch.models import layers, transformer
    from repro_torch.runtime import paging
    cfg = configs.get_smoke("qwen3_14b")
    spec = paging.PageSpec.build(2, 32, 4, 10)
    for kv in (torch.float32, torch.int8):
        cache = transformer.cache_init(cfg, 2, 32, dtype=kv, device=cuda,
                                       paged=spec)
        for a in cache["blocks"].values():
            if a.is_floating_point():
                layers.with_trash_page(a, axis=1).fill_(3.0)
        cache["pages"][0, :2] = torch.tensor([7, 2], device=cuda)
        cache["pages"][1, :1] = torch.tensor([5], device=cuda)
        transformer.cache_poison_slot(cache, 0, paged=spec)
        torch.cuda.synchronize()
        for a in cache["blocks"].values():
            if not a.is_floating_point():
                continue
            full = layers.with_trash_page(a, axis=1)
            assert bool((full[:, spec.num_pages] == 3.0).all())
            assert bool(torch.isnan(a[:, [7, 2]]).all())
            rest = [p for p in range(spec.num_pages) if p not in (7, 2)]
            assert bool((a[:, rest] == 3.0).all())


# -- the other model families on the card -------------------------------------

@pytest.mark.cuda
def test_moe_layer_is_bitwise_repeatable_at_k8(cuda):
    """Qwen3-MoE's routing (128 experts, top 8) on bf16 tokens: repeated
    calls give the same bits (a stable sort picks the experts, the eight
    contributions are added in a fixed order, no atomics), and the
    experts chosen equal the CPU's for tokens with no near-tie."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="moe-k8", family="moe", num_layers=1,
                      d_model=256, d_ff=128, vocab_size=64, num_heads=4,
                      num_kv_heads=2, num_experts=128, top_k=8, moe_d_ff=128)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((4, 48, cfg.d_model), generator=gen, device=cuda,
                    dtype=torch.float32).bfloat16()
    first, aux = moe.apply_sharded(params, x, cfg)
    for _ in range(4):
        again, aux2 = moe.apply_sharded(params, x, cfg)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))
        assert torch.equal(aux2, aux)
    idx, _, _ = moe.route(params, x.reshape(-1, cfg.d_model), cfg)
    cpu = {k: v.cpu() for k, v in params.items()}
    idx_cpu, _, _ = moe.route(cpu, x.reshape(-1, cfg.d_model).cpu(), cfg)
    assert (idx.cpu() == idx_cpu).float().mean() > 0.99
    assert torch.isfinite(first).all()


@pytest.mark.cuda
def test_ring_buffer_attention_matches_its_cpu_result(cuda):
    """The sliding-window ring cache on the card: 20 tokens one by one
    through a ring of 6 rows (wrapped three times), f32, each step's
    output and the ring's rows against the same steps on the CPU."""
    from repro_torch.models import layers
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="swa", family="dense", num_layers=1, d_model=64,
                      d_ff=128, vocab_size=97, num_heads=4, num_kv_heads=2,
                      sliding_window=6)
    gen = torch.Generator().manual_seed(0)
    params = layers.attention_init(gen, cfg)
    x = torch.randn((2, 20, cfg.d_model), generator=gen)
    outs = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        cache = layers.attention_cache_init(cfg, 2, 1000, torch.float32, dev)
        assert cache["k"].shape[1] == 6
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        ys = []
        for t in range(20):
            y, cache = layers.attention_apply(
                p, x[:, t:t + 1].to(dev), cfg, lengths[:, None], cache=cache,
                lengths=lengths)
            lengths = lengths + 1
            ys.append(y)
        outs[str(dev)] = (torch.cat(ys, 1).cpu(), cache["k"].cpu())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "qwen3_moe_235b",
                                  "rwkv6_7b", "jamba_1_5_large_398b",
                                  "h2o_danube_1_8b", "internvl2_2b"])
def test_one_decode_step_of_each_family_is_finite(cuda, arch):
    """Each family's SMOKE model on the card: a prefill of both slots
    (Danube's 8 tokens fill its ring), then one ragged decode step in bf16
    through the guarded serve step; every logit finite, the attention families'
    decode through the decode kernel (Danube's ring on the plain path)."""
    import repro_torch.configs as configs
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = configs.get_smoke(arch)
    params = transformer.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                              dtype=torch.bfloat16)
    cache = transformer.cache_init(cfg, 2, 24, dtype=torch.float32,
                                   device=cuda)
    step = steps.make_guarded_serve_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    nxt, ok, cache = step(params, cache, toks,
                          torch.tensor([True, True], device=cuda))
    assert ok.all()
    decode.launches = 0
    nxt, ok, cache, last = step(params, cache, nxt,
                                torch.tensor([True, False], device=cuda),
                                return_logits=True)
    assert ok.all() and torch.isfinite(last).all()
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    want = 0 if cfg.sliding_window or cfg.family == "ssm" else attn
    assert decode.launches == want
    assert cache["lengths"].tolist() == [9, 8]
