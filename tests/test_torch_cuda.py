"""The CUDA decode-attention kernel on the card, against its plain
PyTorch version.  Every test here is marked ``cuda`` and skips on a host
without a card; this file imports no JAX, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: with an f32 cache and f32 q the kernel and `decode_ref` differ
in summation order only: 1e-5 on outputs of order 1.  With bf16 each side
rounds its f32 result to bf16 once, so an element may land one bf16 ulp
away, at most 2^-7 of its own size.  The bound is taken per (sequence,
query head) row, 2^-7 of that row's largest |ref|, so an error in a long
row or at a tile boundary cannot hide under the scale of another row; a
row of length 0 must be exactly zero.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.kernels.attention import decode  # noqa: E402

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
