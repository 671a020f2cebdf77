"""Layer-by-layer parity of `repro_torch.models.layers` with the JAX
`repro.models.layers`, on the CPU, inputs drawn with numpy.

Tolerances: in f32 the two frameworks differ only in summation order,
so 1e-5 (2e-5 for attention, whose softmax sums over the keys).  In bf16
every rounding to bf16 costs up to 2^-8 relative, and the frameworks round
intermediates at different places, so outputs of order 1 agree to a few
bf16 ulps: 3e-2.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _pair(a: np.ndarray, dt: str):
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rmsnorm(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    jx, tx = _pair(x, dt)
    out_t = tl.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6)
    assert out_t.dtype == tx.dtype
    _close(out_t, jl.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6),
           DTYPES[dt][2])


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_apply_rope(dt, per_slot):
    rng = np.random.default_rng(1)
    b, s, h, dh = 3, 7, 4, 16
    x = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    if per_slot:     # ragged decode: each slot at its own depth
        pos = (rng.integers(0, 50, (b, 1)) + np.arange(s)).astype(np.int32)
    else:
        pos = np.arange(s, dtype=np.int32)[None]
    jx, tx = _pair(x, dt)
    out_t = tl.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    out_j = jl.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    _close(out_t, out_j, DTYPES[dt][2])


def test_rope_is_rotate_half():
    """Position p rotates the pair (x[i], x[i + dh/2]) by p * freq[i]."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    out = tl.apply_rope(x, torch.tensor([[3]]), 10_000.0)[0, 0, 0]
    ang = 3 * float(tl.rope_frequencies(8, 10_000.0)[1])
    assert out[1].item() == pytest.approx(np.cos(ang), abs=1e-6)
    assert out[5].item() == pytest.approx(np.sin(ang), abs=1e-6)


def _attn_inputs(rng, b, sq, sk, hq, hkv, dh):
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("g", [1, 2, 5])
def test_attention_core_causal(g, dt):
    rng = np.random.default_rng(2)
    b, s, hkv, dh = 2, 9, 2, 16
    q, k, v = _attn_inputs(rng, b, s, s, g * hkv, hkv, dh)
    pos = np.arange(s, dtype=np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    out_t = tl.attention_core(tq, tk, tv, torch.from_numpy(pos),
                              torch.from_numpy(pos), causal=True,
                              scale=dh ** -0.5)
    out_j = jl.attention_core(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                              causal=True, window=None, scale=dh ** -0.5)
    _close(out_t, out_j, 2 * DTYPES[dt][2])


@pytest.mark.parametrize("g", [1, 2, 5])
def test_attention_core_per_slot_k_valid(g):
    """Ragged decode over a cache: per-slot (B, Sq) positions and (B, Sk)
    valid prefixes, including a slot whose prefix is empty."""
    rng = np.random.default_rng(3)
    b, sq, sk, hkv, dh = 3, 2, 12, 2, 8
    q, k, v = _attn_inputs(rng, b, sq, sk, g * hkv, hkv, dh)
    lengths = np.array([5, 12, 0], np.int32)
    q_pos = (lengths[:, None] - sq + np.arange(sq)).astype(np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    k_valid = k_pos[None] < lengths[:, None]
    out_t = tl.attention_core(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)),
        causal=True, scale=dh ** -0.5, k_valid=torch.from_numpy(k_valid))
    out_j = jl.attention_core(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), causal=True,
        window=None, scale=dh ** -0.5, k_valid=jnp.asarray(k_valid))
    _close(out_t, out_j, 2 * F32_TOL)


def test_attention_core_chunk_q():
    """The chunk_q split gives the unsplit result (and JAX's)."""
    rng = np.random.default_rng(4)
    b, s, hkv, g, dh = 1, 16, 2, 2, 8
    q, k, v = _attn_inputs(rng, b, s, s, g * hkv, hkv, dh)
    pos = np.arange(s, dtype=np.int32)
    args_t = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    chunked = tl.attention_core(*args_t, causal=True, scale=dh ** -0.5,
                                chunk_q=4)
    whole = tl.attention_core(*args_t, causal=True, scale=dh ** -0.5)
    out_j = jl.attention_core(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                              causal=True, window=None, scale=dh ** -0.5,
                              chunk_q=4)
    _close(chunked, out_j, 2 * F32_TOL)
    _close(chunked, whole.numpy(), 1e-6)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_swiglu_apply(dt):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = {"w_gate": rng.standard_normal((16, 40)) * 0.3,
         "w_up": rng.standard_normal((16, 40)) * 0.3,
         "w_down": rng.standard_normal((40, 16)) * 0.3}
    w = {k: a.astype(np.float32) for k, a in w.items()}
    jx, tx = _pair(x, dt)
    out_t = tl.swiglu_apply({k: torch.from_numpy(a) for k, a in w.items()},
                            tx)
    out_j = jl.swiglu_apply({k: jnp.asarray(a) for k, a in w.items()}, jx)
    assert out_t.dtype == tx.dtype
    _close(out_t, out_j, DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_embedding_lookup_and_unembed(dt):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 12)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    emb_t = tl.embedding_lookup({"table": torch.from_numpy(table)},
                                torch.from_numpy(toks))
    emb_j = jl.embedding_lookup({"table": jnp.asarray(table)},
                                jnp.asarray(toks))
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    jx, tx = _pair(emb_t.numpy(), dt)
    logits_t = tl.unembed({"table": torch.from_numpy(table)}, tx)
    logits_j = jl.unembed({"table": jnp.asarray(table)}, jx)
    assert logits_t.shape == (2, 7, 50) and logits_t.dtype == tx.dtype
    # logits are sums of 12 products of order 1: scale the bound by 4
    _close(logits_t, logits_j, 4 * DTYPES[dt][2])
