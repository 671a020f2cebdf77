"""`repro_torch.kernels.attention` (the flash-attention family: `ops`,
`kernel`, `ref`) and `repro_torch.core.cost_model` against the JAX
package on the CPU.

The JAX Pallas kernel (`kernel.flash_attention`, interpret mode) and its
oracle `ref.attention_ref` take heads folded into the batch axis; the
tests fold K/V so that query head h reads KV head h // g, the grouping of
the port and of `attention_core`.  Small ``block_q``/``block_k`` and
ragged lengths make the Pallas kernel pad, mask tails and skip blocks.

Tolerances: in f32 the sides differ in summation order only: 1e-5 of the
largest |ref|.  In bf16 the Pallas kernel rounds its probabilities to bf16
before the p.v product and each side rounds its output to bf16 once, so an
element may land one bf16 ulp away: 2^-7 of its (query row, head) row's
largest |ref|.  A query row with no surviving key must be exactly 0.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cost_model as jcost  # noqa: E402
from repro.kernels.attention import kernel as jkernel  # noqa: E402
from repro.kernels.attention import ops as jops  # noqa: E402
from repro.kernels.attention import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.kernels.attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.attention import ops as tops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# name: (Sq, Sk, causal, window)
MASKS = {
    "causal": (37, 37, True, None),
    "window": (45, 45, True, 8),
    "non_causal": (37, 53, False, None),
    "window_sq_gt_sk": (45, 30, True, 8),
}
HKV = 2


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _inputs(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32))


def _fold(q, k, v, g):
    """(B, S, H, dh) -> (B*Hq, S, dh), K/V repeated so that folded query
    row b*Hq + h reads KV head h // g."""
    b, sq, hq, dh = q.shape
    qf = q.transpose(0, 2, 1, 3).reshape(b * hq, sq, dh)
    kf, vf = (np.repeat(a.transpose(0, 2, 1, 3), g, axis=1)
              .reshape(b * hq, a.shape[1], dh) for a in (k, v))
    return qf, kf, vf


def _unfold(out, b, hq):
    bh, sq, dh = out.shape
    return np.asarray(out, np.float32).reshape(b, hq, sq, dh).transpose(
        0, 2, 1, 3)


def _torch(a, dt):
    return torch.from_numpy(a).to(DT[dt][1])


def _assert_close(out, ref, dt, zero_rows=()):
    """Per-row tolerance of the module docstring; ``zero_rows`` are query
    rows that must be exactly 0."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out - ref)
    if dt == "f32":
        assert err.max() <= 1e-5 * np.abs(ref).max(), err.max()
    else:
        tol = 2.0 ** -7 * np.abs(ref).max(axis=-1, keepdims=True)
        bad = np.argwhere((err > tol).any(-1))
        assert not len(bad), f"rows {bad[:8].tolist()} exceed 2^-7 of max"
    for i in zero_rows:
        assert not out[:, i].any(), f"row {i} has no key and must be 0"


def _empty_rows(sq, sk, causal, window):
    return [i for i in range(sq)
            if not any((not causal or i >= j)
                       and (window is None or i - j < window)
                       for j in range(sk))]


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("g, dh", [(1, 16), (4, 80), (5, 16)])
@pytest.mark.parametrize("mask", list(MASKS))
def test_plain_version_matches_pallas_kernel_and_oracle(mask, g, dh, dt):
    sq, sk, causal, window = MASKS[mask]
    b, hq = 2, g * HKV
    q, k, v = _inputs(list(MASKS).index(mask) * 1000 + g * 100 + dh, b, sq,
                      sk, hq, HKV, dh)
    out = tops.mha_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                             causal=causal, window=window)
    assert out.shape == (b, sq, hq, dh) and out.dtype == DT[dt][1]
    out = out.float().numpy()

    jq, jk, jv = (jnp.asarray(a, DT[dt][0]) for a in _fold(q, k, v, g))
    scale = 1.0 / math.sqrt(dh)
    pallas = jkernel.flash_attention(jq, jk, jv, scale=scale, causal=causal,
                                     window=window, block_q=16, block_k=16,
                                     interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, scale=scale, causal=causal,
                                window=window)
    empty = _empty_rows(sq, sk, causal, window)
    if mask == "window_sq_gt_sk":
        assert empty, "the case must reach rows with no key"
    _assert_close(out, _unfold(oracle, b, hq), dt, empty)
    _assert_close(out, _unfold(pallas, b, hq), dt, empty)


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("window", [None, 5])
def test_flash_entry_matches_attention_core(window, dt):
    """The prefill entry and the model's `attention_core` (the path of a
    forward that is not a prefill) group heads alike and mask alike."""
    b, s, g, dh = 2, 29, 5, 16
    q, k, v = (_torch(a, dt) for a in _inputs(3, b, s, s, g * HKV, HKV, dh))
    out = tops.mha_attention(q, k, v, causal=True, window=window)
    pos = torch.arange(s)
    core = tlayers.attention_core(q, k, v, pos, pos, causal=True,
                                  scale=dh ** -0.5, window=window)
    _assert_close(out.float().numpy(), core.to(q.dtype).float().numpy(), dt)


def test_reference_gqa_fold_is_tiled_not_grouped():
    """The JAX wrapper `mha_attention` repeats K/V along the folded batch
    axis, so its query head h reads KV head h % Hkv (a tiled MHA), where
    `attention_core` reads KV head h // g.  The port's entry groups as
    `attention_core` does (ROADMAP queue C)."""
    b, s, hq, dh = 2, 24, 4, 16
    q, k, v = _inputs(4, b, s, s, hq, HKV, dh)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_wrapper = np.asarray(jops.mha_attention(jq, jk, jv, causal=True,
                                              use_kernel=False))
    tiled = np.asarray(jops.mha_attention(
        jq, jnp.tile(jk, (1, 1, hq // HKV, 1)),
        jnp.tile(jv, (1, 1, hq // HKV, 1)), causal=True, use_kernel=False))
    pos = jnp.arange(s)
    grouped = np.asarray(jlayers.attention_core(
        jq, jk, jv, pos, pos, causal=True, window=None, scale=dh ** -0.5))
    np.testing.assert_allclose(j_wrapper, tiled, rtol=0, atol=1e-6)
    assert np.abs(j_wrapper - grouped).max() > 0.1
    port = tops.mha_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True).numpy()
    np.testing.assert_allclose(port, grouped, rtol=0,
                               atol=1e-5 * np.abs(grouped).max())


@pytest.mark.parametrize("bad, match", [
    (dict(window=0), "window"),
    (dict(k_heads=4), "multiple"),
    (dict(k_len=0), "empty"),
    (dict(k_dh=8), "head_dim"),
])
def test_entry_refuses_bad_shapes(bad, match):
    q = torch.zeros((1, 4, 6, 16))
    k = torch.zeros((1, bad.get("k_len", 4), bad.get("k_heads", 2),
                     bad.get("k_dh", 16)))
    with pytest.raises(ValueError, match=match):
        tkernel.flash_attention(q, k, k, scale=0.25,
                                window=bad.get("window"))


def _bounds_grid():
    for sq, sk in [(1, 1), (37, 37), (45, 30), (64, 64), (100, 257),
                   (512, 512), (4096, 4096)]:
        for bq, bk in [(16, 16), (64, 64), (16, 64), (128, 32), (128, 128)]:
            for causal in (True, False):
                for window in (None, 1, 8, 64, 100, 4096):
                    yield sq, sk, bq, bk, causal, window


def test_step_bounds_equal_the_jax_law():
    n = 0
    for sq, sk, bq, bk, causal, window in _bounds_grid():
        kw = dict(causal=causal, window=window)
        assert (tcost.attention_active_block_pairs(sq, sk, bq, bk, **kw)
                == jcost.attention_active_block_pairs(sq, sk, bq, bk, **kw))
        assert (tcost.attention_max_k_steps(sq, sk, bq, bk, **kw)
                == jcost.attention_max_k_steps(sq, sk, bq, bk, **kw))
        k_steps = -(-sk // bk)
        for i in range(-(-sq // bq)):
            assert (tcost.attention_step_bounds(i, bq, bk, k_steps, **kw)
                    == jcost.attention_step_bounds(i, bq, bk, k_steps, **kw))
        n += 1
    assert n == 7 * 5 * 2 * 6


def test_band_holds_every_surviving_pair():
    """Every (q, k) pair the mask keeps lies in a K tile inside its q
    tile's [first, last]: skipping the rest loses nothing."""
    for sq, sk, bq, bk, causal, window in _bounds_grid():
        if sq * sk > 300 * 300:
            continue
        k_steps = -(-sk // bk)
        i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
        keep = np.ones((sq, sk), bool)
        if causal:
            keep &= i >= j
        if window is not None:
            keep &= i - j < window
        bounds = np.array([tcost.attention_step_bounds(
            t, bq, bk, k_steps, causal=causal, window=window)
            for t in range(-(-sq // bq))])
        first, last = bounds[i[:, 0] // bq].T
        inside = ((j // bk >= first[:, None]) & (j // bk <= last[:, None]))
        assert not (keep & ~inside).any(), (sq, sk, bq, bk, causal, window)


@pytest.mark.parametrize("dtype, head_dim, want", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma.sync"),
    (torch.bfloat16, 80, "mma.sync"),
    (torch.bfloat16, 96, "mma.sync"),
    (torch.float32, 128, "f32"),
    (torch.float32, 80, "f32"),
    (torch.float32, 16, "f32"),
])
def test_design_routes_by_dtype_and_head_dim(dtype, head_dim, want):
    """bf16 at head_dim 128 (Qwen3-14B's prefill) takes the TMA/wgmma
    kernel in 128 x 128 tiles; the other bf16 head dims the mma.sync one
    and f32 the CUDA-core one, both in 64 x 64 tiles."""
    assert tkernel.design(dtype, head_dim) == want
    assert tkernel.TILES[want] == ((128, 128) if want == "wgmma"
                                   else (64, 64))
    assert head_dim in tkernel.HEAD_DIMS


def test_wgmma_tile_bounds_at_the_prefill_shapes():
    """At the (128, 128) tile a causal 32k prefill walks the triangle of
    256 query tiles, and a 4096-key window at most 33 tiles a query tile,
    as the JAX law counts them."""
    for causal, window in [(True, None), (True, 4096), (False, None)]:
        kw = dict(causal=causal, window=window)
        ours = tcost.attention_active_block_pairs(32768, 32768, 128, 128,
                                                  **kw)
        assert ours == jcost.attention_active_block_pairs(32768, 32768, 128,
                                                          128, **kw)
        assert (tcost.attention_max_k_steps(32768, 32768, 128, 128, **kw)
                == jcost.attention_max_k_steps(32768, 32768, 128, 128, **kw))
    active, dense = tcost.attention_active_block_pairs(32768, 32768, 128, 128,
                                                       causal=True)
    assert (active, dense) == (256 * 257 // 2, 256 * 256)
    assert tcost.attention_max_k_steps(32768, 32768, 128, 128, causal=True,
                                       window=4096) == 33
