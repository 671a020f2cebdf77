"""The forward-only prefill step, `repro_torch.launch.steps.make_prefill_step`,
against the JAX `make_prefill_step` on the SMOKE configs of Qwen3-14B
(causal) and H2O-Danube-1.8B (sliding window 8), with the JAX parameters
converted leaf by leaf.  A prompt of 24 tokens is three windows long, so
the window masks most of each row.  On the CPU the flash entry runs its
plain version; on the JAX side a CPU backend runs `attention_core`.

Tolerances (as in `test_torch_model.py`): f32 differs in summation order
only, 1e-4 of the largest |logit|, and the greedy tokens are equal.  In
bf16 both sides round every matrix product to bf16 at different places,
3e-2 of the largest |logit|; a token may differ only where JAX's own
top-2 gap is below that bound (ROADMAP queue C).
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.convert import disable_tf32, params_from_numpy  # noqa: E402
from repro_torch.kernels.attention import ops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ("qwen3_14b", "h2o_danube_1_8b")
F32_TOL = 1e-4
BF16_REL = 3e-2
B, S = 2, 24


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jtf.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def test_prefill_step_f32_tokens_and_logits(model):
    jcfg, tcfg, jparams, tparams, toks = model
    lj, _, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           compute_dtype=jnp.float32, last_only=True)
    lj = np.asarray(lj)[:, -1]
    lt, _ = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        compute_dtype=torch.float32, last_only=True)
    np.testing.assert_allclose(lt[:, -1].numpy(), lj, rtol=0,
                               atol=F32_TOL * np.abs(lj).max())
    nxt = tsteps.make_prefill_step(tcfg, compute_dtype=torch.float32)(
        tparams, {"tokens": torch.from_numpy(toks),
                  "labels": torch.zeros((B, S))})
    assert nxt.dtype == torch.int32 and nxt.shape == (B,)
    assert nxt.tolist() == lj.argmax(-1).tolist()


def test_prefill_step_bf16_tokens(model):
    jcfg, tcfg, jparams, tparams, toks = model
    tj = np.asarray(jsteps.make_prefill_step(jcfg)(
        jparams, {"tokens": jnp.asarray(toks)}))
    tt = tsteps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks)}).numpy()
    lj, _, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           last_only=True)
    lj = np.asarray(jnp.asarray(lj, jnp.float32))[:, -1]
    assert tj.tolist() == lj.argmax(-1).tolist()
    bound = BF16_REL * np.abs(lj).max()
    for b in range(B):
        if tt[b] != tj[b]:
            top2 = np.sort(lj[b])[-2:]
            assert top2[1] - top2[0] < bound, (b, tt[b], tj[b])


def test_prefill_runs_the_flash_entry_once_per_layer(model, monkeypatch):
    """`make_prefill_step` sends every layer's attention to the flash entry
    (`ops.mha_attention`); a full forward and a cached forward never do."""
    _, tcfg, _, tparams, toks = model
    calls = []
    real = ops.mha_attention

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mha_attention", counting)
    tokens = torch.from_numpy(toks)
    tsteps.make_prefill_step(tcfg)(tparams, {"tokens": tokens})
    assert len(calls) == tcfg.num_layers
    assert all(kw == {"causal": tcfg.causal, "window": tcfg.sliding_window}
               for kw in calls)
    ttf.forward(tcfg, tparams, {"tokens": tokens})
    assert len(calls) == tcfg.num_layers


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_windowed_forward_matches_jax(model, dt):
    """The cache-free forward at every position (`attention_core` with the
    window term) against the JAX forward; for Danube the window changes the
    logits, so the term is exercised."""
    jcfg, tcfg, jparams, tparams, toks = model
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    lj, _, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           compute_dtype=jdt)
    lj = np.asarray(jnp.asarray(lj, jnp.float32))
    lt, _ = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        compute_dtype=tdt)
    tol = (F32_TOL if dt == "f32" else BF16_REL) * np.abs(lj).max()
    np.testing.assert_allclose(lt.float().numpy(), lj, rtol=0, atol=tol)
    if tcfg.sliding_window:
        full, _ = ttf.forward(dataclasses.replace(tcfg, sliding_window=None),
                              tparams, {"tokens": torch.from_numpy(toks)},
                              compute_dtype=tdt)
        assert (full - lt).abs().max() > 10 * tol


def test_swa_ring_buffer_bounded_cache():
    """The counterpart of the JAX package's test of the same name: a
    sliding-window cache asked for 1,000 rows holds the window's, and a
    paged one is refused with the JAX message."""
    cfg = tconfigs.get_smoke("h2o_danube_1_8b")
    cache = ttf.cache_init(cfg, 1, 1000, dtype=torch.float32, device="cpu")
    k = cache["blocks"]["k"]
    assert k.shape == (cfg.num_layers, 1, cfg.sliding_window,
                       cfg.num_kv_heads, cfg.head_dim)
    from repro_torch.runtime import paging
    with pytest.raises(ValueError, match="ring-buffer layout is "
                                         "contiguous-only"):
        ttf.cache_init(cfg, 1, 16, device="cpu",
                       paged=paging.PageSpec.build(1, 16, 4))


def test_shapes_match_jax():
    from repro.configs import shapes as jshapes
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    for arch in tconfigs.list_archs():
        tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        assert [s.name for s in shapes.cells(tcfg)] == \
            [s.name for s in jshapes.cells(jcfg)]
        for name in shapes.SHAPES:
            assert shapes.applicable(tcfg, shapes.SHAPES[name]) == \
                jshapes.applicable(jcfg, jshapes.SHAPES[name])
    assert shapes.applicable(tconfigs.get("h2o_danube_1_8b"),
                             shapes.SHAPES["prefill_32k"]) == (True, "")
