"""`repro_torch.models.transformer` against the JAX `transformer.forward`
on Qwen3-14B's SMOKE config, with the JAX parameters converted leaf by
leaf, and the init trees of every arch (the other families' forwards:
`test_torch_families.py`).

Tolerances: in f32 the two sides differ in summation order only, and the
error grows through two layers and the unembedding to about 1e-6 of
logits of order 0.1: 1e-4.  In bf16 both sides round every matrix
product's output to bf16 (2^-8 relative) but at different places inside
fused elementwise chains, so logits agree to a few bf16 ulps of the
largest logit: 3e-2 of max |logit|.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.convert import (cache_from_numpy, disable_tf32,  # noqa: E402
                                 params_from_numpy, to_numpy)
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "qwen3_14b"
F32_TOL = 1e-4
BF16_REL = 3e-2
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                   torch.bfloat16)}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jparams = jtf.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(t, j, dt):
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    tol = F32_TOL if dt == "f32" else BF16_REL * float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def test_param_tree_converts_leaf_by_leaf(model):
    jcfg, _, jparams, tparams = model
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        t = tparams
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("dt", list(DT))
def test_full_sequence_logits(model, dt):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, 2, 12)
    lj, _, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           compute_dtype=DT[dt][0])
    lt, cache = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                            compute_dtype=DT[dt][1])
    assert cache is None and lt.shape == (2, 12, tcfg.vocab_size)
    _close(lt, lj, dt)
    last, _ = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          compute_dtype=DT[dt][1], last_only=True)
    assert last.shape == (2, 1, tcfg.vocab_size)
    _close(last, lj[:, -1:], dt)


@pytest.mark.parametrize("dt", list(DT))
def test_decode_with_cache_teacher_forced(model, dt):
    """Token-by-token decode through the cache (the decode-attention
    wrapper on the CPU) equals the JAX decode step by step, and in f32 the
    teacher-forced full-sequence logits."""
    jcfg, tcfg, jparams, tparams = model
    b, s = 2, 8
    toks = _tokens(jcfg, b, s, seed=1)
    jcache = jtf.cache_init(jcfg, b, s + 2, dtype=jnp.float32)
    tcache = ttf.cache_init(tcfg, b, s + 2, dtype=torch.float32,
                            device="cpu")
    outs = []
    for t in range(s):
        lj, jcache, _ = jtf.forward(jcfg, jparams,
                                    {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                    cache=jcache, compute_dtype=DT[dt][0])
        lt, tcache = ttf.forward(tcfg, tparams,
                                 {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                 cache=tcache, compute_dtype=DT[dt][1])
        _close(lt, lj, dt)
        outs.append(lt[:, 0])
    assert tcache["lengths"].tolist() == [s, s] and int(tcache["index"]) == s
    if dt == "f32":
        full, _ = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                              compute_dtype=torch.float32)
        torch.testing.assert_close(torch.stack(outs, 1), full, rtol=0,
                                   atol=F32_TOL)


def _check_cache(tcache, jcache):
    t, j = to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    np.testing.assert_array_equal(t["lengths"], j["lengths"])
    for name in ("k", "v"):
        np.testing.assert_allclose(t["blocks"][name], j["blocks"][name],
                                   rtol=0, atol=F32_TOL)


def test_masked_one_slot_prefill(model):
    """A (B,) one-hot ``active`` writes only the target slot's rows and
    advances only its length, exactly as the JAX forward does."""
    jcfg, tcfg, jparams, tparams = model
    b, s, cache_len = 3, 5, 12
    toks = _tokens(jcfg, b, s, seed=2)
    active = np.array([False, True, False])
    jcache = jtf.cache_init(jcfg, b, cache_len, dtype=jnp.float32)
    tcache = ttf.cache_init(tcfg, b, cache_len, dtype=torch.float32,
                            device="cpu")
    lj, jcache, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                cache=jcache, compute_dtype=jnp.float32,
                                active=jnp.asarray(active))
    lt, tcache = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                             cache=tcache, compute_dtype=torch.float32,
                             active=torch.from_numpy(active))
    _close(lt[1], lj[1], "f32")
    _check_cache(tcache, jcache)
    assert tcache["lengths"].tolist() == [0, s, 0]
    assert not tcache["blocks"]["k"][:, [0, 2]].any()


def test_chunked_active_2d(model):
    """A (B, S) ``active`` packs prompts of different lengths (and a
    riding decode slot at column 0) into one forward over a cache that
    already holds ragged prefixes."""
    jcfg, tcfg, jparams, tparams = model
    b, cache_len = 3, 16
    pre = _tokens(jcfg, b, 4, seed=3)
    first = np.array([True, True, False])
    jcache = jtf.cache_init(jcfg, b, cache_len, dtype=jnp.float32)
    tcache = ttf.cache_init(tcfg, b, cache_len, dtype=torch.float32,
                            device="cpu")
    _, jcache, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(pre)},
                               cache=jcache, compute_dtype=jnp.float32,
                               active=jnp.asarray(first))
    _, tcache = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(pre)},
                            cache=tcache, compute_dtype=torch.float32,
                            active=torch.from_numpy(first))
    toks = _tokens(jcfg, b, 6, seed=4)
    act = np.zeros((b, 6), bool)
    act[0, :1] = True          # riding decode slot
    act[1, :6] = True
    act[2, :3] = True          # a fresh, shorter prompt
    lj, jcache, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                cache=jcache, compute_dtype=jnp.float32,
                                active=jnp.asarray(act))
    lt, tcache = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                             cache=tcache, compute_dtype=torch.float32,
                             active=torch.from_numpy(act))
    for slot in range(b):
        n = int(act[slot].sum())
        _close(lt[slot, :n], lj[slot, :n], "f32")
    _check_cache(tcache, jcache)
    assert tcache["lengths"].tolist() == [5, 10, 3]


def test_cache_reset_slot_gives_a_fresh_slot(model):
    jcfg, tcfg, jparams, tparams = model
    tcache = ttf.cache_init(tcfg, 2, 8, dtype=torch.float32,
                            device="cpu")
    toks = torch.from_numpy(_tokens(jcfg, 2, 3, seed=5))
    _, tcache = ttf.forward(tcfg, tparams, {"tokens": toks}, cache=tcache,
                            compute_dtype=torch.float32)
    assert tcache["blocks"]["k"][:, 1].any()
    reset = ttf.cache_reset_slot(tcache, 1)
    fresh = ttf.cache_init(tcfg, 2, 8, dtype=torch.float32,
                           device="cpu")
    assert reset["lengths"].tolist() == [3, 0]
    for name in ("k", "v"):
        torch.testing.assert_close(reset["blocks"][name][:, 1],
                                   fresh["blocks"][name][:, 1])
        assert reset["blocks"][name][:, 0].any()     # slot 0 untouched
    jcache = cache_from_numpy(jax.tree.map(
        np.asarray, jtf.cache_init(jcfg, 2, 8, dtype=jnp.float32)))
    assert set(jcache) == set(fresh) and set(jcache["blocks"]) == {"k", "v"}
    assert jcache["blocks"]["k"].shape == fresh["blocks"]["k"].shape


def test_random_init_layout(model):
    jcfg, tcfg, jparams, _ = model
    gen = torch.Generator().manual_seed(0)
    tparams = ttf.init(tcfg, gen, dtype=torch.bfloat16)
    jshapes = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                           jtf.init(jcfg, jax.random.PRNGKey(0),
                                    dtype=jnp.bfloat16))
    tshapes = {}

    def walk(t, out):
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = {}
                walk(v, out[k])
            else:
                out[k] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    walk(tparams, tshapes)
    assert tshapes == jshapes
    w = tparams["blocks"]["mlp"]["w_up"].float()
    assert abs(w.std().item() - 0.02) < 2e-3
    assert not torch.equal(w[0], w[1])        # layers drawn separately


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_every_arch_init_tree_has_the_reference_shapes(arch):
    """`init` of every arch's SMOKE config: the JAX init's keys, shapes
    and dtypes (the hybrid's group dicts, stacked experts, the f32 router,
    RWKV and Mamba leaves, a frontend's proj), in bf16 and f32."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                            jtf.init(jcfg, jax.random.PRNGKey(0), dtype=jdt))
        got = ttf._tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
            ttf.init(tcfg, torch.Generator().manual_seed(0), dtype=tdt))
        assert got == want
