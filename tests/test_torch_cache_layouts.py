"""Paged, int8 and paged int8 KV caches of the port against the JAX
package: `layers.attention_apply` and `transformer.forward` /
`cache_reset_slot`, on the CPU.

The layer tests draw weights and inputs on a grid of eighths, so every
projection is exact, and leave RoPE out (it is held to JAX in
tests/test_torch_layers.py; its sines differ by an ulp at some positions),
so both frameworks write the same K/V rows: the pools,
int8 codes and scales after a write must be equal bit for bit (tolerance
0), including rows that must not be written (inactive slots, columns past
a slot's prefix, logical pages with no pool page).  Outputs differ in
summation order only: 2e-5 (the softmax sums over the keys).  The model
tests run Qwen3-14B's SMOKE config (qk-norm, two layers) in f32: logits
1e-4, as in tests/test_torch_model.py, float cache leaves 1e-5, and int8
codes, lengths and page tables equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.runtime import paging as jpaging  # noqa: E402
from repro_torch.convert import (cache_from_numpy, disable_tf32,  # noqa: E402
                                 params_from_numpy, to_numpy)
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402

LAYOUTS = ["paged", "int8", "paged_int8"]
B, MAX_LEN, PAGE = 4, 16, 4
LENGTHS = np.array([3, 0, 9, 6], np.int32)
OUT_TOL = 2e-5


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _cfgs():
    kw = dict(name="tiny-cache", family="dense", num_layers=1, d_model=32,
              d_ff=64, vocab_size=50, num_heads=4, num_kv_heads=2,
              head_dim=16)
    return JConfig(**kw), TConfig(**kw)


def _grid(rng, shape, scale=1.0):
    return (rng.integers(-8, 9, shape) / 8 * scale).astype(np.float32)


def _table(rng, need):
    """Page table for slots needing ``need[b]`` pages, from a shuffled
    permutation of a pool with one spare page, -1 past each slot's last."""
    spec = (jpaging.PageSpec(page_size=PAGE, num_pages=B * MAX_LEN // PAGE
                             + 1, max_pages=MAX_LEN // PAGE))
    perm = rng.permutation(spec.num_pages)
    table = -np.ones((B, spec.max_pages), np.int32)
    used = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[used:used + n]
        used += n
    return spec, table


def _layer_caches(rng, layout, jcfg, tcfg, spec):
    """Equal JAX and port caches with random contents."""
    paged = spec if layout != "int8" else None
    dtype = jnp.int8 if "int8" in layout else jnp.float32
    jcache = jl.attention_cache_init(jcfg, B, MAX_LEN, dtype, paged=paged)
    tpaged = (None if paged is None else tpaging.PageSpec(
        spec.page_size, spec.num_pages, spec.max_pages))
    tcache = tl.attention_cache_init(
        tcfg, B, MAX_LEN, torch.int8 if "int8" in layout else torch.float32,
        "cpu", paged=tpaged)
    filled = {}
    for name, leaf in jcache.items():
        if leaf.dtype == jnp.int8:
            a = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        elif name.endswith("_scale"):      # rows of magnitude up to 1
            a = (rng.random(leaf.shape) / 127).astype(np.float32)
        else:
            a = rng.random(leaf.shape).astype(np.float32)
        filled[name] = jnp.asarray(a)
        tcache[name].copy_(torch.from_numpy(a))
    return filled, tcache, tpaged


def _active(kind, s):
    if kind == "1d":
        return np.array([True, False, True, True])
    act = np.zeros((B, s), bool)
    for b, n in enumerate([s, 0, min(2, s), 1]):
        act[b, :n] = True
    return act


@pytest.mark.parametrize("act_kind", ["1d", "2d"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_attention_apply_matches_jax(layout, s, act_kind, monkeypatch):
    for mod in (jl, tl):
        monkeypatch.setattr(mod, "apply_rope", lambda x, pos, theta: x)
    rng = np.random.default_rng([LAYOUTS.index(layout), s, act_kind == "2d"])
    jcfg, tcfg = _cfgs()
    w = {"wq": _grid(rng, (32, 64), 0.25), "wk": _grid(rng, (32, 32), 0.25),
         "wv": _grid(rng, (32, 32), 0.25), "wo": _grid(rng, (64, 32), 0.25)}
    x = _grid(rng, (B, s, 32))
    act = _active(act_kind, s)
    # slot 3 is given pages for only its current prefix plus one row, so
    # its later columns aim at logical pages with no pool page (-1)
    need = [-(-(n + s) // PAGE) for n in LENGTHS]
    need[1] = 0
    need[3] = -(-(LENGTHS[3] + 1) // PAGE)
    spec, table = _table(rng, need)
    jcache, tcache, tspec = _layer_caches(rng, layout, jcfg, tcfg, spec)
    paged = layout != "int8"
    pos = LENGTHS[:, None] + np.arange(s, dtype=np.int32)
    yj, jnew = jl.attention_apply(
        {k: jnp.asarray(a) for k, a in w.items()}, jnp.asarray(x), jcfg,
        jnp.asarray(pos), cache=jcache, lengths=jnp.asarray(LENGTHS),
        active=jnp.asarray(act), pages=jnp.asarray(table) if paged else None,
        paged=spec if paged else None)
    yt, tnew = tl.attention_apply(
        {k: torch.from_numpy(a) for k, a in w.items()}, torch.from_numpy(x),
        tcfg, torch.from_numpy(pos), cache=tcache,
        lengths=torch.from_numpy(LENGTHS), active=torch.from_numpy(act),
        pages=torch.from_numpy(table) if paged else None,
        paged=tspec if paged else None)
    assert tnew is tcache and set(tnew) == set(jnew)
    for name in jnew:
        assert str(tnew[name].dtype) == f"torch.{jnew[name].dtype}"
        np.testing.assert_array_equal(tnew[name].numpy(),
                                      np.asarray(jnew[name]), err_msg=name)
    ok = act if act.ndim == 2 else np.broadcast_to(act[:, None], (B, s))
    rows = [b for b in range(B) if ok[b].any()]
    np.testing.assert_allclose(yt.numpy()[rows], np.asarray(yj)[rows],
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_paged_write_leaves_other_pages_and_uses_the_trash_page():
    """Masked rows land only on the pool's trash page, past the leaf."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = _cfgs()
    spec, table = _table(rng, [1, 0, 0, 0])
    tspec = tpaging.PageSpec(spec.page_size, spec.num_pages, spec.max_pages)
    cache = tl.attention_cache_init(tcfg, B, MAX_LEN, torch.float32, "cpu",
                                    paged=tspec)
    assert cache["k"].shape[0] == spec.num_pages
    x = torch.from_numpy(_grid(rng, (B, 2, 32)))
    w = {k: torch.from_numpy(_grid(rng, shp, 0.25)) for k, shp in (
        ("wq", (32, 64)), ("wk", (32, 32)), ("wv", (32, 32)),
        ("wo", (64, 32)))}
    act = torch.tensor([True, True, False, False])
    tl.attention_apply(w, x, tcfg, torch.arange(2)[None].expand(B, 2),
                       cache=cache, lengths=torch.zeros(B, dtype=torch.int32),
                       active=act, pages=torch.from_numpy(table),
                       paged=tspec)
    written = cache["v"].reshape(spec.num_pages, -1).abs().sum(1) > 0
    assert written.nonzero().flatten().tolist() == [int(table[0, 0])]
    assert tl.with_trash_page(cache["v"])[-1].any()     # slot 1 dropped
    with pytest.raises(RuntimeError):
        tl.with_trash_page(torch.zeros(3, 2))


def test_int8_cache_init_layout_matches_jax():
    jcfg, tcfg = _cfgs()
    spec = jpaging.PageSpec(page_size=4, num_pages=5, max_pages=3)
    tspec = tpaging.PageSpec(4, 5, 3)
    for jp, tp in ((None, None), (spec, tspec)):
        j = jl.attention_cache_init(jcfg, 2, 12, jnp.int8, paged=jp)
        t = tl.attention_cache_init(tcfg, 2, 12, torch.int8, "cpu", paged=tp)
        assert {k: (tuple(a.shape), str(a.dtype)) for k, a in j.items()} == {
            k: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for k, a in t.items()}
        assert not any(a.any() for a in t.values())


# -- the model: forward through paged / int8 caches, cache_reset_slot ------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jconfigs.get_smoke("qwen3_14b"), tconfigs.get_smoke(
        "qwen3_14b")
    jparams = jtf.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams))


def _model_caches(jcfg, tcfg, layout, b, max_len):
    dtype = "int8" if "int8" in layout else "float32"
    paged = layout != "int8"
    jspec = jpaging.PageSpec.build(b, max_len, 4) if paged else None
    tspec = tpaging.PageSpec.build(b, max_len, 4) if paged else None
    jcache = jtf.cache_init(jcfg, b, max_len, dtype=jnp.dtype(dtype),
                            paged=jspec)
    tcache = ttf.cache_init(tcfg, b, max_len, dtype=getattr(torch, dtype),
                            device="cpu", paged=tspec)
    return jcache, tcache, jspec, tspec


def _check(tcache, jcache):
    t, j = to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    assert set(t) == set(j) and set(t["blocks"]) == set(j["blocks"])
    np.testing.assert_array_equal(t["lengths"], j["lengths"])
    if "pages" in j:
        np.testing.assert_array_equal(t["pages"], j["pages"])
    for name, a in j["blocks"].items():
        assert t["blocks"][name].dtype == a.dtype
        if a.dtype == np.int8:
            np.testing.assert_array_equal(t["blocks"][name], a, err_msg=name)
        else:
            np.testing.assert_allclose(t["blocks"][name], a, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_through_each_layout_matches_jax(model, layout):
    """Chunked prefill of ragged prompts, decode steps with the tables grown
    by the host allocator, and a slot reset: logits, lengths, tables and
    cache leaves equal JAX's."""
    jcfg, tcfg, jparams, tparams = model
    b, max_len = 3, 16
    jcache, tcache, jspec, tspec = _model_caches(jcfg, tcfg, layout, b,
                                                 max_len)
    alloc = tpaging.PageAllocator(tspec, b) if tspec else None
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (b, 5)).astype(np.int32)
    act = np.zeros((b, 5), bool)
    act[0, :5], act[1, :2], act[2, :4] = True, True, True
    steps = [(toks, act)] + [
        (rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32),
         np.array([True, t != 1, True])) for t in range(4)]
    for i, (tk, ac) in enumerate(steps):
        if alloc is not None:
            depth = to_numpy(tcache)["lengths"]
            for slot in range(b):
                alloc.ensure(slot, int(depth[slot]) + int(
                    ac[slot].sum() if ac.ndim == 2 else ac[slot]))
            jcache = {**jcache, "pages": jnp.asarray(alloc.table)}
            tcache["pages"].copy_(torch.from_numpy(alloc.table))
        lj, jcache, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(tk)},
                                    cache=jcache, compute_dtype=jnp.float32,
                                    active=jnp.asarray(ac), paged=jspec)
        lt, tcache = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(tk)},
                                 cache=tcache, compute_dtype=torch.float32,
                                 active=torch.from_numpy(ac), paged=tspec)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")
        _check(tcache, jcache)
    jcache = jtf.cache_reset_slot(jcache, 2, paged=jspec)
    ttf.cache_reset_slot(tcache, 2, paged=tspec)
    _check(tcache, jcache)
    assert int(tcache["lengths"][2]) == 0
    if tspec is not None:
        assert (tcache["pages"][2] == -1).all()
        named = alloc.table[2][alloc.table[2] >= 0]
        for a in tcache["blocks"].values():
            assert not a[:, named].any()


def test_converted_paged_int8_cache_keeps_dtypes_and_decodes(model):
    """`convert.cache_from_numpy` carries a JAX paged int8 cache with its
    leaves' dtypes (int8 codes, f32 scales, int32 table) and gives the
    pools a trash page, so the port decodes on from it as JAX does."""
    jcfg, tcfg, jparams, tparams = model
    jcache, _, jspec, tspec = _model_caches(jcfg, tcfg, "paged_int8", 2, 16)
    alloc = jpaging.PageAllocator(jspec, 2)
    for slot in range(2):
        alloc.ensure(slot, 6)
    jcache = {**jcache, "pages": jnp.asarray(alloc.table)}
    toks = np.array([[3, 9, 4, 1, 7], [2, 2, 8, 5, 6]], np.int32)
    _, jcache, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               cache=jcache, compute_dtype=jnp.float32,
                               paged=jspec)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
    assert tcache["blocks"]["k"].dtype == torch.int8
    assert tcache["blocks"]["k_scale"].dtype == torch.float32
    assert tcache["pages"].dtype == torch.int32
    _check(tcache, jcache)
    step = np.array([[5], [11]], np.int32)
    lj, jcache, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(step)},
                                cache=jcache, compute_dtype=jnp.float32,
                                paged=jspec)
    lt, tcache = ttf.forward(tcfg, tparams, {"tokens": torch.from_numpy(step)},
                             cache=tcache, compute_dtype=torch.float32,
                             paged=tspec)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    _check(tcache, jcache)
