"""Every model family of `repro_torch.models.transformer` against the JAX
`transformer`: the SMOKE forwards of Phi-3.5-MoE, Qwen3-MoE, Jamba,
RWKV6, H2O-Danube (sliding window), HuBERT (frames, non-causal) and
InternVL2 (patches ahead of the tokens); decode against teacher forcing
for each case of `tests/test_decode_equivalence.py`, step by step against
the JAX decode too; the one-slot prefill's masking of recurrent state;
`cache_reset_slot` and `cache_poison_slot` on recurrent leaves beside
contiguous and paged attention leaves; the summed MoE aux loss; the
cache trees of every arch; the frontend prefill step.

JAX parameters are converted leaf by leaf (`convert.params_from_numpy`);
inputs come from numpy with a seed.  Tolerances: f32 differs in summation
order only, 1e-5 (decode against the model's own teacher-forced forward:
2e-3, the reference test's bound).  bf16 is held to the bf16 logit bound
of ROADMAP queue C, 3e-2 of the largest |logit|, except where a token's
experts differ between the two sides, which must be a near-tie: the
k-th and (k+1)-th router probabilities within 1e-3 on the JAX side, where
bf16 rounding may pick another expert (such a token, and the later ones
of its row, are left out).
Caches after reset or poisoning are compared bit for bit, NaN included.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.runtime import paging as jpaging  # noqa: E402
from repro_torch.convert import (cache_from_numpy, disable_tf32,  # noqa: E402
                                 params_from_numpy, to_numpy)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402

F32_TOL = 1e-5
TF_TOL = 2e-3
BF16_REL = 3e-2
ROUTER_TIE = 1e-3
FAMILIES = ("phi3_5_moe_42b", "qwen3_moe_235b", "jamba_1_5_large_398b",
            "rwkv6_7b", "h2o_danube_1_8b", "hubert_xlarge", "internvl2_2b")
MOE_ARCHS = ("phi3_5_moe_42b", "qwen3_moe_235b", "jamba_1_5_large_398b")


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _smoke(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jtf.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _inputs(cfg, b=2, s=12, seed=0):
    """numpy inputs of the arch's kind: frames for a frame frontend,
    patches ahead of the tokens for a patch frontend, tokens otherwise."""
    rng = np.random.default_rng(seed)
    inp = {}
    if cfg.frontend == "frame":
        inp["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
        return inp
    if cfg.frontend == "patch":
        inp["patches"] = rng.standard_normal(
            (b, 5, cfg.frontend_dim)).astype(np.float32)
    inp["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return inp


def _j(inp):
    return {k: jnp.asarray(v) for k, v in inp.items()}


def _t(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _nan_equal(got, want):
    """Two numpy trees of the same keys, leaf by leaf bit for bit (NaN
    equal to NaN)."""
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _nan_equal(got[key], want[key])
        else:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_f32(arch):
    jcfg, tcfg, jp, tp = _smoke(arch)
    inp = _inputs(jcfg)
    lj, _, auxj = jtf.forward(jcfg, jp, _j(inp), compute_dtype=jnp.float32)
    lt, cache, auxt = ttf.forward(
        tcfg, tp, _t(inp), compute_dtype=torch.float32, return_aux=True)
    assert cache is None and lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0, atol=F32_TOL)
    assert abs(float(auxt) - float(auxj)) < F32_TOL


def _spy_routes(monkeypatch, mod, calls):
    """Record each `route` call of ``mod``'s MoE module: the chosen
    experts (a set per token) and the gap between the k-th and (k+1)-th
    router probabilities."""
    real = mod.route

    def spy(params, x, cfg):
        idx, w, aux = real(params, x, cfg)
        probs = np.asarray(jax.nn.softmax(
            np.asarray(x, np.float32) @ np.asarray(params["router"]), -1)
            if mod is jmoe else torch.softmax(
                x.float() @ params["router"].float(), -1))
        top = -np.sort(-probs, -1)
        calls.append(([frozenset(r) for r in np.asarray(idx).tolist()],
                      top[:, cfg.top_k - 1] - top[:, cfg.top_k]))
        return idx, w, aux
    monkeypatch.setattr(mod, "route", spy)


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_bf16(arch, monkeypatch):
    """bf16 logits within the bound.  Both sides' routing is recorded (the
    JAX forward unscanned, so its layers run eagerly, with the same
    numbers): a token whose experts differ must be a router near-tie on
    the JAX side, and it and the later tokens of its row are left out."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    inp = _inputs(jcfg)
    jcalls, tcalls = [], []
    _spy_routes(monkeypatch, jmoe, jcalls)
    _spy_routes(monkeypatch, tmoe, tcalls)
    lj, _, _ = jtf.forward(dataclasses.replace(jcfg, scan_layers=False), jp,
                           _j(inp), compute_dtype=jnp.bfloat16)
    lj = _np(lj)
    lt, _ = ttf.forward(tcfg, tp, _t(inp), compute_dtype=torch.bfloat16)
    assert lt.dtype == torch.bfloat16 and len(jcalls) == len(tcalls)
    b, s = lj.shape[:2]
    keep = np.ones((b, s), bool)
    for (jsets, gaps), (tsets, _) in zip(jcalls, tcalls):
        for t, (js, ts) in enumerate(zip(jsets, tsets)):
            if js != ts:
                assert gaps[t] < ROUTER_TIE, (t, gaps[t])
                row, pos = divmod(t, s)
                keep[row, pos if jcfg.causal else 0:] = False
    assert keep[:, 0].any()
    bound = BF16_REL * np.abs(lj).max()
    np.testing.assert_allclose(lt.float().numpy()[keep], lj[keep], rtol=0,
                               atol=bound)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_summed_aux_equals_the_reference(arch):
    """The aux loss summed over the MoE layers, with and without a
    cache (a one-slot prefill), equal to the JAX forward's third value;
    a model without MoE layers returns 0."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    inp = _inputs(jcfg, b=3, s=9, seed=4)
    active = np.array([False, True, True])
    jc = jtf.cache_init(jcfg, 3, 12, dtype=jnp.float32)
    tc = ttf.cache_init(tcfg, 3, 12, dtype=torch.float32, device="cpu")
    _, _, aj = jtf.forward(jcfg, jp, _j(inp), cache=jc,
                           compute_dtype=jnp.float32,
                           active=jnp.asarray(active))
    _, _, at = ttf.forward(tcfg, tp, _t(inp), cache=tc,
                           compute_dtype=torch.float32,
                           active=torch.from_numpy(active), return_aux=True)
    assert float(aj) > 0 and abs(float(at) - float(aj)) < F32_TOL
    n_moe = sum(tcfg.is_moe_layer(i if tcfg.family == "hybrid" else 0)
                for i in range(tcfg.num_layers))
    assert float(at) >= n_moe * (1 - 1e-3)       # each layer's E*sum f*P >= 1
    _, _, none = ttf.forward(tconfigs.get_smoke("rwkv6_7b"),
                             _smoke("rwkv6_7b")[3],
                             {"tokens": torch.zeros((1, 3), dtype=torch.int32)},
                             return_aux=True)
    assert float(none) == 0.0


def _tiny(family, **kw):
    base = dict(name=f"tiny-{family}", family=family, num_layers=4,
                d_model=64, d_ff=128, vocab_size=97, num_heads=4,
                num_kv_heads=2)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


# the CASES of tests/test_decode_equivalence.py
CASES = {
    "dense": dict(family="dense", qk_norm=True),
    "dense_bias": dict(family="dense", qkv_bias=True),
    "swa_ring": dict(family="dense", sliding_window=6),
    "rwkv": dict(family="ssm", num_heads=0, num_kv_heads=0,
                 rwkv_head_dim=16, rwkv_lora_dim=8),
    "jamba": dict(family="hybrid", num_layers=8, attn_period=4,
                  attn_offset=2, num_experts=4, top_k=2, moe_d_ff=32,
                  moe_every=2, moe_offset=1, ssm_state=4, ssm_conv=3,
                  capacity_factor=8.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_teacher_forcing(name):
    """Token by token through the cache (a ring of 6 rows for swa_ring,
    wrapped twice), each step equal to the JAX decode step and the whole
    equal to the port's own teacher-forced forward; the caches equal
    JAX's at the end."""
    kw = dict(CASES[name])
    jcfg, tcfg = _tiny(kw.pop("family"), **kw)
    key = jax.random.PRNGKey(7)
    jp = jtf.init(jcfg, key)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    b, s = 2, 12
    toks = np.asarray(jax.random.randint(key, (b, s), 0, jcfg.vocab_size))
    full, _ = ttf.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                          compute_dtype=torch.float32)
    jc = jtf.cache_init(jcfg, b, s, dtype=jnp.float32)
    tc = ttf.cache_init(tcfg, b, s, dtype=torch.float32, device="cpu")
    if jcfg.sliding_window:
        assert tc["blocks"]["k"].shape[2] == jcfg.sliding_window
    outs = []
    for t in range(s):
        lj, jc, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, cache=jc, compute_dtype=jnp.float32)
        lt, tc = ttf.forward(tcfg, tp, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, cache=tc, compute_dtype=torch.float32)
        np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0,
                                   atol=F32_TOL)
        outs.append(lt[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=TF_TOL,
                               atol=TF_TOL)
    got, want = to_numpy(tc), jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    for gl, wl in zip(jax.tree.leaves(got["blocks"]),
                      jax.tree.leaves(want["blocks"])):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b",
                                  "phi3_5_moe_42b", "h2o_danube_1_8b"])
def test_masked_one_slot_prefill(arch):
    """A (B,) one-hot ``active``: only the target slot's KV rows and
    recurrent state change, and the logits and cache equal JAX's."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    b, s = 3, 7
    toks = _inputs(jcfg, b, s, seed=2)["tokens"]
    active = np.array([False, True, False])
    jc = jtf.cache_init(jcfg, b, 10, dtype=jnp.float32)
    tc = ttf.cache_init(tcfg, b, 10, dtype=torch.float32, device="cpu")
    lj, jc, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            cache=jc, compute_dtype=jnp.float32,
                            active=jnp.asarray(active))
    lt, tc = ttf.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                         cache=tc, compute_dtype=torch.float32,
                         active=torch.from_numpy(active))
    np.testing.assert_allclose(lt[1].numpy(), _np(lj[1]), rtol=0,
                               atol=F32_TOL)
    assert tc["lengths"].tolist() == [0, s, 0]
    for gl, wl in zip(jax.tree.leaves(to_numpy(tc["blocks"])),
                      jax.tree.leaves(jax.tree.map(np.asarray,
                                                   jc["blocks"]))):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=F32_TOL)
    for leaf in ttf._leaves(tc["blocks"]):
        assert not leaf[:, [0, 2]].any() and leaf[:, 1].any()


def _filled_caches(arch, paged):
    """A JAX cache of ``arch`` (SMOKE) with every float leaf random and
    its port copy; paged: pages of 2 tokens, slot 1 holding pages 3 and
    5, slot 0 page 1."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    spec = None
    if paged:
        spec = jpaging.PageSpec.build(3, 10, 2, 7)
    jc = jtf.cache_init(jcfg, 3, 10, dtype=jnp.float32, paged=spec)
    rng = np.random.default_rng(5)
    jc = {**jc, "blocks": jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jc["blocks"]), "lengths": jnp.asarray([2, 4, 0], jnp.int32)}
    if paged:
        jc["pages"] = jnp.asarray([[1, -1, -1, -1, -1],
                                   [3, 5, -1, -1, -1],
                                   [-1, -1, -1, -1, -1]], jnp.int32)
    tspec = (None if spec is None
             else tpaging.PageSpec.build(3, 10, 2, 7))
    return jcfg, tcfg, jc, cache_from_numpy(jax.tree.map(np.asarray, jc)), \
        spec, tspec


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
@pytest.mark.parametrize("op", ["cache_reset_slot", "cache_poison_slot"])
def test_reset_and_poison_on_recurrent_leaves(arch, paged, op):
    """Slot 1 zeroed or poisoned: its batched recurrent leaves at the
    slot, its pool pages (paged), nothing else; bit for bit the JAX
    result."""
    _, _, jc, tc, spec, tspec = _filled_caches(arch, paged)
    want = getattr(jtf, op)(jc, 1, paged=spec)
    got = getattr(ttf, op)(tc, 1, paged=tspec)
    _nan_equal(to_numpy(got), jax.tree.map(np.asarray, want))
    if arch.startswith("jamba"):
        conv = got["blocks"]["0"]["conv"]
        changed = (torch.isnan(conv[:, 1]).all() if op == "cache_poison_slot"
                   else not conv[:, 1].any())
        assert changed and conv[:, 0].isfinite().all() and conv[:, 0].any()


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_cache_trees_equal_the_reference(arch):
    """Every arch's SMOKE cache tree: keys, shapes and dtypes of
    `cache_init` in f32, int8 and (dense and MoE without a window) paged,
    as JAX's; a sliding-window cache holds ``window`` rows, not more."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    layouts = [(jnp.float32, torch.float32, None), (jnp.int8, torch.int8,
                                                    None)]
    if tcfg.family in ("dense", "moe") and not tcfg.sliding_window:
        layouts.append((jnp.float32, torch.float32, (3, 40, 4)))
    for jdt, tdt, pg in layouts:
        jspec = tspec = None
        if pg is not None:
            jspec, tspec = jpaging.PageSpec.build(*pg), tpaging.PageSpec.build(
                *pg)
        jc = jtf.cache_init(jcfg, 3, 40, dtype=jdt, paged=jspec)
        tc = ttf.cache_init(tcfg, 3, 40, dtype=tdt, device="cpu",
                            paged=tspec)
        want = jax.tree.map(lambda a: (a.shape, a.dtype.name), jc)
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).removeprefix("torch.")),
                           tc)
        assert got == want
    if tcfg.sliding_window:
        assert tc["blocks"]["k"].shape[2] == tcfg.sliding_window < 40


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_2b"])
def test_frontend_prefill_step(arch):
    """`make_prefill_step` with frames (HuBERT, non-causal) or patches
    ahead of the tokens (InternVL2): the greedy token equals JAX's, and
    the last-position logits agree in f32."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    inp = _inputs(jcfg, b=2, s=20, seed=3)
    want = jsteps.make_prefill_step(jcfg)(jp, _j(inp))
    got = tsteps.make_prefill_step(tcfg)(tp, _t(inp))
    assert got.tolist() == np.asarray(want).tolist()
    lj, _, _ = jtf.forward(jcfg, jp, _j(inp), compute_dtype=jnp.float32,
                           last_only=True)
    lt, _ = ttf.forward(tcfg, tp, _t(inp), compute_dtype=torch.float32,
                        last_only=True)
    assert lt.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0, atol=F32_TOL)
    n = sum(v.shape[1] for v in inp.values())
    full, _ = ttf.forward(tcfg, tp, _t(inp),
                          compute_dtype=torch.float32)
    assert full.shape[1] == n
