"""RWKV6 and Mamba over the model axis, on the CPU: gloo process groups
of 2 and 4 ranks (`_torch_ranks.spawn`) held to the one-rank mixers, and
the port's splits held to the JAX package's specs.

- RWKV6 SMOKE's time mix (4 heads of 16 over the ranks, the ``ln_x``
  norm over every rank's heads) and channel mix (d_ff 128), and Jamba
  SMOKE's Mamba mixer (d_in 128): forward, the gradients of every leaf
  and of the input, and one decode step from each rank's block of the
  state (output and new state), each leaf within 1e-5 of its largest
  |value|: Mamba's ``x_proj`` too, since B's and C's gradients are
  summed over the ranks before their bf16 rounding rounds them, as the
  unsplit scan rounds its whole sum (rounding each rank's part puts
  ``x_proj``'s gradient 1e-3 of its largest |value| off).
- `transformer.compute_specs` gives every RWKV6 and Mamba leaf the mesh
  axes JAX's `param_specs` place it over, ``in_proj`` a
  `sharding.Parts` whose block is its columns of each half, moved from
  and back to the stored block without a gather.
- `transformer.cache_block` under `decode_rules` cuts each leaf as JAX's
  `cache_specs(cfg, paged, kv_dtype)` places it: the RWKV ``wkv`` state
  over heads, Mamba's ``conv`` and ``h`` over ``d_in``, an int8 cache's
  codes and scales over ``kv_seq``, a paged pool whole with its table by
  slot.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks  # noqa: E402
import repro.configs as ref_configs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import rwkv, ssm, transformer  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.runtime.paging import PageSpec  # noqa: E402

REL = 1e-5
WORLDS = (2, 4)
CASES = (("rwkv_time", "rwkv6_7b", "time", 0),
         ("rwkv_channel", "rwkv6_7b", "channel", 0),
         ("mamba", "jamba_1_5_large_398b", "mamba", 0))
FNS = {"time": rwkv.rwkv_time_mix, "channel": rwkv.rwkv_channel_mix,
       "mamba": ssm.mamba_apply}
CACHE_ARCHS = {"rwkv6": ("rwkv6_7b", None, torch.float32),
               "jamba": ("jamba_1_5_large_398b", None, torch.float32),
               "qwen3_int8": ("qwen3_14b", None, torch.int8),
               "qwen3_paged": ("qwen3_14b", PageSpec(4, 8, 4), torch.float32),
               "qwen3_paged_int8": ("qwen3_14b", PageSpec(4, 8, 4),
                                    torch.int8)}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _state(cfg, kind, g, b):
    if kind == "mamba":
        c = ssm.mamba_cache_init(cfg, b, torch.float32)
    else:
        c = rwkv.rwkv_cache_init(cfg, b, torch.float32)
        c = {k: v for k, v in c.items()
             if (k == "shift_c") == (kind == "channel")}
    return {k: torch.randn(v.shape, generator=g) for k, v in c.items()}


def _case(name, arch, kind, sub):
    cfg = tconfigs.get_smoke(arch)
    g = torch.Generator().manual_seed(
        1 + [c[0] for c in CASES].index(name))
    params = transformer.init(cfg, g)["blocks"]
    if cfg.family == "hybrid":
        params = params[str(sub)]
    params = tree_lib.map_structure(lambda a: a[0].clone(),
                                    params["mlp" if kind == "channel"
                                           else "mixer"])
    if kind == "time":      # a nonzero bonus, a decay LoRA of some size
        params["bonus_u"] = torch.randn(params["bonus_u"].shape,
                                        generator=g) * 0.5
        params["decay_a"] = params["decay_a"] * 20
    b, s, d = 2, 6, cfg.d_model
    return {"name": name, "cfg": cfg, "kind": kind, "sub": sub,
            "params": params, "x": torch.randn(b, s, d, generator=g),
            "cot": torch.randn(b, s, d, generator=g),
            "x_step": torch.randn(b, 1, d, generator=g),
            "state": _state(cfg, kind, g, b)}


def _caches():
    out = {}
    g = torch.Generator().manual_seed(9)
    for name, (arch, paged, dtype) in CACHE_ARCHS.items():
        cfg = tconfigs.get_smoke(arch)
        cache = transformer.cache_init(cfg, 2, 16, dtype=dtype, device="cpu",
                                       paged=paged)
        for leaf in tree_lib.leaves(cache["blocks"]):
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=g)
                       if leaf.dtype == torch.int8
                       else torch.randn(leaf.shape, generator=g))
        if paged is not None:
            cache["pages"][:, :2] = torch.tensor([[0, 2], [1, 3]])
        cache["lengths"] = torch.tensor([3, 7], dtype=torch.int32)
        out[name] = (cfg, cache)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rec")
    args = {"cases": [_case(*c) for c in CASES], "caches": _caches()}
    return {w: _torch_ranks.spawn("recurrent_layers", w, tmp, args,
                                  timeout=150) for w in WORLDS}


def _close(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) <= REL * scale


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_mixer_over_the_model_axis_equals_one_rank(runs, world, name):
    case = _case(*next(c for c in CASES if c[0] == name))
    cfg, fn = case["cfg"], FNS[case["kind"]]
    p = tree_lib.map_structure(lambda t: t.clone().requires_grad_(),
                               case["params"])
    x = case["x"].clone().requires_grad_()
    y, _ = fn(p, x, cfg)
    y.backward(case["cot"])
    with torch.no_grad():
        state = {k: v.clone() for k, v in case["state"].items()}
        y_step, new = fn(case["params"], case["x_step"], cfg, state)
    for res in runs[world]:
        got = res[name]
        assert _close(got["y"], y.detach())
        assert _close(got["dx"], x.grad)
        want = tree_lib.map_structure(lambda t: t.grad, p)
        for path, a, b in zip(*tree_lib.flatten_with_paths(got["grads"]),
                              tree_lib.leaves(want)):
            assert a.shape == b.shape and _close(a, b), (name, path)
        assert _close(got["y_step"], y_step)
        assert set(got["state"]) == set(new)
        for k, v in new.items():
            assert got["state"][k].shape == v.shape and _close(
                got["state"][k], v), k


def _fitted(rules, logical, shape):
    return shd.fitted(rules.spec(*logical), tuple(shape), rules)


def _norm(spec):
    """A spec's entries as tuples of mesh axes."""
    return tuple(shd._axes(e) for e in spec)


def _ref_tree(tree, structure):
    """A JAX spec tree (tuples as leaves) in the port tree's order."""
    return tree_lib.unflatten_like(structure, _spec_leaves(tree))


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
def test_compute_specs_split_the_mixers_as_jax_places_them(runs, world,
                                                           arch):
    """Every RWKV6 time- and channel-mix leaf and every Mamba leaf: its
    compute spec is the mesh axes JAX's `param_specs` place it over on a
    (1, world) mesh (``in_proj``: a `Parts` of them); the others are
    `compute_specs`' own business and are held elsewhere."""
    cfg = tconfigs.get_smoke(arch)
    rules = specs.rules_for(MeshShape(("data", "model"), (1, world)))
    name = "rwkv6" if arch == "rwkv6_7b" else "jamba"
    got = runs[world][0]["compute_specs"][name]["blocks"]
    ref = ref_transformer.param_specs(ref_configs.get_smoke(arch))["blocks"]
    shapes = specs.abstract_params(cfg, torch.float32)["blocks"]
    mixers = ([("mixer", None), ("mlp", None)] if cfg.family == "ssm" else
              [("mixer", str(l)) for l in range(cfg.attn_period)
               if not cfg.is_attn_layer(l)])
    checked = 0
    for part, key in mixers:
        g, r, sh = ((got, ref, shapes) if key is None
                    else (got[key], ref[key], shapes[key]))
        for leaf, spec in g[part].items():
            want = _fitted(rules, r[part][leaf] if not isinstance(
                r[part][leaf], dict) else r[part][leaf]["scale"],
                sh[part][leaf].shape if not isinstance(sh[part][leaf], dict)
                else sh[part][leaf]["scale"].shape)
            if leaf == "in_proj":
                assert spec == (None, None, shd.Parts("model")), spec
                assert _norm(want) == ((), (), ("model",))
            else:
                spec = spec["scale"] if isinstance(spec, dict) else spec
                assert _norm(spec) == _norm(want), (part, leaf, spec, want)
            checked += 1
    assert checked >= 9


@pytest.mark.parametrize("world", WORLDS)
def test_in_proj_compute_block_is_the_two_half_blocks(runs, world):
    d_in = ssm.d_inner(tconfigs.get_smoke("jamba_1_5_large_398b"))
    w = _case(*CASES[2])["params"]["in_proj"]
    c = d_in // world
    for r, res in enumerate(runs[world]):
        got = res["mamba"]["in_proj"]
        want = torch.cat([w[:, r * c:(r + 1) * c],
                          w[:, d_in + r * c:d_in + (r + 1) * c]], dim=1)
        assert torch.equal(got["block"], want)
        assert torch.equal(got["plain"], want)
        assert got["back"] and got["whole"]


def _slice(t, spec, rank, world):
    for d, e in enumerate(spec):
        if e is not None and "model" in ((e,) if isinstance(e, str) else e):
            c = t.shape[d] // world
            t = t.narrow(d, rank * c, c)
    return t


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CACHE_ARCHS))
def test_cache_block_cuts_each_leaf_as_jax_places_it(runs, world, name):
    import jax.numpy as jnp
    arch, paged, dtype = CACHE_ARCHS[name]
    cfg, cache = _caches()[name]
    rules = specs.rules_for(MeshShape(("data", "model"), (1, world)),
                            ShapeSpec("d", "decode", 1, 2))
    ref = ref_transformer.cache_specs(
        ref_configs.get_smoke(arch), paged=paged,
        kv_dtype=jnp.int8 if dtype == torch.int8 else None)
    ref_blocks = _ref_tree(ref["blocks"], cache["blocks"])
    for r, res in enumerate(runs[world]):
        got = res["cache_block"][name]
        for a, whole, logical in zip(tree_lib.leaves(got["blocks"]),
                                     tree_lib.leaves(cache["blocks"]),
                                     tree_lib.leaves(ref_blocks)):
            want = _slice(whole, _fitted(rules, logical, whole.shape), r,
                          world)
            assert torch.equal(a, want), (name, logical)
        assert torch.equal(got["lengths"], cache["lengths"])
        if paged is not None:
            assert torch.equal(got["pages"], cache["pages"])
            assert "kv_split" not in got
            for a, whole in zip(tree_lib.leaves(got["blocks"]),
                                tree_lib.leaves(cache["blocks"])):
                assert torch.equal(a, whole)         # the pools stay whole
        elif cfg.family != "ssm":
            assert got["kv_split"]
    split = [a.shape != w.shape for a, w in zip(
        tree_lib.leaves(runs[world][0]["cache_block"][name]["blocks"]),
        tree_lib.leaves(cache["blocks"]))]
    assert any(split) == (paged is None)
