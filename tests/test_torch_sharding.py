"""The port's sharding rules, mesh helpers and state specs against the
JAX package's (`repro.parallel.sharding`, `repro.launch.specs`,
`repro.launch.mesh`, the models' ``*_param_specs``).

A spec is a tuple in the port and a `PartitionSpec` in JAX; JAX writes a
one-axis entry either as the name or as a 1-tuple, so both sides are
compared with such entries normalised to the name.  No mesh of 256 or
512 devices is built on either side: the port reads a
`launch.mesh.MeshShape`, JAX a plain object with ``axis_names``,
``shape`` and ``devices.shape``.  Abstract parameters are JAX's
`eval_shape` and the port's walk of `init` on the meta device.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _torch_ranks  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import policy as jpolicy  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.runtime.paging import PageSpec as JPageSpec  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import policy as tpolicy  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402
from repro_torch.runtime.paging import PageSpec as TPageSpec  # noqa: E402

ARCHS = tconfigs.list_archs()
MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
KNOBS = [("single_pod", lambda m: m.single_pod_rules()),
         ("multi_pod", lambda m: m.multi_pod_rules()),
         ("test", lambda m: m.test_rules()),
         ("sequence_parallel",
          lambda m: m.sequence_parallel(m.single_pod_rules())),
         ("data_parallel_attention",
          lambda m: m.data_parallel_attention(m.multi_pod_rules())),
         ("data_parallel_only",
          lambda m: m.data_parallel_only(m.multi_pod_rules())),
         ("decode", lambda m: m.decode_rules(m.single_pod_rules())),
         ("decode_replicated",
          lambda m: m.decode_rules(m.multi_pod_rules(), True))]


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _norm(tree):
    """Specs as tuples of normalised entries; logical-axis tuples as
    they are."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, P):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, tuple):
        return tuple(_entry(e) for e in tree)
    return tree


def _jax_tree(tree):
    return _norm(jax.tree.map(lambda p: p, tree,
                              is_leaf=lambda x: isinstance(x, P)))


def _jax_mesh(names, shape):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)),
                                 devices=np.empty(shape, np.int8))


@pytest.fixture(scope="module", autouse=True)
def _cached_jax_abstract_params():
    """The reference's `param_pspecs`, `opt_pspecs` and `decode_specs`
    each trace `init` again; a memo of its `abstract_params` per config
    (a test-time memo: the reference is not edited) keeps this file's
    time down."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jspecs, "abstract_params",
               functools.lru_cache(maxsize=None)(jspecs.abstract_params))
    yield
    mp.undo()


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, make", KNOBS, ids=[k[0] for k in KNOBS])
def test_rule_tables_and_knobs_equal_the_reference(name, make):
    ours, theirs = make(tshd), make(jshd)
    assert ours.table == theirs.table
    for names, shape in MESHES:
        o = ours.with_sizes(mesh_lib.MeshShape(names, shape))
        t = theirs.with_sizes(_jax_mesh(names, shape))
        assert o.sizes == t.sizes
        for ax in [a for a in o.table if a != "zero3_attn"] + ["nope"]:
            assert o.axis_size(o.table.get(ax)) == \
                t.axis_size(t.table.get(ax))
        for logical in [("batch", "seq", "embed"), ("heads", "kv_seq"),
                        ("experts", None, "vocab"), ()]:
            assert _norm(o.spec(*logical)) == _norm(t.spec(*logical))


@pytest.mark.parametrize("names, shape", MESHES)
def test_rules_for_equals_the_reference(names, shape):
    tm, jm = mesh_lib.MeshShape(names, shape), _jax_mesh(names, shape)
    for shape_name in [None, *TSHAPES]:
        o = tspecs.rules_for(tm, TSHAPES.get(shape_name))
        t = jspecs.rules_for(jm, JSHAPES.get(shape_name))
        assert o.table == t.table and o.sizes == t.sizes


def test_fit_spec_and_constrain_drop_indivisible_dims():
    """As tests/test_system.py: with model = 1 every mapping drops; with
    real sizes the indivisible ones drop (8 KV heads on 16 model ranks),
    as the reference's `fit_spec` drops them."""
    rules = tshd.single_pod_rules().with_sizes(
        mesh_lib.MeshShape(("data", "model"), (1, 1)))
    with tshd.use_rules(rules):
        x = torch.zeros(4, 6, 8)
        assert tshd.constrain(x, "batch", "seq", "heads") is x
        with pytest.raises(ValueError):
            tshd.constrain(x, "batch", "seq")
    assert tshd.fitted(rules.spec("batch", "seq", "heads"), (4, 6, 8),
                       rules) == (None, None, None)
    for names, shape in MESHES:
        o = tshd.multi_pod_rules().with_sizes(mesh_lib.MeshShape(names,
                                                                 shape))
        t = jshd.multi_pod_rules().with_sizes(_jax_mesh(names, shape))
        for logical, dims in [(("batch", "kv_seq", "kv_heads", None),
                               (64, 4096, 8, 128)),
                              (("batch", "heads"), (31, 48)),
                              (("experts", "embed", "ff"), (16, 8, 32))]:
            assert _norm(tspecs.fit_spec(o.spec(*logical), dims, o)) == \
                _norm(jspecs.fit_spec(t.spec(*logical), dims, t))
    assert tshd.constrain(torch.ones(3)) is not None   # no rules: identity
    assert tshd.gather_weight(x) is x


def test_placements_split_a_dim_row_major_over_its_axes(tmp_path):
    """``("pod", "data")`` on one dim: rank (p, d, m) of a (2, 2, 2) mesh
    holds rows [(2 p + d) 2, (2 p + d) 2 + 2) of an (8, 3) tensor, as JAX
    splits it; DTensor's `distribute_tensor` by `placements` holds the
    same block, `gather_full` and `full_tensor` give the whole back, and
    `constrain` and `gather_weight` redistribute a DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert tshd.placements((("pod", "data"), None),
                           mesh_lib.MeshShape(names, (2, 2, 2))) == \
        (Shard(0), Shard(0), Replicate())
    assert tshd.placements((None, "model"), mesh_lib.MeshShape(
        names, (2, 2, 2))) == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError):
        tshd.placements((("data", "pod"),), mesh_lib.MeshShape(names,
                                                               (2, 2, 2)))
    full = torch.arange(24.0).reshape(8, 3)
    res = _torch_ranks.spawn("placements", 8, tmp_path, {"full": full})
    for r in res:
        p, d, _ = r["coord"]
        i = 2 * p + d
        assert torch.equal(r["mine"], full[2 * i:2 * i + 2])
        assert torch.equal(r["dtensor"], full[2 * i:2 * i + 2])
        assert torch.equal(r["gathered"], full)
        assert torch.equal(r["full_tensor"], full)
        assert r["spec_of"] == (("pod", "data"), None)
        # constrain on a DTensor: "batch" over (pod, data) divides 8 and
        # stays, "heads" over 2 model ranks does not divide 3 and drops;
        # logical None replicates; gather_weight under zero3_attn too
        spec, local = r["constrained"]
        assert spec == (("pod", "data"), None)
        assert torch.equal(local, full[2 * i:2 * i + 2])
        for key in ("replicated", "gather_weight"):
            spec, local = r[key]
            assert spec == (None, None) and torch.equal(local, full)


# ---------------------------------------------------------------------------
# The models' spec trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_reference(arch, smoke):
    get = "get_smoke" if smoke else "get"
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert _norm(ttf.param_specs(t)) == _norm(jtf.param_specs(j))
    jpage, tpage = JPageSpec.build(4, 64, 16), TPageSpec.build(4, 64, 16)
    for paged in (False, True):
        for kv in ("f32", "bf16", "int8"):
            jk = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                  "int8": jnp.int8}[kv]
            tk = {"f32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}[kv]
            assert _norm(ttf.cache_specs(t, tpage if paged else None, tk)) \
                == _norm(jtf.cache_specs(j, jpage if paged else None, jk))
    # the spec trees have the init's and the cache's structure
    params = tspecs.abstract_params(t)
    assert list(tree_lib.flatten_with_paths(params)[0]) == list(
        tree_lib.flatten_with_paths(tree_lib.map_structure(
            lambda a: 0, ttf.param_specs(t)))[0])
    for spec, leaf in zip(tree_lib.leaves(ttf.param_specs(t)),
                          tree_lib.leaves(params)):
        assert len(spec) == leaf.ndim


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_are_the_reference_shapes_on_meta(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    ours = tspecs.abstract_params(t)
    theirs = jspecs.abstract_params(j)
    keys, leaves = tree_lib.flatten_with_paths(ours)
    flat, _ = jax.tree_util.tree_flatten_with_path(theirs)
    assert keys == ["/".join(str(k) for k in p) for p, _ in flat]
    for a, (_, b) in zip(leaves, flat):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


# ---------------------------------------------------------------------------
# State and decode specs on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names, shape", MESHES,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_decode_specs_equal_the_reference(arch, names, shape):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    jm, tm = _jax_mesh(names, shape), mesh_lib.MeshShape(names, shape)
    jr, tr = jspecs.rules_for(jm), tspecs.rules_for(tm)
    assert tpolicy.use_fsdp(t) == jpolicy.use_fsdp(j)
    assert _norm(tspecs.param_pspecs(t, tr, tm)) == \
        _jax_tree(jspecs.param_pspecs(j, jr, jm))
    jo = jadamw.AdamWConfig(moment_dtype=jpolicy.moment_dtype(j))
    to = tadamw.AdamWConfig(moment_dtype=tpolicy.moment_dtype(t))
    jpa = jspecs.abstract_params(j)
    tpa = tspecs.abstract_params(t)
    ours = tspecs.opt_pspecs(t, tpa, tspecs.abstract_opt_state(tpa, to),
                             tr, tm)
    theirs = jspecs.opt_pspecs(j, jpa, jspecs.abstract_opt_state(jpa, jo),
                               jr, jm)
    assert _norm(ours) == _jax_tree(theirs)
    # above 100 B parameters the moments are int8 {"q", "scale"} pairs
    assert _has_int8(ours["m"]) == (to.moment_dtype == "int8")
    if t.family == "encoder":
        return
    for sname in ("decode_32k", "long_500k"):
        jrd = jspecs.rules_for(jm, JSHAPES[sname])
        trd = tspecs.rules_for(tm, TSHAPES[sname])
        _, jsh = _jax_decode_pspecs(j, JSHAPES[sname], jm, jrd, jr)
        _, tsh = tspecs.decode_pspecs(t, TSHAPES[sname], tm, trd, tr)
        assert _norm(tsh) == _jax_tree(jsh), sname


def _has_int8(tree) -> bool:
    if isinstance(tree, dict):
        return set(tree) == {"q", "scale"} or any(
            _has_int8(v) for v in tree.values())
    return False


def _jax_decode_pspecs(cfg, shape, mesh, rules, state_rules):
    """`jspecs.decode_specs` without its `NamedSharding`s (which need a
    real mesh): the same spec computation, its lines in its order."""
    params_abs = jspecs.abstract_params(cfg)
    b = shape.global_batch
    cache_abs = jax.eval_shape(lambda: jtf.cache_init(
        cfg, b, shape.seq_len, dtype=jnp.bfloat16))
    p_pspecs = jspecs.param_pspecs(cfg, state_rules or rules, mesh)
    c_pspecs = jspecs.fit_pspecs(
        jspecs.logical_to_pspec(jtf.cache_specs(cfg), rules), cache_abs,
        rules)
    tok_spec = jspecs.fit_spec(P(rules.table.get("batch"), None), (b, 1),
                               rules)
    return ({"params": params_abs, "cache": cache_abs},
            {"params": p_pspecs, "cache": c_pspecs, "tokens": tok_spec})


def test_placements_of_a_state_on_a_mesh_shape():
    """`state_shardings` and `decode_specs` turn every spec into DTensor
    placements, one per mesh axis, without a process group."""
    from torch.distributed.tensor import Placement
    cfg = tconfigs.get("qwen3_14b")
    tm = mesh_lib.MeshShape(("data", "model"), (16, 16))
    rules = tspecs.rules_for(tm)
    abs_, pl = tspecs.state_shardings(
        cfg, tadamw.AdamWConfig(), tm, rules)
    for p in tree_lib.leaves(pl):
        assert len(p) == 2 and all(isinstance(x, Placement) for x in p)
    _, dpl = tspecs.decode_specs(cfg, TSHAPES["decode_32k"], tm,
                                 tspecs.rules_for(tm, TSHAPES["decode_32k"]),
                                 rules)
    assert set(dpl) == {"params", "cache", "tokens"}


# ---------------------------------------------------------------------------
# The mesh helpers
# ---------------------------------------------------------------------------

def test_host_mesh_on_the_cpu_is_gloo_and_larger_meshes_need_ranks():
    import torch.distributed as dist
    mesh = mesh_lib.make_host_mesh(1, 1, device_type="cpu")
    assert dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh_lib.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert mesh_lib.make_host_mesh(1, 1, device_type="cpu") is mesh
    with pytest.raises(RuntimeError, match="256 cards needs 256 ranks"):
        mesh_lib.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 cards needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    with mesh_lib.set_mesh(mesh):
        assert mesh_lib.get_abstract_mesh() is mesh
    assert mesh_lib.get_abstract_mesh() is None
    assert tshd.Rules({}).with_sizes(mesh).sizes == {"data": 1, "model": 1}


def test_mesh_of_a_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_lib.make_host_mesh(1, 1)


def test_batch_shardings_equal_the_reference():
    for names, shape in MESHES:
        jm, tm = _jax_mesh(names, shape), mesh_lib.MeshShape(names, shape)
        for arch in ("qwen3_14b", "hubert_xlarge", "internvl2_2b"):
            t, j = tconfigs.get(arch), jconfigs.get(arch)
            for sname in ("train_4k", "prefill_32k"):
                ours = tspecs.batch_shardings(t, TSHAPES[sname], tm,
                                              tspecs.rules_for(tm))
                jb = jspecs.batch_specs(j, JSHAPES[sname])
                tb = tspecs.batch_specs(t, TSHAPES[sname])
                assert list(jb) == list(tb)
                for k in jb:
                    assert tuple(jb[k].shape) == tuple(tb[k].shape)
                    want = jspecs.fit_spec(
                        jspecs.rules_for(jm).spec(
                            "batch", *([None] * (len(jb[k].shape) - 1))),
                        jb[k].shape, jspecs.rules_for(jm))
                    assert _norm(ours[k]) == _norm(want)
