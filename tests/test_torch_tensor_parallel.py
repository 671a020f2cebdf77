"""Tensor and expert parallelism over the model axis, on the CPU: gloo
process groups of 2 and 4 ranks (`_torch_ranks.spawn`) held to the
one-rank layers and to the JAX package on forced host devices (one
subprocess, started before the ranks and read after them).

- (a) Attention, SwiGLU, the embedding, the unembedding and the
  vocab-parallel fused loss on (1, 2) and (1, 4) meshes against the same
  layer on one rank, forward and gradients, within 1e-5 of the largest
  |value|; on 4 ranks Qwen3-14B SMOKE's 4 query heads split while its 2
  KV heads stay whole.
- (b) The train step on a (data 2, model 2) mesh against JAX's
  `value_and_grad` and jitted `make_train_step` on 4 host devices under
  `rules_for(mesh)` with the state placed by `specs.state_shardings`
  (the forward in f32 on both sides): loss within 1e-5 relative,
  gradients within 1e-5 of the step's largest |gradient|, the gradient
  norm within 1e-5 relative, for Qwen3-14B, H2O-Danube (window),
  Phi-3.5-MoE SMOKE (the experts and the router trained over the model
  axis), RWKV6 SMOKE (its time mix over its heads, its channel mix over
  d_ff) and Jamba SMOKE (Mamba over d_in, its experts over the model
  axis), Qwen3-14B and RWKV6 under `sequence_parallel`, and Qwen3-14B
  with int8 moments (updated on each rank's blocks); the state after the
  step bitwise `adamw.update` of those gradients at the step's norm.
- (c) The prefill step's greedy tokens on that mesh equal JAX's.
- (d) 8 greedy decode steps under `decode_rules` on (1, 2) equal JAX's
  `make_serve_step` over its caches placed by
  `transformer.cache_specs(cfg, paged, kv_dtype)`: a contiguous f32
  cache split by sequence (slots whose lengths cross the segment
  boundary, one of length 0), Danube's ring, RWKV6's and Jamba's states
  over heads and d_in, Qwen3-14B's int8 cache split by sequence and its
  paged bf16 and int8 pools whole; and Danube's ring of bf16 rows split
  by sequence against the unsplit ring, layer by layer.
- (e) B1's plain version returns statistics that `combine_partials`
  turns back into the unsplit row.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.kernels.attention import decode  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.loss import fused_cross_entropy  # noqa: E402
from repro_torch.runtime.paging import PageSpec  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
# (name, arch, sequence_parallel, moment dtype); an int8 case is held to
# the f32 case of its arch in JAX (the gradients do not read the moments)
TRAIN = (("qwen3_14b", "qwen3_14b", False, "float32"),
         ("h2o_danube_1_8b", "h2o_danube_1_8b", False, "float32"),
         ("phi3_5_moe_42b", "phi3_5_moe_42b", False, "float32"),
         ("qwen3_14b_sp", "qwen3_14b", True, "float32"),
         ("qwen3_14b_int8", "qwen3_14b", False, "int8"),
         ("rwkv6_7b", "rwkv6_7b", False, "float32"),
         ("rwkv6_7b_sp", "rwkv6_7b", True, "float32"),
         ("jamba_1_5_large_398b", "jamba_1_5_large_398b", False, "float32"))
# (name, arch, rows, lengths, cache layout): "f32" contiguous, "int8"
# contiguous, "paged_bf16" and "paged_int8" pools of PAGE-token pages
DECODE = (("qwen3_14b", "qwen3_14b", 32, (0, 13, 15, 20), "f32"),
          ("h2o_danube_1_8b", "h2o_danube_1_8b", 32, (0, 3, 5, 9), "f32"),
          ("rwkv6_7b", "rwkv6_7b", 32, (0, 3, 5, 9), "f32"),
          ("jamba_1_5_large_398b", "jamba_1_5_large_398b", 32,
           (0, 13, 15, 20), "f32"),
          ("qwen3_14b_int8", "qwen3_14b", 32, (0, 13, 15, 20), "int8"),
          ("qwen3_14b_paged_bf16", "qwen3_14b", 32, (0, 13, 15, 20),
           "paged_bf16"),
          ("qwen3_14b_paged_int8", "qwen3_14b", 32, (0, 13, 15, 20),
           "paged_int8"))
PAGE = 4
STEPS = 8

REFERENCE = r"""
import functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.configs as configs
from repro.configs.shapes import ShapeSpec
from repro.data.pipeline import DataConfig, SyntheticSource
from repro.launch import specs, steps
from repro.launch.mesh import axis_types_kwargs, set_mesh
from repro.models import transformer
from repro.optim import adamw
from repro.parallel import sharding as shd
from repro.parallel.loss import fused_cross_entropy
from repro.runtime.paging import PageSpec

transformer.forward = functools.partial(transformer.forward,
                                        compute_dtype=jnp.float32)
TRAIN = %(train)r
DECODE = %(decode)r
out = {}
opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"), **axis_types_kwargs(2))
for name, arch, sp, moments in TRAIN:
    if moments != "float32":
        continue
    cfg = configs.get_smoke(arch)
    params = transformer.init(cfg, jax.random.PRNGKey(0))
    batch = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=4, seed=1)).batch(0, 0, 1)
    batch["labels"][0, :5] = -1
    batch["labels"][3, 7:12] = -1
    rules = specs.rules_for(mesh)
    if sp:
        rules = shd.sequence_parallel(rules)
    _, state_sh = specs.state_shardings(cfg, opt, mesh, rules)

    def loss_fn(p, b):
        inputs = {k: v for k, v in b.items() if k != "labels"}
        h, _, aux = transformer.forward(cfg, p, inputs, return_hidden=True)
        head = p["embed" if cfg.tie_embeddings else "head"]["table"]
        loss, _ = fused_cross_entropy(h, head, b["labels"],
                                      chunk=cfg.loss_chunk)
        return loss + steps.AUX_WEIGHT * aux

    with set_mesh(mesh), shd.use_rules(rules):
        state = jax.device_put(
            {"params": params, "opt": adamw.init_state(params, opt)},
            state_sh)
        b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           NamedSharding(mesh, P("data", None)))
        total, grads = jax.jit(jax.value_and_grad(loss_fn))(
            state["params"], b)
        _, m = jax.jit(steps.make_train_step(cfg, opt))(state, b)
        toks = jax.jit(steps.make_prefill_step(cfg))(
            state["params"], {"tokens": b["tokens"]})
    out[name + "/total"] = np.asarray(total)
    for k in ("loss", "total_loss", "grad_norm"):
        out[f"{name}/{k}"] = np.asarray(m[k])
    out[name + "/prefill"] = np.asarray(toks)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{name}/param{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"{name}/grad{i}"] = np.asarray(leaf)
    for k, v in batch.items():
        out[f"{name}/batch_{k}"] = v

mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                         ("data", "model"), **axis_types_kwargs(2))
rng = np.random.default_rng(3)
DTYPES = {"f32": jnp.float32, "int8": jnp.int8, "paged_bf16": jnp.bfloat16,
          "paged_int8": jnp.int8}
for name, arch, rows, lengths, layout in DECODE:
    cfg = configs.get_smoke(arch)
    params = transformer.init(cfg, jax.random.PRNGKey(1))
    b = len(lengths)
    shape = ShapeSpec("d", "decode", rows, b)
    rules = specs.rules_for(mesh, shape)
    _, sh = specs.decode_specs(cfg, shape, mesh, rules)
    paged = (PageSpec(%(page)d, b * rows // %(page)d, rows // %(page)d)
             if layout.startswith("paged") else None)
    dtype = DTYPES[layout]
    cache = transformer.cache_init(cfg, b, rows, dtype=dtype, paged=paged)
    leaves = [(rng.integers(-127, 128, v.shape) if v.dtype == jnp.int8
               else rng.standard_normal(v.shape)).astype(
                   jnp.bfloat16 if v.dtype == jnp.bfloat16 else v.dtype)
              for v in jax.tree.leaves(cache["blocks"])]
    lens = np.asarray(lengths, np.int32)
    cache = {"blocks": jax.tree.unflatten(
                 jax.tree.structure(cache["blocks"]),
                 [jnp.asarray(v) for v in leaves]),
             "index": jnp.asarray(int(lens.max()), jnp.int32),
             "lengths": jnp.asarray(lens)}
    if paged is not None:
        cache["pages"] = jnp.asarray(rng.permutation(paged.num_pages)
                                     .reshape(b, -1).astype(np.int32))
        out[name + "/pages"] = np.asarray(cache["pages"])
    c_sh = jax.tree.map(
        lambda ps: NamedSharding(mesh, ps), specs.fit_pspecs(
            specs.logical_to_pspec(transformer.cache_specs(
                cfg, paged=paged, kv_dtype=dtype), rules), cache, rules),
        is_leaf=lambda x: isinstance(x, P))
    tok0 = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    with set_mesh(mesh), shd.use_rules(rules):
        p = jax.device_put(params, sh["params"])
        c = jax.device_put(cache, c_sh)
        step = jax.jit(steps.make_serve_step(cfg, paged=paged))
        tok, seen = jax.device_put(jnp.asarray(tok0), sh["tokens"]), []
        for _ in range(%(steps)d):
            tok, c = step(p, c, tok)
            seen.append(np.asarray(tok))
    out[name + "/decode"] = np.concatenate(seen, 1)
    out[name + "/tok0"] = tok0
    for i, v in enumerate(leaves):
        out[f"{name}/cache{i}"] = (v.view(np.uint16)
                                   if v.dtype == jnp.bfloat16 else v)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{name}/dparam{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
""" % {"train": TRAIN, "decode": DECODE, "steps": STEPS, "page": PAGE}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _ref_name(name: str) -> str:
    """The JAX reference a train case is held to."""
    return next(t[1] if t[3] != "float32" else t[0] for t in TRAIN
                if t[0] == name)


def _opt(name: str) -> adamw.AdamWConfig:
    moments = next(t[3] for t in TRAIN if t[0] == name)
    return adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                             moment_dtype=moments)


def _params(cfg, leaves) -> dict:
    return tree_lib.unflatten_like(
        specs.abstract_params(cfg, torch.float32),
        [torch.from_numpy(np.array(a)) for a in leaves])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's references (a subprocess, run while the ranks run) and the
    port's train, prefill and decode on its ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(tmp / "ref.npz")], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        layer_runs = {w: _torch_ranks.spawn("tp_layers", w, tmp,
                                            _layer_args(), timeout=120)
                      for w in (2, 4)}
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    npz = np.load(tmp / "ref.npz")
    cases = []
    for name, arch, sp, moments in TRAIN:
        cfg = tconfigs.get_smoke(arch)
        n = len(tree_lib.leaves(specs.abstract_params(cfg, torch.float32)))
        ref = _ref_name(name)
        batch = {k: torch.from_numpy(npz[f"{ref}/batch_{k}"])
                 for k in ("tokens", "labels")}
        cases.append({"name": name, "cfg": cfg, "batch": batch,
                      "mesh": (2, 2), "sp": sp, "moments": moments,
                      "params": _params(cfg, [npz[f"{ref}/param{i}"]
                                              for i in range(n)])})
    dec = []
    for name, arch, rows, lengths, layout in DECODE:
        cfg = tconfigs.get_smoke(arch)
        n = len(tree_lib.leaves(specs.abstract_params(cfg, torch.float32)))
        b = len(lengths)
        paged = (PageSpec(PAGE, b * rows // PAGE, rows // PAGE)
                 if layout.startswith("paged") else None)
        dtype = {"f32": torch.float32, "paged_bf16": torch.bfloat16}.get(
            layout, torch.int8)
        cache = transformer.cache_init(cfg, b, rows, dtype=dtype,
                                       device="cpu", paged=paged)
        for i, leaf in enumerate(tree_lib.leaves(cache["blocks"])):
            a = torch.from_numpy(np.array(npz[f"{name}/cache{i}"]))
            leaf.copy_(a.view(torch.bfloat16) if leaf.dtype == torch.bfloat16
                       else a)       # in place: a pool keeps its trash page
        if paged is not None:
            cache["pages"] = torch.from_numpy(npz[f"{name}/pages"])
        cache["lengths"] = torch.tensor(lengths, dtype=torch.int32)
        cache["index"] = torch.tensor(max(lengths), dtype=torch.int32)
        dec.append({"name": name, "cfg": cfg, "cache": cache,
                    "paged": paged,
                    "tokens": torch.from_numpy(npz[f"{name}/tok0"]),
                    "params": _params(cfg, [npz[f"{name}/dparam{i}"]
                                            for i in range(n)])})
    train = _torch_ranks.spawn("tp_train", 4, tmp, {"cases": cases},
                               timeout=180)
    decoded = _torch_ranks.spawn("tp_decode", 2, tmp,
                                 {"cases": dec, "steps": STEPS}, timeout=120)
    return {"npz": npz, "cases": {c["name"]: c for c in cases},
            "train": train, "decode": decoded, "layers": layer_runs}


# ---------------------------------------------------------------------------
# (a) the layers on 2 and 4 model ranks
# ---------------------------------------------------------------------------

LAYER_ARCH = "qwen3_14b"


def _layer_args() -> dict:
    cfg = tconfigs.get_smoke(LAYER_ARCH)
    g = torch.Generator().manual_seed(5)
    params = transformer.init(cfg, g)
    b, s, d = 2, 8, cfg.d_model
    r = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    labels[0, :3] = -1
    return {"cfg": cfg,
            "layer": tree_lib.map_structure(lambda a: a[0].clone(),
                                            params["blocks"]),
            "embed": params["embed"], "x": r(b, s, d),
            "tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g),
            "labels": labels, "chunk": 5,
            "cot": {"attention": r(b, s, d), "mlp": r(b, s, d),
                    "embed": r(b, s, d),
                    "unembed": r(b, s, cfg.vocab_size)}}


def _one_rank_layers(a) -> dict:
    cfg, out = a["cfg"], {}

    def run(name, params, fn, *inputs):
        p = tree_lib.map_structure(lambda t: t.clone().requires_grad_(),
                                   params)
        xs = [x.clone().requires_grad_() if x.is_floating_point() else x
              for x in inputs]
        y = fn(p, *xs)
        y.backward(a["cot"][name] if y.ndim else None)
        out[name] = {"y": y.detach(),
                     "grads": tree_lib.map_structure(lambda t: t.grad, p),
                     "dx": [x.grad for x in xs if x.is_floating_point()]}

    x, pos = a["x"], torch.arange(a["x"].shape[1])
    run("attention", a["layer"]["mixer"],
        lambda p, x: layers.attention_apply(p, x, cfg, pos)[0], x)
    run("mlp", a["layer"]["mlp"], lambda p, x: layers.swiglu_apply(p, x), x)
    run("embed", a["embed"], lambda p, t: layers.embedding_lookup(p, t),
        a["tokens"])
    run("unembed", a["embed"],
        lambda p, x: (layers.unembed(p, x) * a["cot"]["unembed"]).sum(), x)
    run("loss", a["embed"], lambda p, x: fused_cross_entropy(
        x, p["table"], a["labels"], chunk=a["chunk"])[0], x)
    return out


def _close(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) <= REL * scale


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layer", ["attention", "mlp", "embed", "unembed",
                                   "loss"])
def test_layer_over_the_model_axis_equals_one_rank(runs, world, layer):
    want = _one_rank_layers(_layer_args())[layer]
    for res in runs["layers"][world]:
        got = res[layer]
        assert _close(got["y"], want["y"]), layer
        for a, b in zip(tree_lib.leaves(got["grads"]),
                        tree_lib.leaves(want["grads"])):
            assert _close(a, b), layer
        for a, b in zip(got["dx"], want["dx"]):
            assert _close(a, b), layer


def test_four_ranks_split_query_heads_over_whole_kv_heads():
    """On (1, 4) Qwen3-14B SMOKE's 4 query heads split and its 2 KV heads
    stay whole: each rank reads the one KV head its query head reads, a
    local group of 1, and the KV projections are computed whole."""
    from repro_torch.launch.mesh import MeshShape
    cfg = tconfigs.get_smoke(LAYER_ARCH)
    rules = specs.rules_for(MeshShape(("data", "model"), (1, 4)))
    cs = transformer.compute_specs(cfg, rules)["blocks"]["mixer"]
    assert cs["wq"] == (None, None, "model") and cs["wo"][1] == "model"
    assert cs["wk"] == (None, None, None)
    from repro_torch.parallel.sharding import Split
    ids = [layers._kv_heads_read(cfg, Split(("model",), 4, r, None))
           for r in range(4)]
    assert ids == [(0, 1), (0, 1), (1, 1), (1, 1)]


# ---------------------------------------------------------------------------
# (b), (c) the train and prefill steps on (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_train_step_on_data_2_model_2_equals_jax(runs, name):
    npz, case = runs["npz"], runs["cases"][name]
    ref = _ref_name(name)
    res = runs["train"]
    r0 = res[0][name]
    for other in res[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(r0["grads"]),
            tree_lib.leaves(other[name]["grads"])))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(r0["state"]),
            tree_lib.leaves(other[name]["state"])))
    for k in ("loss", "total_loss"):
        want = float(npz[f"{ref}/{k}"])
        assert abs(r0[k] - want) <= REL * abs(want), (k, r0[k], want)
    want_norm = float(npz[f"{ref}/grad_norm"])
    assert abs(float(r0["grad_norm"]) - want_norm) <= REL * want_norm
    grads = tree_lib.leaves(r0["grads"])
    want = [npz[f"{ref}/grad{i}"] for i in range(len(grads))]
    step_max = max(float(np.abs(g).max()) for g in want)
    for i, (g, w) in enumerate(zip(grads, want)):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= REL * step_max, (name, i, err, step_max)
    # the state after the step is the update of those gradients
    p = tree_lib.map_structure(lambda t: t.clone(), case["params"])
    opt = adamw.init_state(p, _opt(name))
    adamw.update(p, r0["grads"], opt, _opt(name),
                 grad_norm=r0["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves({"params": p, "opt": opt}),
        tree_lib.leaves(r0["state"])))


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_prefill_tokens_on_data_2_model_2_equal_jax(runs, name):
    res = runs["train"]
    got = {}
    for r in res:
        got[r[name]["data"]] = r[name]["tokens"]
    tokens = torch.cat([got[0], got[1]]).numpy()
    assert np.array_equal(tokens, runs["npz"][_ref_name(name) + "/prefill"])


# ---------------------------------------------------------------------------
# (d) decode over a cache split by sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [d[0] for d in DECODE])
def test_decode_over_a_sequence_split_cache_equals_jax(runs, arch):
    """Under `decode_rules`: a contiguous attention cache (f32 or int8)
    split by sequence, a paged pool whole on each rank, the RWKV and
    Mamba states split over heads and ``d_in``; 8 greedy tokens equal
    JAX's."""
    want = runs["npz"][arch + "/decode"]
    _, real, _, _, layout = next(d for d in DECODE if d[0] == arch)
    contiguous_attention = (not layout.startswith("paged")
                            and real != "rwkv6_7b")
    for r in runs["decode"]:
        assert r[arch]["kv_split"] == contiguous_attention
        assert np.array_equal(r[arch]["tokens"].numpy(), want), arch


def test_ring_attention_over_a_split_bf16_cache_equals_one_rank(tmp_path):
    """H2O-Danube SMOKE's ring of 8 bf16 K/V rows split into two segments
    of 4: the attention of 1 and of 3 new tokens a slot (lengths 0, 3, 5
    and 13, the last past the window) equals the unsplit ring's within
    1e-5 of its largest |value|, the probabilities rounded to bf16 on
    both sides; each segment holds the unsplit ring's rows after the
    writes."""
    cfg = tconfigs.get_smoke("h2o_danube_1_8b")
    g = torch.Generator().manual_seed(11)
    params = tree_lib.map_structure(
        lambda a: a[0].clone(), transformer.init(cfg, g)["blocks"])["mixer"]
    lengths = torch.tensor([0, 3, 5, 13], dtype=torch.int32)
    cache = layers.attention_cache_init(cfg, 4, 64, dtype=torch.bfloat16)
    for k in cache:
        cache[k] = torch.randn(cache[k].shape, generator=g).to(torch.bfloat16)
    xs = {s: torch.randn(4, s, cfg.d_model, generator=g) for s in (1, 3)}
    world = 2
    got = _torch_ranks.spawn("tp_ring_bf16", world, tmp_path,
                             {"cfg": cfg, "params": params, "cache": cache,
                              "lengths": lengths, "x": xs}, timeout=120)
    rows = cache["k"].shape[1] // world
    for s, x in xs.items():
        whole = {k: c.clone() for k, c in cache.items()}
        pos = lengths[:, None] + torch.arange(s, dtype=torch.int32)
        want, whole = layers.attention_apply(params, x, cfg, pos,
                                             cache=whole, lengths=lengths)
        for r, res in enumerate(got):
            assert _close(res[s]["y"], want), (s, r)
            for k, c in res[s]["cache"].items():
                assert torch.equal(c, whole[k][:, r * rows:(r + 1) * rows])


# ---------------------------------------------------------------------------
# (e) B1's statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 4])
def test_decode_statistics_combine_into_the_unsplit_row(g):
    """`decode_ref`'s (out, m, l) over two halves of the keys, combined by
    `combine_partials` from ``out * l``, equal the row over all of them
    within 1e-5: lengths in the first half, across it, and 0."""
    gen = torch.Generator().manual_seed(2)
    b, rows, hkv, dh = 4, 64, 2, 16
    q = torch.randn(b, hkv * g, dh, generator=gen)
    k = torch.randn(b, rows, hkv, dh, generator=gen)
    v = torch.randn(b, rows, hkv, dh, generator=gen)
    length = torch.tensor([0, 20, 33, 64], dtype=torch.int32)
    whole, m, l = decode.gqa_decode_attention(q, k, v, length=length,
                                              return_stats=True)
    assert torch.equal(whole, decode.gqa_decode_attention(
        q, k, v, length=length))
    assert bool((m[0] == decode.NEG_INF).all()) and not bool(l[0].any())
    half = rows // 2
    parts = [decode.gqa_decode_attention(
        q, k[:, i:i + half], v[:, i:i + half],
        length=torch.clamp(length - i, 0, half), return_stats=True)
        for i in (0, half)]
    out = decode.combine_partials(
        torch.stack([p[1] for p in parts]), torch.stack([p[2] for p in parts]),
        torch.stack([p[0] * p[2][..., None] for p in parts]))
    assert float((out - whole).abs().max()) <= REL * float(whole.abs().max())
    # the whole row's statistics are the halves' combined
    mx = torch.maximum(parts[0][1], parts[1][1])
    lsum = sum(p[2] * torch.exp(p[1] - mx) for p in parts)
    assert torch.allclose(mx, m) and torch.allclose(lsum, l, rtol=1e-5)
