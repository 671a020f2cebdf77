"""Scale-out of the port on the CPU: gloo process groups of 2, 4 and 8
ranks (`_torch_ranks.spawn`, each group under its own time limit) held
to the JAX package, whose multi-device references run in a subprocess
with ``--xla_force_host_platform_device_count`` and write an ``.npz``.

- `parallel.compression.compressed_psum` on 4 ranks against the
  reference's on 4 host devices: the same f32 operations in the same
  order, so bitwise (the test allows 1e-7 relative).
- `launch.steps.data_parallel_step` on 2 and 4 ranks, with moments
  ZeRO-sharded, with `policy.use_fsdp` forced on, and with
  ``grad_dtype=bfloat16``: the loss and the reduced gradients against
  the one-rank port step and JAX's `value_and_grad` within 1e-5 of the
  largest |gradient| (the shards hold different numbers of labelled
  tokens, so a mean of per-rank means would fail); the state after the
  step bitwise `adamw.update` of those gradients on the whole state.
- On a one-rank mesh the step is bitwise the plain one.
- `runtime.elastic`: the reference's `largest_mesh_shape` cases; a
  checkpoint written by 4 ranks restores through `remesh` and
  `reshard_state` onto 2 ranks leaf for leaf bitwise, and the next step
  equals the one-rank step from the same checkpoint within 1e-5 of the
  largest |gradient|.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.loss import fused_cross_entropy as jfce  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import disable_tf32, params_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticSource  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 1e-5                      # of the step's largest |gradient|
LOSS_REL = 1e-5
ARCH = "qwen3_14b"
GLOBAL = (8, 16)                     # batch x sequence
OPT = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _jax_subprocess(snippet: str, out, timeout=120):
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, "-c", snippet, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return np.load(out)


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------

COMPRESSION_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.launch.mesh import axis_types_kwargs, set_mesh, shard_map
from repro.parallel.compression import compressed_psum
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4), ("data",),
                         **axis_types_kwargs(1))
vals = (np.random.default_rng(0).standard_normal((4, 300))
        .astype(np.float32) * 5)
with set_mesh(mesh):
    xs = jax.device_put(jnp.asarray(vals), NamedSharding(mesh, P("data", None)))
    out = jax.jit(lambda v: compressed_psum(
        shard_map(lambda t: t[0], mesh, in_specs=P("data", None),
                  out_specs=P(None))(v), "data"))(xs)
np.savez(sys.argv[1], vals=vals, out=np.asarray(out))
"""


def test_compressed_psum_on_4_ranks_equals_the_reference(tmp_path):
    ref = _jax_subprocess(COMPRESSION_SNIPPET, tmp_path / "ref.npz")
    vals = torch.from_numpy(ref["vals"])
    res = _torch_ranks.spawn("compression", 4, tmp_path, {"vals": vals})
    want = ref["out"]
    for r in res:
        got = r["out"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    # and within each block's scale/2 of the mean, as the reference says
    scale = np.abs(ref["vals"]).max() / 127
    assert np.abs(res[0]["out"].numpy() - ref["vals"].mean(0)).max() \
        <= scale / 2 + 1e-6


# ---------------------------------------------------------------------------
# The data-parallel train step
# ---------------------------------------------------------------------------

def _global_batch():
    cfg = tconfigs.get_smoke(ARCH)
    b, s = GLOBAL
    batch = SyntheticSource(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
        seed=1)).batch(0, 0, 1)
    # shards with different numbers of labelled tokens: rows 0-1 (the
    # first shard on 2 and 4 ranks) lose most of theirs
    batch["labels"][0, :13] = -1
    batch["labels"][1, 2:9] = -1
    batch["labels"][5, :3] = -1
    return batch


@pytest.fixture(scope="module")
def reference():
    """JAX's parameters and `value_and_grad` on the global batch, the
    port's one-rank step, the batch."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jtf.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = _global_batch()
    inputs = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}

    def loss_fn(p):
        h, _, aux = jtf.forward(jcfg, p, inputs, compute_dtype=jnp.float32,
                                return_hidden=True)
        loss, _ = jfce(h, p["embed" if jcfg.tie_embeddings else "head"]
                       ["table"], jnp.asarray(batch["labels"]),
                       chunk=jcfg.loss_chunk)
        return loss + jsteps.AUX_WEIGHT * aux

    jl, jg = jax.value_and_grad(loss_fn)(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, _, _, grads = steps.loss_and_grads(tcfg, params, tb,
                                              compute_dtype=torch.float32)
    return {"cfg": tcfg, "params": params, "batch": tb,
            "jax_loss": float(jl),
            "jax_grads": tree_lib.leaves(params_from_numpy(
                jax.tree.map(np.asarray, jg))),
            "loss": float(total), "grads": tree_lib.leaves(grads)}


_RUNS: dict = {}


def _dp_run(world, reference, tmp_path_factory):
    if world not in _RUNS:
        _RUNS[world] = _torch_ranks.spawn(
            "train", world, tmp_path_factory.mktemp("dp"),
            {"cfg": reference["cfg"], "params": reference["params"],
             "batch": reference["batch"],
             "variants": ["dp", "fsdp", "bf16"]}, timeout=180)
    return _RUNS[world]


def _sharded(spec_tree) -> int:
    return sum(any(e is not None for e in s)
               for s in tree_lib.leaves(spec_tree) if isinstance(s, tuple))


@pytest.mark.parametrize("variant", ["dp", "fsdp"])
@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_equals_one_rank_and_jax(world, variant,
                                                    reference,
                                                    tmp_path_factory):
    runs = _dp_run(world, reference, tmp_path_factory)
    res = runs[0][variant]
    # every rank holds the same reduced gradients and whole state
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(res["grads"]),
            tree_lib.leaves(other[variant]["grads"])))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(res["state"]),
            tree_lib.leaves(other[variant]["state"])))
    # the layouts are sharded: moments over data; FSDP parameters too
    assert _sharded(res["pspecs"]["opt"]["m"]) > 0
    assert (_sharded(res["pspecs"]["params"]) > 0) == (variant == "fsdp")
    grads = tree_lib.leaves(res["grads"])
    for name, loss, want in (("port", reference["loss"], reference["grads"]),
                             ("jax", reference["jax_loss"],
                              reference["jax_grads"])):
        assert abs(res["total_loss"] - loss) <= LOSS_REL * abs(loss), name
        step_max = max(float(g.abs().max()) for g in want)
        err = max(float((a - b).abs().max()) for a, b in zip(grads, want))
        assert err <= GRAD_REL * step_max, (name, err, step_max)
    _assert_state_is_the_update(reference, res)


def _assert_state_is_the_update(reference, res):
    """The sharded update is `adamw.update` of the same gradients on the
    whole state, bit for bit."""
    p = tree_lib.map_structure(lambda t: t.clone(), reference["params"])
    opt = adamw.init_state(p, OPT)
    adamw.update(p, res["grads"], opt, OPT)
    want = tree_lib.leaves({"params": p, "opt": opt})
    got = tree_lib.leaves(res["state"])
    assert len(want) == len(got)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_gradient_reduce(world, reference, tmp_path_factory):
    """``grad_dtype=bfloat16``: each rank rounds its partial gradient to
    bf16 and gloo sums the bf16 tensors as they are (no cast in the
    package).  Each rounding, the partials' and the sums', is at most
    2^-9 of what it rounds, so the reduced gradient lies within world *
    2^-8 * sum_r |partial_r| of the f32 one, element by element; the
    partials are recomputed here as each rank computes them.  The state
    after is `adamw.update` of those bf16 gradients, bitwise."""
    res = _dp_run(world, reference, tmp_path_factory)[0]["bf16"]
    grads = tree_lib.leaves(res["grads"])
    assert all(g.dtype == torch.bfloat16 for g in grads)
    cfg, b = reference["cfg"], GLOBAL[0]
    labels = reference["batch"]["labels"]
    count = torch.clamp(torch.sum(labels != -1).to(torch.float32), min=1.0)
    mag = [torch.zeros_like(g) for g in reference["grads"]]
    for r in range(world):
        rows = slice(r * b // world, (r + 1) * b // world)
        _, _, _, part = steps.loss_and_grads(
            cfg, reference["params"],
            {k: v[rows] for k, v in reference["batch"].items()},
            compute_dtype=torch.float32, denominator=count,
            aux_weight=steps.AUX_WEIGHT / world)
        mag = [m + p.abs() for m, p in zip(mag, tree_lib.leaves(part))]
    for g, want, m in zip(grads, reference["grads"], mag):
        err = (g.float() - want).abs()
        assert bool((err <= world * 2.0 ** -8 * m + 1e-12).all())
    _assert_state_is_the_update(reference, res)


def test_one_card_mesh_step_is_bitwise_the_plain_step(reference):
    """On a (1, 1) mesh (gloo here, NCCL on a card) the data-parallel
    step, gradient cast included, is the plain step bit for bit."""
    cfg = reference["cfg"]
    mesh = mesh_lib.make_host_mesh(1, 1, device_type="cpu")
    rules = specs.rules_for(mesh)
    for grad_dtype in (None, torch.bfloat16):
        out = []
        for on_mesh in (False, True):
            p = tree_lib.map_structure(lambda t: t.clone(),
                                       reference["params"])
            state = {"params": p, "opt": adamw.init_state(p, OPT)}
            if on_mesh:
                from repro_torch.parallel import sharding as shd
                _, pspecs = specs.state_pspecs(cfg, OPT, mesh, rules)
                state = tree_lib.map_structure(
                    lambda t, s: shd.distribute(t, s, mesh), state, pspecs)
            step = steps.make_train_step(
                cfg, OPT, compute_dtype=torch.float32, grad_dtype=grad_dtype,
                mesh=mesh if on_mesh else None, rules=rules)
            state, m, g = step(state, reference["batch"], return_grads=True)
            leaves = [t.to_local() if hasattr(t, "to_local") else t
                      for t in tree_lib.leaves(state)]
            out.append((float(m["loss"]), float(m["total_loss"]),
                        tree_lib.leaves(g), leaves))
        (l0, t0, g0, s0), (l1, t1, g1, s1) = out
        assert l0 == l1 and t0 == t1
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert all(torch.equal(a, b) for a, b in zip(s0, s1))
        if grad_dtype is not None:
            assert all(torch.equal(a, b.to(grad_dtype))
                       for a, b in zip(g0, reference["grads"]))


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------

def test_largest_mesh_shape_is_the_reference():
    for n, mp in ((256, 16), (192, 16), (8, 16), (1, 16), (6, 4), (3, 2)):
        assert elastic.largest_mesh_shape(n, mp) == \
            jelastic.largest_mesh_shape(n, mp)
    assert elastic.largest_mesh_shape(256, 16) == (16, 16)
    assert elastic.largest_mesh_shape(192, 16) == (12, 16)
    assert elastic.largest_mesh_shape(8, 16) == (1, 8)
    assert elastic.largest_mesh_shape(1, 16) == (1, 1)


def test_checkpoint_of_4_ranks_restores_onto_2(reference, tmp_path):
    cfg = reference["cfg"]
    ckdir = tmp_path / "ck"
    batch2 = {k: v.clone() for k, v in reference["batch"].items()}
    batch2["tokens"] = torch.roll(batch2["tokens"], 1, dims=1)
    _torch_ranks.spawn("elastic_save", 4, tmp_path,
                       {"cfg": cfg, "opt": OPT, "params": reference["params"],
                        "batch": reference["batch"], "dir": str(ckdir)})
    res = _torch_ranks.spawn("elastic_restore", 2, tmp_path,
                             {"cfg": cfg, "opt": OPT, "dir": str(ckdir),
                              "batch": batch2})
    like, _ = specs.state_pspecs(cfg, OPT, mesh_lib.MeshShape(
        ("data", "model"), (2, 1)), specs.rules_for(
            mesh_lib.MeshShape(("data", "model"), (2, 1))))
    host, meta = CheckpointManager(ckdir).restore(None, like)
    assert meta["step"] == 1
    for r in res:
        assert r["step"] == 1
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(r["restored"]), tree_lib.leaves(host)))
    # the leaves the FSDP specs shard hold half of their dim on each rank
    halves = [(spec, shape) for spec, shape in zip(
        tree_lib.leaves(res[0]["pspecs"]["params"]),
        tree_lib.leaves(res[0]["local_shapes"]["params"]))
        if any(e is not None for e in spec)]
    assert halves
    # the next step against the one-rank step from the checkpoint
    step = steps.make_train_step(cfg, OPT, compute_dtype=torch.float32)
    _, m, grads = step(host, batch2, return_grads=True)
    want = tree_lib.leaves(grads)
    step_max = max(float(g.abs().max()) for g in want)
    for r in res:
        assert abs(r["loss"] - float(m["loss"])) <= LOSS_REL * float(m["loss"])
        err = max(float((a - b).abs().max()) for a, b in zip(
            tree_lib.leaves(r["grads"]), want))
        assert err <= GRAD_REL * step_max, (err, step_max)


def test_remesh_takes_the_first_ranks(tmp_path):
    """`remesh` over 3 surviving ranks with model parallelism 2 builds a
    (1, 2) mesh of ranks 0 and 1, as `largest_mesh_shape` says; the
    reference builds the same grid of the first devices."""
    mesh_lib.ensure_process_group("cpu")
    m = elastic.remesh([0], 1, device_type="cpu")
    assert tuple(m.shape) == (1, 1) and m.mesh.tolist() == [[0]]
    assert m.mesh_dim_names == ("data", "model")
    assert elastic.largest_mesh_shape(3, 2) == (1, 2)


def test_restore_places_each_leaf_by_its_placements(reference, tmp_path):
    """`CheckpointManager.restore(mesh=, placements=)` (the reference's
    ``shardings``) gives DTensors of the state's placements on a (1, 1)
    gloo mesh, holding the checkpoint's values."""
    from torch.distributed.tensor import DTensor
    cfg = reference["cfg"]
    p = tree_lib.map_structure(lambda t: t.clone(), reference["params"])
    state = {"params": p, "opt": adamw.init_state(p, OPT)}
    ckpt = CheckpointManager(tmp_path / "ck")
    ckpt.save(3, state, blocking=True)
    mesh = mesh_lib.make_host_mesh(1, 1, device_type="cpu")
    like, placements = specs.state_shardings(cfg, OPT, mesh,
                                             specs.rules_for(mesh))
    got, meta = ckpt.restore(None, like, mesh=mesh, placements=placements)
    assert meta["step"] == 3
    for a, b, pl in zip(tree_lib.leaves(got), tree_lib.leaves(state),
                        tree_lib.leaves(placements)):
        assert isinstance(a, DTensor) and tuple(a.placements) == tuple(pl)
        assert torch.equal(a.to_local(), b)


def test_torchrun_trainer_on_2_ranks_equals_one_rank(tmp_path, capsys):
    """`launch.train.main` on 2 ranks of one group (as `torchrun
    --nproc-per-node 2 -m repro_torch.launch.train` runs it) and on one:
    rank 0 prints the same step count, checkpoint and first loss (to the
    printed 4 decimals), and a last loss within 1e-3 of one rank's (the
    two sum each gradient in another order, and six bf16 steps carry the
    difference); the other rank prints nothing; the resume of the 2-rank
    run's checkpoint says so on rank 0 and continues it."""
    from repro_torch.launch import train
    base = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
            "--ckpt-every", "3"]
    res = _torch_ranks.spawn("train_cli", 2, tmp_path, {
        "argv": base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "two")],
        "more": ["--steps", "8"]})
    assert train.main(base + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "one")]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    first, resumed = res[0]
    assert first["rc"] == resumed["rc"] == 0
    two = json.loads(first["lines"][-1])
    for k in ("steps", "first_loss", "final_ckpt"):
        assert two[k] == one[k], k
    assert abs(two["last_loss"] - one["last_loss"]) <= 1e-3 * one["last_loss"]
    assert resumed["lines"][0] == "resumed from step 6"
    assert json.loads(resumed["lines"][-1])["final_ckpt"] == 8
    assert res[1][0]["lines"] == [] and res[1][1]["lines"] == []

