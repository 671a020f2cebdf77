"""The training slice's building blocks in the port against the JAX
package: AdamW (`optim.adamw`: the schedule at its warmup and decay
edges, clipping, the f32 and int8 updates over several steps, the
blockwise quantize round trip, the global norm's flatten order),
`launch.policy`, the losses (`parallel.loss`: values and gradients
against `jax.value_and_grad`, chunked and unchunked, with IGNORE labels),
the data pipeline (`data.pipeline`: batches bit-equal, frontends and the
memmap source) and the optimizer-state converter (`convert`).

Tolerances: AdamW parameters and moments within 1e-6 (the global norm and
the transcendental functions of the schedule may differ in their last
bit; everything else is the same f32 operations in the same order);
losses in f32 within 1e-6 relative, gradients within 1e-5 of their
largest magnitude; batches bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import policy as jpolicy  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import loss as jloss  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import opt_state_from_numpy, to_numpy  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import policy as tpolicy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import loss as tloss  # noqa: E402

ADAM_TOL = 1e-6
GRAD_REL = 1e-5

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several processes at once,
    and more threads than cores slow every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# Leaves of several shapes: a last dim below, at and past one 128-block.
SHAPES = {"b": {"z": (3, 130), "a": (7,)}, "w": (2, 5, 128), "e": (1, 256)}


def _tree(shapes, rng, scale=1.0):
    return {k: (_tree(v, rng, scale) if isinstance(v, dict)
                else (rng.standard_normal(v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _assert_trees_close(jtree, ttree, tol, what):
    jl = jax.tree.leaves(jtree)
    tl = tree_lib.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=0, atol=tol,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup, total", [(100, 1000), (0, 10), (5, 5),
                                           (3, 8)])
def test_schedule_equals_the_reference(warmup, total):
    jcfg = jadamw.AdamWConfig(peak_lr=3e-4, warmup_steps=warmup,
                              total_steps=total, min_lr_frac=0.1)
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(jcfg))
    edges = sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1,
                    (warmup + total) // 2, total - 1, total, total + 1,
                    2 * total + 7})
    for t in edges:
        ours = tadamw.schedule(tcfg, torch.tensor(t, dtype=torch.int32))
        ref = jadamw.schedule(jcfg, jnp.asarray(t, jnp.int32))
        assert ours.dtype == torch.float32
        assert abs(float(ours) - float(ref)) <= 1e-7 * 3e-4 * 10, t


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_update_equals_the_reference_over_several_steps(moment_dtype, clip):
    """Ten steps over a random tree, gradients alternately below and
    above the clip norm; the schedule crosses warmup and decay."""
    rng = np.random.default_rng(0)
    cfg = dict(peak_lr=1e-2, warmup_steps=3, total_steps=8,
               moment_dtype=moment_dtype, clip_norm=clip, weight_decay=0.1)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    p = _tree(SHAPES, rng)
    jp = jax.tree.map(jnp.asarray, p)
    js = jadamw.init_state(jp, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    ts = tadamw.init_state(tp, tcfg)
    _assert_trees_close(js, ts, 0, "init_state")
    for i in range(10):
        g = _tree(SHAPES, rng, 3.0 if i % 2 else 0.1)
        jp, js, jm = jadamw.update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp2, ts2, tm = tadamw.update(
            tp, jax.tree.map(torch.from_numpy, g), ts, tcfg)
        assert tp2 is tp and ts2 is ts          # in place
        _assert_trees_close(jp, tp, ADAM_TOL, f"params, step {i}")
        _assert_trees_close(js, ts, ADAM_TOL, f"opt state, step {i}")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


def test_grad_clip_applied_and_norm_reported_before_it():
    cfg = tadamw.AdamWConfig(peak_lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(10)}
    state = tadamw.init_state(params, cfg)
    _, _, metrics = tadamw.update(params, {"w": torch.full((10,), 1e6)},
                                  state, cfg)
    assert float(metrics["grad_norm"]) > 1e6


def test_global_norm_sums_in_jax_flatten_order():
    """The leaves are summed in sorted-key order whatever the dict's
    insertion order: the port's norm of a tree built in another order is
    the same bits, and equals the reference's sum of the same per-leaf
    square sums."""
    rng = np.random.default_rng(3)
    vals = {k: rng.standard_normal(1000).astype(np.float32) * 10 ** i
            for i, k in enumerate("dcba")}
    a = {k: torch.from_numpy(v) for k, v in vals.items()}
    b = {k: a[k] for k in sorted(a)}
    assert list(a) != list(b)
    assert torch.equal(tadamw.global_norm(a), tadamw.global_norm(b))
    assert [int(x.shape[0]) for x in tree_lib.leaves(a)] == [1000] * 4
    assert tree_lib.leaves(a)[0] is a["a"]
    sums = np.array([np.float32((vals[k].astype(np.float64) ** 2).sum())
                     for k in sorted(vals)], np.float32)
    ref = jadamw.global_norm(jax.tree.map(jnp.asarray, vals))
    np.testing.assert_allclose(float(tadamw.global_norm(a)), float(ref),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ref), np.sqrt(sums.sum()), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (3, 130), (2, 5, 128), (1, 256),
                                   (4, 300)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_blockwise_equals_the_reference(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10).astype(np.float32)
    x.flat[0] = 0.0
    ours = tadamw.quantize_blockwise(torch.from_numpy(x))
    ref = jadamw.quantize_blockwise(jnp.asarray(x))
    np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(ours["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    back = tadamw.dequantize_blockwise(ours, shape[-1])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jadamw.dequantize_blockwise(ref, shape[-1])))
    assert back.shape == x.shape
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        np.abs(x).max() / 127 + 1e-6


def test_zero_blocks_quantize_to_zero_with_the_floor_divisor():
    z = tadamw.quantize_blockwise(torch.zeros(3, 200))
    assert z["q"].shape == (3, 256) and z["scale"].shape == (3, 2)
    assert not z["q"].any() and not z["scale"].any()


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_converges(moment_dtype):
    cfg = tadamw.AdamWConfig(peak_lr=5e-2, warmup_steps=10, total_steps=300,
                             weight_decay=0.0, moment_dtype=moment_dtype)
    params = {"x": torch.zeros(4), "y": torch.zeros(4)}
    state = tadamw.init_state(params, cfg)
    first = loss = None
    for _ in range(300):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = (torch.sum((1 - live["x"]) ** 2)
                + 5 * torch.sum((live["y"] - live["x"] ** 2) ** 2))
        gx, gy = torch.autograd.grad(loss, [live["x"], live["y"]])
        tadamw.update(params, {"x": gx, "y": gy}, state, cfg)
        first = float(loss.detach()) if first is None else first
    assert float(loss.detach()) < first * 0.01


@pytest.mark.parametrize("arch", jconfigs.list_archs())
@pytest.mark.parametrize("smoke", [False, True])
def test_policy_equals_the_reference(arch, smoke):
    get = "get_smoke" if smoke else "get"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert tpolicy.moment_dtype(tcfg) == jpolicy.moment_dtype(jcfg)
    assert tpolicy.use_fsdp(tcfg) == jpolicy.use_fsdp(jcfg)
    assert str(tpolicy.param_dtype(tcfg)).split(".")[-1] == \
        jnp.dtype(jpolicy.param_dtype(jcfg)).name


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_case(b=2, s=24, d=16, v=37, masked=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    if masked:
        labels[:, :5] = tloss.IGNORE
        labels[1, 7] = tloss.IGNORE
    return x, table, labels


def _grads(fn, x, table):
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    loss = fn(xt, tt)
    gx, gt = torch.autograd.grad(loss, [xt, tt])
    return float(loss), gx.numpy(), gt.numpy()


def _close_grad(ours, ref):
    ref = np.asarray(ref)
    assert np.abs(ours - ref).max() <= GRAD_REL * np.abs(ref).max()


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_its_grads_equal_the_reference(masked):
    x, table, labels = _loss_case(masked=masked)
    lt = torch.from_numpy(labels)
    loss, gx, gt = _grads(lambda a, t: tloss.cross_entropy(a @ t.T, lt)[0],
                          x, table)
    jl, (jgx, jgt) = jax.value_and_grad(
        lambda a, t: jloss.cross_entropy(a @ t.T, jnp.asarray(labels))[0],
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-6)
    _close_grad(gx, jgx)
    _close_grad(gt, jgt)
    _, ours = tloss.cross_entropy(torch.from_numpy(x @ table.T), lt)
    _, ref = jloss.cross_entropy(jnp.asarray(x @ table.T),
                                 jnp.asarray(labels))
    assert set(ours) == set(ref) == {"loss", "tokens", "accuracy_proxy"}
    for k in ours:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6)


@pytest.mark.parametrize("chunk", [0, 8, 16, 48, 1000])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_cross_entropy_and_its_grads_equal_the_reference(chunk,
                                                               masked):
    x, table, labels = _loss_case(masked=masked)
    lt = torch.from_numpy(labels)
    loss, gx, gt = _grads(
        lambda a, t: tloss.fused_cross_entropy(a, t, lt, chunk=chunk)[0],
        x, table)
    jl, (jgx, jgt) = jax.value_and_grad(
        lambda a, t: jloss.fused_cross_entropy(a, t, jnp.asarray(labels),
                                               chunk=chunk)[0],
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-6)
    _close_grad(gx, jgx)
    _close_grad(gt, jgt)
    _, m = tloss.fused_cross_entropy(torch.from_numpy(x),
                                     torch.from_numpy(table), lt, chunk=chunk)
    assert float(m["tokens"]) == float((labels != tloss.IGNORE).sum())


def test_fused_cross_entropy_of_bf16_hidden_states():
    """The logits are the bf16 product cast to f32, as the reference's.
    The two products round their logits to bf16 separately (the CPU
    backends accumulate differently), so the bound is bf16's: 2^-8 of
    the loss."""
    x, table, labels = _loss_case()
    xb = torch.from_numpy(x).bfloat16()
    ours, _ = tloss.fused_cross_entropy(xb, torch.from_numpy(table),
                                        torch.from_numpy(labels), chunk=16)
    ref, _ = jloss.fused_cross_entropy(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(labels), chunk=16)
    np.testing.assert_allclose(float(ours), float(ref), rtol=2.0 ** -8)


def test_fused_cross_entropy_recomputes_each_chunk_in_the_backward():
    """Under autograd each chunk's logits are not kept: the chunk runs
    again in the backward (torch.utils.checkpoint)."""
    x, table, labels = _loss_case()
    calls = []
    orig = tloss._chunk_stats

    def counting(*a):
        calls.append(1)
        return orig(*a)

    tloss._chunk_stats = counting
    try:
        xt = torch.from_numpy(x).requires_grad_()
        loss, _ = tloss.fused_cross_entropy(xt, torch.from_numpy(table),
                                            torch.from_numpy(labels),
                                            chunk=16)
        assert len(calls) == 3
        loss.backward()
        assert len(calls) == 6
    finally:
        tloss._chunk_stats = orig


def test_all_masked_is_finite_and_uniform_logits_give_log_v():
    x, table, labels = _loss_case()
    loss, m = tloss.fused_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(table),
        torch.full(labels.shape, tloss.IGNORE), chunk=8)
    assert np.isfinite(float(loss)) and float(m["tokens"]) == 0
    loss, _ = tloss.fused_cross_entropy(torch.zeros(1, 10, 8),
                                        torch.zeros(64, 8),
                                        torch.zeros(1, 10, dtype=torch.int32),
                                        chunk=4)
    assert float(loss) == pytest.approx(np.log(64), rel=1e-6)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

DATA_CASES = [dict(), dict(frontend="frame", frontend_dim=12),
              dict(frontend="patch", frontend_dim=12, num_patches=4),
              dict(vocab_size=32000, seq_len=64, global_batch=16, seed=3)]


@pytest.mark.parametrize("kw", DATA_CASES,
                         ids=["tokens", "frames", "patches", "wide"])
@pytest.mark.parametrize("step, shard, shards", [(0, 0, 1), (5, 1, 4),
                                                 (9999, 3, 8)])
def test_synthetic_batches_are_bit_equal(kw, step, shard, shards):
    base = dict(vocab_size=101, seq_len=16, global_batch=8, seed=7)
    base.update(kw)
    ours = tdata.SyntheticSource(tdata.DataConfig(**base)).batch(
        step, shard, shards)
    ref = jdata.SyntheticSource(jdata.DataConfig(**base)).batch(
        step, shard, shards)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_memmap_batches_are_bit_equal_and_make_source_picks_it(tmp_path):
    f = tmp_path / "tokens.bin"
    (np.random.default_rng(0).integers(0, 97, 10_000)
     .astype(np.int32).tofile(f))
    base = dict(vocab_size=97, seq_len=16, global_batch=8, seed=7,
                kind="memmap", path=str(f))
    ours = tdata.make_source(tdata.DataConfig(**base))
    ref = jdata.make_source(jdata.DataConfig(**base))
    assert isinstance(ours, tdata.MemmapSource)
    for step in (0, 2, 17):
        a, b = ours.batch(step, 0, 1), ref.batch(step, 0, 1)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert isinstance(tdata.make_source(tdata.DataConfig(
        vocab_size=5, seq_len=4, global_batch=2)), tdata.SyntheticSource)


def test_prefetcher_orders_steps():
    src = tdata.SyntheticSource(tdata.DataConfig(vocab_size=101, seq_len=16,
                                                 global_batch=8))
    pf = tdata.Prefetcher(src, start_step=10, shard=0, num_shards=1, depth=2)
    try:
        it = iter(pf)
        (s0, b0), (s1, _) = next(it), next(it)
        assert (s0, s1) == (10, 11)
        np.testing.assert_array_equal(b0["tokens"],
                                      src.batch(10, 0, 1)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# Optimizer state across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_both_packages_start_from_one_optimizer_state(moment_dtype):
    """A JAX AdamW state after two steps converts to the port's and back
    bit for bit, and one more step from it gives both packages the same
    parameters (1e-6)."""
    rng = np.random.default_rng(5)
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, _tree(SHAPES, rng))
    js = jadamw.init_state(jp, jcfg)
    for _ in range(2):
        g = jax.tree.map(jnp.asarray, _tree(SHAPES, rng))
        jp, js, _ = jadamw.update(jp, g, js, jcfg)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js))
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    back = to_numpy(ts)
    for a, b in zip(jax.tree.leaves(js), tree_lib.leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    g = _tree(SHAPES, rng)
    jp, js, _ = jadamw.update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
    tadamw.update(tp, jax.tree.map(torch.from_numpy, g), ts, tcfg)
    _assert_trees_close(jp, tp, ADAM_TOL, "params")
    _assert_trees_close(js, ts, ADAM_TOL, "opt state")
    with pytest.raises(ValueError, match="AdamW"):
        opt_state_from_numpy({"m": {}, "v": {}})
