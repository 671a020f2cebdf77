"""The train and eval steps of the port against the JAX package's, for
every arch's SMOKE config: the loss and every gradient of one f32 step
against `jax.value_and_grad` of the same loss (the fused chunked cross
entropy of `forward(..., return_hidden=True)` plus `AUX_WEIGHT` times the
MoE aux), with and without ``remat="full"``; `make_train_step` in bf16
against the reference's jitted step; `make_eval_step`'s metrics; the
loss falling on synthetic data (tests/test_train_loop.py); and the train
step never reaching the flash kernel, which has no backward.

JAX parameters are converted leaf by leaf (`convert.params_from_numpy`);
batches come from the ported `SyntheticSource` (bit-equal to the
reference's).  Tolerances: the f32 loss within 1e-5 relative; every
gradient within 1e-5 of the step's largest |gradient|, and of its own
leaf's largest |gradient| except where the reference's own f32 step rounds
to bf16 (Jamba's Mamba B, C and x streams, `repro/models/ssm.py:117-119`,
whose gradients are bf16-rounded on both sides and so differ in a last
bf16 bit now and then); the bf16 step's loss within the bf16 logit bound
of ROADMAP queue C (3e-2), its grad norm within 2^-6 relative and the
parameters within 2 x lr a step (an AdamW step moves a parameter by at
most about lr, so a gradient whose sign differs under bf16 moves it 2 x lr
apart), summed over the steps taken.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.loss import fused_cross_entropy as jfce  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import (disable_tf32, params_from_numpy,  # noqa: E402
                                 to_numpy)
from repro_torch.data import DataConfig, SyntheticSource  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

ARCHS = jconfigs.list_archs()
LOSS_REL = 1e-5
GRAD_REL = 1e-5
BF16_REL = 3e-2
GNORM_REL = 2.0 ** -6
# Leaves whose gradient passes the reference's bf16 casts inside its f32
# step (Mamba's x_proj feeds the bf16 B and C streams).
BF16_ROUNDED = ("['x_proj']",)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several processes at once,
    and more threads than cores slow every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _configs(arch, remat):
    return (dataclasses.replace(jconfigs.get_smoke(arch), remat=remat),
            dataclasses.replace(tconfigs.get_smoke(arch), remat=remat))


def _batch(cfg, b=2, s=16, step=0):
    d = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                   seed=1, frontend=cfg.frontend,
                   frontend_dim=cfg.frontend_dim,
                   num_patches=4 if cfg.frontend == "patch" else 0)
    return SyntheticSource(d).batch(step, 0, 1)


def _jax_loss_and_grads(jcfg, jp, batch):
    inputs = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}

    def loss_fn(p):
        h, _, aux = jtf.forward(jcfg, p, inputs, compute_dtype=jnp.float32,
                                return_hidden=True)
        head = p["embed" if jcfg.tie_embeddings else "head"]["table"]
        loss, _ = jfce(h, head, jnp.asarray(batch["labels"]),
                       chunk=jcfg.loss_chunk)
        return loss + jsteps.AUX_WEIGHT * aux

    return jax.value_and_grad(loss_fn)(jp)


def _port_loss_and_grads(tcfg, tp, batch):
    total, _, _, grads = tsteps.loss_and_grads(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        compute_dtype=torch.float32)
    keys, leaves = tree_lib.flatten_with_paths(grads)
    return float(total), keys, leaves


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_f32_step_loss_and_grads_equal_jax_value_and_grad(arch, remat):
    jcfg, tcfg = _configs(arch, remat)
    jp = jtf.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = _batch(jcfg)
    jl, jg = _jax_loss_and_grads(jcfg, jp, batch)
    tl, keys, tg = _port_loss_and_grads(tcfg, tp, batch)
    assert abs(tl - float(jl)) <= LOSS_REL * abs(float(jl))
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert keys == ["/".join(str(k) for k in path) for path, _ in jflat]
    ref = [np.asarray(g) for _, g in jflat]
    step_max = max(np.abs(g).max() for g in ref)
    for key, r, g in zip(keys, ref, tg):
        g = g.numpy()
        assert g.shape == r.shape, key
        err = np.abs(g - r).max()
        assert err <= GRAD_REL * step_max, (key, err, step_max)
        if not key.endswith(BF16_ROUNDED):
            assert err <= GRAD_REL * np.abs(r).max(), (key, err)


@pytest.mark.parametrize("arch", ["qwen3_14b", "phi3_5_moe_42b"])
def test_bf16_train_step_equals_the_reference_jitted_step(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jp = jtf.init(jcfg, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jadamw.init_state(
        jp, jadamw.AdamWConfig(**opt))}
    tstate = {"params": params_from_numpy(jax.tree.map(np.asarray, jp))}
    tstate["opt"] = tadamw.init_state(tstate["params"],
                                      tadamw.AdamWConfig(**opt))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    tstep = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**opt))
    lr_sum = 0.0
    for t in range(2):
        batch = _batch(jcfg, step=t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert set(tm) == set(jm)
        lr = float(jm["lr"])
        lr_sum += lr
        assert float(tm["lr"]) == pytest.approx(lr, rel=1e-6)
        for k in ("loss", "total_loss"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                BF16_REL * abs(float(jm[k])), k
        assert float(tm["tokens"]) == float(jm["tokens"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            GNORM_REL * float(jm["grad_norm"])
        for a, b in zip(jax.tree.leaves(jstate["params"]),
                        tree_lib.leaves(to_numpy(tstate["params"]))):
            assert np.abs(np.asarray(a) - b).max() <= 2 * lr_sum
        assert int(tstate["opt"]["step"]) == t + 1


@pytest.mark.parametrize("arch", ["qwen3_14b", "hubert_xlarge",
                                  "phi3_5_moe_42b"])
def test_eval_step_metrics_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jtf.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = _batch(jcfg)
    ref = jsteps.make_eval_step(jcfg)(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    ours = tsteps.make_eval_step(tcfg)(tp, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    assert set(ours) == set(ref) == {"loss", "tokens", "accuracy_proxy"}
    assert float(ours["tokens"]) == float(ref["tokens"])
    assert abs(float(ours["loss"]) - float(ref["loss"])) <= \
        BF16_REL * float(ref["loss"])
    assert 0.0 <= float(ours["accuracy_proxy"]) <= 1.0


def test_return_hidden_is_the_forward_before_the_unembedding():
    tcfg = tconfigs.get_smoke("qwen3_14b")
    tp = ttf.init(tcfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_batch(tcfg)["tokens"])
    h, _ = ttf.forward(tcfg, tp, {"tokens": tokens},
                       compute_dtype=torch.float32, return_hidden=True)
    logits, _ = ttf.forward(tcfg, tp, {"tokens": tokens},
                            compute_dtype=torch.float32)
    assert h.shape == (*tokens.shape, tcfg.d_model)
    assert torch.equal(h @ tp["head"]["table"].T, logits)


@pytest.mark.parametrize("arch", ["qwen3_14b", "jamba_1_5_large_398b"])
def test_remat_recomputes_each_layer_and_changes_no_bit(arch, monkeypatch):
    """Under ``remat="full"`` each layer (a hybrid's each sub-layer) runs
    once more in the backward, and the loss and gradients are the same
    bits as without."""
    out = {}
    for remat in ("none", "full"):
        _, tcfg = _configs(arch, remat)
        tp = ttf.init(tcfg, torch.Generator().manual_seed(0))
        calls = []
        orig = ttf._layer_apply

        def counting(*a, orig=orig, calls=calls):
            calls.append(1)
            return orig(*a)

        monkeypatch.setattr(ttf, "_layer_apply", counting)
        out[remat] = (_port_loss_and_grads(tcfg, tp, _batch(tcfg)),
                      len(calls))
        monkeypatch.setattr(ttf, "_layer_apply", orig)
    (l0, _, g0), n0 = out["none"]
    (l1, _, g1), n1 = out["full"]
    assert n0 == tconfigs.get_smoke(arch).num_layers and n1 == 2 * n0
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_train_step_never_reaches_the_flash_kernel(monkeypatch):
    """The flash kernel (B5) has no backward: training attends through
    `attention_core` and never calls the flash entry."""
    from repro_torch.kernels.attention import ops

    def refuse(*a, **k):
        raise AssertionError("the train step reached the flash kernel")

    monkeypatch.setattr(ops, "mha_attention", refuse)
    for arch in ("qwen3_14b", "h2o_danube_1_8b", "internvl2_2b"):
        tcfg = tconfigs.get_smoke(arch)
        opt = tadamw.AdamWConfig()
        tp = ttf.init(tcfg, torch.Generator().manual_seed(0))
        state = {"params": tp, "opt": tadamw.init_state(tp, opt)}
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        _, m = tsteps.make_train_step(tcfg, opt)(state, batch)
        assert np.isfinite(float(m["loss"]))


def _learn(arch, steps, lr):
    tcfg = tconfigs.get_smoke(arch)
    opt = tadamw.AdamWConfig(peak_lr=lr, warmup_steps=5, total_steps=steps)
    tp = ttf.init(tcfg, torch.Generator().manual_seed(0))
    state = {"params": tp, "opt": tadamw.init_state(tp, opt)}
    src = SyntheticSource(DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                     global_batch=8, seed=1))
    step = tsteps.make_train_step(tcfg, opt)
    losses = []
    for t in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in src.batch(t, 0, 1).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_loss_decreases_on_synthetic_lm():
    losses = _learn("qwen3_14b", 60, 5e-3)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "rwkv6_7b"])
def test_other_families_learn(arch):
    losses = _learn(arch, 30, 3e-3)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
