"""`repro_torch.models.moe` against the JAX `repro.models.moe`, with the
JAX parameters converted leaf by leaf and inputs drawn from numpy with a
seed.

Routing and dispatch are integers and compared with ``==`` (the expert
of each choice, the dispatch slots and the kept mask, bit for bit); the
outputs and the aux loss are f32 and differ in summation order only:
1e-5.  The last test documents a fault of the reference that the port
reproduces on purpose (ROADMAP queue C): the expert capacity counts every
row of the forward, so a slot's output in the one-slot prefill depends
on what the padded rows of the other slots hold.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.convert import disable_tf32, params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

TOL = 1e-5
# the (E, k) grid of tests/test_moe.py
GRID = [(4, 1), (8, 2), (16, 4)]


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _cfgs(e=8, k=2, cf=16.0):
    base = dict(name="t", family="moe", num_layers=1, d_model=32, d_ff=64,
                vocab_size=64, num_heads=4, num_kv_heads=2, num_experts=e,
                top_k=k, moe_d_ff=16, capacity_factor=cf)
    return JConfig(**base), TConfig(**base)


def _layer(e, k, cf=16.0, t=64, seed=1):
    jcfg, tcfg = _cfgs(e, k, cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).standard_normal(
        (t, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("e,k", GRID)
def test_route_equals_the_reference(e, k):
    jcfg, tcfg, jp, tp, x = _layer(e, k)
    ij, wj, aj = jmoe.route(jp, jnp.asarray(x), jcfg)
    it, wt, at = tmoe.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), _np(wj), rtol=0, atol=TOL)
    np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, rtol=0, atol=TOL)
    assert abs(float(at) - float(aj)) < TOL


def test_route_breaks_ties_by_the_lower_expert():
    """Experts with equal router columns have equal probabilities: both
    the port and `jax.lax.top_k` take the lower expert first."""
    jcfg, tcfg, jp, tp, x = _layer(8, 2)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    ij, _, _ = jmoe.route(jp, jnp.asarray(x), jcfg)
    it, _, _ = tmoe.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    ties = (np.asarray(ij)[:, 0] == 2)
    assert ties.any() and (np.asarray(ij)[ties, 1] == 5).all()


@pytest.mark.parametrize("e,k", GRID)
def test_apply_dense_equals_the_reference(e, k):
    jcfg, tcfg, jp, tp, x = _layer(e, k)
    oj, aj = jmoe.apply_dense(jp, jnp.asarray(x), jcfg)
    ot, at = tmoe.apply_dense(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ot.numpy(), _np(oj), rtol=0, atol=TOL)
    assert abs(float(at) - float(aj)) < TOL


@pytest.mark.parametrize("n,groups,capacity", [
    (64, 4, 8), (128, 8, 16), (40, 16, 8), (7, 3, 1), (256, 128, 8)])
def test_dispatch_indices_are_bit_equal(n, groups, capacity):
    flat_e = np.random.default_rng(n).integers(0, groups, n).astype(np.int32)
    sj, kj = jmoe._dispatch_indices(jnp.asarray(flat_e), groups, capacity)
    st, kt = tmoe._dispatch_indices(torch.from_numpy(flat_e).long(), groups,
                                    capacity)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    vals = np.arange(n, dtype=np.int32)
    bj = jmoe._scatter_slots(jnp.asarray(vals), sj, kj, groups * capacity, n)
    bt = tmoe._scatter_slots(torch.from_numpy(vals), st, kt,
                             groups * capacity, n)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("cf", [16.0, 1.0, 0.5], ids=["no_drops", "cf1",
                                                      "cf0.5"])
@pytest.mark.parametrize("e,k", GRID)
def test_apply_grouped_with_drops_equals_the_reference(e, k, cf):
    """With a capacity factor of 1 or below, experts overflow and items
    are dropped: the same items as the reference's, so the same
    outputs."""
    jcfg, tcfg, jp, tp, x = _layer(e, k, cf, t=96, seed=e)
    oj, aj = jmoe.apply_grouped(jp, jnp.asarray(x), jcfg)
    ot, at = tmoe.apply_grouped(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ot.numpy(), _np(oj), rtol=0, atol=TOL)
    assert abs(float(at) - float(aj)) < TOL
    if cf == 16.0:
        od, _ = tmoe.apply_dense(tp, torch.from_numpy(x), tcfg)
        torch.testing.assert_close(ot, od, rtol=0, atol=TOL)
    else:
        from repro_torch.core.loadbalance import expert_capacity
        idx, _, _ = tmoe.route(tp, torch.from_numpy(x), tcfg)
        cap = expert_capacity(96, e, k, cf)
        assert int(torch.bincount(idx.reshape(-1), minlength=e).max()) > cap


def test_apply_sharded_is_grouped_over_the_rows():
    jcfg, tcfg, jp, tp, x = _layer(8, 2, 1.25, t=48)
    x3 = x.reshape(3, 16, -1)
    oj, aj = jmoe.apply_sharded(jp, jnp.asarray(x3), jcfg)
    ot, at = tmoe.apply_sharded(tp, torch.from_numpy(x3), tcfg)
    assert ot.shape == (3, 16, jcfg.d_model)
    np.testing.assert_allclose(ot.numpy(), _np(oj), rtol=0, atol=TOL)
    assert abs(float(at) - float(aj)) < TOL


@pytest.mark.parametrize("k", [2, 8])
def test_combine_adds_in_ascending_k_like_the_scatter_add(k):
    """The bf16 combine: a token's k contributions added one after
    another, as the reference's scatter-add adds them on the CPU, bit for
    bit; a one-shot f32 sum rounds differently."""
    t, d = 64, 48
    rng = np.random.default_rng(k)
    contrib = rng.standard_normal((t * k, d)).astype(np.float32)
    cj = jnp.asarray(contrib, jnp.bfloat16)
    flat_t = jnp.repeat(jnp.arange(t, dtype=jnp.int32), k)
    want = jnp.zeros((t, d), jnp.bfloat16).at[flat_t].add(cj)
    ct = torch.from_numpy(contrib).bfloat16()
    got = tmoe._combine(ct, t, k)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    if k == 8:
        one_shot = ct.reshape(t, k, d).float().sum(1).bfloat16()
        assert not torch.equal(one_shot, got)


def test_capacity_counts_padded_rows_like_the_reference():
    """A fault of the reference, reproduced: the one-slot prefill of the
    server runs every slot's row, and the capacity of `apply_grouped`
    counts them all, so what the idle rows hold changes which of the
    active slot's items an expert drops, and with it the slot's logits.
    Both packages give the same logits for each filling; the two fillings
    give different ones (ROADMAP queue C)."""
    arch = "phi3_5_moe_42b"
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jtf.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, 16).astype(np.int32)
    active = np.array([False, False, False, True])    # last in row order
    outs = []
    for pad in (np.zeros((4, 16), np.int32),
                rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)):
        toks = pad.copy()
        toks[3] = prompt
        jc = jtf.cache_init(jcfg, 4, 20, dtype=jnp.float32)
        tc = ttf.cache_init(tcfg, 4, 20, dtype=torch.float32, device="cpu")
        lj, _, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               cache=jc, compute_dtype=jnp.float32,
                               active=jnp.asarray(active))
        lt, _ = ttf.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            cache=tc, compute_dtype=torch.float32,
                            active=torch.from_numpy(active))
        np.testing.assert_allclose(lt[3].numpy(), _np(lj[3]), rtol=0,
                                   atol=1e-4)
        outs.append(_np(lj[3]))
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def test_the_reference_cli_rules_take_a_two_stage_capacity():
    """A difference inside the reference, logged in ROADMAP queue C: the
    JAX serve CLI runs under sharding rules on a one-device mesh, so its
    `apply_sharded` takes the `all_to_all` path with one model shard,
    whose two capacities (send, then per expert) compound the capacity
    factor; without the rules (the JAX `Server` as the tests drive it) it
    is `apply_grouped`.  Where experts overflow the two drop different
    items.  The port has no mesh and is `apply_grouped` (ROADMAP A14)."""
    from repro.launch import specs
    from repro.launch.mesh import make_host_mesh, set_mesh
    from repro.parallel import sharding as shd
    jcfg, tcfg, jp, tp, x = _layer(4, 2, 1.25, t=64)
    x3 = x.reshape(4, 16, -1)
    x3[:3] = x3[0, 0]                   # 48 copies of one token: overflow
    mesh = make_host_mesh(data=1, model=1)
    with set_mesh(mesh), shd.use_rules(specs.rules_for(mesh)):
        cli, _ = jax.jit(lambda p, v: jmoe.apply_sharded(p, v, jcfg))(
            jp, jnp.asarray(x3))
    plain, _ = jmoe.apply_sharded(jp, jnp.asarray(x3), jcfg)
    mine, _ = tmoe.apply_sharded(tp, torch.from_numpy(x3), tcfg)
    np.testing.assert_allclose(mine.numpy(), _np(plain), rtol=0, atol=TOL)
    assert np.abs(_np(cli) - _np(plain)).max() > 1e-4
