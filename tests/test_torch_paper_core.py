"""The paper's laws in the port against the JAX package: eq. 2 and its
traffic volumes (`core/tiling.py`), the two machine models
(`core/cost_model.py`, with the reference's chip numbers passed in), the
row-balancing law (`core/loadbalance.py`) and the DSE machinery
(`core/dse.py`), all equal, most bit for bit.  The Hopper solver
(`solve_hopper`) has no JAX twin and is held to its properties."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcost  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import loadbalance as jlb  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402

from repro_torch.core import cost_model, dse, hardware, loadbalance, tiling  # noqa: E402

# The reference's chip in the port's terms: one rate for every operand
# width, as the TPU model has.
TPU_AS_CHIP = hardware.Chip(
    variant="TPU v5e (the JAX package's numbers)",
    peak_flops=TPU_V5E.peak_flops, peak_flops_f32=TPU_V5E.peak_flops,
    hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
    smem_bytes=TPU_V5E.usable_vmem())

LS = [5, 64, 100, 1000, 4096, 16384, 65536]
PS = [1, 2, 4, 16]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("L", LS)
def test_solve_paper_and_brute_force_equal_the_reference(L, p):
    assert tiling.solve_paper(L, p) == tiling.Tile(
        *dataclass_tuple(jtiling.solve_paper(L, p)))
    assert tiling.brute_force_paper(L, p, n=1024) == tiling.Tile(
        *dataclass_tuple(jtiling.brute_force_paper(L, p, n=1024)))


def dataclass_tuple(t):
    return (t.y, t.x, t.z)


@pytest.mark.parametrize("m, n, k", [(4096, 4096, 4096), (1, 128, 256),
                                     (130, 70, 50), (8192, 2048, 8192)])
@pytest.mark.parametrize("p", [1, 4])
def test_comm_volumes_equal_the_reference(m, n, k, p):
    for y, x, z in [(1, 1, 1), (64, 32, 16), (128, 256, 64), (300, 17, 3)]:
        assert tiling.comm_volume(n, tiling.Tile(y, x, z), p) == \
            jtiling.comm_volume(n, jtiling.Tile(y, x, z), p)
        assert tiling.comm_volume_rect(m, n, k, tiling.Tile(y, x, z), p) == \
            jtiling.comm_volume_rect(m, n, k, jtiling.Tile(y, x, z), p)
        assert tiling.Tile(y, x, z).vmem_elems() == \
            jtiling.Tile(y, x, z).vmem_elems()
    assert tiling.comm_volume(n, tiling.Tile(0, 4, 1)) == math.inf


def _rel_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key] == pytest.approx(b[key], rel=1e-12), key


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("m, n, k", [(4096, 4096, 4096), (1, 128, 256),
                                     (16384, 16384, 16384)])
def test_matmul_time_model_equals_the_reference(m, n, k, dtype_bytes):
    for y, x, z in [(128, 128, 128), (64, 256, 32), (512, 1024, 256)]:
        _rel_equal(
            cost_model.matmul_time_model(m, n, k, tiling.Tile(y, x, z),
                                         chip=TPU_AS_CHIP,
                                         dtype_bytes=dtype_bytes),
            jcost.matmul_time_model(m, n, k, jtiling.Tile(y, x, z),
                                    dtype_bytes=dtype_bytes))


@pytest.mark.parametrize("block_cols", [None, 256, 4096])
@pytest.mark.parametrize("waste", [None, 1.0, 2.37])
def test_spmv_time_model_equals_the_reference(waste, block_cols):
    for rows, width, n, nnz, br in [(560, 256, 300, 4357, 8),
                                    (1 << 20, 128, 1 << 20, 50_000_000, 64),
                                    (91, 896, 128, 72_072, 16)]:
        _rel_equal(
            cost_model.spmv_time_model(rows, width, n, nnz, br, block_cols,
                                       waste=waste, chip=TPU_AS_CHIP),
            jcost.spmv_time_model(rows, width, n, nnz, br, block_cols,
                                  waste=waste))


def _weights(seed, rows, dist):
    rng = np.random.default_rng(seed)
    if dist == "poisson":
        return rng.poisson(20, rows) + 1
    if dist == "uniform":
        return rng.integers(1, 100, rows)
    return np.clip(rng.pareto(1.5, rows) * 5, 1, 2000).astype(int)


@pytest.mark.parametrize("dist", ["poisson", "uniform", "powerlaw"])
@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_balancing_laws_are_bit_equal(p, dist):
    for seed, rows in [(0, 200), (1, 2030), (3295, 2810)]:
        w = _weights(seed, rows, dist)
        indptr = np.concatenate([[0], np.cumsum(w)])
        np.testing.assert_array_equal(loadbalance.round_robin(w, p),
                                      jlb.round_robin(w, p))
        np.testing.assert_array_equal(loadbalance.lpt(w, p), jlb.lpt(w, p))
        for scheme in ("round_robin", "lpt"):
            a, s = loadbalance.nnz_balanced_row_order(indptr, p, scheme)
            ja, js = jlb.nnz_balanced_row_order(indptr, p, scheme)
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(s.per_worker, js.per_worker)
            assert (s.imbalance, s.max_fraction) == (js.imbalance,
                                                     js.max_fraction)
        st = loadbalance.stats_for(loadbalance.lpt(w, p), w, p)
        jst = jlb.stats_for(jlb.lpt(w, p), w, p)
        np.testing.assert_array_equal(st.per_worker, jst.per_worker)
    with pytest.raises(ValueError, match="unknown scheme"):
        loadbalance.nnz_balanced_row_order(np.array([0, 1]), p, "bogus")


@pytest.mark.parametrize("t, e, k, cf", [(1, 8, 1, 1.25), (4096, 64, 2, 1.0),
                                         (10_000, 128, 8, 1.5),
                                         (333, 16, 3, 1.25)])
def test_expert_capacity_equals_the_reference(t, e, k, cf):
    assert loadbalance.expert_capacity(t, e, k, cf) == \
        jlb.expert_capacity(t, e, k, cf)


def test_dse_explore_and_grid_give_the_reference_order():
    space = {"a": [3, 1, 2], "b": ["x", "y"], "c": [0.5, 0.25]}
    assert list(dse.grid(space)) == list(jdse.grid(space))

    def evaluate(knobs):
        if knobs["a"] == 2 and knobs["b"] == "y":
            raise ValueError("infeasible")
        return (knobs["a"] * 10 + knobs["c"]) % 7, {"k": dict(knobs)}
    ours = dse.explore(space, evaluate, top=7)
    theirs = jdse.explore(space, evaluate, top=7)
    assert [(c.knobs, c.score) for c in ours] == \
        [(c.knobs, c.score) for c in theirs]
    assert dse.sharding_candidates(8, 2) == jdse.sharding_candidates(8, 2)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("smem_kb", [8, 16, 32, 48, 64, 96, 128, 227])
def test_solve_hopper_fits_is_built_and_moves_least(smem_kb, dtype_bytes):
    budget = smem_kb * 1024
    chip = hardware.H100_SXM
    t = tiling.solve_hopper(budget, dtype_bytes)
    assert t in tiling.HOPPER_TILES
    fitting = [c for c in tiling.HOPPER_TILES
               if tiling.hopper_fits(c, dtype_bytes, budget,
                                     chip.accum_regs_bytes())]
    if not fitting:
        # below the least footprint of the smallest built tile only
        assert budget < tiling.hopper_min_smem_bytes(tiling.HOPPER_TILES[0],
                                                     dtype_bytes)
        assert t == tiling.HOPPER_TILES[0]
        return
    assert t in fitting
    q = tiling.comm_volume_rect(8192, 8192, 8192, t)
    assert all(q <= tiling.comm_volume_rect(8192, 8192, 8192, c)
               for c in fitting)
    # z is the deepest that fits for its (y, x)
    assert all(c.z <= t.z for c in fitting if (c.y, c.x) == (t.y, t.x))
    assert tiling.solve_hopper(budget, dtype_bytes) == t   # deterministic


def test_hopper_budgets_leave_out_the_full_register_tile():
    regs = hardware.H100_SXM.accum_regs_bytes()
    assert not tiling.hopper_fits(tiling.Tile(256, 256, 32), 2, 1 << 30, regs)
    assert tiling.hopper_fits(tiling.Tile(256, 128, 64), 2,
                              hardware.H100_SXM.smem_bytes, regs)
    assert tiling.hopper_smem_bytes(tiling.Tile(256, 128, 64), 4) == \
        2 * (256 * 68 + 64 * 132) * 4
    assert all(tiling.hopper_smem_bytes(t, 4) <= hardware.H100_SXM.smem_bytes
               for t in tiling.HOPPER_TILES)


def test_hopper_smem_bytes_is_each_kernels_layout():
    """bf16: the wgmma kernel's ring, as many stages of unpadded A (y, z),
    B (z, x) and two 8-byte mbarriers as fit after 1,024 bytes of
    alignment slack, at least 3 (4 at 128 x 256 x 64: 48 KB stages); its
    least footprint is 3 of them.  f32: two stages padded by 16 bytes a
    row, launched and least alike.  Every built tile fits a block's
    232,448 bytes."""
    limit = 232_448
    assert hardware.H100_SXM.smem_bytes == limit
    t = tiling.Tile(128, 256, 64)
    assert tiling.wgmma_stages(t) == 4
    assert tiling.hopper_smem_bytes(t, 2) == 4 * (49_152 + 16) + 1024
    assert tiling.hopper_min_smem_bytes(t, 2) == 3 * (49_152 + 16) + 1024
    for t in tiling.HOPPER_TILES:
        stage = (t.y * t.z + t.z * t.x) * 2 + 16
        s = tiling.wgmma_stages(t)
        assert s >= 3 and (s + 1) * stage + 1024 > limit
        assert tiling.hopper_smem_bytes(t, 2) == s * stage + 1024 <= limit
        assert tiling.hopper_min_smem_bytes(t, 2) == 3 * stage + 1024
        assert tiling.hopper_smem_bytes(t, 4) == \
            tiling.hopper_min_smem_bytes(t, 4) == \
            2 * (t.y * (t.z + 4) + t.z * (t.x + 4)) * 4 <= limit
        assert tiling.hopper_fits(t, 2, limit,
                                  hardware.H100_SXM.accum_regs_bytes())


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_smem_sweep_picks_fitting_tiles_that_grow_with_the_budget(
        dtype_bytes):
    """The paper's local-memory axis L: from the least footprint of the
    smallest tile up, `solve_hopper` and the model's ranking pick a tile
    whose least footprint fits L, the C tile never shrinks as L grows,
    and the sweep of Table I moves through several tiles."""
    from repro_torch.benchmarks import table1_matmul
    regs = hardware.H100_SXM.accum_regs_bytes()
    least = tiling.hopper_min_smem_bytes(tiling.HOPPER_TILES[0], dtype_bytes)
    budgets = sorted({kb * 1024 for kb, _ in table1_matmul.SMEM_SWEEP}
                     | {least, 40 << 10, 80 << 10, 160 << 10, 200 << 10})
    picks = []
    for budget in budgets:
        if budget < least:
            continue
        t = tiling.solve_hopper(budget, dtype_bytes)
        assert tiling.hopper_fits(t, dtype_bytes, budget, regs)
        ranked = dse.rank_matmul_tiles(8192, 8192, 8192, smem_bytes=budget,
                                       dtype_bytes=dtype_bytes, top=16)
        assert ranked and all(
            tiling.hopper_fits(c.detail["tile"], dtype_bytes, budget, regs)
            for c in ranked)
        picks.append(t)
    areas = [t.y * t.x for t in picks]
    assert areas == sorted(areas)
    assert len(set(picks)) >= 4
    assert picks[-1] == tiling.Tile(128, 256, 64)


def test_chip_rates_by_operand_width():
    chip = hardware.H100_SXM
    assert chip.peak_for(2) == 989e12 and chip.peak_for(4) == 67e12
    assert chip.smem_bytes == 232_448 and chip.sms == 132
    assert hardware.DTYPE_BYTES["bfloat16"] == 2
    if not torch.cuda.is_available():
        assert hardware.detect() == chip
