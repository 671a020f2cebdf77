"""The port's SpMV entry (`kernels/spmv/ops.py`, `ref.py`) on the CPU
against the JAX package: `pack_csr` bit-equal for every packing law (the
ELL arrays, the permutation, the row lengths, both waste metrics, the
layout fingerprint), on the reference's kernel-test shapes and on the
four Table-II matrices built once here and fed to both packages; `spmv`
on its plain path against the reference's jnp path and dense @ x within
the reference test's rtol/atol of 1e-4; the blocked kernel's plain
version (the slab walk) against `spmv_ell_ref`."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.spmv import pack_csr as jpack_csr  # noqa: E402
from repro.kernels.spmv import spmv as jspmv  # noqa: E402
from repro.kernels.spmv.ref import spmv_csr_ref as jspmv_csr_ref  # noqa: E402

from repro_torch.benchmarks import table2_spmv  # noqa: E402
from repro_torch.kernels.spmv import kernel, ops, ref  # noqa: E402

SCHEMES = ["round_robin", "lpt", "sorted", "none"]
RANDOM_SHAPES = [(555, 300, 0.02), (91, 91, 0.5), (2030, 128, 0.05)]
TABLE2 = list(table2_spmv.MATRICES)


@functools.cache
def _table2(name):
    """A Table-II matrix's CSR arrays, built on first use, not when the
    file is collected."""
    return table2_spmv.synthesize(name)


def _random_csr(rng, m, n, density):
    dense = (rng.random((m, n)) < density) * rng.standard_normal((m, n))
    nnz_per_row = (dense != 0).sum(1)
    indptr = np.concatenate([[0], np.cumsum(nnz_per_row)]).astype(np.int32)
    cols = (np.concatenate([np.nonzero(r)[0] for r in dense])
            .astype(np.int32) if nnz_per_row.sum() else
            np.zeros(0, np.int32))
    vals = dense[dense != 0].astype(np.float32)
    return dense, indptr, cols, vals


def _assert_packs_equal(indptr, cols, vals, shape, scheme, **kw):
    ours = ops.pack_csr(indptr, cols, vals, shape, scheme=scheme,
                        device="cpu", **kw)
    theirs = jpack_csr(indptr, cols, vals, shape, scheme=scheme, **kw)
    np.testing.assert_array_equal(ours.cols.numpy(), np.asarray(theirs.cols))
    assert ours.vals.numpy().dtype == np.asarray(theirs.vals).dtype
    np.testing.assert_array_equal(ours.vals.numpy(), np.asarray(theirs.vals))
    np.testing.assert_array_equal(ours.perm, theirs.perm)
    np.testing.assert_array_equal(ours.row_lens, theirs.row_lens)
    assert (ours.shape, ours.nnz) == (tuple(theirs.shape), theirs.nnz)
    assert ours.padding_waste == theirs.padding_waste
    for br in (8, 16, 32, 64):
        assert ours.sliced_waste(br) == theirs.sliced_waste(br)
    assert ours.layout_fingerprint() == theirs.layout_fingerprint()
    return ours, theirs


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("m, n, density", RANDOM_SHAPES)
def test_pack_csr_is_bit_equal_on_random_matrices(m, n, density, scheme):
    rng = np.random.default_rng(m + n)
    _, indptr, cols, vals = _random_csr(rng, m, n, density)
    _assert_packs_equal(indptr, cols, vals, (m, n), scheme)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", TABLE2)
def test_pack_csr_is_bit_equal_on_the_table2_matrices(name, scheme):
    indptr, cols, vals, shape = _table2(name)
    _assert_packs_equal(indptr, cols, vals, shape, scheme)


@pytest.mark.parametrize("scheme", ["round_robin", "sorted"])
def test_vectorised_pack_is_bit_equal_at_20k_rows(scheme):
    indptr, cols, vals, shape = table2_spmv.synthesize_large(20_000, 4096,
                                                             seed=11)
    _assert_packs_equal(indptr, cols, vals, shape, scheme, block_rows=16,
                        align=32)


@pytest.mark.parametrize("scheme", ["round_robin", "lpt", "none"])
@pytest.mark.parametrize("m, n, density", RANDOM_SHAPES)
def test_spmv_matches_the_reference_and_dense(m, n, density, scheme):
    rng = np.random.default_rng(m + n)
    dense, indptr, cols, vals = _random_csr(rng, m, n, density)
    x = rng.standard_normal(n).astype(np.float32)
    ours, theirs = _assert_packs_equal(indptr, cols, vals, (m, n), scheme)
    y = ops.spmv(ours, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), dense @ x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jspmv(theirs, jnp.asarray(x),
                                    use_kernel=False)), rtol=1e-4, atol=1e-4)
    # the blocked path's plain version, in the original row order too
    yb = ops.spmv(ours, torch.from_numpy(x), block_rows=16, block_cols=64)
    np.testing.assert_allclose(yb.numpy(), dense @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", TABLE2)
def test_spmv_on_the_table2_matrices(name):
    indptr, cols, vals, shape = _table2(name)
    x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
    mat = ops.pack_csr(indptr, cols, vals, shape, device="cpu")
    y = ops.spmv(mat, torch.from_numpy(x))
    want = np.asarray(jspmv_csr_ref(jnp.asarray(indptr), jnp.asarray(cols),
                                    jnp.asarray(vals), jnp.asarray(x),
                                    shape[0]))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
    ours_csr = ref.spmv_csr_ref(torch.from_numpy(indptr),
                                torch.from_numpy(cols),
                                torch.from_numpy(vals), torch.from_numpy(x),
                                shape[0])
    np.testing.assert_allclose(ours_csr.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m, n, density", RANDOM_SHAPES)
def test_blocked_plain_version_matches_spmv_ell_ref(m, n, density):
    rng = np.random.default_rng(m * n)
    _, indptr, cols, vals = _random_csr(rng, m, n, density)
    mat = ops.pack_csr(indptr, cols, vals, (m, n), device="cpu")
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = ref.spmv_ell_ref(mat.cols, mat.vals, x)
    tol = ref.row_tolerance(mat.cols, mat.vals, x)
    for block_cols in (128, 256, n // 2):
        got = ref.spmv_blocked_ref(mat.cols, mat.vals, x, block_cols)
        assert got.dtype == mat.vals.dtype
        assert bool(((got - want).abs() <= tol).all()), block_cols


def test_pack_csr_refuses_columns_outside_the_matrix():
    with pytest.raises(ValueError, match="column indices"):
        ops.pack_csr(np.array([0, 1]), np.array([5]), np.ones(1, np.float32),
                     (1, 5), device="cpu")


def test_column_check_refuses_columns_outside_x():
    """The check the CUDA wrappers make before a launch: every column in
    [0, n), read once for a cols tensor and again after it changes."""
    cols = torch.tensor([[0, 4], [3, 1]], dtype=torch.int32)
    kernel.check_columns(cols, 5)
    kernel.check_columns(cols, 5)                  # answered from the memo
    with pytest.raises(ValueError, match=r"outside x's \[0, 4\)"):
        kernel.check_columns(cols, 4)
    cols[1, 0] = -1                                # changed in place
    with pytest.raises(ValueError, match=r"\[-1, 4\]"):
        kernel.check_columns(cols, 5)


# ---------------------------------------------------------------------------
# B8's per-(row block, slab) decision: `kernel.slab_plan`
# ---------------------------------------------------------------------------

def _slab_plan_by_loops(cols, vals, n, block_rows, block_cols):
    """The kernel's rule written out block by block and entry by entry."""
    cols, vals = cols.numpy(), vals.numpy()
    rows = cols.shape[0]
    slabs = -(-n // block_cols)
    out = dict(staged=0, gathered=0, skipped=0, direct_entries=0)
    for r0 in range(0, rows, block_rows):
        live = [int(c) for c, v in zip(cols[r0:r0 + block_rows].ravel(),
                                       vals[r0:r0 + block_rows].ravel())
                if v != 0]
        if slabs == 1:
            out["staged"] += 1
            continue
        touched = {c // block_cols for c in live}
        out["gathered"] += len(touched)
        out["skipped"] += slabs - len(touched)
        out["direct_entries"] += len(live)
    return out


def _banded(rows, seed=5):
    return table2_spmv.synthesize_banded(rows, rows, seed=seed)


@pytest.mark.parametrize("kind, n, block_rows, block_cols", [
    ("banded", 3000, 64, 1024),
    ("banded", 3000, 16, 4099),          # one slab: staged
    ("scattered", 60_000, 64, 1024),
    ("scattered", 60_000, 128, 200),     # 300 slabs
    ("scattered", 60_000, 32, 59_999),   # a ragged last slab of 1 column
    ("scattered", 60_000, 64, 60_000),   # one slab: staged
])
def test_slab_plan_equals_the_kernel_rule_entry_by_entry(kind, n, block_rows,
                                                         block_cols):
    if kind == "banded":
        csr = _banded(n)
    else:
        csr = table2_spmv.synthesize_large(3000, n, seed=4)
    mat = ops.pack_csr(*csr, scheme="sorted", device="cpu")
    plan = kernel.slab_plan(mat.cols, mat.vals, n, block_rows, block_cols)
    want = _slab_plan_by_loops(mat.cols, mat.vals, n, block_rows, block_cols)
    assert {k: plan[k] for k in want} == want
    assert plan["staged"] + plan["gathered"] + plan["skipped"] \
        == plan["pairs"] == plan["blocks"] * plan["slabs"]
    assert plan["entries"] == mat.nnz


def test_slab_plan_stages_one_slab_and_gathers_across_many():
    """The two regimes at a small size.  x of one slab is staged by every
    row block.  Across many slabs every entry gathers: a banded matrix
    (columns within 128 of the diagonal) in its natural row order puts a
    row block's entries in one or two slabs, so nearly every other pair
    is skipped; sorted by length, as the Table-II driver packs it, a
    block's rows come from far apart and touch more slabs; a
    `synthesize_large` matrix spreads every row over all of x."""
    csr = _banded(100_000)
    mat = ops.pack_csr(*csr, scheme="none", device="cpu")
    one = kernel.slab_plan(mat.cols, mat.vals, 100_000, 128, 100_000)
    assert one["staged"] == one["blocks"] == one["pairs"]
    assert one["direct_entries"] == 0
    band = kernel.slab_plan(mat.cols, mat.vals, 100_000, 128, 4096)
    assert band["staged"] == 0
    assert band["gathered"] <= 2 * band["blocks"]
    assert band["skipped"] > 10 * band["gathered"]
    assert band["direct_entries"] == band["entries"] \
        == int((mat.vals != 0).sum())
    mat = ops.pack_csr(*csr, scheme="sorted", device="cpu")
    sorted_band = kernel.slab_plan(mat.cols, mat.vals, 100_000, 128, 4096)
    assert sorted_band["gathered"] > 2 * band["gathered"]
    csr = table2_spmv.synthesize_large(20_000, 400_000, seed=3)
    mat = ops.pack_csr(*csr, scheme="sorted", device="cpu")
    wide = kernel.slab_plan(mat.cols, mat.vals, 400_000, 128, 4096)
    assert wide["staged"] == 0 and wide["gathered"] > 0
    assert wide["direct_entries"] == wide["entries"] == mat.nnz


def test_blocked_smem_is_one_slab():
    assert kernel.smem_bytes(10_000, 4096) == 4 * 4096
    assert kernel.smem_bytes(10_000) == 40_000


def test_banded_matrix_keeps_its_band():
    indptr, indices, data, shape = table2_spmv.synthesize_banded(
        5000, 5000, seed=5)
    lens = np.diff(indptr)
    assert shape == (5000, 5000) and lens.min() >= 1 and lens.max() <= 96
    rows = np.repeat(np.arange(5000), lens)
    inner = (rows >= 128) & (rows < 5000 - 128)
    assert np.abs(indices - rows)[inner].max() <= 128
    assert np.abs(indices - rows).max() <= 256
    key = rows * 5000 + indices
    assert len(np.unique(key)) == len(key)     # distinct within a row
    again = table2_spmv.synthesize_banded(5000, 5000, seed=5)
    assert all(np.array_equal(a, b) for a, b in zip(again[:3],
                                                      (indptr, indices, data)))
