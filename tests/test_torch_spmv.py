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
from repro.kernels.spmv.ref import spmv_ell_ref as jspmv_ell_ref  # noqa: E402

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


# ---------------------------------------------------------------------------
# B7 with row lengths: the plain path, the wrapper's checks, the geometry
# ---------------------------------------------------------------------------

def _rows_with_empty_and_full(seed):
    """CSR of 300 rows over 700 columns: every third row empty, every
    third at 256 entries (the full ELL width at align 128), the rest 1-255
    entries."""
    rng = np.random.default_rng(seed)
    rows = [np.array([], np.int64) if r % 3 == 0 else
            np.sort(rng.choice(700, 256 if r % 3 == 1
                               else int(rng.integers(1, 256)),
                               replace=False)) for r in range(300)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate(rows).astype(np.int32)
    data = rng.standard_normal(len(indices)).astype(np.float32)
    return indptr.astype(np.int32), indices, data, (300, 700)


@pytest.mark.parametrize("scheme", ["sorted", "none", "round_robin"])
@pytest.mark.parametrize("kind", ["empty_and_full", "random", "table2"])
def test_length_aware_plain_path_matches_the_reference(kind, scheme):
    """`kernel.ell_spmv` with the row lengths on the CPU (the plain
    version honours them) against the JAX package's `spmv_csr_ref` and
    `spmv_ell_ref`, on rows of length 0, rows at the full width and rows
    in between; in packed order and through `ops.spmv`.  Tolerance: the
    reference test's rtol and atol of 1e-4 (the same f32 products, summed
    in another order, up to 792 a row)."""
    if kind == "empty_and_full":
        indptr, indices, data, shape = _rows_with_empty_and_full(3)
    elif kind == "random":
        rng = np.random.default_rng(17)
        _, indptr, indices, data = _random_csr(rng, 555, 300, 0.02)
        shape = (555, 300)
    else:
        indptr, indices, data, shape = _table2("BIBD_14_7")
    mat = ops.pack_csr(indptr, indices, data, shape, scheme=scheme,
                       device="cpu")
    if kind == "empty_and_full":
        assert mat.cols.shape[1] == 256 and mat.row_lens.max() == 256
        assert (mat.row_lens == 0).sum() >= 100
    assert mat.lens.dtype == torch.int32
    np.testing.assert_array_equal(mat.lens.numpy(), mat.row_lens)
    x = np.random.default_rng(2).standard_normal(shape[1]).astype(np.float32)
    tx = torch.from_numpy(x)
    y_packed = kernel.ell_spmv(tx, mat.cols, mat.vals, row_lens=mat.lens)
    theirs_ell = np.asarray(jspmv_ell_ref(jnp.asarray(mat.cols.numpy()),
                                          jnp.asarray(mat.vals.numpy()),
                                          jnp.asarray(x)))
    np.testing.assert_allclose(y_packed.numpy(), theirs_ell, rtol=1e-4,
                               atol=1e-4)
    want = np.asarray(jspmv_csr_ref(jnp.asarray(indptr),
                                    jnp.asarray(indices), jnp.asarray(data),
                                    jnp.asarray(x), shape[0]))
    np.testing.assert_allclose(ops.spmv(mat, tx).numpy(), want, rtol=1e-4,
                               atol=1e-4)
    assert bool((y_packed[torch.from_numpy(mat.row_lens == 0)] == 0).all())


def test_length_aware_plain_path_uses_no_padding_where_x0_is_inf():
    """The padded reference (the JAX package's `spmv_ell_ref`) adds a
    pad's 0 * x[0] to every row: NaN where x[0] is inf.  With the row
    lengths no pad is used, so rows that do not hold column 0 stay
    finite and equal the CSR product (ROADMAP queue C)."""
    indptr, indices, data, shape = _rows_with_empty_and_full(4)
    keep = indices != 0
    row_ids = np.repeat(np.arange(shape[0]), np.diff(indptr))
    lens = np.bincount(row_ids[keep], minlength=shape[0])
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices, data = indices[keep], data[keep]
    mat = ops.pack_csr(indptr, indices, data, shape, scheme="sorted",
                       device="cpu")
    x = np.random.default_rng(5).standard_normal(shape[1]).astype(np.float32)
    x[0] = np.inf
    padded = mat.row_lens < mat.cols.shape[1]
    theirs = np.asarray(jspmv_ell_ref(jnp.asarray(mat.cols.numpy()),
                                      jnp.asarray(mat.vals.numpy()),
                                      jnp.asarray(x)))
    assert np.isnan(theirs[padded]).all() and padded.sum() > 100
    ours = kernel.ell_spmv(torch.from_numpy(x), mat.cols, mat.vals,
                           row_lens=mat.lens).numpy()
    assert np.isfinite(ours).all()
    want = np.asarray(jspmv_csr_ref(jnp.asarray(indptr),
                                    jnp.asarray(indices), jnp.asarray(data),
                                    jnp.asarray(x), shape[0]))
    np.testing.assert_allclose(ops.spmv(mat, torch.from_numpy(x)).numpy(),
                               want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad, match", [
    (lambda lens: lens[:-1], "is not"),
    (lambda lens: lens[:, None], "is not"),
    (lambda lens: lens.long(), "int32"),
    (lambda lens: lens.float(), "int32"),
    (lambda lens: lens.to("meta"), "lies on"),
], ids=["short", "2d", "int64", "float", "other_device"])
def test_ell_spmv_refuses_bad_row_lens(bad, match):
    rng = np.random.default_rng(1)
    _, indptr, cols, vals = _random_csr(rng, 91, 91, 0.5)
    mat = ops.pack_csr(indptr, cols, vals, (91, 91), device="cpu")
    x = torch.from_numpy(rng.standard_normal(91).astype(np.float32))
    with pytest.raises(ValueError, match=match):
        kernel.ell_spmv(x, mat.cols, mat.vals, row_lens=bad(mat.lens))


@pytest.mark.parametrize("lanes", [1, 4, 8, 32])
def test_launch_geometry_spreads_few_long_rows_and_fills_the_card(lanes):
    """BIBD_14_7's 91 rows of 792 entries (width 896): 32 lanes a row,
    one-warp blocks, a block per row, so 91 SMs work (a row needs a warp;
    the card's residency is far above 91).  A 1M-row matrix of width 128
    keeps the tuner's lanes and 1024-thread blocks, one per SM (x of 128
    KB leaves room for one), on all 132 SMs."""
    geo = kernel.launch_geometry(91, 896, lanes, 3432, 132)
    assert geo == {"threads": 32, "lanes": 32, "rows_per_block": 1,
                   "grid": 91}
    geo = kernel.launch_geometry(1 << 20, 128, lanes, 32768, 132)
    assert geo["threads"] == 1024 and geo["lanes"] == lanes
    assert geo["grid"] == 132
    # Maragal_2's 555 rows of width 128: a lane keeps one 16-byte vector
    # of a full row, and blocks of 4 warps give every SM one
    geo = kernel.launch_geometry(555, 128, lanes, 128, 132)
    assert geo == {"threads": 128, "lanes": 32, "rows_per_block": 4,
                   "grid": 139}
    geo = kernel.launch_geometry(555, 8, 1, 128, 132)
    assert geo["lanes"] == 2                   # width 8: two vectors a row
    # the residency caps the grid: x of 80 KB leaves room for two blocks
    geo = kernel.launch_geometry(500_000, 8, lanes, 20_000, 132)
    assert geo["threads"] == 1024 and geo["grid"] == 132 * 2


def test_distinct_block_rows_keeps_the_first_of_each_launch():
    """Few long rows launch alike whatever block_rows asks (BIBD_14_7,
    Maragal_2); a 1M-row matrix launches differently on each; the order
    given is kept, so the best-ranked of a launch is the one kept."""
    assert kernel.distinct_block_rows(91, 896, 3432, 132) == [32]
    assert kernel.distinct_block_rows(555, 128, 128, 132,
                                      [256, 32, 1024]) == [256]
    assert kernel.distinct_block_rows(1 << 20, 128, 32768, 132) == \
        list(kernel.RESIDENT_ROWS)
    assert kernel.distinct_block_rows(1 << 20, 128, 32768, 132,
                                      [128, 32]) == [128, 32]
