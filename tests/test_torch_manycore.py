"""The paper's design flow in the port: `core.manycore` against the JAX
package's `ManyCoreConfig` (what does not read the chip equal, the tile
plan and budgets held to `solve_hopper` and the data sheet, the
invariant of tests/test_system.py's manycore test), the one-card mesh,
and the two examples of the flow (`examples.quickstart`,
`examples.spmv_pipeline`) on the CPU, where every kernel wrapper runs its
plain version."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import manycore as jmc  # noqa: E402
from repro.kernels.spmv import pack_csr as jpack_csr  # noqa: E402
from repro_torch.core import hardware, manycore, tiling  # noqa: E402
from repro_torch.examples import quickstart, spmv_pipeline  # noqa: E402

CONFIGS = [("default", lambda m: m.ManyCoreConfig()),
           ("single_pod", lambda m: m.SINGLE_POD),
           ("multi_pod", lambda m: m.MULTI_POD),
           ("host", lambda m: m.host_test_config()),
           ("host_2x4", lambda m: m.host_test_config(2, 4))]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several processes at once,
    and more threads than cores slow every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, make", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_what_does_not_read_the_chip_equals_the_reference(name, make):
    ours, ref = make(manycore), make(jmc)
    assert ours.mesh_shape == ref.mesh_shape
    assert ours.mesh_axes == ref.mesh_axes
    assert ours.num_chips == ref.num_chips
    for axis in ours.mesh_axes:
        assert ours.axis(axis) == ref.axis(axis)
    assert ours.data_axes() == ref.data_axes()
    assert ours.model_axis() == ref.model_axis()
    assert ours.kernels == ref.kernels == manycore.KERNEL_LIBRARY
    assert dataclasses.asdict(ours.dtypes) == dataclasses.asdict(ref.dtypes)
    assert ours.dtypes.param_bytes == ref.dtypes.param_bytes
    assert ours.dtypes.compute_bytes == ref.dtypes.compute_bytes
    # describe: the lines that do not read the chip are the reference's
    mine, theirs = ours.describe().splitlines(), ref.describe().splitlines()
    assert len(mine) == len(theirs) == 5
    for i in (0, 2, 3):
        assert mine[i] == theirs[i]


@pytest.mark.parametrize("name, make", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_the_chip_terms_are_the_h100s(name, make):
    mc = make(manycore)
    assert mc.chip is hardware.H100_SXM
    assert mc.usable_vmem == hardware.H100_SXM.smem_bytes
    assert mc.peak_flops() == mc.num_chips * 989e12
    assert f"{mc.peak_flops() / 1e12:.0f} TFLOP/s" in mc.describe()
    assert f"{mc.usable_vmem / 1024:.0f} KiB/core" in mc.describe()


@pytest.mark.parametrize("shape", [(8192, 8192, 8192), (4096, 4096, 4096),
                                   (1024, 8192, 512), (None, None, None)])
@pytest.mark.parametrize("vmem", [None, 64 * 1024, 160 * 1024])
def test_matmul_tile_is_solve_hopper_and_fits(shape, vmem):
    mc = dataclasses.replace(manycore.ManyCoreConfig(), vmem_bytes=vmem)
    m, n, k = shape
    t = mc.matmul_tile(m, n, k)
    assert t == tiling.solve_hopper(smem_bytes=mc.usable_vmem,
                                    dtype_bytes=2, m=m, n=n, k=k)
    # tests/test_system.py's invariant, read for the card: the tile's
    # least shared-memory footprint fits the budget
    assert tiling.hopper_min_smem_bytes(t, 2) <= mc.usable_vmem


def test_manycore_config_generates_consistent_plan():
    """tests/test_system.py::test_manycore_config_generates_consistent_plan
    on the port's chip."""
    mc = manycore.ManyCoreConfig()
    assert mc.num_chips == 256
    t = mc.matmul_tile(8192, 8192, 8192)
    assert tiling.hopper_fits(t, 2, mc.usable_vmem,
                              mc.chip.accum_regs_bytes())
    assert "256 chips" in mc.describe()


def test_the_one_card_mesh_and_the_refusal_of_larger_ones():
    import torch.distributed as dist
    mesh = manycore.host_test_config().make_mesh("cpu")
    try:
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()
    for mc, n in ((manycore.SINGLE_POD, 256),
                  (manycore.host_test_config(2, 1), 2)):
        with pytest.raises(RuntimeError, match=f"{n} cards needs {n} ranks"):
            mc.make_mesh("cpu")


def test_quickstart_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    res = quickstart.run("cpu")
    out = capsys.readouterr().out
    assert res["matmul"]["ok"] and res["spmv"]["ok"]
    assert res["matmul"]["max_abs_err"] < 1e-4
    assert res["spmv"]["max_abs_err"] < 1e-4
    assert "=== deploy plan ===" in out
    assert out.splitlines()[-1].endswith(
        "python -m repro_torch.launch.sweep --mesh both")
    assert quickstart.main(["--device", "cpu"]) == 0


def test_quickstart_spmv_packing_equals_the_reference():
    """Step 4b's matrix and its sorted packing are the JAX flow's."""
    rng = np.random.default_rng(0)
    rows, cols_n = quickstart.SPMV_SHAPE
    dense = ((rng.random((rows, cols_n)) < quickstart.SPMV_DENSITY)
             * rng.standard_normal((rows, cols_n)))
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(
        np.int32)
    cols = np.concatenate([np.nonzero(r)[0] for r in dense]).astype(np.int32)
    vals = dense[dense != 0].astype(np.float32)
    from repro_torch.kernels.spmv.ops import pack_csr
    ours = pack_csr(indptr, cols, vals, dense.shape, scheme="sorted",
                    device="cpu")
    ref = jpack_csr(indptr, cols, vals, dense.shape, scheme="sorted")
    np.testing.assert_array_equal(ours.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(ours.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_array_equal(ours.perm, np.asarray(ref.perm))


def test_spmv_pipeline_on_the_cpu(capsys):
    res = spmv_pipeline.run("cpu")
    out = capsys.readouterr().out
    assert set(res) == {*spmv_pipeline.SCHEMES, "tuned", "blocked"}
    assert all(r["ok"] for r in res.values()), res
    assert "matrix: 2030x512" in out and "SORTED" in out
    assert spmv_pipeline.main(["--device", "cpu"]) == 0


def test_spmv_pipeline_matrix_is_the_references():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "spmv_pipeline.py"
    spec = importlib.util.spec_from_file_location("ref_spmv_pipeline", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for a, b in zip(spmv_pipeline.make_matrix(), ref.make_matrix()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.run()
    with pytest.raises(RuntimeError, match="cuda"):
        spmv_pipeline.run()
