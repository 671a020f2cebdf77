"""The port's tuning engine (`kernels/registry.py`, `kernels/autotune.py`)
on the CPU: the registry's rules, the cache's life (miss, hit, upgrade
by a measuring caller, v2 migration, v1 drop, quarantine of a corrupt
file, an unwritable path, a poisoned plan), keys, the cache file shared
with the JAX engine in both directions, a toy family tuned by both
engines to the same entry, and `dispatch` (the plain path on CPU
tensors; a launch that raises poisons its plan and propagates)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dse as jdse  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402

from repro_torch.core import dse, hardware  # noqa: E402
from repro_torch.kernels import autotune, registry  # noqa: E402
from repro_torch.kernels.spmv import kernel as spmv_kernel  # noqa: E402
from repro_torch.kernels.spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.spmv import spec as spmv_spec  # noqa: E402


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    return autotune.TuneCache(path)


def _enumerate_toy(problem, dtype_bytes, top, candidate, budget=None,
                   **_):
    cands = []
    for chunk in (64, 128, 256):
        row = _toy_cost(problem, {"chunk": chunk}, dtype_bytes)
        if budget is not None and row["smem_bytes"] > budget:
            continue
        cands.append(candidate({"chunk": chunk}, row["time_s"],
                               {"bytes": row["smem_bytes"]}))
    return cands or [candidate({"chunk": 64}, 1.0, {})]


def _toy_cost(problem, knobs, dtype_bytes=4):
    n = problem["n"]
    chunks = -(-n // knobs["chunk"])
    return {"time_s": n * dtype_bytes / 1e9 + chunks * 1e-6,
            "smem_bytes": knobs["chunk"] * dtype_bytes}


def _toy_spec(name="toy_scale", run_fn=None):
    """y = x * alpha with a chunk knob; the model prefers the largest
    chunk that fits the budget."""
    return registry.KernelSpec(
        name=name,
        key_fn=lambda p, dtype, backend: f"n{p['n']}:{dtype}:{backend}",
        enumerate_candidates=lambda problem, dtype_bytes, smem_bytes, top:
            _enumerate_toy(problem, dtype_bytes, top, dse.Candidate,
                           smem_bytes),
        cost_fn=_toy_cost,
        make_inputs=lambda p, dtype, device: (
            torch.ones(p["n"], dtype=dtype, device=device),),
        build_launcher=lambda problem, knobs: lambda x: x * problem["alpha"],
        reference_fn=lambda x, alpha=2.0: x * alpha,
        problem_fn=lambda x, alpha=2.0: ({"n": x.shape[0], "alpha": alpha},
                                         x.dtype),
        run_fn=run_fn or (lambda plan, x, alpha=2.0: x * alpha),
        tie_break=lambda knobs: (-knobs["chunk"],),
        detail_keys=("bytes",),
    )


@pytest.fixture
def toy_spec():
    spec = registry.register(_toy_spec())
    yield spec
    registry.unregister(spec.name)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_builtin_families_are_matmul_and_spmv():
    """The paper slice's two families, and since the attention specs the
    three attention families beside them."""
    assert registry.families() == ["attention", "decode", "decode_int8",
                                   "matmul", "spmv"]
    assert set(registry.BUILTIN_FAMILIES) == set(registry.families())


def test_duplicates_and_builtins_are_protected(toy_spec):
    assert registry.get(toy_spec.name) is toy_spec
    with pytest.raises(ValueError, match="already registered"):
        registry.register(_toy_spec(toy_spec.name))
    with pytest.raises(ValueError, match="already registered"):
        registry.register(_toy_spec("matmul"))
    with pytest.raises(ValueError, match="cannot unregister built-in"):
        registry.unregister("spmv")
    with pytest.raises(TypeError):
        registry.register({"name": "not_a_spec"})


def test_unknown_family_names_the_registered_ones():
    with pytest.raises(KeyError, match=r"unknown kernel family.*matmul"):
        registry.get("no_such_family")


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_miss_then_hit(cache):
    problem = {"m": 512, "n": 256, "k": 128}
    p1 = autotune.tune("matmul", problem, torch.bfloat16, device="cpu",
                       cache=cache)
    assert p1.source == "model" and p1.provenance == "analytic"
    assert (cache.hits, cache.misses) == (0, 1)
    p2 = autotune.tune("matmul", problem, torch.bfloat16, device="cpu",
                       cache=cache)
    assert p2.source == "cache" and p2.knobs == p1.knobs
    assert p2.key == p1.key == "matmul:512x256x128:bfloat16:cpu:vdflt"
    assert cache.hits == 1
    on_disk = json.loads(cache.path.read_text())
    assert on_disk["version"] == 3 and p1.key in on_disk["entries"]


def test_the_cpu_never_measures(cache, toy_spec):
    plan = autotune.tune(toy_spec.name, {"n": 512, "alpha": 2.0},
                         device="cpu", cache=cache, measure_k=3)
    assert plan.source == "model" and plan.measured_us is None


def test_model_entry_is_upgraded_by_a_measuring_caller(cache, toy_spec,
                                                       monkeypatch):
    problem = {"n": 512, "alpha": 2.0}
    monkeypatch.setattr(autotune, "_backend", lambda device: "cuda:fake")
    p1 = autotune.tune(toy_spec.name, problem, device="cpu", cache=cache,
                       measure_k=0)
    assert p1.source == "model" and p1.knobs == {"chunk": 256}
    assert p1.detail == {"bytes": 1024}
    p2 = autotune.tune(toy_spec.name, problem, device="cpu", cache=cache,
                       measure_k=2)
    assert p2.source == "measured" and p2.measured_us > 0
    p3 = autotune.tune(toy_spec.name, problem, device="cpu", cache=cache,
                       measure_k=2)
    assert p3.source == "cache" and p3.provenance == "measured"


def test_budget_shapes_the_choice_and_the_key(cache, toy_spec):
    p = autotune.tune(toy_spec.name, {"n": 512, "alpha": 2.0}, device="cpu",
                      cache=cache, smem_bytes=300)
    assert p.knobs == {"chunk": 64} and p.key.endswith(":v300")


def _v2_file(path):
    entries = {
        "matmul:128x128x128:float32:cpu:vdflt": {
            "tile": [128, 128, 128], "source": "measured",
            "model_time_s": 3.2e-5, "measured_us": 41.5},
        "spmv:64x10:n300:nnz512:labc:float32:cpu:vdflt": {
            "block_rows": 16, "block_cols": None, "source": "model",
            "model_time_s": 1.1e-6, "measured_us": None, "waste": 1.25},
        "matmul:1x1x1:float32:cpu:vdflt": {"source": "model"},
        "ghost:1x1:float32:cpu:vdflt": {"widget": 7},
    }
    path.write_text(json.dumps({"version": 2, "entries": entries}))


def test_v2_file_is_migrated_in_place(cache):
    _v2_file(cache.path)
    entries = autotune.TuneCache(cache.path)._load()["entries"]
    assert set(entries) == {"matmul:128x128x128:float32:cpu:vdflt",
                            "spmv:64x10:n300:nnz512:labc:float32:cpu:vdflt"}
    mm = entries["matmul:128x128x128:float32:cpu:vdflt"]
    assert mm["knobs"] == {"tile": [128, 128, 128]}
    assert (mm["source"], mm["measured_us"]) == ("measured", 41.5)
    sp = entries["spmv:64x10:n300:nnz512:labc:float32:cpu:vdflt"]
    assert sp["knobs"] == {"block_rows": 16, "block_cols": None}
    assert sp["detail"] == {"waste": 1.25}


def test_v1_file_is_dropped(cache):
    cache.path.write_text(json.dumps({"version": 1, "entries": {
        "matmul:8x8x8:float32:cpu:vdflt": {"tile": [8, 8, 8]}}}))
    assert autotune.TuneCache(cache.path)._load()["entries"] == {}


def test_corrupt_file_is_quarantined_with_a_warning(cache):
    cache.path.write_text("{not json")
    fresh = autotune.TuneCache(cache.path)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert fresh._load()["entries"] == {}
    assert cache.path.with_name(cache.path.name + ".corrupt").read_text() \
        == "{not json"


def test_an_unwritable_path_does_not_crash(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    unwritable = autotune.TuneCache(blocker / "sub" / "autotune.json")
    plan = autotune.tune("matmul", {"m": 64, "n": 64, "k": 64},
                         device="cpu", cache=unwritable)
    assert plan.source == "model"
    again = autotune.tune("matmul", {"m": 64, "n": 64, "k": 64},
                          device="cpu", cache=unwritable)
    assert again.source == "cache"          # served from memory


def test_a_poisoned_plan_is_retuned(cache):
    problem = {"m": 256, "n": 256, "k": 256}
    p1 = autotune.tune("matmul", problem, device="cpu", cache=cache)
    autotune.mark_plan_poisoned(p1.key, cache=cache)
    assert cache._load()["entries"][p1.key]["poisoned"]
    p2 = autotune.tune("matmul", problem, device="cpu", cache=cache)
    assert p2.source == "model"
    assert not cache._load()["entries"][p1.key].get("poisoned")


def _csr(seed, m, n, density):
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < density) * rng.standard_normal((m, n))
    lens = (dense != 0).sum(1)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return (dense, indptr, np.nonzero(dense)[1].astype(np.int32),
            dense[dense != 0].astype(np.float32))


def test_keys_separate_shapes_dtypes_packings_and_backends(cache):
    spec = registry.get("matmul")
    keys = {autotune.cache_key(spec, {"m": m, "n": 64, "k": 64}, dt, be,
                               None)
            for m in (64, 65) for dt in ("float32", "bfloat16")
            for be in ("cpu", "cuda:NVIDIA H100 80GB HBM3")}
    assert len(keys) == 8
    _, indptr, cols, vals = _csr(3, 300, 200, 0.05)
    mats = [spmv_ops.pack_csr(indptr, cols, vals, (300, 200), scheme=s,
                              device="cpu") for s in ("round_robin", "sorted")]
    spmv_keys = {autotune.tune("spmv", {"mat": m}, device="cpu",
                               cache=cache).key for m in mats}
    assert len(spmv_keys) == 2
    assert autotune._backend("cpu") == "cpu"


def test_the_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.delenv(jautotune.CACHE_ENV, raising=False)
    assert autotune.CACHE_ENV != jautotune.CACHE_ENV
    path = autotune.default_cache_path()
    assert path != jautotune.default_cache_path()
    assert path.parent.name == "build"
    assert path.parent.parent == autotune._build.BUILD.parents[1]


def test_cache_files_load_in_both_engines(tmp_path):
    ours = autotune.TuneCache(tmp_path / "ours.json")
    plan = autotune.tune("matmul", {"m": 96, "n": 96, "k": 96},
                         device="cpu", cache=ours)
    theirs = jautotune.TuneCache(tmp_path / "ours.json")
    assert theirs.get(plan.key)["knobs"] == plan.knobs
    jcache = jautotune.TuneCache(tmp_path / "theirs.json")
    jplan = jautotune.tune("matmul", {"m": 96, "n": 96, "k": 96},
                           measure_k=0, cache=jcache)
    assert autotune.TuneCache(tmp_path / "theirs.json").get(jplan.key) \
        == jcache.get(jplan.key)


def test_a_toy_family_tunes_to_the_same_entry_in_both_engines(tmp_path):
    jspec = jregistry.KernelSpec(
        name="toy_both",
        key_fn=lambda p, dtype, backend: f"n{p['n']}:{dtype}:{backend}",
        enumerate_candidates=lambda problem, dtype_bytes, vmem_bytes, top:
            _enumerate_toy(problem, dtype_bytes, top, jdse.Candidate,
                           vmem_bytes),
        cost_fn=_toy_cost, make_inputs=None, build_launcher=None,
        reference_fn=None, problem_fn=None, run_fn=None,
        measure_elems=lambda p: p["n"],
        tie_break=lambda knobs: (-knobs["chunk"],), detail_keys=("bytes",))
    jregistry.register(jspec)
    registry.register(_toy_spec("toy_both"))
    try:
        for budget in (None, 300):
            ours = autotune.TuneCache(tmp_path / f"o{budget}.json")
            theirs = jautotune.TuneCache(tmp_path / f"t{budget}.json")
            p = autotune.tune("toy_both", {"n": 512, "alpha": 2.0},
                              device="cpu", measure_k=0, smem_bytes=budget,
                              cache=ours)
            jp = jautotune.tune("toy_both", {"n": 512, "alpha": 2.0},
                                measure_k=0, vmem_bytes=budget,
                                cache=theirs)
            assert p.key.replace(":cpu:", ":B:") == \
                jp.key.replace(f":{jautotune._backend()}:", ":B:")
            assert ours.get(p.key) == theirs.get(jp.key)
    finally:
        registry.unregister("toy_both")
        jregistry.unregister("toy_both")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_on_cpu_tensors_runs_the_plain_version(cache, toy_spec):
    x = torch.arange(8, dtype=torch.float32)
    out = autotune.dispatch(toy_spec.name, x, alpha=3.0, cache=cache)
    torch.testing.assert_close(out, x * 3.0)
    assert (cache.hits, cache.misses) == (0, 0)      # no tuning at all
    a = torch.randn(33, 17, generator=torch.Generator().manual_seed(0))
    b = torch.randn(17, 9, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(autotune.dispatch("matmul", a, b,
                                                 activation="relu"),
                               torch.relu(a @ b))
    dense, indptr, cols, vals = _csr(5, 120, 90, 0.1)
    mat = spmv_ops.pack_csr(indptr, cols, vals, (120, 90), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(90)
                         .astype(np.float32))
    np.testing.assert_allclose(autotune.dispatch("spmv", mat, x).numpy(),
                               dense @ x.numpy(), rtol=1e-4, atol=1e-4)


def test_dispatch_reraises_a_failing_launch_after_poisoning(cache,
                                                          monkeypatch):
    def boom(plan, x, alpha=2.0):
        raise RuntimeError("launch failed")

    # Take the card's route with CPU tensors: the arguments count as on a
    # CUDA device, and the plan is tuned by the model as the CPU tunes.
    real_tune = autotune.tune
    monkeypatch.setattr(autotune, "_device_of",
                        lambda args: torch.device("cuda"))
    monkeypatch.setattr(autotune, "tune", lambda spec, problem, dtype, *,
                        device, cache: real_tune(spec, problem, dtype,
                                                 device="cpu", cache=cache))
    spec = registry.register(_toy_spec("toy_boom", run_fn=boom))
    try:
        x = torch.ones(16)
        with pytest.raises(RuntimeError, match="launch failed"):
            autotune.dispatch(spec.name, x, cache=cache)
        (key,) = cache._load()["entries"]
        assert cache._load()["entries"][key]["poisoned"]
    finally:
        registry.unregister("toy_boom")


def test_measure_times_on_the_host_for_the_cpu():
    us = autotune.measure(lambda: torch.ones(10).sum(), "cpu", reps=2)
    assert us > 0


def test_spmv_tuning_times_each_distinct_kernel_launch(cache, monkeypatch):
    """The SpMV family times a candidate as the kernel call alone
    (`ops.packed_spmv`: packed rows, no scatter back), through the one
    timing policy of `autotune.measure`, and never two resident
    candidates that `ell_spmv` would launch alike."""
    monkeypatch.setattr(autotune, "_backend", lambda device: "cuda:fake")
    seen = []

    def fake_measure(fn, device):
        seen.append(tuple(fn().shape))
        return float(len(seen))

    monkeypatch.setattr(autotune, "measure", fake_measure)
    rng = np.random.default_rng(4)
    dense = (rng.random((203, 90)) < 0.1) * rng.standard_normal((203, 90))
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    mat = spmv_ops.pack_csr(indptr.astype(np.int32),
                            np.nonzero(dense)[1].astype(np.int32),
                            dense[dense != 0].astype(np.float32), (203, 90),
                            device="cpu")
    plan = autotune.tune("spmv", {"mat": mat}, device="cpu", cache=cache)
    cands = registry.get("spmv").enumerate_candidates(
        {"mat": mat}, 4, None, 8)
    # x of 90 columns: no slab; 208 rows give every block_rows one launch
    assert [c.knobs for c in cands] == [plan.knobs]
    assert plan.source == "measured" and seen == [(208,)]  # 203 rows packed
    resident = [c.knobs["block_rows"] for c in cands
                if c.knobs["block_cols"] is None]
    rows, width = mat.cols.shape
    geos = [tuple(sorted(spmv_kernel.launch_geometry(
        rows, width, spmv_kernel.RESIDENT_THREADS // br, 90,
        hardware.H100_SXM.sms).items())) for br in resident]
    assert resident and len(set(geos)) == len(geos)
    # the model's best resident candidate is the one kept of its launch
    best = min((r for r in spmv_spec.rank_configs(mat) if r[2] is None),
               key=lambda r: (r[0], r[1]))
    assert best[1] in resident


@pytest.mark.parametrize("call_us, reps, timed", [
    (40.0, None, [1, 25]),        # 1000 us / 40 us, capped at 25 calls
    (300.0, None, [1, 4]),        # ceil(1000 / 300)
    (2000.0, None, [1]),          # one call covers a millisecond
    (5.0, 7, [7]),                # the caller's count
])
def test_measure_spins_the_card_and_covers_a_millisecond(monkeypatch,
                                                         call_us, reps,
                                                         timed):
    """On the card every timed run starts behind a spin of
    `LEAD_CYCLES`, after one warm-up call; without ``reps`` one call is
    timed, then as many as cover `COVER_US`, at most `MAX_REPS`."""
    clock, log = [0.0], []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            log.append("record")
            self.t = clock[0]

        def synchronize(self):
            pass

        def elapsed_time(self, other):            # ms, as CUDA events
            return (other.t - self.t) / 1e3

    def fn():
        log.append("call")
        clock[0] += call_us

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: log.append(("spin", cycles)))
    assert autotune.measure(fn, "cuda", reps=reps) == pytest.approx(call_us)
    want = ["call"]
    for n in timed:
        want += [("spin", autotune.LEAD_CYCLES), "record"] + ["call"] * n \
            + ["record"]
    assert log == want
    assert autotune.MAX_REPS == 25 and autotune.COVER_US == 1000.0
