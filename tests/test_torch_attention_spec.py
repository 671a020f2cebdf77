"""The attention half of the tuning engine against the JAX package: the
roofline and FLOP laws and the three attention time models
(`core/cost_model.py`), bit for bit at the JAX package's chip; the two
rankers and the int8 enumeration (`kernels/attention/spec.py`) candidate
for candidate; the three registered families with the JAX package's cache
keys; and the decode entries at every span the tuner offers against the
JAX Pallas kernels run at that ``block_k`` in interpret mode.

Tolerances: the laws and rankers are the same float arithmetic in the
same order, so they are compared with ``==``.  The decode entries compute
in f32 on both sides and differ in summation order only: 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cost_model as jcost  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.kernels.attention import decode as jdecode  # noqa: E402
from repro.kernels.attention import decode_int8 as jdecode_int8  # noqa: E402
from repro.kernels.attention import spec as jspec  # noqa: E402
from repro.runtime import quantize as jquantize  # noqa: E402

from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.core import cost_model, hardware  # noqa: E402
from repro_torch.kernels import autotune, registry  # noqa: E402
from repro_torch.kernels.attention import decode, decode_int8  # noqa: E402
from repro_torch.kernels.attention import kernel as flash  # noqa: E402
from repro_torch.kernels.attention import spec  # noqa: E402
from repro_torch.runtime import quantize  # noqa: E402

# The reference's chip in the port's terms: one rate for every operand
# width, the TPU's HBM, link and usable VMEM.
TPU_AS_CHIP = hardware.Chip(
    variant="TPU v5e (the JAX package's numbers)",
    peak_flops=TPU_V5E.peak_flops, peak_flops_f32=TPU_V5E.peak_flops,
    hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
    link_bw=TPU_V5E.ici_bw_per_link, smem_bytes=TPU_V5E.usable_vmem())


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


# -- the laws -----------------------------------------------------------------

@pytest.mark.parametrize("flops, nbytes, coll, chips, useful", [
    (1e15, 2e12, 0.0, 1, 6e14), (3e12, 8e12, 5e11, 4, 0.0),
    (7e13, 1e9, 9e12, 8, 7e13), (0.0, 0.0, 0.0, 1, 0.0)])
def test_roofline_equals_the_reference(flops, nbytes, coll, chips, useful):
    mine = cost_model.roofline(flops, nbytes, coll, chips, useful,
                               chip=TPU_AS_CHIP)
    ref = jcost.roofline(flops, nbytes, coll, chips, useful)
    assert mine.row() == ref.row()
    assert (mine.bound_s, mine.dominant) == (ref.bound_s, ref.dominant)


def test_roofline_prices_the_port_chip_by_default():
    """The default chip is the H100, and `mfu_bound` reads the chip the
    roofline was built for, never the TPU."""
    r = cost_model.roofline(989e12, 0.0, 0.0, 1, 989e12)
    assert r.compute_s == 1.0 and r.mfu_bound == 1.0
    assert r.peak_flops == hardware.H100_SXM.peak_flops
    assert cost_model.roofline(0.0, 3.35e12, 0.0, 1).memory_s == 1.0
    assert cost_model.roofline(0.0, 0.0, 450e9, 1).collective_s == 1.0


@pytest.mark.parametrize("n, d", [(1.4e10, 4096), (3.8e9, 1), (0.0, 7)])
def test_model_flops_equal_the_reference(n, d):
    assert cost_model.model_flops_train(n, d) == jcost.model_flops_train(n, d)
    assert cost_model.model_flops_decode(n, d) == \
        jcost.model_flops_decode(n, d)


ATTN_CASES = [(320, 2048, 2048, 128), (64, 4096, 4096, 80), (8, 37, 53, 16),
              (16, 700, 500, 128)]


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("causal, window", [(True, None), (True, 64),
                                            (False, None), (False, 50)])
@pytest.mark.parametrize("bh, sq, sk, dh", ATTN_CASES)
def test_attention_time_model_equals_the_reference(bh, sq, sk, dh, causal,
                                                   window, dtype_bytes, skip):
    for bq, bk in [(128, 128), (64, 256), (512, 1024), (1024, 128)]:
        assert cost_model.attention_time_model(
            bh, sq, sk, dh, bq, bk, causal=causal, window=window,
            chip=TPU_AS_CHIP, dtype_bytes=dtype_bytes,
            block_skipping=skip) == jcost.attention_time_model(
            bh, sq, sk, dh, bq, bk, causal=causal, window=window,
            dtype_bytes=dtype_bytes, block_skipping=skip)


DECODE_CASES = [(32, 5, 624, 128, None), (32, 5, 624, 128, [601, 608, 612,
                                                              616]),
                (8, 4, 4096, 80, [0, 1, 4096, 5000]), (2, 16, 37, 16, None),
                (40, 5, 32768, 128, [32768] * 5)]


@pytest.mark.parametrize("bkv, g, kv_len, dh, lengths", DECODE_CASES)
def test_decode_time_models_equal_the_reference(bkv, g, kv_len, dh,
                                                lengths):
    for bk in (1, 64, 128, 624, 2048):
        for dtype_bytes in (1, 2, 4):
            assert cost_model.decode_time_model(
                bkv, g, kv_len, dh, bk, chip=TPU_AS_CHIP,
                dtype_bytes=dtype_bytes, lengths=lengths) == \
                jcost.decode_time_model(bkv, g, kv_len, dh, bk,
                                        dtype_bytes=dtype_bytes,
                                        lengths=lengths)
        assert cost_model.quantized_decode_time_model(
            bkv, g, kv_len, dh, bk, chip=TPU_AS_CHIP, lengths=lengths) == \
            jcost.quantized_decode_time_model(bkv, g, kv_len, dh, bk,
                                              lengths=lengths)


def test_decode_laws_charge_the_cuda_core_rate():
    """The decode kernels compute in f32 on the CUDA cores whatever the
    cache holds: the H100's compute term is at 67 TFLOP/s."""
    res = cost_model.decode_time_model(32, 5, 624, 128, 128, dtype_bytes=2)
    assert res["compute_s"] == res["flops"] / hardware.H100_SXM.peak_flops_f32
    q8 = cost_model.quantized_decode_time_model(32, 5, 624, 128, 128)
    assert q8["compute_s"] == q8["flops"] / hardware.H100_SXM.peak_flops_f32


# -- the rankers ----------------------------------------------------------------

def _cands(ranked):
    return [(c.knobs, c.score, c.detail) for c in ranked]


@pytest.mark.parametrize("budget", [None, 1 << 20, 300_000, 1000])
@pytest.mark.parametrize("bh, sq, sk, dh", ATTN_CASES)
def test_rank_attention_blocks_equals_the_reference(bh, sq, sk, dh, budget):
    for causal, window in [(True, None), (True, 64), (False, None)]:
        for dtype_bytes in (2, 4):
            assert _cands(spec.rank_attention_blocks(
                bh, sq, sk, dh, smem_bytes=budget, dtype_bytes=dtype_bytes,
                causal=causal, window=window, chip=TPU_AS_CHIP)) == \
                _cands(jspec.rank_attention_blocks(
                    bh, sq, sk, dh, vmem_bytes=budget,
                    dtype_bytes=dtype_bytes, causal=causal, window=window))


@pytest.mark.parametrize("budget", [None, 300_000, 1000])
@pytest.mark.parametrize("bkv, g, kv_len, dh, lengths", DECODE_CASES)
def test_rank_decode_blocks_equal_the_reference(bkv, g, kv_len, dh, lengths,
                                                budget):
    for dtype_bytes in (2, 4):
        assert _cands(spec.rank_decode_blocks(
            bkv, g, kv_len, dh, smem_bytes=budget, dtype_bytes=dtype_bytes,
            lengths=lengths, chip=TPU_AS_CHIP)) == \
            _cands(jspec.rank_decode_blocks(
                bkv, g, kv_len, dh, vmem_bytes=budget,
                dtype_bytes=dtype_bytes, lengths=lengths))
    # the int8 ranking is the JAX package's decode_int8 enumeration
    problem = {"bkv": bkv, "g": g, "cache_len": kv_len, "dh": dh}
    if lengths:
        problem["lengths"] = tuple(lengths)
    mine = spec.rank_quantized_decode_blocks(
        bkv, g, kv_len, dh, smem_bytes=budget, lengths=lengths,
        chip=TPU_AS_CHIP)
    ref = jspec._decode_int8_enumerate(problem, 1, budget, 8)
    assert [(c.knobs, c.score) for c in mine] == \
        [(c.knobs, c.score) for c in ref]


def test_rankers_use_the_card_budget():
    """The H100's 227 KB hold the law's staging of a 128-key f32 block
    at head_dim 64 but not of a 256-key one."""
    ranked = spec.rank_decode_blocks(8, 4, 4096, 64, dtype_bytes=4)
    assert {c.knobs["block_k"] for c in ranked} == {128}
    assert spec.rank_decode_blocks(
        8, 4, 4096, 64, dtype_bytes=4, smem_bytes=10 ** 9)[0].knobs == \
        jspec.rank_decode_blocks(8, 4, 4096, 64, dtype_bytes=4,
                                 vmem_bytes=10 ** 9)[0].knobs


# -- the specs ------------------------------------------------------------------

def test_registry_holds_the_attention_families():
    assert {"attention", "decode", "decode_int8"} <= set(registry.families())
    for name in ("attention", "decode", "decode_int8"):
        assert name in registry.BUILTIN_FAMILIES
        with pytest.raises(ValueError, match="built-in"):
            registry.unregister(name)


@pytest.mark.parametrize("family, problem", [
    ("attention", {"bh": 320, "sq": 600, "sk": 600, "dh": 128,
                   "causal": True, "window": None}),
    ("attention", {"bh": 64, "sq": 2048, "sk": 2048, "dh": 80,
                   "causal": True, "window": 4096}),
    ("decode", {"bkv": 32, "g": 5, "cache_len": 624, "dh": 128}),
    ("decode", {"bkv": 32, "g": 5, "cache_len": 624, "dh": 128,
                "lengths": (601, 608, 612, 616)}),
    ("decode_int8", {"bkv": 32, "g": 5, "cache_len": 624, "dh": 128,
                     "lengths": (601, 616)}),
])
def test_cache_keys_are_the_reference_keys(family, problem):
    for dtype in ("float32", "bfloat16"):
        assert registry.get(family).key_fn(problem, dtype, "cpu") == \
            getattr(jspec, {"attention": "_attn_key_fn",
                            "decode": "_decode_key_fn",
                            "decode_int8": "_decode_int8_key_fn"}[family])(
                problem, dtype, "cpu")


@pytest.mark.parametrize("kv_len", [37, 624, 4096])
@pytest.mark.parametrize("family", ["decode", "decode_int8"])
def test_decode_specs_offer_every_clamped_span(family, kv_len):
    """Every candidate span, clamped to the cache depth as the JAX
    enumeration clamps it, whatever the budget: the CUDA kernels' shared
    memory does not grow with the span.  Scored by the law."""
    problem = {"bkv": 32, "g": 5, "cache_len": kv_len, "dh": 128}
    want = sorted({min(b, kv_len) for b in spec.DECODE_BLOCKS})
    s = registry.get(family)
    for budget in (None, 1000):
        cands = s.enumerate_candidates(problem, dtype_bytes=4,
                                       smem_bytes=budget, top=1)
        assert sorted(c.knobs["block_k"] for c in cands) == want
        for c in cands:
            assert c.score == s.cost_fn(problem, c.knobs, 4)["time_s"]


@pytest.mark.parametrize("dtype, dh", [(torch.bfloat16, 128),
                                       (torch.bfloat16, 80),
                                       (torch.float32, 128)])
def test_attention_spec_offers_the_design_tile_alone(dtype, dh):
    problem = {"bh": 320, "sq": 4096, "sk": 4096, "dh": dh, "causal": True,
               "window": None}
    plan = autotune.tune("attention", problem, dtype, device="cpu",
                         measure_k=0,
                         cache=autotune.TuneCache("/nonexistent/x.json"))
    bq, bk = flash.tile(dtype, dh)
    assert plan.knobs == {"block_q": bq, "block_k": bk}
    assert plan.model_time_s == cost_model.attention_time_model(
        320, 4096, 4096, dh, bq, bk,
        dtype_bytes=torch.empty((), dtype=dtype).element_size())["time_s"]


def test_flash_entry_refuses_a_tile_it_is_not_built_for():
    """The tile rule holds on the CPU too, before the plain version runs."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 20, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    bq, bk = flash.tile(torch.float32, 16)
    assert (bq, bk) == flash.TILES["f32"]
    out = flash.flash_attention(q, k, v, scale=0.25, block_q=bq, block_k=bk)
    torch.testing.assert_close(out, flash.flash_attention(q, k, v,
                                                          scale=0.25))
    with pytest.raises(ValueError, match="built for"):
        flash.flash_attention(q, k, v, scale=0.25, block_q=128, block_k=128)


@pytest.mark.parametrize("family", ["attention", "decode", "decode_int8"])
def test_dispatch_on_the_cpu_runs_the_plain_version(family):
    """CPU tensors take the family's plain version and pay no tuning."""
    s = registry.get(family)
    problem = ({"bh": 4, "sq": 30, "sk": 30, "dh": 16, "causal": True,
                "window": None} if family == "attention"
               else {"bkv": 6, "g": 2, "cache_len": 40, "dh": 16})
    inputs = s.make_inputs(problem, torch.float32, "cpu")
    want = s.reference_fn(*inputs)
    cache = autotune.TuneCache("/nonexistent/x.json")
    got = autotune.dispatch(family, *inputs, cache=cache)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cache.hits == cache.misses == 0
    # the launcher is the kernel entry at the plan's knobs
    knobs = s.enumerate_candidates(problem, 4, None, 1)[0].knobs
    torch.testing.assert_close(s.build_launcher(problem, knobs)(*inputs),
                               want, rtol=1e-6, atol=1e-6)


# -- the decode entries at every span against JAX --------------------------------

KV_LEN = 1100                 # candidates 128 .. 1024 and 2048 -> 1100
SPAN_LENGTHS = np.array([0, 1, 127, 128, 600, 1025, KV_LEN], np.int32)
SPANS = sorted({min(b, KV_LEN) for b in spec.DECODE_BLOCKS})


def _decode_inputs(seed, b=len(SPAN_LENGTHS), hq=4, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, dh)).astype(np.float32),
            rng.standard_normal((b, KV_LEN, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, KV_LEN, hkv, dh)).astype(np.float32))


def test_spans_include_one_clamped_to_the_cache():
    assert SPANS == [128, 256, 512, 1024, KV_LEN]


@pytest.mark.parametrize("span", SPANS)
def test_decode_entry_matches_the_pallas_kernel_at_each_span(span):
    q, k, v = _decode_inputs(0)
    want = np.asarray(jdecode.gqa_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        length=jnp.asarray(SPAN_LENGTHS), block_k=span, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lv = torch.from_numpy(SPAN_LENGTHS)
    got = decode.gqa_decode_attention(tq, tk, tv, length=lv, block_k=span)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    split = decode.split_decode_ref(tq, tk, tv, length=lv, span=span)
    np.testing.assert_allclose(split.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("span", SPANS)
def test_int8_entry_matches_the_pallas_kernel_at_each_span(span):
    q, k, v = _decode_inputs(1, dh=32)
    jkq, jks = jquantize.quantize_rows(jnp.asarray(k))
    jvq, jvs = jquantize.quantize_rows(jnp.asarray(v))
    want = np.asarray(jdecode_int8.quantized_gqa_decode_attention(
        jnp.asarray(q), jkq, jks, jvq, jvs,
        length=jnp.asarray(SPAN_LENGTHS), block_k=span, interpret=True))
    kq, ks = quantize.quantize_rows(torch.from_numpy(k))
    vq, vs = quantize.quantize_rows(torch.from_numpy(v))
    assert np.array_equal(kq.numpy(), np.asarray(jkq))
    tq, lv = torch.from_numpy(q), torch.from_numpy(SPAN_LENGTHS)
    got = decode_int8.quantized_gqa_decode_attention(
        tq, kq, ks, vq, vs, length=lv, block_k=span)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    split = decode.split_decode_ref(tq, quantize.dequantize_rows(kq, ks),
                                    quantize.dequantize_rows(vq, vs),
                                    length=lv, span=span)
    np.testing.assert_allclose(split.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", [0, -3, 1.5, True])
def test_decode_entries_refuse_a_span_that_is_not_a_positive_int(bad):
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(2))
    with pytest.raises(ValueError, match="block_k"):
        decode.gqa_decode_attention(q, k, v, length=5, block_k=bad)
    kq, ks = quantize.quantize_rows(k)
    with pytest.raises(ValueError, match="block_k"):
        decode_int8.quantized_gqa_decode_attention(q, kq, ks, kq, ks,
                                                   length=5, block_k=bad)
    assert decode.split_span(None) == decode.SPLIT_KEYS == 256
    assert decode.split_span(624) == 624



# -- the paper slice's report ----------------------------------------------------

def test_report_runner_writes_the_reference_report_keys(tmp_path,
                                                        monkeypatch):
    """`python -m repro_torch.benchmarks.run --smoke --device cpu`: the
    report has the JAX report's keys (the root BENCH_kernels.json, written
    by ``benchmarks/run.py``), each row holding every key of the JAX row
    but ``interpret`` (the port has no interpret mode), and passes
    `tools/check_bench.py` unchanged; the CPU measured nothing."""
    import io
    import json
    import pathlib
    import sys
    from contextlib import redirect_stdout

    from repro_torch.benchmarks import run
    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo / "tools"))
    import check_bench
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    out = tmp_path / "report.json"
    log = io.StringIO()
    with redirect_stdout(log):
        assert run.main(["--smoke", "--device", "cpu", "--out",
                         str(out)]) == 0
    report = json.loads(out.read_text())
    ref = json.loads((repo / "BENCH_kernels.json").read_text())
    assert set(report) == set(ref)
    assert report["backend"] == "cpu"
    for key, rows in ref.items():
        if isinstance(rows, dict):
            assert set(rows) - {"interpret"} <= set(report[key]), key
            if "measured" in report[key]:
                assert report[key]["measured"] is False, key
        elif isinstance(rows, list):
            assert set(rows[0]) - {"interpret"} <= set(report[key][0]), key
    assert check_bench.check(out) == []
    assert report["attention_measured"]["speedup_vs_fixed"] == 1.0
    assert report["attention_decode"]["tuned_us"] is None
    text = log.getvalue()
    assert text.startswith("name,us_per_call,derived")
    assert "roofline.unavailable" in text and "bandwidth.spmv_smem_x" in text
