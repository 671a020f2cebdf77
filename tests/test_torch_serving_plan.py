"""The serving plans of the tuning engine against the JAX package's:
`_quantile_lengths`, `predict_decode_step_us` and `select_serving_batch`
record for record when both engines price the same plans (the matmul
specs differ by design, so `plan_for_model` is replaced in both by one
table of model times); `plan_for_model`'s decode plan and its pinning
under the runtime key; the server's span resolved once at start-up and
handed to every layer; and ``serve`` with its default ``--batch 0`` on
the CPU.

The sweep and the step prediction are the same float arithmetic in the
same order on both sides, compared with ``==``; the JAX package prices its
TPU, so the port is given `TPU_AS_CHIP`, the TPU's numbers as a `Chip`.
"""

import io
import pathlib
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import hardware  # noqa: E402
from repro_torch.kernels import autotune, registry  # noqa: E402
from repro_torch.kernels.attention import decode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import check_serve  # noqa: E402

TPU_AS_CHIP = hardware.Chip(
    variant="TPU v5e (the JAX package's numbers)",
    peak_flops=TPU_V5E.peak_flops, peak_flops_f32=TPU_V5E.peak_flops,
    hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
    link_bw=TPU_V5E.ici_bw_per_link, smem_bytes=TPU_V5E.usable_vmem())
KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16),
      "int8": (jnp.int8, torch.int8)}
OPS = ("qkv_proj", "out_proj", "ffn_up", "ffn_down", "logits")


@pytest.fixture(autouse=True)
def _own_tune_caches(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "j.json"))


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 8, 32])
@pytest.mark.parametrize("dist", [[600, 604, 612, 615], list(range(0, 900, 7)),
                                  [5], [3000, 2, 40, 17, 17]])
def test_quantile_lengths_equal_the_reference(batch, dist):
    for cache_len in (616, 624, 64):
        assert autotune._quantile_lengths(batch, dist, cache_len) == \
            jautotune._quantile_lengths(batch, dist, cache_len)


def _plans(pkg_registry, op_plan, cfg, batch, cache_len, kv, decode_plan):
    """One table of model times for both engines: the matmul ops grow
    with the batch, the decode plan is the law's at a span of 256 (or
    none)."""
    plans = [op_plan(op, pkg_registry.Plan(
        "matmul", f"matmul:{op}:{batch}", {"m": batch, "n": 64, "k": 64},
        {"tile": [64, 64, 32]}, "model",
        (1 + i) * 1e-6 + batch * 3e-7)) for i, op in enumerate(OPS)]
    if decode_plan:
        fam = "decode_int8" if kv == "int8" else "decode"
        problem = {"bkv": batch * cfg.num_kv_heads,
                   "g": cfg.num_heads // cfg.num_kv_heads,
                   "cache_len": cache_len, "dh": cfg.head_dim}
        plans.append(op_plan("attn_decode", pkg_registry.Plan(
            fam, f"{fam}:{batch}", problem, {"block_k": 256}, "model",
            2e-6 * batch)))
    return plans


def _patch(monkeypatch, cache_len, kv, decode_plan, arch="qwen3_14b"):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)

    def fake(pkg_registry, op_plan, cfg):
        return lambda _cfg, batch, **kw: _plans(
            pkg_registry, op_plan, cfg, batch, cache_len, kv, decode_plan)
    monkeypatch.setattr(jautotune, "plan_for_model",
                        fake(jregistry, jautotune.OpPlan, jcfg))
    monkeypatch.setattr(autotune, "plan_for_model",
                        fake(registry, autotune.OpPlan, tcfg))
    return jcfg, tcfg


SWEEP_CASES = [
    # kv, decode plan, slot lengths, latency budget (ms), paging
    ("f32", True, None, None, None),
    ("f32", True, [600, 604, 608, 612, 616], None, None),
    ("bf16", True, [600, 616], 0.05, None),       # some batches too slow
    ("f32", True, [600, 616], 1e-6, None),        # none fits: least bad
    ("int8", True, [600, 608, 616], None, None),
    ("f32", False, [600, 616], None, None),       # no decode plan
    ("int8", False, None, None, None),
    ("f32", True, [600, 616], None, (16, None)),  # free-page term
    ("f32", True, [600, 616], None, (16, 100)),   # small pool
    ("int8", True, [600, 616], 1e-6, (16, 60)),   # no fit, no budget
]


@pytest.mark.parametrize("kv, decode_plan, dist, budget, paging", SWEEP_CASES)
def test_select_serving_batch_equals_the_reference(monkeypatch, kv,
                                                   decode_plan, dist, budget,
                                                   paging):
    cache_len = 624
    jcfg, tcfg = _patch(monkeypatch, cache_len, kv, decode_plan)
    page_size, pool = paging or (None, None)
    common = dict(cache_len=cache_len, prefill_len=600,
                  candidates=(1, 2, 4, 8, 16, 32), latency_budget_ms=budget,
                  slot_lengths=dist, pool_pages=pool, page_size=page_size)
    want = jautotune.select_serving_batch(jcfg, kv_dtype=KV[kv][0], **common)
    got = autotune.select_serving_batch(tcfg, kv_dtype=KV[kv][1],
                                        chip=TPU_AS_CHIP, **common)
    assert got == want
    if paging and pool:
        assert not all(r["kv_fits"] for r in got["sweep"])


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("decode_plan", [True, False])
def test_predict_decode_step_us_equals_the_reference(monkeypatch, kv,
                                                     decode_plan):
    jcfg, tcfg = _patch(monkeypatch, 624, kv, decode_plan)
    for batch in (1, 4, 7):
        for lengths in (None, [600, 616, 3, 0, 624, 9, 12][:batch]):
            for block_k in (None, 16):
                common = dict(cache_len=624, lengths=lengths,
                              block_k=block_k)
                assert autotune.predict_decode_step_us(
                    tcfg, batch, kv_dtype=KV[kv][1], chip=TPU_AS_CHIP,
                    **common) == jautotune.predict_decode_step_us(
                    jcfg, batch, kv_dtype=KV[kv][0], **common)


FAMILY_ARCHS = ("h2o_danube_1_8b", "phi3_5_moe_42b", "qwen3_moe_235b",
                "rwkv6_7b", "jamba_1_5_large_398b", "internvl2_2b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_plans_and_sweep_equal_the_reference(monkeypatch, arch):
    """The other families' serving decisions at full width: the ops and
    problems `plan_for_model` tunes (no attention plans for RWKV6), the
    attention layers the step prices (Jamba's 9 of 72), and, over one
    table of model times, the sweep's record and the step prediction."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert autotune._attn_layer_count(tcfg) == \
        jautotune._attn_layer_count(jcfg)
    common = dict(prefill_len=600, cache_len=624, slot_lengths=[600, 616])
    want = jautotune.plan_for_model(jcfg, 4, kv_dtype=jnp.float32, **common)
    got = autotune.plan_for_model(tcfg, 4, kv_dtype=torch.float32, **common)
    assert [(p.op, p.plan.family, p.plan.problem) for p in got] == \
        [(p.op, p.plan.family, p.plan.problem) for p in want]
    has_decode = bool(tcfg.num_heads and tcfg.num_kv_heads)
    assert any(p.op == "attn_decode" for p in got) == has_decode
    _patch(monkeypatch, 624, "f32", has_decode, arch)
    sweep = dict(cache_len=624, prefill_len=600, candidates=(1, 2, 4, 8),
                 slot_lengths=[600, 604, 616])
    assert autotune.select_serving_batch(
        tcfg, kv_dtype=torch.float32, chip=TPU_AS_CHIP, **sweep) == \
        jautotune.select_serving_batch(jcfg, kv_dtype=jnp.float32, **sweep)
    for lengths in (None, [600, 616, 3, 0]):
        assert autotune.predict_decode_step_us(
            tcfg, 4, cache_len=624, lengths=lengths, chip=TPU_AS_CHIP) == \
            jautotune.predict_decode_step_us(jcfg, 4, cache_len=624,
                                             lengths=lengths)


def test_no_plan_fallback_prices_the_port_chip(monkeypatch):
    """Without a decode plan the KV stream is priced at the chip's memory
    rate: the H100's by default, never the TPU's."""
    _, tcfg = _patch(monkeypatch, 624, "f32", False)
    h100 = autotune.predict_decode_step_us(tcfg, 4, cache_len=624,
                                           kv_dtype=torch.float32)
    tpu = autotune.predict_decode_step_us(tcfg, 4, cache_len=624,
                                          kv_dtype=torch.float32,
                                          chip=TPU_AS_CHIP)
    kv_bytes = 2.0 * 4 * 624 * tcfg.kv_dim * 4 * tcfg.num_layers
    assert tpu - h100 == pytest.approx(
        kv_bytes / TPU_V5E.hbm_bw * 1e6 - kv_bytes / 3.35e12 * 1e6,
        rel=1e-9)


def test_plan_for_model_pins_the_workload_span(tmp_path):
    """The decode plan is tuned at the batch's quantiles of the workload
    and its span pinned under the plain key; a measured entry there is
    never overwritten."""
    cfg = tconfigs.get("qwen3_14b")
    cache = autotune.TuneCache(tmp_path / "a.json")
    dist = [600 + i for i in range(0, 16, 2)]
    plans = autotune.plan_for_model(cfg, 4, prefill_len=600, cache_len=624,
                                    kv_dtype=torch.float32,
                                    slot_lengths=dist, cache=cache)
    assert [p.op for p in plans] == [*OPS, "attn_prefill", "attn_decode"]
    dp = plans[-1].plan
    assert dp.problem["lengths"] == tuple(
        autotune._quantile_lengths(4, dist, 624))
    run = {"bkv": 32, "g": 5, "cache_len": 624, "dh": 128}
    spec = registry.get("decode")
    key = autotune.cache_key(spec, run, "float32", "cpu", None)
    pinned = cache._load()["entries"][key]
    assert pinned["knobs"] == dp.knobs
    assert pinned["detail"] == {"pinned_from": dp.key}
    assert pinned["model_time_s"] == spec.cost_fn(run, dp.knobs)["time_s"]
    cache.put(key, {**pinned, "knobs": {"block_k": 128},
                    "source": "measured", "measured_us": 9.0})
    autotune.plan_for_model(cfg, 4, cache_len=624, kv_dtype=torch.float32,
                            slot_lengths=dist, cache=cache)
    assert cache._load()["entries"][key]["knobs"] == {"block_k": 128}
    # an int8 cache takes the quantized family, keyed on bf16 activations
    q8 = autotune.plan_for_model(cfg, 4, cache_len=624,
                                 kv_dtype=torch.int8, cache=cache)[-1].plan
    assert q8.family == "decode_int8" and ":q8:bfloat16:" in q8.key


def test_server_resolves_the_span_once(monkeypatch):
    """The server takes its decode span from its ``attn_decode`` plan when
    it is built and hands it to every layer with the cache; decode steps
    look up no plan.  A paged server decodes at the kernels' default."""
    from repro_torch.runtime import paging
    cfg = tconfigs.get_smoke("qwen3_14b")
    paged = serve.Server(cfg, 2, 40, device="cpu",
                         paged=paging.PageSpec.build(2, 40, 4))
    assert paged.decode_span is None and "decode_span" not in paged.cache
    assert any(p.op == "attn_decode" for p in paged.kernel_plan)
    server = serve.Server(cfg, 2, 40, device="cpu", prefill_len=8,
                          slot_lengths=[10, 20, 30])
    plan = next(p for p in server.kernel_plan if p.op == "attn_decode")
    assert server.decode_span == plan.plan.knobs["block_k"] is not None
    assert server.cache["decode_span"] == server.decode_span
    spans, tunes = [], []
    real = decode.gqa_decode_attention

    def spy(*a, block_k=None, **kw):
        spans.append(block_k)
        return real(*a, block_k=block_k, **kw)
    monkeypatch.setattr(decode, "gqa_decode_attention", spy)
    monkeypatch.setattr(autotune, "tune",
                        lambda *a, **kw: tunes.append(a) or 1 / 0)
    server.prefill(0, 0, [1, 2, 3, 4], 5)
    for _ in range(3):
        server.decode_step()
    assert spans == [server.decode_span] * (3 * cfg.num_layers)
    assert not tunes
    assert server.cache["decode_span"] == server.decode_span


def _run_main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("flags", [[], ["--kv-dtype", "int8"],
                                   ["--paged", "--sched", "spf"],
                                   ["--latency-budget-ms", "1e-9"]])
def test_serve_smoke_defaults_to_the_sweep(flags):
    """`serve --smoke --device cpu` with no ``--batch``: the serving plan
    comes from the sweep (``"source": "autotune"``, priced for the H100 of
    the data sheet), the summary carries the server's plans, and the log
    passes `tools/check_serve.py`."""
    rc, log = _run_main(["--smoke", "--device", "cpu", *flags])
    assert rc == 0
    assert check_serve.check(log) == []
    lines = check_serve._json_lines(log)
    plan = lines[0]["serving_plan"]
    assert plan["source"] == "autotune"
    assert plan["chip"] == hardware.H100_SXM.variant
    assert plan["length_model"] == "active-prefix"
    assert [r["batch"] for r in plan["sweep"]] == [1, 2, 4]
    if "--latency-budget-ms" in flags:      # nothing fits: least bad
        assert plan["batch"] == min(plan["sweep"],
                                    key=lambda r: r["step_us"])["batch"]
    summary = lines[-1]
    assert summary["batch"] == plan["batch"]
    assert summary["kernel_plan"]
    decode_plan = summary["kernel_plan"][-1]
    assert decode_plan["op"] == "attn_decode"
    assert decode_plan["family"] == ("decode_int8" if "int8" in flags
                                     else "decode")
    assert summary["decode_span"] == (
        None if "--paged" in flags else decode_plan["knobs"]["block_k"])
    assert summary["watchdog"]["predicted_step_us"] > 0
