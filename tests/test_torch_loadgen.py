"""The port's load harness against the JAX package's: `runtime/loadgen.py`
(samplers, traces, the virtual clock, the arrival sources,
`collect_metrics`, `strip_volatile`), ``serve --load-trace`` and
`benchmarks/serving_load.py` (`run_mix`, the paging block).

Everything here is seeded numpy and the same float arithmetic in the same
order on both sides, so it is compared with ``==``: traces record for
record, reports after `strip_volatile` (which drops the wall clock).  The
harness prices steps with the tuner's model: the JAX package prices its
TPU, so the port is given `TPU_AS_CHIP`, and `plan_for_model` is replaced
in both engines by one table of model times (the matmul specs differ by
design; tests/test_torch_serving_plan.py holds the rest of the pricing
to the JAX package's).
"""

import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.runtime import loadgen as jloadgen  # noqa: E402
from repro.runtime.lifecycle import Lifecycle as JLifecycle  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.benchmarks import serving_load  # noqa: E402
from repro_torch.core import hardware  # noqa: E402
from repro_torch.kernels import autotune, registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime import loadgen  # noqa: E402
from repro_torch.runtime.lifecycle import Lifecycle as TLifecycle  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import check_load  # noqa: E402

sys.path.insert(0, str(REPO))
from benchmarks import serving_load as jserving_load  # noqa: E402

TPU_AS_CHIP = hardware.Chip(
    variant="TPU v5e (the JAX package's numbers)",
    peak_flops=TPU_V5E.peak_flops, peak_flops_f32=TPU_V5E.peak_flops,
    hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
    link_bw=TPU_V5E.ici_bw_per_link, smem_bytes=TPU_V5E.usable_vmem())
OPS = ("qkv_proj", "out_proj", "ffn_up", "ffn_down", "logits")


@pytest.fixture(autouse=True)
def _own_tune_caches(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "j.json"))


# -- samplers, traces, the clock ----------------------------------------------

DISTS = [{"kind": "fixed", "value": 7},
         {"kind": "uniform", "lo": 3, "hi": 40},
         {"kind": "choice", "values": [4, 8, 16], "weights": [0.5, 0.3, 0.2]},
         {"kind": "choice", "values": [2, 9]},
         {"kind": "staggered", "base": 600, "spread": 16},
         {"kind": "lognormal", "mean": 8, "sigma": 0.6, "lo": 4, "hi": 48}]
TIMES = [{"kind": "fixed", "value": 0.25},
         {"kind": "uniform", "lo": 0.1, "hi": 2.0},
         {"kind": "exponential", "mean": 5.0}]


@pytest.mark.parametrize("seed", [0, 11, 19])
@pytest.mark.parametrize("dist", DISTS, ids=lambda d: d["kind"])
def test_sample_lengths_equal_the_reference(dist, seed):
    for n in (1, 10, 33):
        assert loadgen.sample_lengths(np.random.default_rng(seed), n, dist) \
            == jloadgen.sample_lengths(np.random.default_rng(seed), n, dist)


@pytest.mark.parametrize("dist", TIMES, ids=lambda d: d["kind"])
def test_sample_times_equal_the_reference(dist):
    for seed in (2, 17):
        assert loadgen.sample_times(np.random.default_rng(seed), 12, dist) \
            == jloadgen.sample_times(np.random.default_rng(seed), 12, dist)


def test_unknown_distributions_raise_like_the_reference():
    for fn in ("sample_lengths", "sample_times"):
        for mod in (loadgen, jloadgen):
            with pytest.raises(ValueError, match="unknown"):
                getattr(mod, fn)(np.random.default_rng(0), 3, {"kind": "x"})


@pytest.mark.parametrize("rate", [0.0, 3.0, 250.0])
def test_make_trace_equals_the_reference(rate):
    kw = dict(seed=7, n=16, rate_rps=rate, prompt_dist=DISTS[1],
              gen_dist=DISTS[2], think_dist=TIMES[2], start_s=0.5,
              ttft_deadline_s=0.2, deadline_s=None)
    assert [t.record() for t in loadgen.make_trace(**kw)] == \
        [t.record() for t in jloadgen.make_trace(**kw)]


def test_traces_cross_between_the_packages(tmp_path):
    """A trace either package saves, the other loads record for record;
    the sessions cut from it and the prompts drawn for it agree."""
    trace = jloadgen.make_trace(seed=3, n=9, rate_rps=4.0,
                                prompt_dist=DISTS[5], gen_dist=DISTS[0])
    jloadgen.save_trace(tmp_path / "j.jsonl", trace)
    mine = loadgen.load_trace(tmp_path / "j.jsonl")
    assert [t.record() for t in mine] == [t.record() for t in trace]
    loadgen.save_trace(tmp_path / "t.jsonl", mine)
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    for n in (1, 3, 4):
        assert [[t.record() for t in s] for s in
                loadgen.sessions_from_trace(mine, n)] == \
            [[t.record() for t in s] for s in
             jloadgen.sessions_from_trace(trace, n)]
    for rid in range(5):
        np.testing.assert_array_equal(
            loadgen.prompt_tokens(11, rid, 13, 151936),
            jloadgen.prompt_tokens(11, rid, 13, 151936))


def test_load_trace_fails_loudly_like_the_reference(tmp_path):
    good = json.dumps(loadgen.TraceRequest(0, 0.0, 4, 4).record())
    (tmp_path / "mid.jsonl").write_text(good + "\n{oops\n" + good + "\n")
    (tmp_path / "torn.jsonl").write_text(good + "\n" + good[:20])
    for name, match in (("mid", "corrupt trace line"),
                        ("torn", "partial final line")):
        for mod in (loadgen, jloadgen):
            with pytest.raises(mod.TraceError, match=match):
                mod.load_trace(tmp_path / f"{name}.jsonl")


def test_virtual_clock_and_step_floor_equal_the_reference():
    for step_s in (1e-3, 6.3e-3):
        mine, ref = loadgen.VirtualClock(step_s, 0.5), \
            jloadgen.VirtualClock(step_s, 0.5)
        for step in (0, 3, 17):
            mine.on_step(step)
            ref.on_step(step)
            assert mine() == ref()
        for t in (0.0, 0.5, 0.51, 1.0, 7.3):
            assert mine.step_for(t) == ref.step_for(t)
    for us in (0.4, 999.0, 1000.0, 6316.3):
        assert loadgen.virtual_step_us(us) == jloadgen.virtual_step_us(us)
    with pytest.raises(ValueError):
        loadgen.VirtualClock(0.0)


def test_strip_volatile_equals_the_reference():
    row = {"a": 1, "wall": {"wall_s": 2}, "rows": [
        {"measured_step_us": 3, "x": [{"step_time_ratio": 1, "y": 2}]}],
        "predicted_vs_measured": {"predicted_step_us": 5,
                                  "divergence": 1.1}}
    assert loadgen.strip_volatile(row) == jloadgen.strip_volatile(row)
    assert loadgen.VOLATILE_FIELDS == jloadgen.VOLATILE_FIELDS


# -- the sources and the metrics, through both serve loops --------------------

def _cfgs():
    from repro.models.config import ModelConfig as JConfig
    from repro_torch.models.config import ModelConfig as TConfig
    base = dict(name="tiny-load", family="dense", num_layers=2, d_model=32,
                d_ff=64, vocab_size=101, num_heads=4, num_kv_heads=2)
    return JConfig(**base), TConfig(**base)


def _run_both(trace, batch, *, sessions=0, queue_limit=0, step_s=1e-3):
    """One trace through the JAX and the port serve loop on the virtual
    clock (each with its own random weights: the metrics are token counts
    and clock readings), returning both lifecycles, stats and metrics."""
    from repro_torch.convert import params_from_numpy
    import jax
    jcfg, tcfg = _cfgs()
    out = []
    for pkg, cfg, lgen, Lc in ((jserve, jcfg, jloadgen, JLifecycle),
                               (tserve, tcfg, loadgen, TLifecycle)):
        if pkg is jserve:
            server = pkg.Server(cfg, batch, 40, autotune_kernels=False)
            params = server.params
        else:
            server = pkg.Server(cfg, batch, 40, autotune_kernels=False,
                                device="cpu", params=params_from_numpy(
                                    jax.tree.map(np.asarray, params)))
        lc = Lc(queue_limit=queue_limit, clock=lgen.VirtualClock(step_s))
        src = (lgen.SessionSource(lgen.sessions_from_trace(trace, sessions),
                                  cfg.vocab_size, seed=4) if sessions
               else lgen.TraceSource(trace, cfg.vocab_size, seed=4))
        rec = lgen.StepTimeRecorder()
        stats = pkg.serve_loop(server, lc, watchdog=rec, source=src)
        metrics = lgen.collect_metrics(lc, predicted_step_us=step_s * 1e6,
                                       step_times=rec.times,
                                       queue_depth=src.queue_depth)
        out.append((lc, stats, metrics))
    return out


@pytest.mark.parametrize("sessions, rate, queue_limit", [
    (0, 300.0, 0),         # open loop, near capacity
    (0, 3000.0, 2),        # overload with backpressure: REJECTED requests
    (3, 0.0, 0),           # closed loop with think times
])
def test_sources_and_metrics_equal_the_reference(sessions, rate,
                                                 queue_limit):
    trace = jloadgen.make_trace(
        seed=5, n=10, rate_rps=rate,
        prompt_dist={"kind": "uniform", "lo": 3, "hi": 9},
        gen_dist={"kind": "choice", "values": [2, 5, 9]},
        think_dist={"kind": "exponential", "mean": 0.004})
    (jlc, jstats, jm), (tlc, tstats, tm) = _run_both(
        trace, 2, sessions=sessions, queue_limit=queue_limit)
    assert loadgen.strip_volatile(tm) == jloadgen.strip_volatile(jm)
    assert tlc.outcome_trace() == jlc.outcome_trace()
    for key in ("generated", "steps", "max_concurrent"):
        assert tstats[key] == jstats[key], key
    assert tm["conserved"] and tm["ttft_ms"]["n"] > 0
    assert set(tm["requests"][0]) >= {"measured_step_us", "per_token_ms"}
    if queue_limit:
        assert tm["outcomes"]["rejected"] > 0


def test_load_trace_replay_equals_the_jax_replay(tmp_path):
    """A trace the JAX harness emits, replayed through both serving CLIs
    at one ``--step-time-us``: the ``load`` block, the latency
    percentiles and the outcomes are equal."""
    trace, _ = jserving_load.build_trace(jserving_load.MIXES["bursty"], 12,
                                         1e-3, 2)
    path = tmp_path / "bursty.jsonl"
    jloadgen.save_trace(path, trace)
    logs = []
    for pkg, extra in ((jserve, []), (tserve, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = pkg.main(["--arch", "qwen3_14b", "--smoke", "--batch", "2",
                           "--load-trace", str(path), "--step-time-us",
                           "1500", *extra])
        assert rc == 0
        logs.append(json.loads(buf.getvalue().splitlines()[-1]))
    want, got = logs
    assert got["load"] == want["load"]
    assert got["load"]["step_time_us"] == 1500.0
    assert got["load"]["queue_depth_max"] > 0
    for key in ("ttft_ms", "per_token_ms", "outcomes", "request_outcomes",
                "decode_steps", "tokens_generated"):
        assert got[key] == want[key], key


# -- the harness --------------------------------------------------------------

def _plans(pkg_registry, op_plan, cfg, batch, kw):
    """One table of model times for both engines: the matmul ops grow with
    the batch, the decode plan is the law's at a span of 256."""
    plans = [op_plan(op, pkg_registry.Plan(
        "matmul", f"matmul:{op}:{batch}", {"m": batch, "n": 64, "k": 64},
        {"tile": [64, 64, 32]}, "model",
        (1 + i) * 1e-6 + batch * 3e-7)) for i, op in enumerate(OPS)]
    quantized = "int8" in str(kw.get("kv_dtype"))
    fam = "decode_int8" if quantized else "decode"
    problem = {"bkv": batch * cfg.num_kv_heads,
               "g": cfg.num_heads // cfg.num_kv_heads,
               "cache_len": kw["cache_len"], "dh": cfg.head_dim}
    plans.append(op_plan("attn_decode", pkg_registry.Plan(
        fam, f"{fam}:{batch}", problem, {"block_k": 256}, "model",
        2e-6 * batch)))
    return plans


@pytest.fixture
def one_plan_table(monkeypatch):
    jcfg = jconfigs.get_smoke("qwen3_14b")
    tcfg = tconfigs.get_smoke("qwen3_14b")

    def fake(pkg_registry, op_plan, cfg):
        return lambda _cfg, batch, **kw: _plans(pkg_registry, op_plan, cfg,
                                                batch, kw)
    monkeypatch.setattr(jautotune, "plan_for_model",
                        fake(jregistry, jautotune.OpPlan, jcfg))
    monkeypatch.setattr(autotune, "plan_for_model",
                        fake(registry, autotune.OpPlan, tcfg))
    return jcfg, tcfg


@pytest.mark.parametrize("mix", ["steady", "interactive"])
def test_run_mix_equals_the_reference(one_plan_table, mix, tmp_path):
    """`run_mix` at the smoke counts: the whole row after
    `strip_volatile` (trace, batch decision, step time, latencies,
    outcomes, queue timeline, SLOs) equals the JAX harness's, and the
    emitted trace files are byte-equal."""
    jcfg, tcfg = one_plan_table
    spec = jserving_load.MIXES[mix]
    assert serving_load.MIXES[mix] == spec
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = jserving_load.run_mix(jcfg, mix, spec, smoke=True,
                                 emit_dir=tmp_path / "j")
    got = serving_load.run_mix(tcfg, mix, spec, smoke=True,
                               emit_dir=tmp_path / "t", device="cpu",
                               chip=TPU_AS_CHIP)
    assert loadgen.strip_volatile(got) == jloadgen.strip_volatile(want)
    assert (tmp_path / "t" / f"{mix}.jsonl").read_bytes() == \
        (tmp_path / "j" / f"{mix}.jsonl").read_bytes()
    assert got["slo_ok"] and got["wall"]["wall_s"] > 0


def test_paging_block_equals_the_reference(one_plan_table):
    jcfg, tcfg = one_plan_table
    want = jserving_load.measure_paging(jcfg, smoke=True)
    got = serving_load.measure_paging(tcfg, smoke=True, device="cpu",
                                      chip=TPU_AS_CHIP)
    assert loadgen.strip_volatile(got) == jloadgen.strip_volatile(want)
    assert got["ratio_ok"] and got["concurrency_ratio"] >= 1.5


def test_harness_cli_passes_check_load_and_its_replay_matches(tmp_path):
    """The port's harness on the CPU (SMOKE config, smoke counts) writes a
    report that passes the unchanged ``tools/check_load.py``; replaying
    its emitted steady trace through ``serve --load-trace`` gives the
    steady mix's TTFT and per-token percentiles."""
    out, traces = tmp_path / "s.json", tmp_path / "traces"
    with redirect_stdout(io.StringIO()):
        assert serving_load.main(["--smoke", "--device", "cpu", "--out",
                                  str(out), "--emit-traces",
                                  str(traces)]) == 0
    assert check_load.check(out) == []
    report = json.loads(out.read_text())
    assert set(report["mixes"]) == set(jserving_load.MIXES)
    assert report["device"] == "cpu" and report["recovery"]["conserved"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tserve.main(["--smoke", "--device", "cpu", "--load-trace",
                            str(traces / "steady.jsonl")]) == 0
    summary = json.loads(buf.getvalue().splitlines()[-1])
    steady = report["mixes"]["steady"]
    assert summary["ttft_ms"] == steady["ttft_ms"]
    assert summary["per_token_ms"] == steady["per_token_ms"]
    assert summary["load"]["step_time_us"] == steady["step_time_us"]
