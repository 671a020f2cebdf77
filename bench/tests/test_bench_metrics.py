"""Each metric reader on a synthetic run: stamps, requests and a trace
made by hand."""

import pytest

from bench import counts, devtrace, spec
from bench.harness import Run
from bench.timed import Record
from conftest import SMOKE

CHIP = counts.PEAKS["NVIDIA H100 80GB HBM3"]


class _Req:
    def __init__(self, rid, submit, first):
        self.rid, self.submit_t, self.first_token_t = rid, submit, first


def _run(trace=None):
    m = dict(SMOKE["qwen2_5_32b"])
    recs = [
        # before the window: ignored
        Record("admit", 0, 0.0, 0.5, 8, [(0, 0, 8), (1, 0, 6)], [10, 11]),
        Record("decode", 1, 1.0, 1.1, 1, [(0, 8, 1), (1, 6, 1)], [10, 11]),
        Record("admit", 2, 1.1, 1.5, 10, [(0, 9, 1), (1, 7, 1),
                                          (2, 0, 10)], [10, 11, 12]),
        Record("decode", 3, 1.5, 1.7, 1, [(0, 10, 1), (1, 8, 1),
                                          (2, 10, 1)], [10, 11, 12]),
        # after the window: ignored
        Record("decode", 4, 2.0, 2.2, 1, [(0, 11, 1)], [10]),
    ]
    reqs = [_Req(10, -1.0, 0.5), _Req(11, -1.0, 0.5), _Req(12, 1.0, 1.5)]
    return Run(m, 4, 0.0, 1.0, 2.0, recs, reqs, CHIP, 12_000_000_000,
               trace)


def _read(name, run):
    return spec.reader(name)(run)


def test_host_clock_metrics():
    run = _run()
    assert _read("output_tok_s", run) == pytest.approx(8 / 1.0)
    assert _read("setup_s", run) == 1.0
    assert _read("ttft_mean_ms", run) == pytest.approx(500.0)
    # request 10: 1.1, 1.5, 1.7 -> gaps .4 .2; 11 the same; 12 one gap .2
    gaps = [0.4, 0.2, 0.4, 0.2, 0.2]
    import numpy as np
    assert _read("itl_p95_ms", run) == pytest.approx(
        1e3 * np.percentile(gaps, 95))
    assert _read("admit_ms", run) == pytest.approx(400.0)
    assert _read("decode_step_ms", run) == pytest.approx(150.0)
    # the window's one admission: 4 x 10 positions, 12 carried
    assert _read("admit_pad_share", run) == pytest.approx(100 * 28 / 40)
    assert _read("peak_hbm_gb", run) == 12.0


def test_a_traced_runs_host_clock_ends_where_the_profiler_starts():
    """With the profiler started at 1.6 s, the decode call that ended at
    1.7 s under it is left out of every host-clock reading."""
    run = _run()
    run.t_trace = 1.6
    assert run.seconds == pytest.approx(0.6)
    assert _read("decode_step_ms", run) == pytest.approx(100.0)
    assert _read("admit_ms", run) == pytest.approx(400.0)
    flops = sum(counts.forward_flops(run.model, r.rows, len(r.emitted))
                for r in run.records[1:3])
    assert _read("serve_mfu", run) == pytest.approx(
        100 * flops / (0.6 * 989e12))


def test_serve_mfu_counts_the_window():
    run = _run()
    flops = sum(counts.forward_flops(run.model, r.rows, len(r.emitted))
                for r in run.records[1:4])
    assert _read("serve_mfu", run) == pytest.approx(
        100 * flops / 989e12)
    run.chip = None
    assert _read("serve_mfu", run) is None


def _trace():
    ms = 1_000_000
    spans = [("bench.decode#1", 1000 * ms, 1100 * ms),
             ("bench.admit#2", 1100 * ms, 1500 * ms),
             ("bench.decode#3", 1500 * ms, 1700 * ms),
             ("bench.source", 1700 * ms, 1710 * ms)]
    b1 = "void decode_kernel<__nv_bfloat16, false, 5>(Args<__nv_bfloat16>)"
    dev = [(b1, 1050 * ms, 1052 * ms), (b1, 1060 * ms, 1062 * ms),
           ("gemm", 1200 * ms, 1400 * ms),
           (b1, 1600 * ms, 1604 * ms),
           ("void decode_kernel<__nv_bfloat16, true, 5>(x)",
            1650 * ms, 1651 * ms)]
    return devtrace.Trace((1000 * ms, 2000 * ms), dev, spans)


def test_device_metrics_from_a_trace():
    tr = _trace()
    run = _run(tr)
    assert devtrace.busy_s(tr) == pytest.approx(0.209)
    assert _read("device_idle_share", run) == pytest.approx(100 * 0.791)
    m = run.model
    per1 = counts.decode_attention_bound_s(m, [9, 7], CHIP)
    per3 = counts.decode_attention_bound_s(m, [11, 9, 11], CHIP)
    assert _read("b1_roofline", run) == pytest.approx(
        100 * (2 * per1 + per3) / 0.008)
    bd = devtrace.breakdown(tr)
    assert bd["device_ops"][0] == ["gemm", pytest.approx(0.2)]
    idle = dict(bd["idle_gaps"])
    # 1000-1050, 1052-1060, 1062-1100 decode; 1100-1200, 1400-1500
    # admit; 1500-1600, 1604-1650, 1651-1700 decode; 1700-1710 source;
    # 1710-2000 loop
    assert idle["decode"] == pytest.approx(0.05 + 0.008 + 0.038 + 0.1
                                           + 0.046 + 0.049)
    assert idle["admit"] == pytest.approx(0.2)
    assert idle["source"] == pytest.approx(0.01)
    assert idle["loop"] == pytest.approx(0.29)


def test_readers_without_a_trace_report_nothing():
    run = _run()
    for name in ("b1_roofline", "device_idle_share"):
        assert _read(name, run) is None
    run.records = []
    assert _read("admit_ms", run) is None
    assert _read("admit_pad_share", run) is None
