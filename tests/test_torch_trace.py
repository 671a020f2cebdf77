"""`repro_torch.runtime.trace`: the tracer alone (off, nesting, its bound,
the profiler's ranges), and the serving path's spans and the server's
position counts on a SMOKE-sized server on the CPU, counted by hand."""

import gc
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import loadgen, paging, trace
from repro_torch.runtime.lifecycle import Lifecycle

LAYERS = 2


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def test_off_records_nothing_and_makes_no_span():
    assert trace.span("a", x=1) is trace.span("b") is trace.NO_SPAN

    def loop():
        for _ in range(10_000):
            with trace.span("model.attn"):
                pass
    loop()
    gc.collect()
    before = sys.getallocatedblocks()
    loop()
    assert sys.getallocatedblocks() - before < 16
    assert trace.records() == [] and trace.dropped() == 0


def test_measure_stamps_while_off_and_records_only_while_on():
    with trace.measure("serve.decode", step=3) as sp:
        time.sleep(0.002)
    assert sp.seconds >= 0.002 and trace.records() == []
    trace.enable()
    with trace.measure("serve.decode", step=4) as sp:
        pass
    (rec,) = trace.records()
    assert rec is sp and rec.attrs == {"step": 4} and rec.seconds >= 0


def test_nesting_and_parents():
    trace.enable()
    with trace.span("serve.decode", step=0) as top:
        with trace.span("step.prepare") as a:
            pass
        with trace.span("step.enqueue") as b:
            with trace.span("model.attn") as c:
                pass
    recs = trace.records()
    # a record is kept as its span closes
    assert [r.name for r in recs] == ["step.prepare", "model.attn",
                                      "step.enqueue", "serve.decode"]
    assert top.parent is None and a.parent == b.parent == top.id
    assert c.parent == b.id
    assert top.id < a.id < b.id < c.id
    assert top.start_ns <= a.start_ns <= a.end_ns <= b.start_ns \
        <= c.start_ns <= c.end_ns <= b.end_ns <= top.end_ns


def test_a_span_an_exception_leaves_is_kept_and_closed():
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("serve.admit", rids=[7]):
            with trace.span("step.prepare"):
                raise ValueError("prompt")
    with trace.span("serve.decode") as after:
        pass
    assert [r.name for r in trace.records()] == [
        "step.prepare", "serve.admit", "serve.decode"]
    assert after.parent is None


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.enable()
    for i in range(5):
        with trace.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in trace.records()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0
    with trace.span("s", i=5):
        pass
    assert [r.attrs["i"] for r in trace.records()] == [5]


def test_spans_appear_as_profiler_ranges():
    """Under the CPU profiler each span is a ``repro.<name>`` range of
    its own length (within 100 us), nested as the spans are."""
    trace.enable()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.prepare_trace()
    prof.start_trace()
    # the profiler's first range starts late by a cold call's cost
    with torch.profiler.record_function("warm"):
        pass
    for i in range(3):
        with trace.span("serve.decode", step=i):
            with trace.span("step.enqueue"):
                torch.ones(64) @ torch.ones(64)
            time.sleep(0.001)
    prof.stop_trace()
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("repro."))
    assert [n for _, _, n in ranges] == [
        "repro.serve.decode", "repro.step.enqueue"] * 3
    for (s0, e0, _), (s1, e1, _) in zip(ranges[::2], ranges[1::2]):
        assert s0 <= s1 <= e1 <= e0
    recs = sorted(trace.records(), key=lambda r: r.start_ns)
    for (s, e, name), r in zip(ranges, recs):
        assert name == "repro." + r.name
        assert abs((e - s) - (r.end_ns - r.start_ns)) < 100_000


# -- the serving path ---------------------------------------------------

BATCH, MAX_LEN = 3, 40
# (prompt, gen): three admitted in one chunk, the fourth alone when the
# third finishes
MIX = [(5, 3), (7, 6), (4, 2), (6, 4)]
# Worked by hand from serve_loop's order: step 0 admits r0-r2 as one
# chunk, a run of all three slots (3 x 7 computed, 5 + 7 + 4 carried),
# and decodes nothing; steps 1-2 decode three slots; r2 is done after
# step 2, so step 3 prefills r3 alone on its own row (6 computed, 6
# carried) and decodes r0, r1, r3; r0 is done, steps 4-6 decode r1 and
# r3 until both are done.
DECODES = 6
COMPUTED = {"admit": 3 * 7 + 6, "decode": DECODES * BATCH}
CARRIED = {"admit": 5 + 7 + 4 + 6, "decode": 3 + 3 + 3 + 2 + 2 + 2}


def _server(layout):
    cfg = ModelConfig(name="tiny-trace", family="dense", num_layers=LAYERS,
                      d_model=32, d_ff=64, vocab_size=101, num_heads=4,
                      num_kv_heads=2)
    paged = (paging.PageSpec.build(BATCH, MAX_LEN, 4)
             if layout == "paged" else None)
    return serve.Server(cfg, BATCH, MAX_LEN, device="cpu",
                        autotune_kernels=False, paged=paged,
                        kv_dtype=torch.int8 if layout == "int8"
                        else torch.float32)


def _serve(server):
    lc = Lifecycle(clock=lambda: 0.0)
    rng = np.random.default_rng(0)
    for rid, (n, gen) in enumerate(MIX):
        lc.submit(rid, rng.integers(0, 101, n).astype(np.int32), gen)
    calls = []
    decode_step = server.decode_step

    def counted(*a, **k):
        calls.append(a)
        return decode_step(*a, **k)
    server.decode_step = counted
    rec = loadgen.StepTimeRecorder()
    stats = serve.serve_loop(server, lc, watchdog=rec)
    return stats, calls, rec


@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8"])
def test_serving_spans_and_position_counts(layout):
    server = _server(layout)
    trace.enable()
    stats, calls, rec = _serve(server)
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    children = {}
    for r in sorted(recs, key=lambda r: r.id):
        children.setdefault(r.parent, []).append(r)

    decodes = [r for r in recs if r.name == "serve.decode"]
    admits = [r for r in recs if r.name == "serve.admit"]
    assert len(decodes) == len(calls) == DECODES
    assert [r.attrs["step"] for r in decodes] == list(range(1, 7))
    assert [r.attrs["slots"] for r in decodes] == [3, 3, 3, 2, 2, 2]
    assert [(r.attrs["rids"], r.attrs["width"], r.attrs["positions"])
            for r in admits] == [([0, 1, 2], 7, 16), ([3], 6, 6)]
    # the watchdog saw each decode span's length
    assert rec.times == {r.attrs["step"]: r.seconds for r in decodes}
    # every forward: prepare, enqueue, wait, in that order, and nothing
    # else at the top of it; one attention a layer inside its enqueue
    for top in decodes + admits:
        kids = children[top.id]
        assert [k.name for k in kids] == ["step.prepare", "step.enqueue",
                                          "step.wait"]
        assert kids[0].end_ns <= kids[1].start_ns
        assert kids[1].end_ns <= kids[2].start_ns
        enqueue = kids[1]
        assert [k.name for k in children[enqueue.id]] == \
            ["model.attn"] * LAYERS
    assert {r.name for r in recs} == {"serve.decode", "serve.admit",
                                      "step.prepare", "step.enqueue",
                                      "step.wait", "model.attn"}
    assert all(r.parent is None or r.parent in by_id for r in recs)
    assert stats["positions_computed"] == COMPUTED
    assert stats["positions_carried"] == CARRIED


def test_serving_with_the_tracer_off_records_nothing():
    server = _server("contiguous")
    stats, calls, rec = _serve(server)
    assert trace.records() == []
    # the loop's own counts and the watchdog do not need the tracer
    assert stats["positions_computed"] == COMPUTED
    assert stats["positions_carried"] == CARRIED
    assert sorted(rec.times) == list(range(1, 7))
    assert all(t > 0 for t in rec.times.values())
    # a second loop on the same server counts only its own forwards
    stats, _, _ = _serve(server)
    assert stats["positions_carried"] == CARRIED
