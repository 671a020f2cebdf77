"""The readers of the program's own spans (`bench.progtrace` and the four
metrics on it): on a run, a trace and the program's ranges made by hand,
on a profiler's raw events made by hand (through `progtrace.strip` the
harness's own readings do not move when the program's ranges are in the
trace), and on runs of a cell on the CPU through `bench.progrun`."""

import time
import types

import pytest
import torch

from bench import devtrace, progrun, progtrace, spec
from bench.harness import Run
from bench.timed import Record
from conftest import SMOKE, small_cell

MS = 1_000_000
SEED = 2 ** 31 + 91


def _read(name, run):
    return spec.reader(name)(run)


@pytest.fixture
def tracer():
    from repro_torch.runtime import trace
    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


# -- by hand ------------------------------------------------------------
# One decode step wholly in the window (90-200 ms), an admission (300-500)
# and a decode step the window's end cuts (900-1100); the device work each
# launch put there, by correlation id.
RANGES = [
    ("repro.serve.decode", 90, 200), ("repro.step.prepare", 100, 110),
    ("repro.step.enqueue", 110, 170), ("repro.model.attn", 120, 130),
    ("repro.model.attn", 140, 150), ("repro.step.wait", 170, 200),
    ("repro.serve.admit", 300, 500), ("repro.step.prepare", 300, 310),
    ("repro.step.enqueue", 310, 400), ("repro.model.attn", 320, 340),
    ("repro.model.attn", 350, 380), ("repro.step.wait", 400, 500),
    ("repro.serve.decode", 900, 1100), ("repro.step.prepare", 900, 910),
    ("repro.step.enqueue", 910, 1050), ("repro.step.wait", 1050, 1100),
]
# correlation id: (launched at, device start, device end)
LAUNCHES = {1: (112, 130, 160), 2: (125, 160, 165), 3: (145, 165, 168),
            4: (172, 180, 185),
            10: (325, 330, 360), 11: (355, 355, 390), 12: (315, 320, 330),
            13: (405, 410, 420),
            20: (920, 990, 1000)}


def _host():
    return progtrace.Host(
        [(n, s * MS, e * MS) for n, s, e in RANGES],
        sorted((t * MS, c) for c, (t, _, _) in LAUNCHES.items()),
        {c: [(s * MS, e * MS)] for c, (_, s, e) in LAUNCHES.items()})


def _trace():
    window = (0, 1000 * MS)
    dev = [(f"k{c}", s * MS, min(e * MS, window[1]))
           for c, (_, s, e) in LAUNCHES.items()]
    return devtrace.Trace(window, dev, [])


def _run(trace=None, host=None, program=None):
    run = Run(dict(SMOKE["phi3_mini_3_8b"]), 4, 0.0, 1.0, 2.0, [], [], None,
              0, trace)
    if host is not None:
        run.host = host
    if program is not None:
        run.program = program
    return run


def test_device_readings_by_hand():
    run = _run(_trace(), _host())
    # the decode step at 90-200 launched 1-4; the one at 900 is cut
    assert _read("decode_launches", run) == 4.0
    # the admission's attention launched 10 and 11: 330-390; 12 was
    # launched outside its attention
    assert _read("admit_attn_ms", run) == pytest.approx(60.0)
    # idle 0-130, 168-180, 185-320, 390-410, 420-990; enqueue 110-170,
    # 310-400, 910-1000 (cut at the window's end)
    assert _read("idle_enqueue_share", run) == pytest.approx(
        100 * (20 + 2 + 10 + 10 + 80) / 1000)
    assert progtrace.idle_by_range(run) == pytest.approx({
        "loop": 0.590, "serve.decode": 0.010, "step.prepare": 0.030,
        "step.enqueue": 0.112, "model.attn": 0.010, "step.wait": 0.115})
    assert sum(progtrace.idle_by_range(run).values()) == pytest.approx(
        1.0 - devtrace.busy_s(run.trace))


def test_enqueue_time_by_hand():
    s = 1_000_000_000

    def span(name, i, parent, t0, t1):
        return types.SimpleNamespace(name=name, id=i, parent=parent,
                                     start_ns=int(t0 * s), end_ns=int(t1 * s))
    program = [
        # before the window: left out
        span("serve.decode", 0, None, 0.8, 0.9),
        span("step.enqueue", 1, 0, 0.81, 0.85),
        span("serve.decode", 2, None, 1.1, 1.2),
        span("step.enqueue", 3, 2, 1.11, 1.14),
        span("serve.admit", 4, None, 1.3, 1.5),
        span("step.enqueue", 5, 4, 1.31, 1.45),
        span("serve.decode", 6, None, 1.6, 1.7),
        span("step.enqueue", 7, 6, 1.61, 1.66),
    ]
    run = _run(program=program)
    assert _read("decode_enqueue_ms", run) == pytest.approx(40.0)
    run.t_trace = 1.5          # the host clock's window ends there
    assert _read("decode_enqueue_ms", run) == pytest.approx(30.0)


def test_without_the_programs_spans_nothing_is_read():
    for run in (_run(), _run(_trace()), _run(_trace(), program=[]),
                _run(_trace(), progtrace.Host([], [], {}))):
        for name in ("decode_enqueue_ms", "decode_launches",
                     "idle_enqueue_share", "admit_attn_ms"):
            assert _read(name, run) is None, name
        assert progtrace.idle_by_range(run) is None


# -- a profiler's raw events --------------------------------------------

class _Event:
    """A profiler event as the card's torch reports it: no activity
    type."""

    def __init__(self, name, start, end, device="CPU", kind="cpu_op",
                 corr=0):
        self._v = name, start, end, device, kind, corr

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return f"DeviceType.{self._v[3]}"

    def correlation_id(self):
        return self._v[5]


class _Labelled(_Event):
    """An event of a torch that gives the activity type."""

    def activity_type(self):
        return self._v[4]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


B1 = "void decode_kernel<__nv_bfloat16, false, 4>(Args<__nv_bfloat16>)"


def _events(with_program, _Event=_Event):
    ev = [_Event("bench.window", 0, 1000 * MS, kind="user_annotation"),
          _Event("bench.decode#1", 95 * MS, 195 * MS,
                 kind="user_annotation"),
          _Event("bench.decode#1", 95 * MS, 195 * MS, "CUDA",
                 "gpu_user_annotation")]
    for c, (t, s, e) in LAUNCHES.items():
        ev.append(_Event("cudaLaunchKernel", t * MS, t * MS + 5,
                         kind="cuda_runtime", corr=c))
        ev.append(_Event(B1 if c in (2, 3) else f"k{c}", s * MS, e * MS,
                         "CUDA", "kernel", corr=c))
    # a host call that puts nothing on the device, and a launch whose
    # device record the profiler lost
    ev.append(_Event("cudaStreamSynchronize", 175 * MS, 176 * MS,
                     kind="cuda_runtime", corr=99))
    ev.append(_Event("cuLaunchKernel", 126 * MS, 126 * MS + 5,
                     kind="cuda_runtime", corr=98))
    if with_program:
        for n, s, e in RANGES:
            ev.append(_Event(n, s * MS, e * MS, kind="user_annotation"))
            ev.append(_Event(n, s * MS, e * MS, "CUDA",
                             "gpu_user_annotation"))
    return ev


@pytest.mark.parametrize("event", [_Event, _Labelled],
                         ids=["no_activity_type", "activity_type"])
def test_the_harness_reads_the_same_with_the_programs_ranges_in(event):
    plain = devtrace.read(_prof(_events(False, event)))
    with_program = _prof(_events(True, event))
    traced = devtrace.read(progtrace.strip(with_program))
    assert traced == plain
    if event is _Event:
        # without an activity type, `devtrace` alone takes the ranges'
        # device copies for work: hence the strip
        assert devtrace.busy_s(devtrace.read(with_program)) > \
            devtrace.busy_s(plain)
    rec = Record("decode", 1, 0.0, 0.1, 1, [(0, 8, 1), (1, 6, 1)], [1, 2])
    runs = []
    for tr in (plain, traced):
        run = _run(tr)
        run.chip = {"hbm_bytes_s": 3.35e12, "bf16_flops": 989e12}
        run.records = [rec]
        runs.append(run)
    for name in ("device_idle_share", "b1_roofline"):
        assert _read(name, runs[1]) == _read(name, runs[0]) is not None
    assert devtrace.busy_s(traced) == devtrace.busy_s(plain)
    assert devtrace.breakdown(traced) == devtrace.breakdown(plain)


def test_read_keeps_the_programs_ranges_and_the_calls_that_launched():
    host = progtrace.read(_prof(_events(True)))
    assert host.ranges == sorted(((n, s * MS, e * MS) for n, s, e in RANGES),
                                 key=lambda r: r[1])
    # the synchronize puts nothing on the device; the launch at 126 is
    # counted though its kernel's record is missing
    assert [c for _, c in host.launches] == sorted(
        [*LAUNCHES, 98], key=lambda c: LAUNCHES.get(c, (126,))[0])
    assert host.ops[11] == [(355 * MS, 390 * MS)] and 98 not in host.ops
    run = _run(devtrace.read(progtrace.strip(_prof(_events(True)))), host)
    assert _read("decode_launches", run) == 5.0
    assert _read("admit_attn_ms", run) == pytest.approx(60.0)


# -- a traced run of a cell ---------------------------------------------

def _traced_run(cell, device="cpu"):
    """A traced run with the program's tracer on (`bench.progrun`)."""
    run, _ = progrun.serve_window(cell, SEED, 5.0, True,
                                  torch.device(device), time.monotonic())
    return run


def test_a_traced_cpu_run_reads_the_programs_spans(tracer):
    """On the CPU the trace holds the program's ranges but no device
    work: of the four readings only the enqueue time is there.  The
    admissions' spans give the harness's padding share."""
    cell = small_cell("phi3mini-code")
    run = _traced_run(cell)
    names = {n for n, _, _ in run.host.ranges}
    assert {"repro.serve.decode", "repro.serve.admit", "repro.step.enqueue",
            "repro.model.attn"} <= names
    enqueue = _read("decode_enqueue_ms", run)
    assert 0 < enqueue < _read("decode_step_ms", run)
    for name in ("decode_launches", "idle_enqueue_share", "admit_attn_ms"):
        assert _read(name, run) is None

    admits = [sp for sp in run.program if sp.name == "serve.admit"]
    window = [sp for sp in admits if run.in_window(sp.end_ns * 1e-9)
              and sp.attrs["width"] > 1]
    computed = sum(run.batch * sp.attrs["width"] for sp in window)
    carried = sum(sp.attrs["positions"] for sp in window)
    assert window and 100.0 * (computed - carried) / computed == \
        pytest.approx(_read("admit_pad_share", run), rel=1e-12)


@pytest.mark.parametrize("tracer_on", [1, 0])
def test_progrun_adds_the_program_readings_it_finds(tracer, tracer_on):
    """An untraced CPU run through `bench.progrun`: with the tracer on
    its line carries the enqueue time and the tracer's counts; with it
    off it is the harness's line and a block with nothing in it."""
    cell = small_cell("phi3mini-chat")
    out = progrun.run_cell(cell, SEED, 3.0, False, tracer=bool(tracer_on),
                           device="cpu")
    assert out["correct"]
    got = set(out["metrics"]) & set(progrun.METRICS)
    block = out["program"]
    assert block["dropped"] == 0 and block["idle_by_range"] is None
    if tracer_on:
        assert got == {"decode_enqueue_ms"}
        assert 0 < out["metrics"]["decode_enqueue_ms"]["value"]
        # a decode step's 4 spans, and one attention a layer
        assert block["records_per_decode"] > 4 + cell.config[
            "num_hidden_layers"]
    else:
        assert got == set() and block["records"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3mini-code", "qwen25-32b-code"])
def test_a_traced_card_run_reads_every_program_metric(name, cuda_card,
                                                      tracer):
    """On the card: launches per decode step are counted and the same in
    every step of the window; the admissions' attention is device time
    under their forward; the enqueue's idle share is part of the idle."""
    cell = small_cell(name)
    cell.config["head_dim"] = 16          # a width the decode kernels take
    run = _traced_run(cell, "cuda")
    got = {n: _read(n, run) for n in (
        "decode_enqueue_ms", "decode_launches", "idle_enqueue_share",
        "admit_attn_ms", "decode_step_ms", "device_idle_share")}
    print(name, got)
    assert 0 < got["decode_enqueue_ms"] < got["decode_step_ms"]
    assert 0 < got["idle_enqueue_share"] <= got["device_idle_share"]
    decodes = progtrace._whole(run.host, "serve.decode", run.trace.window)
    per_step = {len(run.host.launched(s, e)) for s, e in decodes}
    assert len(per_step) == 1 and per_step.pop() > 0
    admits = progtrace._whole(run.host, "serve.admit", run.trace.window)
    if admits:
        longest = max(e - s for s, e in admits) * 1e-6
        assert 0 < got["admit_attn_ms"] < longest
