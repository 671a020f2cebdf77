"""Runs of one cell with the program's own tracer on, and the readings of
its spans (`bench.progtrace`) beside the harness's.

    python3 bench/progrun.py --workload <cell> --seed <n> [<n> ...] \\
        --seconds <s> --trace <0|1> [--tracer 1 [0]]

Each seed runs once under each ``--tracer`` setting, in that order, all
in this one process (``--tracer 1 0`` prices the tracer on one host).  A
run is `bench.harness.run_cell`'s.  With ``--tracer 1``,
`repro_torch.runtime.trace` is on from set-up to the window's close; the
tracer's records go on the run as ``run.program``, and in a traced run
the profiler's ``repro.*`` ranges, the launches and the device work as
``run.host``, while `bench.devtrace` reads the trace without the device
copies of those ranges (`progtrace.strip`).  Each run prints one line:
the harness's result with the program's metrics that found something to
read added to ``metrics``, and a ``program`` block: the traced window's
idle time by program range, the tracer's records per decode step and the
records it dropped.  The benchmark's own runs (`bench/run.py`) leave the
tracer off.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import collections  # noqa: E402
import functools  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
METRICS = {"decode_enqueue_ms": "ms", "decode_launches": "launches",
           "idle_enqueue_share": "%", "admit_attn_ms": "ms"}


def serve_window(cell, seed, seconds, trace, dev, t_start, tracer=True):
    """`bench.harness.serve_window` with the program's tracer on (or,
    with ``tracer`` false, as it is), its records and ranges on the
    run."""
    from bench import devtrace, harness, progtrace
    from repro_torch.runtime import trace as program
    plain = inspect.unwrap(harness.serve_window)   # run_cell's stands in
    program.clear()
    if not tracer:
        return plain(cell, seed, seconds, trace, dev, t_start)
    read, host = devtrace.read, []

    def read_both(prof):
        host.append(progtrace.read(prof))
        return read(progtrace.strip(prof))
    devtrace.read = read_both
    program.enable()
    try:
        run, lc = plain(cell, seed, seconds, trace, dev, t_start)
    finally:
        program.disable()
        devtrace.read = read
    run.program = program.records()
    run.host = host[0] if host else None
    return run, lc


def program_block(run) -> dict:
    """What the tracer saw of a run, beside its metrics."""
    from bench import progtrace
    from repro_torch.runtime import trace as program
    spans = getattr(run, "program", None) or []
    names = collections.Counter(sp.name for sp in spans)
    return {"idle_by_range": progtrace.idle_by_range(run),
            "records": len(spans),
            "records_per_decode": (len(spans) / names["serve.decode"]
                                   if names["serve.decode"] else None),
            "dropped": program.dropped()}


def run_cell(cell, seed, seconds, trace, *, tracer=True, device="cuda",
             t_start=None) -> dict:
    """`bench.harness.run_cell` through `serve_window`, with the
    program's metrics and its ``program`` block."""
    from bench import harness, spec
    t_start = time.monotonic() if t_start is None else t_start
    runs = []
    plain = harness.serve_window

    @functools.wraps(plain)
    def window(*a):
        runs.append(serve_window(*a, tracer=tracer))
        return runs[-1]
    harness.serve_window = window
    try:
        out = harness.run_cell(cell, seed, seconds, trace, device=device,
                               t_start=t_start)
    finally:
        harness.serve_window = plain
    run = runs[0][0]
    for name, unit in METRICS.items():
        value = spec.reader(name)(run)
        if value is not None:
            out["metrics"][name] = {"value": value, "unit": unit}
    out["program"] = program_block(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), nargs="+",
                    default=[1])
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    from bench import run as bench_run
    bench_run._environment()

    import torch
    from bench import spec
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    t_start = T_START
    for seed in args.seed:
        for tracer in args.tracer:
            out = run_cell(cell, seed, args.seconds, bool(args.trace),
                           tracer=bool(tracer), t_start=t_start)
            out.pop("setup_phases_s")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "tracer": tracer, **out}), flush=True)
            t_start = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
