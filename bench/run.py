"""Run one cell of the benchmark once, on the card this process sees.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of BENCHMARK.json (see `bench.spec`).  The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers are
the last lines of standard error.  Without a card (or with fewer than
the cell's chips), or with the JAX package or JAX loaded once the window
has closed, it prints no result and exits non-zero.

The program's build and tuning caches go to fixed directories under
``build/`` of the checkout; nothing else is written.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHES = ROOT / "build" / "bench"


def _environment() -> None:
    """Fixed cache directories inside the checkout, set before torch or
    the program is imported; the one-rank NCCL group of the serving
    rules kept off /dev/shm; one thread for the host's own arithmetic,
    so that the serving loop shares its cores with nothing of ours."""
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(CACHES / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(CACHES / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHES / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHES / "cuda")
    os.environ["NCCL_SHM_DISABLE"] = "1"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    _environment()

    import torch
    from bench import spec
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    import repro_torch
    if ROOT / "src" not in pathlib.Path(repro_torch.__file__).parents:
        print(f"repro_torch loaded from {repro_torch.__file__}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    from bench import harness
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"set-up: {json.dumps(out.pop('setup_phases_s'))}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
