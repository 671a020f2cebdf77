"""The readings a cell's correctness limit is set from, many seeds in one
process:

    python3 bench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, a run of the cell (set-up and a window, as `bench/run.py`
makes it), then over the same seeded sample of finished requests: the
program's widest logit gap against the float32 reference (the lower
reading: the largest over the seeds), and the control's, the reference
computed with every product's operands in float8 e4m3 and judged by the
float32 reference at the same positions (the upper reading: the
smallest over the seeds).  One JSON line a seed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, device: str = "cuda",
             t_start: float | None = None) -> dict:
    import torch
    from bench import check, harness, spec
    from bench.reference.dense import Dense
    dev = torch.device(device)
    t0 = time.monotonic()
    run, _ = harness.serve_window(cell, seed, seconds, False, dev,
                                  t_start or t0)
    reqs = check.sample(run.requests, run.slot_of, seed,
                        int(cell.workload["check"]["sample_tokens"]))
    seqs, pos, served = check.sequences(reqs)
    t1 = time.monotonic()
    ref = Dense(cell.config, seed, dev).logits(seqs, pos)
    t2 = time.monotonic()
    ctl = Dense(cell.config, seed, dev, "fp8").logits(seqs, pos)
    t3 = time.monotonic()
    metrics = {e["name"]: spec.reader(e["name"])(run)
               for e in cell.end_to_end if e["name"] != "setup_s"}
    return {"workload": cell.name, "seed": seed, "metrics": metrics,
            "program_gap": check.widest_gap(ref, served),
            "control_gap": check.control_gap(ref, ctl),
            "tokens": int(sum(t.numel() for t in served)),
            "requests": len(reqs),
            "slots": len({run.slot_of[r.rid] for r in reqs}),
            "longest": max((s.numel() + 1 for s in seqs), default=0),
            "memory_peak_bytes": run.memory_peak_bytes,
            "run_s": t1 - t0, "reference_s": t2 - t1, "control_s": t3 - t2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    from bench import run as run_mod
    run_mod._environment()
    import torch
    from bench import spec
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    lines = []
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        line = readings(cell, seed, args.seconds)
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(json.dumps({
        "workload": cell.name, "seeds": len(lines),
        "lower": max(x["program_gap"] for x in lines),
        "upper": min(x["control_gap"] for x in lines)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
