"""Host time of one decode step of the serve shape.

Qwen3-14B at full width and depth (random weights from seed 0), 4 slots
holding prompts of 600 tokens: `launch.serve.Server.decode_step` timed
on the host clock, each step ending in its host synchronisation (the
copy of the next tokens).  The steps run in rounds, alternately without
sharding rules and under the serve CLI's `serve.serving_rules`, and
the Python function calls of a step are counted (`cProfile`) in each
mode.  It imports nothing but `launch.serve` and `configs`, so it also
runs against an older checkout of the package, for an A/B on one card:

    PYTHONPATH=<checkout>/src python src/repro_torch/benchmarks/decode_host.py

Prints one JSON line.  ``--device cpu`` runs the SMOKE config, at
prompts of 8 tokens.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import pstats
import subprocess
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.launch import serve

BATCH, DEPTH = 4, 600
WARMUP, STEPS, ROUNDS = 3, 10, 2
MODES = ("plain", "serving_rules")


def _nvidia_smi() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    cfg = (configs.get_smoke if cpu else configs.get)("qwen3_14b")
    depth = 8 if cpu else DEPTH
    steps = WARMUP + len(MODES) * (ROUNDS * STEPS + 1)
    server = serve.Server(cfg, BATCH, depth + steps + 8, device=args.device)
    rng = np.random.default_rng(0)
    server.admit_chunk([(s, s, rng.integers(0, cfg.vocab_size, depth),
                         steps + 1) for s in range(BATCH)])

    def rules(mode):
        return (serve.serving_rules(args.device) if mode == "serving_rules"
                else contextlib.nullcontext())

    for _ in range(WARMUP):
        server.decode_step()
    host_ms = {m: [] for m in MODES}
    for _ in range(ROUNDS):
        for mode in MODES:
            with rules(mode):
                for _ in range(STEPS):
                    t0 = time.perf_counter()
                    server.decode_step()
                    host_ms[mode].append((time.perf_counter() - t0) * 1e3)
    calls = {}
    for mode in MODES:
        with rules(mode):
            prof = cProfile.Profile()
            prof.enable()
            server.decode_step()
            prof.disable()
        calls[mode] = pstats.Stats(prof).total_calls
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
        "depth": depth, "device": str(server.device),
        "nvidia_smi": _nvidia_smi() if server.device.type == "cuda"
        else None,
        "host_ms": host_ms,
        "host_median_ms": {m: float(np.median(v))
                           for m, v in host_ms.items()},
        "python_calls_per_step": calls}), flush=True)
    if torch.distributed.is_initialized():      # `serving_rules`' group
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
