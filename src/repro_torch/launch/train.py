"""End-to-end trainer on one card: config -> state -> data -> resilient
step loop.  Counterpart of `repro.launch.train`, with its flags and its
last-line JSON (``arch``, ``steps``, ``wall_s``, ``first_loss``,
``last_loss``, ``stragglers``, ``final_ckpt``).

The state (``{"params", "opt"}``) is built unsharded on the device with
`policy`'s dtypes (f32 weights and moments below 100 B parameters) from a
seeded generator; the reference shards it over a host mesh.  Meshes, and
so ``--production-mesh``, are ROADMAP A14.  Checkpoints are the
reference's format (`checkpoint.manager`), so ``--resume`` also takes a
checkpoint the JAX trainer wrote for the same config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_14b \\
      --smoke --steps 30 --batch 8 --seq 64 [--device cpu] [--resume]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_source
from repro_torch.launch import policy, steps
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 run_resilient)


def build_state(cfg, opt_cfg, seed: int, device) -> dict:
    """The train state on ``device``: seeded parameters in
    `policy.param_dtype` and zeroed AdamW moments."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = transformer.init(cfg, gen, dtype=policy.param_dtype(cfg))
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="synthetic", choices=["synthetic",
                                                            "memmap"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 pod mesh (ROADMAP A14: raises)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise SystemExit("--production-mesh: meshes over several cards are "
                         "ROADMAP A14; the port trains on one card")
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    opt_cfg = adamw.AdamWConfig(peak_lr=args.lr, warmup_steps=10,
                                total_steps=args.steps,
                                moment_dtype=policy.moment_dtype(cfg))
    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, kind=args.data, path=args.data_path,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        num_patches=min(8, args.seq // 4) if cfg.frontend == "patch" else 0)
    source = make_source(dcfg)

    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=3)
    train_step = steps.make_train_step(cfg, opt_cfg)
    state = build_state(cfg, opt_cfg, 0, device)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(None, state, device)
        start_step = meta["step"]
        print(f"resumed from step {start_step}")

    def batch_fn(step):
        b = source.batch(step, 0, 1)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def on_restore(_step):
        restored, meta = ckpt.restore(None, state, device)
        print(f"restored from step {meta['step']}")
        return restored, meta["step"]

    t0 = time.time()
    state, history, monitor = run_resilient(
        train_step, state, args.steps, ckpt, batch_fn,
        start_step=start_step,
        config=ResilienceConfig(checkpoint_every=args.ckpt_every),
        on_restore=on_restore)
    wall = time.time() - t0

    losses = [h["loss"] for h in history if "loss" in h]
    print(json.dumps({
        "arch": cfg.name,
        "steps": len(history),
        "wall_s": round(wall, 2),
        "first_loss": round(losses[0], 4) if losses else None,
        "last_loss": round(losses[-1], 4) if losses else None,
        "stragglers": len(monitor.reports),
        "final_ckpt": ckpt.latest_step(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
