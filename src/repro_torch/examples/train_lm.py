"""End-to-end training example: a ~100M-class LM on the synthetic pipeline
for a few hundred steps, with checkpointing and the fault-tolerant step
loop.  Counterpart of the JAX package's ``examples/train_lm.py``, with its
configs and its JSON.

The default config is lm-27m; ``--hundred-m`` selects the ~124M-parameter
model (same code path).  Weights come from a seeded generator on the
device.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticSource
from repro_torch.launch import steps as step_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ResilienceConfig, run_resilient


def model_config(hundred_m: bool) -> ModelConfig:
    if hundred_m:
        return ModelConfig(
            name="lm-124m", family="dense", num_layers=12, d_model=768,
            d_ff=2048, vocab_size=32768, num_heads=12, num_kv_heads=4)
    return ModelConfig(
        name="lm-27m", family="dense", num_layers=8, d_model=512,
        d_ff=1408, vocab_size=8192, num_heads=8, num_kv_heads=4)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.hundred_m)
    n_params = cfg.param_count()
    opt_cfg = adamw.AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)
    params = transformer.init(cfg, torch.Generator(device=device).manual_seed(0))
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=0)
    source = SyntheticSource(dcfg)
    train_step = step_lib.make_train_step(cfg, opt_cfg)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=2)

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in source.batch(step, 0, 1).items()}

    print(f"training {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")
    t0 = time.time()
    state, history, monitor = run_resilient(
        train_step, state, args.steps, ckpt, batch_fn,
        config=ResilienceConfig(checkpoint_every=max(args.steps // 4, 10)))
    wall = time.time() - t0

    losses = [h["loss"] for h in history]
    window = max(args.steps // 10, 5)
    tok_per_step = args.batch * args.seq
    result = {
        "params_m": round(n_params / 1e6, 1),
        "steps": len(history),
        "wall_s": round(wall, 1),
        "tokens_per_s": round(len(history) * tok_per_step / wall, 1),
        "loss_first": round(float(np.mean(losses[:window])), 4),
        "loss_last": round(float(np.mean(losses[-window:])), 4),
        "stragglers_flagged": len(monitor.reports),
        "final_checkpoint": ckpt.latest_step(),
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
