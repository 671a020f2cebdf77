"""End-to-end trainer: config -> mesh -> state -> data -> resilient
step loop.  Counterpart of `repro.launch.train`, with its flags and its
last-line JSON (``arch``, ``steps``, ``wall_s``, ``first_loss``,
``last_loss``, ``stragglers``, ``final_ckpt``).

The mesh is ``(data = ranks, model = 1)`` over the ranks `torchrun`
started (`launch.mesh.make_host_mesh`), one rank on one card under plain
``python -m``; ``--production-mesh`` takes the 16 x 16 pod mesh, which
needs 256 ranks.  The state (``{"params", "opt"}``, `policy`'s dtypes:
f32 weights and moments below 100 B parameters) is built from a seeded
generator and placed on the mesh by `launch.specs` (moments ZeRO-sharded
over the data axis, parameters too where `policy.use_fsdp`); the step is
`steps.data_parallel_step`'s.  Checkpoints are the reference's
mesh-agnostic format (`checkpoint.manager`, written by rank 0), so
``--resume`` also takes a checkpoint the JAX trainer wrote for the same
config, on any number of ranks.  Only rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_14b \\
      --smoke --steps 30 --batch 8 --seq 64 [--device cpu] [--resume]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --steps 30
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_source
from repro_torch.launch import policy, specs, steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 restore_onto, run_resilient)


def build_state(cfg, opt_cfg, seed: int, device, mesh=None,
                rules=None) -> dict:
    """The train state on ``device``: seeded parameters in
    `policy.param_dtype` and zeroed AdamW moments; with ``mesh``, every
    leaf a DTensor of its `specs.state_pspecs` spec under ``rules``
    (each rank holding its block; every rank draws the same state)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = transformer.init(cfg, gen, dtype=policy.param_dtype(cfg))
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    if mesh is None:
        return state
    rules = rules if rules is not None else specs.rules_for(mesh)
    _, pspecs = specs.state_pspecs(cfg, opt_cfg, mesh, rules)
    return tree_lib.map_structure(
        lambda t, spec: shd.distribute(t, spec, mesh), state, pspecs)


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
                    help="the 16x16 pod mesh (needs 256 ranks)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    try:
        mesh = (make_production_mesh(device_type=device.type)
                if args.production_mesh else
                make_host_mesh(data=_world(), model=1,
                               device_type=device.type))
    except RuntimeError as e:
        raise SystemExit(f"--production-mesh: {e}" if args.production_mesh
                         else str(e))
    rules = specs.rules_for(mesh)
    rank0 = dist.get_rank() == 0
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
    train_step = steps.make_train_step(cfg, opt_cfg, mesh=mesh, rules=rules)
    state = build_state(cfg, opt_cfg, 0, device, mesh, rules)
    _, pspecs = specs.state_pspecs(cfg, opt_cfg, mesh, rules)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start_step = restore_onto(ckpt, state, mesh, pspecs)
        if rank0:
            print(f"resumed from step {start_step}")

    def batch_fn(step):
        # the global batch; the step takes this rank's rows of it
        b = source.batch(step, 0, 1)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def on_restore(_step):
        restored, step = restore_onto(ckpt, state, mesh, pspecs)
        if rank0:
            print(f"restored from step {step}")
        return restored, step

    t0 = time.time()
    state, history, monitor = run_resilient(
        train_step, state, args.steps, ckpt, batch_fn,
        start_step=start_step,
        config=ResilienceConfig(checkpoint_every=args.ckpt_every),
        on_restore=on_restore)
    wall = time.time() - t0

    if not rank0:
        return 0
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


def _world() -> int:
    """The ranks of the running process group, else the number
    `torchrun` started (1 without it)."""
    import os
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


if __name__ == "__main__":
    raise SystemExit(main())
