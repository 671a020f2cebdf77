"""Per-rank dry run of every (arch x shape x mesh) cell.  Counterpart of
`repro.launch.dryrun`.

The reference lowers and compiles each cell's SPMD step for 512 forced
host devices and reads one device's FLOPs and bytes from XLA's cost
analysis and its collectives from the HLO text.  The port traces rank 0's
PyTorch program instead: the single-pod (16, 16) or multi-pod
(2, 16, 16) mesh is a `DeviceMesh` over a ``fake`` process group of 256
or 512 ranks (`launch.mesh.make_production_mesh` on the ``meta`` device
type), every tensor lies on the ``meta`` device, and
`core.hlo_stats.count_step` counts what the step dispatches: nothing is
allocated and no card is needed.  So a record's ``lower_s`` and
``compile_s`` are one ``trace_s``.  The record keeps the reference's
keys where they mean the same thing; it is held to the reference's
contract (cells, record, report), not to its numbers, since the port's
per-rank program is its own:

- ``train``: `steps.data_parallel_step` over a state placed by
  `specs.state_pspecs` (ZeRO moments; FSDP weights from 10 B
  parameters), the global batch on every rank, each rank taking its
  rows and computing with its model-axis blocks of the weights
  (`steps.rank_params`): heads, ff, vocab and experts split over the
  model axis where the rules keep them, RWKV6's time mix over its heads,
  its channel mix over d_ff and Mamba over its inner width.
- ``prefill``: `steps.make_prefill_step` on the rank's batch rows and
  the same blocks, gathered from the placed weights inside the step.
- ``decode``: `steps.make_serve_step` under `decode_rules` on rank 0's
  block of a bf16 cache of the shape's length (`transformer.cache_block`:
  its slots, and its segment of the rows over the ``kv_seq`` axes, the
  model axis, or the data and model axes for a batch-1 decode; the RWKV
  and Mamba states over their heads and inner width) and the blocks of
  the weights placed by `specs.decode_pspecs`.

Each runs under the mesh and the cell's rules, so MoE layers take
`moe.apply_sharded`'s expert exchange.  A cell the port cannot form is
``skipped`` with a reason that begins ``not in the port:`` (the step
raised `sharding.NotInPort`, naming its ROADMAP item); any other exception
makes an ``error`` record.  The reference's own rule
(`configs.shapes.applicable`) skips the rest as it does.

Whole-cluster totals are rank 0's counts times the chips, as the
reference scales one device's program.  ``raw`` is the full-depth count.
The probes count the 1- and 2-period depth cuts at the full input shape
(under the whole model's number format, `policy.sized_as`) and
extrapolate, as the reference does, into ``extrapolated``.  The port's
count sees every step of the Mamba and RWKV scans (Python loops over
time): their contractions among the FLOPs, all their bytes; so
`core.estimate.recurrence_correction` is recorded beside the count and
not added.  The memory fields come from the full-depth trace:
``argument_size_in_bytes`` (the rank's state shards and batch),
``temp_size_in_bytes`` (the tracked peak less them), ``peak_bytes`` and
``fits`` (the peak against one H100's 80 GB).  The roofline
(`cost_model.roofline` at `hardware.H100_SXM`) takes its memory term
from `core.estimate.bytes_model`, the counted bytes kept as an unfused
upper bound, and prices collectives at NVLink's 450 GB/s, which no
256-card mesh has end to end: it is a model of the data sheet, never a
measurement.

Usage (artifacts under ``build/dryrun/``):
  python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # every applicable cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

import repro_torch.configs as configs
from repro_torch import tree as tree_lib
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core import cost_model, estimate, hardware, hlo_stats
from repro_torch.launch import policy, specs, steps
from repro_torch.launch.mesh import make_production_mesh, set_mesh
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd

ARTIFACTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"
NOT_IN_PORT = "not in the port:"


def _mesh(kind: str):
    return make_production_mesh(multi_pod=(kind == "multi"),
                                device_type="meta")


def opt_config(cfg) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(moment_dtype=policy.moment_dtype(cfg))


# §Perf hillclimb variants: each is (rules transform, cfg transform,
# train-step kwargs).  "baseline" is the paper-faithful configuration.
VARIANTS = {
    "baseline": {},
    "sp": {"rules": "sequence_parallel"},          # Megatron-style SP
    "bf16grad": {"grad_dtype": "bfloat16"},        # compressed grad sync
    "sp_bf16grad": {"rules": "sequence_parallel",
                    "grad_dtype": "bfloat16"},
    "lowcap": {"cfg": {"capacity_factor": 1.0}},   # tighter MoE capacity
    "sp_lowcap": {"rules": "sequence_parallel",
                  "cfg": {"capacity_factor": 1.0}},
    "sp_bf16grad_lowcap": {"rules": "sequence_parallel",
                           "grad_dtype": "bfloat16",
                           "cfg": {"capacity_factor": 1.0}},
    "bigchunk": {"cfg": {"attn_chunk": 2048}},     # fewer, larger q-chunks
    "dp_only": {"rules": "data_parallel_only"},    # no TP (small models)
    "dp_only_bf16grad": {"rules": "data_parallel_only",
                         "grad_dtype": "bfloat16"},
    # ZeRO-3-style: weights stay sharded in state, attention activations
    # batch-sharded (weights gathered per layer instead of all-reducing
    # activations).  act_rules only — state keeps the base shardings.
    "attn_dp": {"act_rules": "data_parallel_attention"},
    "attn_dp_lowcap": {"act_rules": "data_parallel_attention",
                       "cfg": {"capacity_factor": 1.0}},
    "sp_attn_dp": {"rules": "sequence_parallel",
                   "act_rules": "data_parallel_attention"},
}

_RULE_FNS = {
    "sequence_parallel": shd.sequence_parallel,
    "data_parallel_only": shd.data_parallel_only,
    "data_parallel_attention": shd.data_parallel_attention,
}


def apply_variant(cfg, rules, variant: str):
    """Returns (cfg, act_rules, state_rules, step_kwargs)."""
    spec = VARIANTS[variant]
    state_rules = rules
    if "rules" in spec:  # applies to both activations and state
        rules = _RULE_FNS[spec["rules"]](rules)
        state_rules = rules
    if "act_rules" in spec:
        rules = _RULE_FNS[spec["act_rules"]](rules)
    if "cfg" in spec:
        cfg = dataclasses.replace(cfg, **spec["cfg"])
    kwargs = {}
    if "grad_dtype" in spec:
        kwargs["grad_dtype"] = torch.bfloat16
    return cfg, rules, state_rules, kwargs


def _placed(tree, pspecs, mesh):
    """A meta tree as DTensors of its specs (each holding rank 0's
    block)."""
    return tree_lib.map_structure(
        lambda t, spec: shd.distribute(t, spec, mesh), tree, pspecs)


def model_flops(cfg, shape: ShapeSpec) -> tuple[int, float]:
    """(tokens, useful FLOPs) of one step of the whole cluster: 6 N D
    for a train step, 2 N D for prefill and decode (one new token per
    sequence), N the active parameters."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        return (shape.global_batch,
                cost_model.model_flops_decode(n, shape.global_batch))
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return tokens, cost_model.model_flops_train(n, tokens)
    return tokens, cost_model.model_flops_decode(n, tokens)


def _rank_step(cfg, shape: ShapeSpec, mesh, rules, step_kwargs=None,
               state_rules=None):
    """Rank 0's step of one cell on meta tensors: ``(fn, args)``,
    ``fn(*args)`` the step.  ``state_rules`` (default ``rules``) place
    the weights and optimizer state; ``rules`` govern the activations
    and the batch.  Raises `sharding.NotInPort` for a cell the port's steps
    do not form."""
    step_kwargs = step_kwargs or {}
    state_rules = state_rules or rules

    def on_blocks(step):
        def run(params, *rest):
            with set_mesh(mesh), shd.use_rules(rules):
                return step(steps.rank_params(cfg, params, mesh, rules),
                            *rest)
        return run

    if shape.kind == "decode":
        abs_, pspecs = specs.decode_pspecs(cfg, shape, mesh, rules,
                                           state_rules=state_rules)
        b = shape.global_batch // rules.axis_size(pspecs["tokens"][0])
        cache = transformer.cache_block(cfg, abs_["cache"], rules, mesh)
        tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
        params = _placed(abs_["params"], pspecs["params"], mesh)
        fn = on_blocks(steps.make_serve_step(cfg, mesh=mesh, rules=rules))
        return fn, (params, cache, tokens)
    if shape.kind == "train":
        opt_cfg = opt_config(cfg)
        step = steps.make_train_step(cfg, opt_cfg, mesh=mesh, rules=rules,
                                     **step_kwargs)
        state_abs, pspecs = specs.state_pspecs(cfg, opt_cfg, mesh,
                                               state_rules)
        state = _placed(state_abs, pspecs, mesh)
        return step, (state, specs.batch_specs(cfg, shape))
    b_spec = specs.batch_shardings(cfg, shape, mesh, rules)
    b = shape.global_batch // rules.axis_size(next(iter(b_spec.values()))[0])
    batch = specs.batch_specs(cfg, dataclasses.replace(shape,
                                                       global_batch=b))
    params = _placed(specs.abstract_params(cfg),
                     specs.param_pspecs(cfg, state_rules, mesh), mesh)
    fn = on_blocks(steps.make_prefill_step(cfg, mesh=mesh, rules=rules))
    return fn, (params, batch)


def _counted_stats(counts: hlo_stats.StepCounts, chips: int) -> dict:
    """Whole-cluster stats: rank 0's counts times the chip count."""
    flops, bytes_accessed = hlo_stats.cost_analysis_stats(counts)
    colls = counts.collectives
    return {
        "flops": flops * chips,
        "bytes_accessed": bytes_accessed * chips,
        "collective_bytes": float(colls.total_bytes) * chips,
        "collectives": {k: float(v) * chips
                        for k, v in colls.bytes_by_op.items()},
        "collective_counts": dict(colls.count_by_op),
        "kernels": counts.kernels,
    }


def _probe_layers(cfg) -> tuple[int, int]:
    period = cfg.attn_period if cfg.family == "hybrid" else max(
        cfg.moe_every, 1)
    period = max(period, 1)
    return period, 2 * period


def _scale_stats(s1: dict, s2: dict, l1: int, l2: int, l_full: int) -> dict:
    """Affine extrapolation per statistic: f(L) = f(L1) + (L-L1) * slope."""

    def extrap(a, b):
        slope = (b - a) / (l2 - l1)
        return max(a + (l_full - l1) * slope, 0.0)

    out = {
        "flops": extrap(s1["flops"], s2["flops"]),
        "bytes_accessed": extrap(s1["bytes_accessed"], s2["bytes_accessed"]),
    }
    coll = {}
    for op in set(s1["collectives"]) | set(s2["collectives"]):
        coll[op] = extrap(s1["collectives"].get(op, 0.0),
                          s2["collectives"].get(op, 0.0))
    out["collectives"] = coll
    out["collective_bytes"] = sum(coll.values())
    return out


def probe_cell(cfg, shape, mesh, rules, step_kwargs=None,
               state_rules=None) -> dict:
    """Differential cost probes: count the L1/L2-layer cuts at the full
    input shape, under the whole model's number format, and extrapolate
    per-layer costs to the real depth."""
    l1, l2 = _probe_layers(cfg)
    chips = math.prod(mesh.shape)
    stats = []
    with policy.sized_as(cfg):
        for lp in (l1, l2):
            pcfg = dataclasses.replace(cfg, num_layers=lp)
            fn, args = _rank_step(pcfg, shape, mesh, rules, step_kwargs,
                                  state_rules)
            stats.append(_counted_stats(hlo_stats.count_step(fn, *args),
                                        chips))
    return _scale_stats(stats[0], stats[1], l1, l2, cfg.num_layers)


def _result_bytes(counts: hlo_stats.StepCounts, args) -> int:
    """Bytes of the result's storages that are not the arguments'."""
    held = hlo_stats.storage_bytes(args)
    return sum(n for k, n in hlo_stats.storage_bytes(counts.result).items()
               if k not in held)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             probes: bool = True, variant: str = "baseline") -> dict:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}

    mesh = _mesh(mesh_kind)
    rules = specs.rules_for(mesh, shape)
    cfg, rules, state_rules, step_kwargs = apply_variant(cfg, rules, variant)
    chips = math.prod(mesh.shape)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "variant": variant, "chips": chips, "status": "ok"}

    tokens, useful = model_flops(cfg, shape)
    t0 = time.time()
    try:
        fn, args = _rank_step(cfg, shape, mesh, rules, step_kwargs,
                              state_rules)
    except shd.NotInPort as e:
        return {**record, "status": "skipped", "reason": f"{NOT_IN_PORT} {e}"}
    counts = hlo_stats.count_step(fn, *args)
    record["trace_s"] = round(time.time() - t0, 2)
    # Memory from the full-depth trace.
    record["argument_size_in_bytes"] = counts.argument_bytes
    record["output_size_in_bytes"] = _result_bytes(counts, args)
    record["temp_size_in_bytes"] = counts.peak_bytes - counts.argument_bytes
    record["peak_bytes"] = counts.peak_bytes
    record["fits"] = counts.peak_bytes <= hardware.H100_SXM.hbm_bytes
    del fn, args
    counts.result = None
    record["raw"] = _counted_stats(counts, chips)  # the full-depth count

    # Compute + collective terms from the probes (the count sees the scan
    # interiors; the law's figure is recorded beside it); the memory term
    # from the closed-form traffic model, the counted bytes kept as the
    # unfused upper bound (see core/estimate.py).
    pbytes = 2 if policy.param_dtype(cfg) == torch.bfloat16 else 4
    mbytes = 1.03 if policy.moment_dtype(cfg) == "int8" else 4.0
    bm = estimate.bytes_model(
        cfg, batch=shape.global_batch,
        seq=1 if shape.kind == "decode" else shape.seq_len,
        kind=shape.kind, param_bytes=pbytes, moment_bytes=mbytes,
        cache_len=shape.seq_len if shape.kind == "decode" else 0)
    record["bytes_model"] = bm
    if probes:
        t2 = time.time()
        ext = probe_cell(cfg, shape, mesh, rules, step_kwargs, state_rules)
        record["probe_s"] = round(time.time() - t2, 2)
        rec_f, rec_b = estimate.recurrence_correction(cfg, tokens,
                                                      shape.kind)
        ext["recurrence_correction"] = {"flops": rec_f, "bytes": rec_b,
                                        "added": False}
        record["extrapolated"] = ext
        flops = ext["flops"]
        coll_bytes = ext["collective_bytes"]
    else:
        raw = record["raw"]
        flops = raw["flops"]
        coll_bytes = raw["collective_bytes"]
    bytes_accessed = bm["total"]

    roof = cost_model.roofline(flops, bytes_accessed, coll_bytes, chips,
                               model_flops=useful)
    record.update({"model_flops": useful, "tokens": tokens,
                   "roofline": roof.row(),
                   "roofline_source": "model of the H100 SXM data sheet "
                                      "(hardware.H100_SXM), not measured"})
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", choices=list(VARIANTS), default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the differential cost probes (faster)")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    if args.all:
        for arch in configs.list_archs():
            for shape in SHAPES:
                for mesh_kind in ("single", "multi"):
                    cells.append((arch, shape, mesh_kind))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape, args.mesh))

    failures = 0
    for arch, shape, mesh_kind in cells:
        tag = f"{arch}__{shape}__{mesh_kind}"
        if args.variant != "baseline":
            tag += f"__{args.variant}"
        try:
            rec = run_cell(arch, shape, mesh_kind, probes=not args.no_probes,
                           variant=args.variant)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
            failures += 1
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" dominant={r['dominant']}"
                     f" compute={r['compute_s']:.4f}s"
                     f" memory={r['memory_s']:.4f}s"
                     f" coll={r['collective_s']:.4f}s"
                     f" useful={r['useful_fraction']:.2f}"
                     f" fits={rec['fits']}"
                     f" (trace {rec['trace_s']}s)")
        elif status == "skipped":
            extra = f" ({rec['reason']})"
        else:
            extra = f" {rec['error']}"
        print(f"[{status:7s}] {tag}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
