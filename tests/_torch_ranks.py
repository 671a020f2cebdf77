"""Multi-rank jobs of the port's CPU tests, each rank a process of its
own in one gloo process group.

`spawn(job, world, tmp_path, args)` starts ``world`` processes of

    python tests/_torch_ranks.py <job> <rank> <world> <dir>

which join through a `FileStore` in ``dir`` (no port to collide on under
pytest-xdist), run ``job(rank, world, args)`` (``args`` read from
``dir/args.pt``) and save what it returns to ``dir/<rank>.pt``.  The
whole group has one time limit: past it every rank is killed and the
test fails, so a hung rank cannot hold the suite.  The jobs import
torch and the port only, never JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def spawn(job: str, world: int, tmp_path, args: dict | None = None,
          timeout: float = 180.0) -> list:
    """Run ``job`` on ``world`` ranks; the list of what each returned."""
    d = Path(tmp_path) / f"{job}-{world}-{time.monotonic_ns()}"
    d.mkdir(parents=True)
    torch.save(args or {}, d / "args.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    procs = []
    for r in range(world):
        with open(d / f"{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, job, str(r), str(world), str(d)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{job} on {world} ranks: over {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, (f"{job}: ranks {bad} failed:\n"
                     + (d / f"{bad[0]}.log").read_text()[-3000:])
    return [torch.load(d / f"{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Jobs (run inside a rank)
# ---------------------------------------------------------------------------

def _full(tree):
    from repro_torch import tree as tree_lib
    from repro_torch.parallel.sharding import full_tensor
    return tree_lib.map_structure(lambda t: full_tensor(t).clone(), tree)


def job_compression(rank, world, args):
    """`compressed_psum` of row ``rank`` of ``args["vals"]``."""
    from repro_torch.parallel.compression import compressed_psum
    return {"out": compressed_psum(args["vals"][rank])}


def job_placements(rank, world, args):
    """``args["full"]`` on a (2, 2, 2) ``pod, data, model`` mesh under
    ``(("pod", "data"), None)``: this rank's block by `local_shard` and
    by `distribute_tensor` with `placements`, and the whole again."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as shd
    mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
    full, spec = args["full"], (("pod", "data"), None)
    mine = shd.local_shard(full, spec, mesh)
    dt = distribute_tensor(full, mesh, shd.placements(spec, mesh))
    rules = shd.multi_pod_rules().with_sizes(mesh)
    with shd.use_rules(rules):
        kept = shd.constrain(dt, "batch", "heads")  # 3 heads on 2: dropped
        whole = shd.constrain(dt, None, None)
    with shd.use_rules(shd.data_parallel_attention(rules)):
        gathered_weight = shd.gather_weight(dt)
    return {"coord": tuple(mesh.get_coordinate()), "mine": mine.clone(),
            "dtensor": dt.to_local().clone(),
            "gathered": shd.gather_full(mine, spec, mesh),
            "full_tensor": shd.full_tensor(shd.distribute(full, spec, mesh)),
            "spec_of": shd.spec_of(dt),
            "constrained": (shd.spec_of(kept), kept.to_local().clone()),
            "replicated": (shd.spec_of(whole), whole.to_local().clone()),
            "gather_weight": (shd.spec_of(gathered_weight),
                              gathered_weight.to_local().clone())}


def job_moe(rank, world, args):
    """`moe.apply_sharded` on a (2, 4) mesh under the single-pod rules,
    this rank's data rows of ``args["x"]`` in, at each capacity factor."""
    import dataclasses

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shd
    mesh = mesh_lib.make_host_mesh(2, 4, device_type="cpu")
    rules = shd.single_pod_rules().with_sizes(mesh)
    x = args["x"]
    d = mesh_lib.axis_index(mesh, "data")
    rows = x.shape[0] // 2
    out = {"data": d, "model": mesh_lib.axis_index(mesh, "model")}
    for cf in args["factors"]:
        cfg = dataclasses.replace(args["cfg"], capacity_factor=cf)
        with mesh_lib.set_mesh(mesh), shd.use_rules(rules):
            y, aux = moe.apply_sharded(args["params"],
                                       x[d * rows:(d + 1) * rows], cfg)
        out[cf] = {"out": y, "aux": aux}
    return out


def _dp_state(cfg, opt, params, mesh, rules):
    from repro_torch import tree as tree_lib
    from repro_torch.launch import specs
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    state = {"params": tree_lib.map_structure(lambda t: t.clone(), params),
             "opt": adamw.init_state(params, opt)}
    _, pspecs = specs.state_pspecs(cfg, opt, mesh, rules)
    return tree_lib.map_structure(
        lambda t, s: shd.distribute(t, s, mesh), state, pspecs), pspecs


def job_train(rank, world, args):
    """One data-parallel step of ``args["cfg"]`` from ``args["params"]``
    on ``args["batch"]`` over a (world, 1) mesh, per variant: ``dp``
    (moments ZeRO-sharded), ``fsdp`` (`policy.use_fsdp` forced on),
    ``bf16`` (``grad_dtype=bfloat16``).  Returns the loss, the reduced
    gradients, the whole state after the step, the step's specs."""
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import policy, specs, steps
    from repro_torch.optim import adamw
    disable_tf32()
    mesh = mesh_lib.make_host_mesh(world, 1, device_type="cpu")
    rules = specs.rules_for(mesh)
    cfg = args["cfg"]
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    use_fsdp = policy.use_fsdp
    out = {}
    for variant in args["variants"]:
        policy.use_fsdp = ((lambda c: True) if variant == "fsdp"
                           else use_fsdp)
        state, pspecs = _dp_state(cfg, opt, args["params"], mesh, rules)
        step = steps.make_train_step(
            cfg, opt, compute_dtype=torch.float32, mesh=mesh, rules=rules,
            grad_dtype=torch.bfloat16 if variant == "bf16" else None)
        state, m, grads = step(state, args["batch"], return_grads=True)
        out[variant] = {"loss": float(m["loss"]),
                        "total_loss": float(m["total_loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "grads": grads, "state": _full(state),
                        "pspecs": pspecs}
    policy.use_fsdp = use_fsdp
    return out


def job_elastic_save(rank, world, args):
    """FSDP on a (world, 1) mesh: one step, then a checkpoint of the
    state at step 1 in ``args["dir"]`` (written by rank 0)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import policy, specs, steps
    disable_tf32()
    policy.use_fsdp = lambda c: True
    mesh = mesh_lib.make_host_mesh(world, 1, device_type="cpu")
    rules = specs.rules_for(mesh)
    cfg, opt = args["cfg"], args["opt"]
    state, pspecs = _dp_state(cfg, opt, args["params"], mesh, rules)
    step = steps.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                 mesh=mesh, rules=rules)
    state, _ = step(state, args["batch"])
    CheckpointManager(args["dir"]).save(1, state, blocking=True)
    return {"pspecs": pspecs}


def job_elastic_restore(rank, world, args):
    """The checkpoint restored onto ``remesh(world, 1)`` by its FSDP
    specs, then the next step: the restored state (whole), the specs, and
    the step's loss, gradients and state after."""
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import policy, specs, steps
    from repro_torch.runtime import elastic
    from repro_torch.runtime.fault_tolerance import restore_onto
    disable_tf32()
    policy.use_fsdp = lambda c: True
    mesh = elastic.remesh(world, 1, device_type="cpu")
    rules = specs.rules_for(mesh)
    cfg, opt = args["cfg"], args["opt"]
    like, pspecs = specs.state_pspecs(cfg, opt, mesh, rules)
    state, at = restore_onto(CheckpointManager(args["dir"]), like, mesh,
                             pspecs)
    restored = _full(state)
    local_shapes = tree_lib.map_structure(
        lambda t: tuple(t.to_local().shape), state)
    step = steps.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                 mesh=mesh, rules=rules)
    state, m, grads = step(state, args["batch"], return_grads=True)
    return {"step": at, "restored": restored, "pspecs": pspecs,
            "local_shapes": local_shapes, "loss": float(m["loss"]),
            "grads": grads, "state": _full(state)}


def job_train_cli(rank, world, args):
    """`launch.train.main` on every rank, as `torchrun` runs it, then
    again with ``--resume``: each run's printed lines."""
    import contextlib
    import io

    from repro_torch.launch import train
    out = []
    for extra in ([], ["--resume"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(args["argv"] + extra + args["more"] * bool(extra))
        out.append({"rc": rc, "lines": buf.getvalue().splitlines()})
    return out


def job_tp_train(rank, world, args):
    """Per case of ``args["cases"]`` (``cfg``, whole ``params``, global
    ``batch``, ``mesh`` (data, model), ``sp``, ``moments``, the AdamW
    moment dtype): one train step over the
    mesh under `specs.rules_for` (with `sharding.sequence_parallel` for
    ``sp``) from a state placed by `specs.state_pspecs`, then the
    prefill step's greedy tokens of this rank's rows, from the placed
    weights' blocks (`steps.rank_params`).  Returns per case the loss,
    total loss, gradient norm, the gradients (whole), the whole state
    after, and the tokens with this rank's data index."""
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs, steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    disable_tf32()
    out = {}
    for case in args["cases"]:
        cfg, batch = case["cfg"], case["batch"]
        opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                                moment_dtype=case["moments"])
        mesh = mesh_lib.make_host_mesh(*case["mesh"], device_type="cpu")
        rules = specs.rules_for(mesh)
        if case.get("sp"):
            rules = shd.sequence_parallel(rules)
        state, _ = _dp_state(cfg, opt, case["params"], mesh, rules)
        prefill = steps.make_prefill_step(cfg, torch.float32, mesh=mesh,
                                          rules=rules)
        with mesh_lib.set_mesh(mesh), shd.use_rules(rules):
            blocks = steps.rank_params(cfg, state["params"], mesh, rules)
        d = mesh_lib.axis_index(mesh, "data")
        rows = batch["tokens"].shape[0] // case["mesh"][0]
        toks = prefill(blocks, {k: v[d * rows:(d + 1) * rows]
                                for k, v in batch.items()})
        step = steps.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                     mesh=mesh, rules=rules)
        state, m, grads = step(state, batch, return_grads=True)
        out[case["name"]] = {
            "loss": float(m["loss"]), "total_loss": float(m["total_loss"]),
            "grad_norm": m["grad_norm"].clone(), "grads": grads,
            "state": _full(state), "tokens": toks, "data": d}
    return out


def job_tp_layers(rank, world, args):
    """Each layer of ``args["cfg"]`` (attention, SwiGLU, embedding,
    unembedding, fused loss) on a (1, world) mesh under the single-pod
    rules: forward and the gradients of ``sum(y * cot)`` for a fixed
    cotangent, on this rank's blocks (`transformer.compute_specs`), the
    gradients gathered whole."""
    from repro_torch import tree as tree_lib
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import layers, transformer
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.loss import fused_cross_entropy
    disable_tf32()
    cfg, a = args["cfg"], args
    mesh = mesh_lib.make_host_mesh(1, world, device_type="cpu")
    rules = specs.rules_for(mesh)
    cs = transformer.compute_specs(cfg, rules)
    layer_cs = tree_lib.map_structure(lambda c: c[1:], cs["blocks"])
    out = {}

    def run(name, params, spec, fn, *inputs):
        with mesh_lib.set_mesh(mesh), shd.use_rules(rules):
            blk = tree_lib.map_structure(
                lambda t, c: shd.compute_block(t, c, mesh).clone()
                .requires_grad_(), params, spec)
            xs = [x.clone().requires_grad_() if x.is_floating_point() else x
                  for x in inputs]
            y = fn(blk, *xs)
            y.backward(a["cot"][name] if y.ndim else None)
            grads = tree_lib.map_structure(
                lambda t, c: shd.gather_full(t.grad, c, mesh), blk, spec)
            out[name] = {"y": y.detach(), "grads": grads,
                         "dx": [x.grad for x in xs if x.is_floating_point()]}

    x, pos = a["x"], torch.arange(a["x"].shape[1])
    run("attention", a["layer"]["mixer"], layer_cs["mixer"],
        lambda p, x: layers.attention_apply(p, x, cfg, pos)[0], x)
    run("mlp", a["layer"]["mlp"], layer_cs["mlp"],
        lambda p, x: layers.swiglu_apply(p, x, cfg.d_ff), x)
    run("embed", a["embed"], cs["embed"],
        lambda p, t: layers.embedding_lookup(p, t, cfg.vocab_size),
        a["tokens"])
    cot = a["cot"]["unembed"]

    def logits_dot(p, x):
        y = layers.unembed(p, x, cfg.vocab_size)
        s = shd.split("vocab", cfg.vocab_size)
        return shd.reduce_out((y * shd.block(cot, 2, cfg.vocab_size, s))
                              .sum(), s)

    run("unembed", a["embed"], cs["embed"], logits_dot, x)
    run("loss", a["embed"], cs["embed"], lambda p, x: fused_cross_entropy(
        x, p["table"], a["labels"], chunk=a["chunk"],
        vocab=cfg.vocab_size)[0], x)
    return out


def job_tp_decode(rank, world, args):
    """Per case (``cfg``, whole ``params``, a whole cache with its
    ``lengths``, its ``paged`` spec or None, first ``tokens``):
    ``args["steps"]`` greedy decode steps on a (1, world) mesh under
    `decode_rules` on this rank's block of the cache
    (`transformer.cache_block`: a contiguous attention cache split by
    sequence, a paged pool whole, the recurrent states over heads or
    ``d_in``).  Returns the tokens and whether the rows split."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs, steps
    from repro_torch.models import transformer
    disable_tf32()
    mesh = mesh_lib.make_host_mesh(1, world, device_type="cpu")
    out = {}
    for case in args["cases"]:
        cfg, cache = case["cfg"], case["cache"]
        b = cache["lengths"].shape[0]
        rules = specs.rules_for(mesh, ShapeSpec("d", "decode", 1, b))
        mine = transformer.cache_block(cfg, cache, rules, mesh)
        step = steps.make_serve_step(cfg, torch.float32,
                                     paged=case.get("paged"), mesh=mesh,
                                     rules=rules)
        tok, seen = case["tokens"], []
        for _ in range(args["steps"]):
            tok, mine = step(case["params"], mine, tok)
            seen.append(tok)
        out[case["name"]] = {"tokens": torch.cat(seen, 1),
                             "kv_split": bool(mine.get("kv_split"))}
    return out


def job_tp_ring_bf16(rank, world, args):
    """A sliding-window model's ring of bf16 K/V rows split by sequence
    over a (1, world) mesh under `decode_rules`: for each entry of
    ``args["x"]`` (new tokens a slot -> input), `layers.attention_apply`
    with ``kv_split`` on this rank's segment of the whole ``args["cache"]``
    at the slots' ``args["lengths"]``.  Returns each output and the
    segment after the writes."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import layers
    from repro_torch.parallel import sharding as shd
    disable_tf32()
    cfg, cache, lengths = args["cfg"], args["cache"], args["lengths"]
    mesh = mesh_lib.make_host_mesh(1, world, device_type="cpu")
    rules = specs.rules_for(mesh, ShapeSpec("d", "decode", 1,
                                            lengths.shape[0]))
    rows = cache["k"].shape[1] // world
    out = {}
    for s, x in args["x"].items():
        seg = {n: c[:, rank * rows:(rank + 1) * rows].clone()
               for n, c in cache.items()}
        pos = lengths[:, None] + torch.arange(s, dtype=torch.int32)
        with mesh_lib.set_mesh(mesh), shd.use_rules(rules):
            y, seg = layers.attention_apply(args["params"], x, cfg, pos,
                                            cache=seg, lengths=lengths,
                                            kv_split=True)
        out[s] = {"y": y, "cache": seg}
    return out


def job_recurrent_layers(rank, world, args):
    """RWKV6's time and channel mixes and Mamba on a (1, world) mesh under
    the single-pod rules, each case of ``args["cases"]`` (``cfg``,
    ``kind``, hybrid sub-layer ``sub``, the layer's whole ``params``,
    ``x``, cotangent ``cot``, the whole decode ``state`` of the mixer and
    its step input ``x_step``): forward and the gradients of
    ``sum(y * cot)`` on this rank's blocks (`transformer.compute_specs`),
    gathered whole, then one decode step from this rank's block of the
    state, the new state gathered whole; for Mamba also ``in_proj``'s
    block from a DTensor stored as the JAX specs store it, and back
    (`sharding.compute_block`, `sharding.block_of`).  Per model of
    ``args["caches"]`` (``cfg``, a whole cache): `transformer.cache_block`
    of it under `decode_rules`, and each leaf's compute spec."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import rwkv, ssm, transformer
    from repro_torch.parallel import sharding as shd
    disable_tf32()
    mesh = mesh_lib.make_host_mesh(1, world, device_type="cpu")
    rules = specs.rules_for(mesh)
    out = {"cache_block": {}, "compute_specs": {}}
    for name, (cfg, cache) in args["caches"].items():
        drules = specs.rules_for(mesh, ShapeSpec(
            "d", "decode", 1, cache["lengths"].shape[0]))
        out["cache_block"][name] = transformer.cache_block(cfg, cache,
                                                           drules, mesh)
        out["compute_specs"][name] = transformer.compute_specs(cfg, rules)
    for case in args["cases"]:
        cfg, kind = case["cfg"], case["kind"]
        cs = transformer.compute_specs(cfg, rules)["blocks"]
        st = transformer.cache_specs(cfg)["blocks"]
        if cfg.family == "hybrid":
            cs, st = cs[str(case["sub"])], st[str(case["sub"])]
        cspec = tree_lib.map_structure(
            lambda c: c[1:], cs["mlp" if kind == "channel" else "mixer"])
        st_spec = {k: shd.fitted(rules.spec(*st[k][1:]), tuple(v.shape),
                                 rules) for k, v in case["state"].items()}
        fn, split = {
            "time": (rwkv.rwkv_time_mix, rwkv.time_split),
            "channel": (rwkv.rwkv_channel_mix, rwkv.channel_split),
            "mamba": (ssm.mamba_apply, ssm.mamba_split)}[kind]
        res = {}
        with mesh_lib.set_mesh(mesh), shd.use_rules(rules):
            s = split(cfg)
            blk = tree_lib.map_structure(
                lambda t, c: shd.compute_block(t, c, mesh).clone()
                .requires_grad_(), case["params"], cspec)
            x = case["x"].clone().requires_grad_()
            y = shd.leave(fn(blk, shd.enter(x, s), cfg)[0], s)
            y.backward(case["cot"])
            res["y"], res["dx"] = y.detach(), x.grad
            res["grads"] = tree_lib.map_structure(
                lambda t, c: shd.gather_full(t.grad, c, mesh), blk, cspec)
            mine = {k: shd.local_shard(v, st_spec[k], mesh).clone()
                    for k, v in case["state"].items()}
            with torch.no_grad():
                ys, new = fn(blk, shd.enter(case["x_step"], s), cfg, mine)
                res["y_step"] = shd.leave(ys, s)
            res["state"] = {k: shd.gather_full(v, st_spec[k], mesh)
                            for k, v in new.items()}
            if kind == "mamba":
                w = case["params"]["in_proj"]
                stored = shd.fitted(rules.spec("embed", "ff"),
                                    tuple(w.shape), rules)
                dt = shd.distribute(w, stored, mesh)
                got = shd.compute_block(dt, cspec["in_proj"], mesh)
                res["in_proj"] = {
                    "block": got,
                    "plain": shd.compute_block(w, cspec["in_proj"], mesh),
                    "back": torch.equal(shd.block_of(
                        got, cspec["in_proj"], stored, mesh), dt.to_local()),
                    "whole": torch.equal(shd.gather_full(
                        got, cspec["in_proj"], mesh), w)}
        out[case["name"]] = res
    return out


def job_chip_tp(rank, world, args):
    """`chip_smoke.py`'s new ``tensor_parallel`` parts on the CPU at SMOKE
    width, on a (1, world) mesh: `tp_decode_layouts` (Qwen3-14B SMOKE),
    `tp_rwkv` (RWKV6 SMOKE at ``args["shape"]`` and a
    ``args["prefill"]``-token prefill) and `mamba_parallel` (Jamba SMOKE).
    Returns each part's record."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import repro_torch.configs as configs
    from repro_torch.convert import disable_tf32
    from repro_torch.kernels.attention import decode, decode_int8
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    disable_tf32()
    mesh = mesh_lib.make_host_mesh(1, world, device_type="cpu")
    rules = specs.rules_for(mesh)
    mods = (decode, decode_int8)

    def peak(res):
        return res

    def free():
        pass

    qcfg = configs.get_smoke("qwen3_14b")
    out = chip_smoke.tp_decode_layouts(
        torch, mods, qcfg,
        transformer.init(qcfg, torch.Generator().manual_seed(0)), mesh,
        "cpu", peak, free)
    opt = adamw.AdamWConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10)
    out.update(chip_smoke.tp_rwkv(
        torch, mods, configs.get_smoke("rwkv6_7b"), opt, mesh, rules, "cpu",
        peak, free, shape=args["shape"], prefill=args["prefill"]))
    out["mamba"] = chip_smoke.mamba_parallel(
        torch, configs, mesh, rules, "cpu",
        cfg=configs.get_smoke("jamba_1_5_large_398b"))
    return out


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to bf16 backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def job_chip_mamba(rank, world, args):
    """`chip_smoke.mamba_parallel` alone on a (1, world) mesh: at Jamba
    SMOKE width on the CPU, or with ``args["device"]`` "cuda" at the
    phase's own width on ``cuda:0``.  With ``args["round_on_each_rank"]``
    Mamba's scan takes the fault of rounding each rank's part of the
    gradients that enter it to bf16 before the ranks' sum (the unsplit
    scan rounds the whole sum once).  Returns the part's record."""
    sys.path.insert(0, str(ROOT))
    import types

    import chip_smoke
    import repro_torch.configs as configs
    from repro_torch.convert import disable_tf32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding as shd
    disable_tf32()
    if args.get("round_on_each_rank"):
        def copy_in(x, s):
            return x if s is None else _RoundGrad.apply(shd.copy_in(x, s))
        ssm.shd = types.SimpleNamespace(**{**vars(shd), "copy_in": copy_in})
    dev = args.get("device", "cpu")
    if dev == "cuda":
        torch.cuda.set_device(0)
    mesh = mesh_lib.make_host_mesh(1, world, device_type=dev,
                                   backend="gloo")
    return chip_smoke.mamba_parallel(
        torch, configs, mesh, specs.rules_for(mesh), dev,
        cfg=(None if dev == "cuda"
             else configs.get_smoke("jamba_1_5_large_398b")))


def _main(job, rank, world, d):
    import torch.distributed as dist
    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"),
                                                         world),
                            rank=rank, world_size=world)
    try:
        args = torch.load(d / "args.pt", weights_only=False)
        res = globals()[f"job_{job}"](rank, world, args)
        torch.save(res, d / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
