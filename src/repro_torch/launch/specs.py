"""Abstract inputs and state, and their shardings, for every (arch x
shape) cell.  Counterpart of `repro.launch.specs`.

Abstract tensors live on the ``meta`` device: shapes and dtypes with no
storage.  `abstract_params` walks `transformer.init` with a generator
whose device reads ``meta``, so every draw is shape-only and no
full-size model is allocated.  A spec is a tuple of mesh-axis entries
(`parallel.sharding`); the shardings of a state are its specs' DTensor
placements.  Every function that reads a mesh reads only its axis names
and sizes, so a `launch.mesh.MeshShape` stands in for a mesh of 256
ranks.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import internvl2_2b
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd

Tree = Any


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def rules_for(mesh, shape: ShapeSpec | None = None) -> shd.Rules:
    multi = "pod" in axis_names(mesh)
    rules = shd.multi_pod_rules() if multi else shd.single_pod_rules()
    if shape is not None and shape.kind == "decode":
        sizes = axis_sizes(mesh)
        dp = 1
        for a in rules.table["dp"]:
            dp *= sizes[a]
        rules = shd.decode_rules(
            rules, batch_replicated=bool(shape.global_batch % dp))
    return rules.with_sizes(mesh)


# ---------------------------------------------------------------------------
# Batch specs (train / prefill)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The abstract train/prefill batch: the inputs and the labels."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "frame":
        return {"frames": _abstract((b, s, cfg.frontend_dim), torch.bfloat16),
                "labels": _abstract((b, s), torch.int32)}
    batch: dict = {}
    if cfg.frontend == "patch":
        npatch = min(internvl2_2b.NUM_PATCHES, s // 4)
        batch["patches"] = _abstract((b, npatch, cfg.frontend_dim),
                                     torch.bfloat16)
        batch["tokens"] = _abstract((b, s - npatch), torch.int32)
        batch["labels"] = _abstract((b, s), torch.int32)
        return batch
    batch["tokens"] = _abstract((b, s), torch.int32)
    batch["labels"] = _abstract((b, s), torch.int32)
    return batch


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules) -> dict:
    """Each batch entry's fitted spec: its first dim over ``batch``."""
    def one(t):
        axes = ("batch",) + (None,) * (t.ndim - 1)
        return fit_spec(rules.spec(*axes), tuple(t.shape), rules)

    return {k: one(v) for k, v in batch_specs(cfg, shape).items()}


# ---------------------------------------------------------------------------
# State specs (params + optimizer)
# ---------------------------------------------------------------------------

class _ShapeOnly(torch.Generator):
    """A generator whose device reads ``meta``: `transformer.init` then
    draws every leaf on the meta device."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(cfg: ModelConfig, dtype=None) -> Tree:
    if dtype is None:
        from repro_torch.launch import policy
        dtype = policy.param_dtype(cfg)
    return transformer.init(cfg, _ShapeOnly(), dtype=dtype)


def abstract_opt_state(params: Tree, opt_cfg: adamw.AdamWConfig) -> Tree:
    return adamw.init_state(params, opt_cfg)


def logical_to_pspec(tree: Tree, rules: shd.Rules) -> Tree:
    return tree_lib.map_structure(lambda axes: rules.spec(*axes), tree)


def fit_spec(spec, shape, rules: shd.Rules) -> tuple:
    """Drop the entries whose mesh-axis product does not divide the dim."""
    return shd.fitted(spec, shape, rules)


def fit_pspecs(pspec_tree: Tree, abs_tree: Tree, rules: shd.Rules) -> Tree:
    return tree_lib.map_structure(
        lambda ps, t: fit_spec(ps, tuple(t.shape), rules), pspec_tree,
        abs_tree)


def param_pspecs(cfg: ModelConfig, rules: shd.Rules, mesh=None) -> Tree:
    params_abs = abstract_params(cfg)
    base = fit_pspecs(logical_to_pspec(transformer.param_specs(cfg), rules),
                      params_abs, rules)
    from repro_torch.launch import policy
    if mesh is None or not policy.use_fsdp(cfg):
        return base
    # FSDP storage: the DP axes on the first free divisible dim of each
    # leaf, the weights gathered at use
    dp_axes = tuple(rules.table.get("dp") or ())
    return tree_lib.map_structure(
        lambda ps, t: zero_shard(ps, tuple(t.shape), mesh, dp_axes), base,
        params_abs)


def zero_shard(pspec, shape, mesh, dp_axes: tuple) -> tuple:
    """ZeRO-1/FSDP: the DP axes on the first unsharded, divisible dim; no
    change if the spec already uses a DP axis."""
    sizes = axis_sizes(mesh)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    if dp <= 1:
        return pspec
    used = set()
    for e in pspec:
        if e is None:
            continue
        used.update(e if isinstance(e, tuple) else (e,))
    if used & set(dp_axes):
        return pspec
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dp == 0 and dim >= dp:
            entries[i] = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]
            return tuple(entries)
    return pspec


def opt_pspecs(cfg: ModelConfig, params_abs: Tree, opt_abs: Tree,
               rules: shd.Rules, mesh, zero: bool = True) -> Tree:
    """Moment specs: the parameter's plus the ZeRO DP-axis shard.  An int8
    moment ``{"q", "scale"}`` takes the parameter's (ZeRO) spec on both,
    cut to each one's rank and fitted to its shape."""
    p_pspecs = param_pspecs(cfg, rules, mesh)
    dp_axes = tuple(rules.table.get("dp") or ())

    def moment_spec(ps, p, m):
        spec = zero_shard(ps, tuple(p.shape), mesh, dp_axes) if zero else ps
        if isinstance(m, dict):
            entries = list(spec) + [None] * (p.ndim - len(spec))
            return {"q": fit_spec(tuple(entries), tuple(m["q"].shape), rules),
                    "scale": fit_spec(tuple(entries[:m["scale"].ndim]),
                                      tuple(m["scale"].shape), rules)}
        return fit_spec(spec, tuple(m.shape), rules)

    m_specs = tree_lib.map_structure(moment_spec, p_pspecs, params_abs,
                                     opt_abs["m"])
    return {"step": (), "m": m_specs, "v": m_specs}


def to_placements(pspec_tree: Tree, mesh) -> Tree:
    """The DTensor placements of every spec of a tree."""
    return tree_lib.map_structure(lambda ps: shd.placements(ps, mesh),
                                  pspec_tree)


def state_pspecs(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                 rules: shd.Rules, zero: bool = True) -> tuple[Tree, Tree]:
    """(abstract state, specs) of ``{"params", "opt"}``."""
    params_abs = abstract_params(cfg)
    opt_abs = abstract_opt_state(params_abs, opt_cfg)
    state_abs = {"params": params_abs, "opt": opt_abs}
    return state_abs, {"params": param_pspecs(cfg, rules, mesh),
                       "opt": opt_pspecs(cfg, params_abs, opt_abs, rules,
                                         mesh, zero)}


def state_shardings(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                    rules: shd.Rules, zero: bool = True):
    """(abstract state, placements) of ``{"params", "opt"}``."""
    state_abs, specs = state_pspecs(cfg, opt_cfg, mesh, rules, zero)
    return state_abs, to_placements(specs, mesh)


# ---------------------------------------------------------------------------
# Decode specs
# ---------------------------------------------------------------------------

def decode_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                  state_rules=None):
    """(abstract {params, cache, tokens}, their specs) of a serve step:
    a bf16 contiguous cache of ``shape``'s batch and length."""
    params_abs = abstract_params(cfg)
    b = shape.global_batch
    cache_abs = transformer.cache_init(cfg, b, shape.seq_len,
                                       dtype=torch.bfloat16, device="meta")
    p_pspecs = param_pspecs(cfg, state_rules or rules, mesh)
    c_pspecs = fit_pspecs(
        logical_to_pspec(transformer.cache_specs(cfg), rules), cache_abs,
        rules)
    tok_abs = _abstract((b, 1), torch.int32)
    tok_spec = fit_spec((rules.table.get("batch"), None), (b, 1), rules)
    abs_ = {"params": params_abs, "cache": cache_abs, "tokens": tok_abs}
    return abs_, {"params": p_pspecs, "cache": c_pspecs, "tokens": tok_spec}


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                 state_rules=None):
    """(abstract {params, cache, tokens}, placements) of a serve step."""
    abs_, specs = decode_pspecs(cfg, shape, mesh, rules, state_rules)
    return abs_, to_placements(specs, mesh)
