"""In-house AdamW.  Counterpart of `repro.optim.adamw`.

- global-norm gradient clipping
- linear-warmup + cosine decay schedule
- optional **blockwise int8 moment quantization**: moments stored as int8
  with one f32 scale per 128-wide block of the last dim, dequantized and
  requantized around each update.

`update` works **in place** (the parameters, the moments and the step
counter; the JAX version returns new trees), so one card holds one copy
of the train state.  Its arithmetic is the reference's op for op in f32:
the schedule, the bias corrections ``1 - b ** step`` (computed on f32
tensors, as the reference's ``b1 ** step.astype(f32)``; Python floats
would round otherwise) and each leaf's update.  The global norm sums one
square-sum per leaf in JAX's flatten order (`repro_torch.tree`, sorted
keys).  Scalars never stand left of a tensor division (``float /
tensor`` in torch multiplies by a reciprocal, which rounds twice).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "int8"


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), 0-d f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    mult = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, mult)


# ---------------------------------------------------------------------------
# Blockwise int8 moment quantization
# ---------------------------------------------------------------------------

def quantize_blockwise(x: torch.Tensor) -> dict:
    """f32 -> {q: int8 (last dim padded to a multiple of 128), scale: f32
    per 128-block}.  The original last-dim size is not stored;
    `dequantize_blockwise` takes it from the caller."""
    xp = x.to(torch.float32)
    pad = (-xp.shape[-1]) % QBLOCK
    if pad:
        xp = F.pad(xp, (0, pad))
    blocks = xp.reshape(*xp.shape[:-1], -1, QBLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-12))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return {"q": q.reshape(xp.shape), "scale": scale}


def dequantize_blockwise(packed: dict, orig_last: int) -> torch.Tensor:
    q = packed["q"].to(torch.float32)
    blocks = q.reshape(*q.shape[:-1], -1, QBLOCK)
    x = (blocks * packed["scale"][..., None]).reshape(q.shape)
    return x[..., :orig_last]


def _moment_zeros(p: torch.Tensor, moment_dtype: str):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return quantize_blockwise(z) if moment_dtype == "int8" else z


# ---------------------------------------------------------------------------
# State / update
# ---------------------------------------------------------------------------

def init_state(params, cfg: AdamWConfig) -> dict:
    """``{"step": 0-d int32, "m": tree, "v": tree}`` on the parameters'
    device; each moment leaf f32 zeros, or an int8 ``{q, scale}``."""
    device = tree_lib.leaves(params)[0].device
    zeros = lambda p: _moment_zeros(p, cfg.moment_dtype)  # noqa: E731
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_lib.map_structure(zeros, params),
        "v": tree_lib.map_structure(zeros, params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of each leaf's f32 square-sum, the leaves summed in
    JAX's flatten order."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_lib.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``like``'s device, filled there: a
    copy from the host would wait for the card."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def update(params, grads, opt_state: dict, cfg: AdamWConfig,
           grad_norm: torch.Tensor | None = None):
    """One AdamW step, in place.  Returns ``(params, opt_state, metrics)``
    (the same trees, updated), ``metrics`` holding ``grad_norm`` (before
    clipping) and ``lr``, 0-d f32 tensors.  ``grad_norm`` stands for
    ``global_norm(grads)`` where the trees hold one rank's shards of the
    leaves (ZeRO): the update is elementwise but for the clip."""
    step = opt_state["step"]
    step.add_(1)
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(
        _f32(cfg.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    c1 = 1 - torch.pow(_f32(b1, step_f), step_f)
    c2 = 1 - torch.pow(_f32(b2, step_f), step_f)
    int8 = cfg.moment_dtype == "int8"

    def leaf_update(p, g, m, v):
        g = g.to(torch.float32) * scale
        last = p.shape[-1]
        m_f = dequantize_blockwise(m, last) if int8 else m
        v_f = dequantize_blockwise(v, last) if int8 else v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * torch.square(g)
        upd = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
        p_f = p.to(torch.float32)
        p.copy_(p_f - lr * (upd + cfg.weight_decay * p_f))
        for old, new in ((m, m_f), (v, v_f)):
            if int8:
                packed = quantize_blockwise(new)
                old["q"].copy_(packed["q"])
                old["scale"].copy_(packed["scale"])
            else:
                old.copy_(new)

    tree_lib.map_structure(leaf_update, params, grads, opt_state["m"],
                           opt_state["v"])
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
