"""Number-format policy per architecture (the paper's 'number format'
knob).  Counterpart of `repro.launch.policy`, with the same thresholds.

Models above ~100B parameters store bf16 weights and int8 blockwise
optimizer moments; smaller models keep f32 master weights and f32
moments.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.models.config import ModelConfig

BIG_MODEL_PARAMS = 100e9
FSDP_PARAMS = 10e9

_SIZED: contextvars.ContextVar = contextvars.ContextVar("policy_size",
                                                        default=None)


@contextlib.contextmanager
def sized_as(cfg: ModelConfig):
    """Inside the block every policy reads ``cfg``'s parameter count, so
    a depth cut of a model (the dry run's probes) keeps the whole
    model's number format and FSDP."""
    tok = _SIZED.set(cfg.param_count())
    try:
        yield
    finally:
        _SIZED.reset(tok)


def _params(cfg: ModelConfig) -> int:
    sized = _SIZED.get()
    return cfg.param_count() if sized is None else sized


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return (torch.bfloat16 if _params(cfg) > BIG_MODEL_PARAMS
            else torch.float32)


def moment_dtype(cfg: ModelConfig) -> str:
    return "int8" if _params(cfg) > BIG_MODEL_PARAMS else "float32"


def use_fsdp(cfg: ModelConfig) -> bool:
    """>=10B params: parameters are stored sharded over the data axes too
    (FSDP), as `launch.specs.param_pspecs` places them and the
    data-parallel step gathers them at use."""
    return _params(cfg) >= FSDP_PARAMS
