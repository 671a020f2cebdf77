"""Input-shape sets and (arch x shape) applicability rules.  A copy of
`repro.configs.shapes`, kept here because this package never imports the
JAX one."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs, with the reason if skipped:
    encoder-only archs have no decode step; ``long_500k`` needs
    sub-quadratic attention (SSM / hybrid / sliding-window qualify; pure
    full-attention archs skip)."""
    if cfg.family == "encoder" and shape.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.sliding_window is not None)
        if not sub_quadratic:
            return False, "full attention is quadratic at 500k; skipped per brief"
    return True, ""


def cells(cfg: ModelConfig):
    """All applicable ShapeSpecs for an arch."""
    return [s for s in SHAPES.values() if applicable(cfg, s)[0]]
