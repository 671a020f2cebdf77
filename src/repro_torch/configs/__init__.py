"""Architecture config registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (the exact published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).
"""

from __future__ import annotations

import importlib

ARCHS = (
    "jamba_1_5_large_398b",
    "phi3_5_moe_42b",
    "qwen3_moe_235b",
    "phi3_mini_3_8b",
    "qwen3_14b",
    "qwen2_5_32b",
    "h2o_danube_1_8b",
    "hubert_xlarge",
    "rwkv6_7b",
    "internvl2_2b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen3-14b": "qwen3_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "hubert-xlarge": "hubert_xlarge",
    "rwkv6-7b": "rwkv6_7b",
    "internvl2-2b": "internvl2_2b",
})


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def list_archs():
    return list(ARCHS)
