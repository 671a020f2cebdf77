"""PyTorch/CUDA port of the `repro` serving stack for NVIDIA Hopper.

The JAX package `repro` stays the reference: every module here has a
counterpart of the same name there, takes the same parameter tree (a dict
of stacked, layer-axis leaves) and the same `(B, L, Hkv, dh)` KV-cache
layout, and is tested against it on the CPU.  This package imports torch
and numpy only, never jax or `repro`.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; asking
for ``cuda`` on a host without a card raises (`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) raises when no CUDA card is
    visible: nothing quietly carries on on the CPU.  ``"cpu"`` is for the
    parity tests and CPU rehearsals, where every kernel wrapper takes its
    plain PyTorch version.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
