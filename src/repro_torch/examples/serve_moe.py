"""Batched MoE serving example: continuous batching on a smoke-scale
Phi-3.5-MoE through the port's serving stack (prefill, cached decode
through the CUDA decode kernel, expert routing on every token).
Counterpart of the JAX package's ``examples/serve_moe.py``.

Run (on a card; add ``--device cpu`` for the plain PyTorch paths):

    PYTHONPATH=src python -m repro_torch.examples.serve_moe [--device cpu]
"""

from __future__ import annotations

import sys

from repro_torch.launch import serve


def main(argv=None) -> int:
    return serve.main([
        "--arch", "phi3_5_moe_42b", "--smoke",
        "--requests", "6", "--batch", "2",
        "--prompt-len", "12", "--gen", "8",
        *(sys.argv[1:] if argv is None else argv),
    ])


if __name__ == "__main__":
    raise SystemExit(main())
