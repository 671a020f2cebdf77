"""Public matmul entry: tile selection (eq. 2 / DSE) and the kernel call.
Counterpart of `repro.kernels.matmul.ops`.

On CPU tensors `matmul` runs the plain version (the tile does not
matter there, and none is picked); on the card the CUDA kernel with the given tile, or with
the model's best tile for the shape.  The kernel masks ragged edges, so
nothing is padded.
"""

from __future__ import annotations

import torch

from repro_torch.core import dse, tiling
from repro_torch.kernels.matmul import kernel

_YS = sorted({t.y for t in tiling.HOPPER_TILES})
_XS = sorted({t.x for t in tiling.HOPPER_TILES})
_ZS = sorted({t.z for t in tiling.HOPPER_TILES})


def _fit(v: int, dim: int, sizes) -> int:
    """``v`` shrunk to the smallest built size that covers ``dim``."""
    return min(v, next((s for s in sizes if s >= dim), sizes[-1]))


def clamp_tile(t: tiling.Tile, m: int, n: int, k: int) -> tiling.Tile:
    """Shrink a tile to the problem so tiny shapes do not run mostly
    masked tiles: each side to the smallest built size covering it (a
    shrunk built tile is built: only 256 x 256 is left out)."""
    return tiling.Tile(_fit(t.y, m, _YS), _fit(t.x, n, _XS),
                       _fit(t.z, k, _ZS))


def pick_tile(m: int, n: int, k: int, dtype_bytes: int = 2,
              smem_bytes: int | None = None) -> tiling.Tile:
    """The model's best kernel tile (never worse than the eq. 2 seed),
    clamped to the problem."""
    t = dse.autotune_matmul_tile(m, n, k, smem_bytes=smem_bytes,
                                 dtype_bytes=dtype_bytes)
    return clamp_tile(t, m, n, k)


def matmul(a: torch.Tensor, b: torch.Tensor, tile: tiling.Tile | None = None,
           bias: torch.Tensor | None = None, activation: str | None = None,
           compute_dtype: torch.dtype | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = act(A @ B + bias).

    ``out_dtype`` defaults to A's dtype as given, before ``compute_dtype``
    (e.g. ``torch.bfloat16``) casts A and B; accumulation is f32.  A 1-D
    ``bias`` of length N becomes (1, N).
    """
    out_dtype = out_dtype or a.dtype
    if bias is not None and bias.ndim == 1:
        bias = bias[None, :]
    if compute_dtype is not None:
        a = a.to(compute_dtype)
        b = b.to(compute_dtype)
    if tile is None and a.device.type != "cpu":
        tile = pick_tile(a.shape[0], b.shape[1], a.shape[1],
                         dtype_bytes=a.element_size())
    return kernel.blocked_matmul(a, b, tile, bias=bias,
                                 activation=activation, out_dtype=out_dtype)
