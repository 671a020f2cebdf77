"""Gradient compression for the data-parallel reduce.  Counterpart of
`repro.parallel.compression`.

`compressed_psum` quantizes a tensor to int8 with one f32 scale per
256-element block, all-reduces the quanta as int32 over a process group
and dequantizes: a quarter of an f32 all-reduce's bytes at an error of
at most half a block's scale.  The cheaper default is the bf16 gradient
cast of `launch.steps.make_train_step(grad_dtype=)`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

QBLOCK = 256


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (None: the world)
    through an int8-quantized all-reduce, in two phases: the ranks agree
    on each block's scale (an all-reduce MAX of the blocks' largest |x|,
    1/256 of the payload), then quantize with it, sum the quanta as int32
    and dequantize.  The reference's f32 operations in its order
    (`torch.round` and `jnp.round` both round half to even)."""
    count = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, QBLOCK)
    shared_max = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    dist.all_reduce(shared_max, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(shared_max / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    out = (qsum.to(torch.float32) * scale).reshape(-1)
    return out[:x.numel()].reshape(x.shape) / count
