"""Mamba-style selective SSM block, the SSM half of the Jamba hybrid.
Counterpart of `repro.models.ssm`.

The forward scans the selective recurrence over the sequence (a Python
loop over time where the JAX code has `lax.scan`); decode carries an O(1)
state per layer, ``{"conv": (B, W-1, Din)}`` (the causal conv's tail, in
the cache's dtype) and ``{"h": (B, Din, N)}`` (the SSM state, f32).  The
scan mixes f32 (the step size and the state) with bf16 streams (B, C and
x), which the JAX code promotes to f32; here each bf16 operand is cast to
f32 where it meets an f32 one, to the same values.

Over the model axis (`mamba_split`, as the JAX specs shard the leaves
over ``ff``) each rank runs its block of the ``d_in`` channels: its
columns of both halves of ``in_proj`` (a `parallel.sharding.Parts`
block), the conv, the step projection, A and D at its channels, the scan
over its block of ``h``, and its rows of ``out_proj``; the output is its
part of a sum, which the caller's `sharding.leave` takes.  ``x_proj``
splits by rows, so its product is a partial sum, reduced over the split
before it is cut into the step, B and C; their gradients, parts on each
rank, are summed before B's and C's bf16 rounding rounds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import sharding as shd

Params = dict
# Leaves the forward reads in f32 or in their own dtype, never through
# ``.to(compute dtype)``: the step projection and bias, A_log and D.
OWN_DTYPE_LEAVES = frozenset({"dt_proj", "dt_bias", "A_log", "D"})


def d_inner(cfg) -> int:
    """The inner width ``d_in = ssm_expand * d_model`` (Mamba's ``ff``)."""
    return cfg.ssm_expand * cfg.d_model


def mamba_split(cfg) -> shd.Split | None:
    """The mixer's split over the model axis: ``d_in``, where the rules
    split ``ff`` at that width."""
    return shd.split("ff", d_inner(cfg))


def _in_proj(x: torch.Tensor, w: torch.Tensor, d_in: int, fs):
    """``x @ in_proj`` as (x half, gate half), each at this rank's channels
    under ``fs``: ``w`` whole (2 d_in columns), or this rank's `Parts`
    block (its columns of each half, end to end)."""
    if fs is not None and w.shape[-1] == 2 * d_in:
        c = d_in // fs.n
        halves = w.unflatten(-1, (2, d_in)).narrow(-1, fs.index * c, c)
        return (x @ halves[..., 0, :].to(x.dtype),
                x @ halves[..., 1, :].to(x.dtype))
    return (x @ w.to(x.dtype)).chunk(2, dim=-1)


def mamba_init(generator: torch.Generator, cfg, dtype=torch.float32
               ) -> Params:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n, r = cfg.ssm_state, cfg.ssm_dt_rank
    dev = generator.device
    dense = layers._dense_init
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None, :]
    return {
        "in_proj": dense(generator, (d, 2 * d_in), dtype),
        "conv_w": dense(generator, (cfg.ssm_conv, d_in), dtype, scale=0.1),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": dense(generator, (d_in, r + 2 * n), dtype),
        "dt_proj": dense(generator, (r, d_in), dtype, scale=r ** -0.5),
        "dt_bias": torch.full((d_in,), -4.6, dtype=dtype, device=dev),
        "A_log": torch.log(a.repeat(d_in, 1)),                  # kept f32
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense(generator, (d_in, d), dtype),
    }


def mamba_param_specs(cfg) -> Params:
    return {
        "in_proj": ("embed", "ff"),
        "conv_w": (None, "ff"),
        "conv_b": ("ff",),
        "x_proj": ("ff", None),
        "dt_proj": (None, "ff"),
        "dt_bias": ("ff",),
        "A_log": ("ff", None),
        "D": ("ff",),
        "out_proj": ("ff", "embed"),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, tail: torch.Tensor | None = None):
    """x: (B, S, C); w: (W, C) depthwise causal taps; ``tail`` (B, W-1, C)
    the previous chunk's last inputs.  Returns (out, new tail in the
    tail's dtype)."""
    width = w.shape[0]
    tail_dtype = x.dtype if tail is None else tail.dtype
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)              # (B, S+W-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    new_tail = (xp[:, -(width - 1):, :].to(tail_dtype) if width > 1
                else tail)
    return out + b[None, None, :], new_tail


def _selective_scan(delta, a, b_ssm, c_ssm, x, h0):
    """delta (f32), x: (B, S, Din); a: (Din, N); b_ssm, c_ssm: (B, S, N);
    h0: (B, Din, N) f32.  Returns (y (B, S, Din) f32, the last state)."""
    h = h0
    ys = []
    for t in range(delta.shape[1]):
        d_t = delta[:, t]
        da = torch.exp(d_t[..., None] * a[None])                # (B, Din, N)
        dbx = d_t[..., None] * b_ssm[:, t][:, None, :] * x[:, t][..., None]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, c_ssm[:, t].float()))
    return torch.stack(ys, dim=1), h


def mamba_apply(params: Params, x: torch.Tensor, cfg,
                cache: Params | None = None):
    """x: (B, S, D) -> (out (B, S, D), new cache or None).  Under
    `mamba_split` the output is this rank's part of the sum and the state
    its channels'."""
    b, s, d = x.shape
    d_in = d_inner(cfg)
    n, r = cfg.ssm_state, cfg.ssm_dt_rank
    fs = mamba_split(cfg)

    def blk(name, dim):                 # this rank's channels
        return shd.block(params[name], dim, d_in, fs)

    xb, z = _in_proj(x, params["in_proj"], d_in, fs)
    tail = cache["conv"] if cache is not None else None
    xb, new_tail = _causal_depthwise_conv(
        xb, blk("conv_w", 1).to(x.dtype), blk("conv_b", 0).to(x.dtype), tail)
    xb = F.silu(xb)

    # A partial sum over the split, summed before the step, B and C are
    # cut out of it and before B and C are rounded to bf16.  Each enters
    # the rank's part of the scan through `copy_in` after its rounding,
    # so the ranks' parts of its gradient are summed in f32 before the
    # rounding's backward rounds the sum to bf16, as the unsplit scan
    # rounds its whole sum once.
    dbl = shd.reduce_out((xb @ blk("x_proj", 0).to(x.dtype)).float(), fs)
    dt, b_ssm, c_ssm = torch.split(dbl, [r, n, n], dim=-1)
    dt = shd.copy_in(dt, fs)
    b_ssm, c_ssm = (shd.copy_in(t.to(torch.bfloat16).float(), fs)
                    for t in (b_ssm, c_ssm))
    pre = dt @ blk("dt_proj", 1).float() + blk("dt_bias", 0).float()
    delta = torch.logaddexp(pre, torch.zeros_like(pre))      # softplus
    a = -torch.exp(blk("A_log", 0))

    h0 = (cache["h"] if cache is not None
          else torch.zeros((b, xb.shape[-1], n), dtype=torch.float32,
                           device=x.device))
    # delta stays f32; the B, C and x streams are bf16 values, as in the
    # JAX code.
    y, h_last = _selective_scan(delta, a, b_ssm, c_ssm,
                                xb.to(torch.bfloat16), h0)
    y = (y + blk("D", 0)[None, None, :] * xb.float()).to(x.dtype)
    y = y * F.silu(z)
    out = y @ blk("out_proj", 0).to(x.dtype)
    new_cache = {"conv": new_tail, "h": h_last} if cache is not None else None
    return out, new_cache


def mamba_cache_init(cfg, batch: int, dtype=torch.bfloat16, device=None
                     ) -> Params:
    d_in = d_inner(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_in, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }
