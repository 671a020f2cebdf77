"""RWKV-6 ("Finch") block: attention-free time mix with a data-dependent
decay, and the squared-ReLU channel mix.  Counterpart of
`repro.models.rwkv`.

The WKV recurrence keeps one (dh x dh) f32 state per head, so decode is
O(1) in the sequence length.  `lax.scan` over time becomes a Python loop
over time.  The decode state of a layer is ``{"shift_t", "shift_c": (B,
1, D)}`` in the cache's dtype (the previous token of the time and channel
mixes) and ``{"wkv": (B, H, dh, dh)}`` in f32.

Over the model axis (`parallel.sharding.split`, as the JAX specs shard
the leaves) the time mix splits its ``D / dh`` heads (`time_split`):
each rank projects its heads' columns of ``wr``, ``wk``, ``wv`` and
``wg``, takes the decay of its columns, scans its heads' ``wkv`` state
and multiplies by its rows of ``wo``; the channel mix splits d_ff
(`channel_split`): columns of ``ck``, rows of ``cv``, the gate ``cr``
whole on every rank.  The ranks' outputs are parts of a sum, which the
caller's `sharding.leave` takes.  Every whole leaf a split mix uses
passes through `sharding.copy_in`, so its gradient, a part on each
rank, is summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import sharding as shd

Params = dict
# Leaves the forward reads in f32 whatever the compute dtype: the decay
# and the bonus.
OWN_DTYPE_LEAVES = frozenset({"decay_w0", "decay_a", "decay_b", "bonus_u"})


def rwkv_time_init(generator: torch.Generator, cfg, dtype=torch.float32
                   ) -> Params:
    d, r = cfg.d_model, cfg.rwkv_lora_dim
    h = d // cfg.rwkv_head_dim
    dev = generator.device
    dense = layers._dense_init
    return {
        "mix": torch.full((5, d), 0.5, dtype=dtype, device=dev),  # r,k,v,g,w
        "wr": dense(generator, (d, d), dtype),
        "wk": dense(generator, (d, d), dtype),
        "wv": dense(generator, (d, d), dtype),
        "wg": dense(generator, (d, d), dtype),
        "wo": dense(generator, (d, d), dtype),
        "decay_w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "decay_a": dense(generator, (d, r), torch.float32),
        "decay_b": dense(generator, (r, d), torch.float32),
        "bonus_u": torch.zeros((h, cfg.rwkv_head_dim), dtype=torch.float32,
                               device=dev),
        "ln_x": layers.rmsnorm_init(d, torch.float32, dev),
    }


def rwkv_channel_init(generator: torch.Generator, cfg, dtype=torch.float32
                      ) -> Params:
    d = cfg.d_model
    dense = layers._dense_init
    return {
        "cmix": torch.full((2, d), 0.5, dtype=dtype,
                           device=generator.device),        # r,k
        "ck": dense(generator, (d, cfg.d_ff), dtype),
        "cv": dense(generator, (cfg.d_ff, d), dtype),
        "cr": dense(generator, (d, d), dtype),
    }


def rwkv_time_param_specs(cfg) -> Params:
    return {
        "mix": (None, "embed"),
        "wr": ("embed", "heads"), "wk": ("embed", "heads"),
        "wv": ("embed", "heads"), "wg": ("embed", "heads"),
        "wo": ("heads", "embed"),
        "decay_w0": ("embed",),
        "decay_a": ("embed", None), "decay_b": (None, "embed"),
        "bonus_u": ("heads", None),
        "ln_x": {"scale": (None,)},
    }


def rwkv_channel_param_specs(cfg) -> Params:
    return {
        "cmix": (None, "embed"),
        "ck": ("embed", "ff"), "cv": ("ff", "embed"), "cr": ("embed", "embed"),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None):
    """The sequence shifted by one, ``prev`` (the previous chunk's last
    token, zeros at the start) in front; and x's last token in ``prev``'s
    dtype, the next state."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    shifted = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)
    return shifted, x[:, -1:].to(prev.dtype)


def _wkv_scan(r, k, v, w, u, s0):
    """The recurrence per head, in f32.  r, k, v, w: (B, S, H, dh), w the
    decay in (0, 1); u: (H, dh) bonus; s0: (B, H, dh, dh) state (k-dim x
    v-dim).  Returns (y (B, S, H, dh), the last state)."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        k_t, v_t = k[:, t], v[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]              # (B,H,dh,dh)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t][..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def time_split(cfg) -> shd.Split | None:
    """The time mix's split over the model axis: its heads, ``D / dh`` of
    them (not ``cfg.num_heads``, which RWKV6 leaves 0), where the rules
    split ``heads`` into whole heads."""
    return shd.split("heads", cfg.d_model // cfg.rwkv_head_dim)


def channel_split(cfg) -> shd.Split | None:
    """The channel mix's split over the model axis: d_ff."""
    return shd.split("ff", cfg.d_ff)


def _norm_over_split(params: Params, y: torch.Tensor, d: int, eps: float,
                     hs) -> torch.Tensor:
    """`layers.rmsnorm` over all ``d`` columns of ``y``, of which this rank
    holds its block under ``hs``: the sum of squares all-reduced over the
    split, forward and backward (each rank's columns take part of its
    gradient), then this rank's columns of the scale."""
    if hs is None:
        return layers.rmsnorm(params, y, eps)
    y32 = y.float()
    ss = shd.copy_in(shd.reduce_out(
        torch.sum(torch.square(y32), dim=-1, keepdim=True), hs), hs)
    scale = shd.block(shd.copy_in(params["scale"], hs), 0, d, hs)
    return (y32 * torch.rsqrt(ss / d + eps) * scale.float()).to(y.dtype)


def rwkv_time_mix(params: Params, x: torch.Tensor, cfg,
                  state: Params | None = None):
    """x: (B, S, D) -> (out (B, S, D), new state or None).  Under
    `time_split` the output is this rank's part of the sum and the
    ``wkv`` state its heads'."""
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    hs = time_split(cfg)
    cols = d if hs is None else d // hs.n
    h = cols // dh
    prev = state["shift_t"] if state is not None else None
    shifted, last = _token_shift(x, prev)
    mix = shd.copy_in(params["mix"], hs).to(x.dtype)
    xr, xk, xv, xg, xw = (x + (shifted - x) * mix[i] for i in range(5))

    def w(name):                        # this rank's columns
        return shd.block(params[name], 1, d, hs).to(x.dtype)

    r = (xr @ w("wr")).reshape(b, s, h, dh)
    k = (xk @ w("wk")).reshape(b, s, h, dh)
    v = (xv @ w("wv")).reshape(b, s, h, dh)
    g = F.silu(xg @ w("wg"))

    # The data-dependent decay (RWKV6's novelty), in f32: the LoRA's first
    # half whole, its second half and the bias at this rank's columns.
    decay_b = shd.block(shd.copy_in(params["decay_b"], hs), 1, d, hs)
    w0 = shd.block(shd.copy_in(params["decay_w0"], hs), 0, d, hs)
    dd = torch.tanh(xw.float() @ shd.copy_in(params["decay_a"], hs)) \
        @ decay_b
    decay = torch.exp(-torch.exp(w0[None, None] + dd)).reshape(b, s, h, dh)

    s0 = (state["wkv"] if state is not None
          else torch.zeros((b, h, dh, dh), dtype=torch.float32,
                           device=x.device))
    u = shd.block(params["bonus_u"], 0, d // dh, hs)
    y, s_last = _wkv_scan(r.float(), k.float(), v.float(), decay, u, s0)
    y = _norm_over_split(params["ln_x"], y.reshape(b, s, cols), d,
                         cfg.norm_eps, hs)
    out = (y.to(x.dtype) * g) @ shd.block(params["wo"], 0, d, hs).to(
        x.dtype)
    new_state = None
    if state is not None:
        new_state = {"shift_t": last, "wkv": s_last}
    return out, new_state


def rwkv_channel_mix(params: Params, x: torch.Tensor, cfg,
                     state: Params | None = None):
    """x: (B, S, D) -> (out, new state or None); under `channel_split`
    the output is this rank's part of the sum: the gate, whole on every
    rank, multiplies each part."""
    fs = channel_split(cfg)
    prev = state["shift_c"] if state is not None else None
    shifted, last = _token_shift(x, prev)
    cmix = shd.copy_in(params["cmix"], fs).to(x.dtype)
    xk = x + (shifted - x) * cmix[0]
    xr = x + (shifted - x) * cmix[1]
    ck = shd.block(params["ck"], 1, cfg.d_ff, fs).to(x.dtype)
    cv = shd.block(params["cv"], 0, cfg.d_ff, fs).to(x.dtype)
    kk = torch.square(F.relu(xk @ ck))
    out = torch.sigmoid(xr @ shd.copy_in(params["cr"], fs).to(x.dtype)) * (
        kk @ cv)
    new_state = {"shift_c": last} if state is not None else None
    return out, new_state


def rwkv_cache_init(cfg, batch: int, dtype=torch.bfloat16, device=None
                    ) -> Params:
    d = cfg.d_model
    h, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {
        "shift_t": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                           device=device),
        "shift_c": torch.zeros((batch, 1, d), dtype=dtype, device=device),
    }
