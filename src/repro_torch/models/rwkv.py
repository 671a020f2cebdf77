"""RWKV-6 ("Finch") block: attention-free time mix with a data-dependent
decay, and the squared-ReLU channel mix.  Counterpart of
`repro.models.rwkv`.

The WKV recurrence keeps one (dh x dh) f32 state per head, so decode is
O(1) in the sequence length.  `lax.scan` over time becomes a Python loop
over time.  The decode state of a layer is ``{"shift_t", "shift_c": (B,
1, D)}`` in the cache's dtype (the previous token of the time and channel
mixes) and ``{"wkv": (B, H, dh, dh)}`` in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

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


def rwkv_time_mix(params: Params, x: torch.Tensor, cfg,
                  state: Params | None = None):
    """x: (B, S, D) -> (out (B, S, D), new state or None)."""
    b, s, d = x.shape
    h, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    prev = state["shift_t"] if state is not None else None
    shifted, last = _token_shift(x, prev)
    mix = params["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (shifted - x) * mix[i] for i in range(5))

    r = (xr @ params["wr"].to(x.dtype)).reshape(b, s, h, dh)
    k = (xk @ params["wk"].to(x.dtype)).reshape(b, s, h, dh)
    v = (xv @ params["wv"].to(x.dtype)).reshape(b, s, h, dh)
    g = F.silu(xg @ params["wg"].to(x.dtype))

    # The data-dependent decay (RWKV6's novelty), in f32.
    dd = torch.tanh(xw.float() @ params["decay_a"]) @ params["decay_b"]
    w = torch.exp(-torch.exp(params["decay_w0"][None, None] + dd))
    w = w.reshape(b, s, h, dh)

    s0 = (state["wkv"] if state is not None
          else torch.zeros((b, h, dh, dh), dtype=torch.float32,
                           device=x.device))
    y, s_last = _wkv_scan(r.float(), k.float(), v.float(), w,
                          params["bonus_u"], s0)
    y = layers.rmsnorm(params["ln_x"], y.reshape(b, s, d), cfg.norm_eps)
    out = (y.to(x.dtype) * g) @ params["wo"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"shift_t": last, "wkv": s_last}
    return out, new_state


def rwkv_channel_mix(params: Params, x: torch.Tensor, cfg,
                     state: Params | None = None):
    prev = state["shift_c"] if state is not None else None
    shifted, last = _token_shift(x, prev)
    cmix = params["cmix"].to(x.dtype)
    xk = x + (shifted - x) * cmix[0]
    xr = x + (shifted - x) * cmix[1]
    kk = torch.square(F.relu(xk @ params["ck"].to(x.dtype)))
    out = torch.sigmoid(xr @ params["cr"].to(x.dtype)) * (
        kk @ params["cv"].to(x.dtype))
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
