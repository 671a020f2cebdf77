"""Plain PyTorch version of the flash-attention kernel (materialized-logits
softmax), a port of the JAX oracle `repro.kernels.attention.ref`.

It takes the model's (B, S, H, dh) layout and maps query head ``h`` to KV
head ``h // g`` (g = Hq / Hkv), as `models.layers.attention_core` and the
decode kernels group GQA heads; K and V are never repeated.  Query rows
run in chunks sized so one chunk's f32 logits stay near 1 GiB, which lets
it run at 32k tokens on the card; each row's arithmetic does not depend
on the chunking, so it remains the oracle of ``csrc/flash_attention.cu``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK_LOGITS = 2 ** 28               # f32 logits per chunk of q rows


def mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
         window: int | None) -> torch.Tensor:
    """(Sq, Sk) boolean: query ``i`` sees key ``j`` iff ``i >= j`` when
    causal and ``i - j < window`` when windowed (a window without causal
    is one-sided: every ``j > i`` survives)."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh) in
    q's dtype.  Logits in f32, masked ones filled with -1e30; a query row
    with no surviving key outputs 0 (reachable at Sq > Sk with a window),
    not the uniform mean a softmax over -1e30 logits gives."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(sk, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    chunk = max(1, CHUNK_LOGITS // max(1, b * hq * sk))
    for i0 in range(0, sq, chunk):
        n = min(chunk, sq - i0)
        qc = q[:, i0:i0 + n].float().reshape(b, n, hkv, g, dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf) * scale
        ok = mask(torch.arange(i0, i0 + n, device=q.device), k_pos,
                  causal=causal, window=window)
        s = torch.where(ok, s, NEG_INF)
        p = torch.softmax(s, dim=-1) * ok.any(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        out[:, i0:i0 + n] = o.reshape(b, n, hq, dh).to(q.dtype)
    return out
