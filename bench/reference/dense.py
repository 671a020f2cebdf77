"""A dense pre-norm decoder in plain float32 PyTorch: the reference of
the served models (Phi-3-mini, Qwen2.5).

Per layer: RMSNorm; Q, K, V projections (with biases where the model has
them); rotary embedding, the two halves of each head rotated as pairs
(``theta ** (-2i / head_dim)``); causal softmax attention, query head h
reading KV head ``h // (heads / kv_heads)``; the output projection; a
residual add; RMSNorm; SwiGLU (``silu(x Wg) * (x Wu) Wd``); a residual
add.  Then the final RMSNorm and the unembedding.  Every product runs in
float32 with TF32 off.  The weights are made again from the seed
(`bench.weights`), one layer at a time, and upcast, so the whole model
never lives in float32.

``precision="fp8"`` is the control: every product's operands are rounded
to float8 e4m3 first (the weights with one scale a matrix, activations,
queries, keys, values and probabilities with one scale a row), the
products still summed in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import weights as weights_lib

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """``x`` rounded to e4m3 at one scale per slice along ``dim`` (all of
    ``x`` when ``dim`` is None), returned in float32."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    s = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Dense:
    def __init__(self, model: dict, seed: int, device,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.m, self.seed, self.device = model, int(seed), device
        self.fp8 = precision == "fp8"

    def _mm(self, x, w):
        if self.fp8:
            return _fp8(x) @ _fp8(w, None)
        return x @ w

    def _norm(self, x, scale):
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["rms_norm_eps"]) * scale

    def _rope(self, x, pos):
        half = x.shape[-1] // 2
        inv = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos[:, None].float() * inv                     # (T, half)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attention(self, q, k, v):
        """q (T, Hq, dh), k and v (T, Hkv, dh): causal, grouped."""
        t, hq, dh = q.shape
        g = hq // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        if self.fp8:
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        logits = torch.einsum("qhd,khd->hqk", q, k) / dh ** 0.5
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        if self.fp8:
            p = _fp8(p)
        return torch.einsum("hqk,khd->qhd", p, v)

    def _layer(self, x, w, pos):
        m = self.m
        dh = m["head_dim"]
        t = x.shape[0]
        h = self._norm(x, w["ln1.scale"])
        q = self._mm(h, w["wq"])
        k = self._mm(h, w["wk"])
        v = self._mm(h, w["wv"])
        if m["attention_bias"]:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q = self._rope(q.view(t, -1, dh), pos)
        k = self._rope(k.view(t, -1, dh), pos)
        a = self._attention(q, k, v.view(t, -1, dh)).reshape(t, -1)
        x = x + self._mm(a, w["wo"])
        h = self._norm(x, w["ln2.scale"])
        return x + self._mm(F.silu(self._mm(h, w["w_gate"]))
                            * self._mm(h, w["w_up"]), w["w_down"])

    @torch.no_grad()
    def logits(self, sequences, positions):
        """For each token sequence (1-D int tensor) the float32 logits at
        its ``positions`` (the positions whose next token is judged):
        a list of (len(positions), vocab) tensors."""
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            top = weights_lib.outer(self.m, self.seed, self.device)
            embed = top.pop("embed")
            xs = [embed[s.to(self.device).long()].float() for s in sequences]
            del embed
            pos = [torch.arange(s.numel(), device=self.device)
                   for s in sequences]
            for l in range(self.m["num_hidden_layers"]):
                w = {n: t.float() for n, t in weights_lib.layer(
                    self.m, self.seed, l, self.device).items()}
                xs = [self._layer(x, w, p) for x, p in zip(xs, pos)]
                del w
            head = top["head"].float()
            out = []
            for x, at in zip(xs, positions):
                h = self._norm(x[torch.as_tensor(at, device=self.device)],
                               top["final_norm.scale"])
                out.append(self._mm(h, head.T))
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
