"""Unified model configuration for the assigned architecture zoo."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # attention (ignored by attn-free families)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int | None = None
    causal: bool = True
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim (0 -> d_ff)
    moe_every: int = 1             # MoE on layers where (l % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # hybrid (Jamba): attention on layers where (l % attn_period == attn_offset)
    attn_period: int = 0
    attn_offset: int = 0

    # Mamba (ssm half of hybrid)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> d_model // 16

    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64

    # modality frontend stub: None | "frame" (audio) | "patch" (vlm)
    frontend: str | None = None
    frontend_dim: int = 0          # precomputed embedding dim fed by input_specs

    # training-time details
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "none"            # none | full  (activation checkpointing)
    scan_layers: bool = True
    attn_chunk: int = -1           # -1 auto; 0 never chunk; >0 fixed q-chunk
    loss_chunk: int = 2048         # fused-xent token-chunk size (0 = unchunked)
    probe_unroll: bool = False     # unroll inner chunk loops (cost probes)

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.family in ("ssm", "hybrid") and not self.ssm_dt_rank:
            object.__setattr__(self, "ssm_dt_rank", max(1, self.d_model // 16))

    # ---- derived sizes -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_attn_layer(self, l: int) -> bool:
        if self.family in ("dense", "moe", "encoder"):
            return True
        if self.family == "ssm":
            return False
        return self.attn_period > 0 and (l % self.attn_period == self.attn_offset)

    def is_moe_layer(self, l: int) -> bool:
        if not self.num_experts:
            return False
        return l % self.moe_every == self.moe_offset

    def param_count(self) -> int:
        """Analytical parameter count (validates against published sizes)."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        total = emb
        for l in range(self.num_layers):
            if self.family == "ssm":
                total += self._rwkv_layer_params()
                continue
            if self.is_attn_layer(l):
                total += (
                    self.d_model * self.q_dim
                    + 2 * self.d_model * self.kv_dim
                    + self.q_dim * self.d_model
                )
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
            else:  # mamba layer of a hybrid
                total += self._mamba_layer_params()
            if self.family in ("dense", "moe", "hybrid", "encoder"):
                if self.is_moe_layer(l):
                    total += self.num_experts * 3 * self.d_model * self.moe_d_ff
                    total += self.d_model * self.num_experts  # router
                elif self.family == "encoder":
                    total += 2 * self.d_model * self.d_ff  # GELU MLP
                else:
                    total += 3 * self.d_model * self.d_ff  # SwiGLU
            total += 2 * self.d_model  # norms
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        for l in range(self.num_layers):
            if self.is_moe_layer(l):
                total -= (self.num_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
        return total

    def _mamba_layer_params(self) -> int:
        d_in = self.ssm_expand * self.d_model
        return (
            self.d_model * 2 * d_in                       # in_proj
            + d_in * self.ssm_conv                        # depthwise conv
            + d_in * (self.ssm_dt_rank + 2 * self.ssm_state)  # x_proj
            + self.ssm_dt_rank * d_in + d_in              # dt_proj
            + d_in * self.ssm_state + d_in                # A_log, D
            + d_in * self.d_model                         # out_proj
        )

    def _rwkv_layer_params(self) -> int:
        d, r = self.d_model, self.rwkv_lora_dim
        time_mix = 5 * d * d + d * d  # r,k,v,g,o? (r,k,v,g + output) + decay
        lora = 6 * (d * r + r * d) + 2 * d * r  # ddlerp + decay/gate loras (approx)
        channel = 2 * d * self.d_ff + d * d
        return time_mix + lora + channel
