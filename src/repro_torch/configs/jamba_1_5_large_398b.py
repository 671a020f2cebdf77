"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887; hf].

Hybrid Mamba+attention at 1:7 (one attention layer per period-8 group, at
in-group offset 4 as in the HF config), MoE (16 experts, top-2) on every
other layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    remat="full",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    d_ff=128,
    vocab_size=128,
    num_heads=4,
    num_kv_heads=2,
    num_experts=4,
    top_k=2,
    moe_d_ff=64,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=4,
    ssm_conv=3,
    ssm_expand=2,
)
