"""Qwen3-MoE 235B-A22B family config [hf:Qwen/Qwen3-30B-A3B scaled per brief].

128 experts, top-8, per-expert FFN 1536; qk-norm; GQA with 4 KV heads.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    d_ff=1536,
    vocab_size=151936,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    moe_every=1,
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    d_ff=48,
    vocab_size=160,
    num_heads=4,
    num_kv_heads=2,
    qk_norm=True,
    num_experts=8,
    top_k=2,
    moe_d_ff=48,
)
