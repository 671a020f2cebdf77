"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

16 experts, top-2, MoE on every layer; GQA with 8 KV heads.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    num_experts=16,
    top_k=2,
    moe_d_ff=6400,
    moe_every=1,
    remat="full",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    d_ff=96,
    vocab_size=128,
    num_heads=4,
    num_kv_heads=2,
    num_experts=4,
    top_k=2,
    moe_d_ff=96,
)
