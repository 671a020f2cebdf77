"""RWKV-6 "Finch" 7B [arXiv:2404.05892].  Attention-free; data-dependent
decay; O(1) decode state => long_500k runs at constant per-token cost.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_lora_dim=64,
    remat="full",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=128,
    rwkv_head_dim=16,
    rwkv_lora_dim=8,
)
