"""Qwen2.5-32B [hf:Qwen/Qwen2.5 family].  Dense, GQA kv=8, QKV bias."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    d_ff=27648,
    vocab_size=152064,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qkv_bias=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=128,
    num_heads=4,
    num_kv_heads=2,
    qkv_bias=True,
)
