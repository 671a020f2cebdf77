"""Qwen3-14B [hf:Qwen/Qwen3-8B family].  Dense, qk-norm, GQA kv=8."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab_size=151936,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=160,
    num_heads=4,
    num_kv_heads=2,
    qk_norm=True,
)
