"""Phi-3-mini 3.8B [arXiv:2404.14219].  Dense; kv=32 => plain MHA."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    remat="full",
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=128,
    num_heads=4,
    num_kv_heads=4,
)
