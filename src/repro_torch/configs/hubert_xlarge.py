"""HuBERT X-Large [arXiv:2106.07447].  Encoder-only audio transformer
(wav2vec2-style backbone).  The conv feature extractor is a STUB per the
brief: ``input_specs()`` feeds precomputed 512-d frame embeddings.
No decode shapes (encoder-only).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    causal=False,
    frontend="frame",
    frontend_dim=512,
    remat="full",
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="encoder",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=32,
    num_heads=4,
    num_kv_heads=4,
    causal=False,
    frontend="frame",
    frontend_dim=24,
)
