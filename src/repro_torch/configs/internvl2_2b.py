"""InternVL2-2B [arXiv:2404.16821].  InternLM2-1.8B language backbone; the
InternViT vision tower is a STUB per the brief: ``input_specs()`` feeds
precomputed 1024-d patch embeddings which a projector maps into d_model.
"""

from repro_torch.models.config import ModelConfig

# Number of visual patch embeddings prepended to the text sequence.
NUM_PATCHES = 1024

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="dense",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    frontend="patch",
    frontend_dim=1024,
    remat="full",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=128,
    num_heads=4,
    num_kv_heads=2,
    frontend="patch",
    frontend_dim=32,
)
