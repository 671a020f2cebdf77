"""H2O-Danube 1.8B [arXiv:2401.16818].  Llama/Mistral mix with sliding-window
attention (window 4096), GQA kv=8.  SWA makes long-context decode
linear-in-window, so this arch RUNS long_500k (ring-buffer KV cache).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    sliding_window=4096,
    remat="full",
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=128,
    num_heads=4,
    num_kv_heads=2,
    sliding_window=8,
)
