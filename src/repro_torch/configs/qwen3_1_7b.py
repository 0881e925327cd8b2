"""qwen3-1.7b [dense]: 28L d=2048 16H(kv=8) ff=6144 V=151936, qk_norm, GQA.

[hf:Qwen/Qwen3-8B family; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="decoder",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tied_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
