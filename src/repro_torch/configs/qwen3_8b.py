"""qwen3-8b [dense]: 36L d=4096 32H(kv=8) ff=12288 V=151936, qk_norm, GQA.

[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="decoder",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    microbatches=2,
    source="hf:Qwen/Qwen3-8B; hf",
)
