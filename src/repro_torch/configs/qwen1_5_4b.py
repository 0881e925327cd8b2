"""qwen1.5-4b [dense]: 40L d=2560 20H(kv=20) ff=6912 V=151936, QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="decoder",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
