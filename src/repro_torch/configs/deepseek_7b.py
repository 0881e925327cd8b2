"""deepseek-7b [dense]: 30L d=4096 32H(kv=32) ff=11008 V=102400 llama-arch.

[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="decoder",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    microbatches=2,
    source="arXiv:2401.02954; hf",
)
