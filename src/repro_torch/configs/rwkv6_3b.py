"""rwkv6-3b [ssm]: 32L d=2560 (attn-free) ff=8960 V=65536, head_size 64.

Finch: data-dependent decay + token-shift ddlerp.  [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    source="arXiv:2404.05892; hf",
)
