"""recurrentgemma-9b [hybrid]: 38L d=4096 16H(kv=1) ff=12288 V=256000.

[arXiv:2402.19427; unverified].  Griffin pattern: (rec, rec, local-attn)
repeating; 38 = 12x3 + 2 leftover recurrent layers.  RG-LRU width 4096,
local attention window 2048, MQA (kv=1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention="local",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    act="gelu",
    microbatches=4,
    source="arXiv:2402.19427; unverified",
)
