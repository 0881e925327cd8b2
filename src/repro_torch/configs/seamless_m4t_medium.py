"""seamless-m4t-medium [audio enc-dec]: 12L d=1024 16H(kv=16) ff=4096 V=256206.

[arXiv:2308.11596; hf].  Backbone only: the audio frontend is a stub
(precomputed frame embeddings via input_specs).  12 encoder + 12 decoder
layers (the assignment's "12L" is per stack).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    act="gelu",
    source="arXiv:2308.11596; hf",
)
