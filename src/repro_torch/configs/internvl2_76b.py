"""internvl2-76b [vlm]: 80L d=8192 64H(kv=8) ff=28672 V=128256.

[arXiv:2404.16821; unverified].  InternViT frontend is a stub: input_specs
provides 1024 precomputed patch embeddings prepended to the text sequence.
LLM backbone is llama-3-70b-shaped (GQA kv=8, SwiGLU).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="decoder",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    frontend="vision",
    frontend_len=1024,
    param_dtype="bfloat16",
    microbatches=8,
    source="arXiv:2404.16821; unverified",
)
