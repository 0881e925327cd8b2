"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H(kv=8) ff_expert=8192 V=202048.

MoE 16 experts top-1 + 1 shared expert, every layer routed; early-fusion
multimodal (frontend stubbed).  [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="decoder",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500000.0,
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        d_ff_expert=8192,
        n_shared_experts=1,
        d_ff_shared=8192,
    ),
    param_dtype="bfloat16",
    serve_profile="tp_fsdp",  # params too large for TP-resident serving on one pod
    microbatches=8,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
