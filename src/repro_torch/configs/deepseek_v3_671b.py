"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, 256 routed top-8 + 1 shared.

MLA: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128.  First 3
layers dense (ff 18432); routed expert ff 2048; shared expert ff 2048.
MTP (multi-token prediction) is provided as an optional extra head (off in
the baseline step; see train.mtp).  [arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="decoder",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        d_ff_shared=2048,
        first_dense_layers=3,
        d_ff_dense=18432,
        capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    serve_profile="tp_fsdp",  # params too large for TP-resident serving on one pod
    opt_dtype="bfloat16",
    microbatches=8,
    source="arXiv:2412.19437; hf",
)
