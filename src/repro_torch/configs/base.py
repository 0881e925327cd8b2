"""Model / run configuration (copy of ``repro.configs.base``).

One frozen dataclass describes every assigned architecture; per-arch files in
this package instantiate it with the published numbers.  ``reduced()`` shrinks
any config to a CPU-smoke-testable size while preserving its family-defining
structure (GQA ratio, MoE routing, MLA ranks, block pattern, ...).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0       # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0               # d_ff of those dense layers
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # decoder | encdec | hybrid | rwkv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # attention flavor
    attention: str = "full"            # full | local | mla
    window: int = 0                    # local-attention window
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    mla: MLAConfig | None = None
    moe: MoEConfig | None = None

    # hybrid (recurrentgemma / griffin)
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv_width: int = 4

    # rwkv
    rwkv_head_size: int = 0

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend (stub: precomputed embeddings via input_specs)
    frontend: str = "none"             # none | audio | vision
    frontend_len: int = 0              # patches/frames prepended (vision)

    tied_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6

    # numerics / runtime
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                # none | dots | full | save_block_io
    seq_parallel: bool = False         # Megatron-SP: shard seq over model between blocks
    sharding_profile: str = "tp_fsdp"  # tp_fsdp | fsdp (pure ZeRO-3, batch over all axes)
    serve_profile: str = "serve_tp"    # prefill/decode param layout (giants: tp_fsdp)
    scan_layers: bool = True
    attn_q_chunk: int = 1024           # flash-jnp chunk sizes
    attn_k_chunk: int = 1024
    rwkv_chunk: int = 128

    # training
    microbatches: int = 1
    opt_dtype: str = "float32"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    z_loss: float = 0.0

    # paper citation tier
    source: str = ""

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k (no full-attention block)?"""
        if self.family == "rwkv":
            return True
        if self.family == "hybrid":
            return all(b != "attn" or self.window > 0 for b in ("attn",)) and self.window > 0
        return False

    def layer_groups(self) -> tuple[tuple[str, int], ...]:
        """Homogeneous layer groups, each lowered as one lax.scan.

        Returns ((block_type, n_repeat), ...).  Block types:
          dense_attn | moe_attn | rec | local_attn | rwkv | pattern:<spec>
        """
        if self.family == "rwkv":
            return (("rwkv", self.n_layers),)
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            n_super, rem = divmod(self.n_layers, len(pat))
            groups: list[tuple[str, int]] = []
            if n_super:
                groups.append(("pattern:" + ",".join(pat), n_super))
            if rem:
                groups.append(("pattern:" + ",".join(pat[:rem]), 1))
            return tuple(groups)
        if self.moe is not None:
            groups = []
            if self.moe.first_dense_layers:
                groups.append(("dense_attn", self.moe.first_dense_layers))
            groups.append(("moe_attn", self.n_layers - self.moe.first_dense_layers))
            return tuple(groups)
        return (("dense_attn", self.n_layers),)

    def reduced(self) -> "ModelConfig":
        """Structure-preserving shrink for CPU smoke tests."""
        kw: dict = {}
        kw["n_layers"] = min(
            self.n_layers,
            2 if not self.block_pattern else len(self.block_pattern))
        kw["d_model"] = 64
        ratio = max(self.n_heads // max(self.n_kv_heads, 1), 1)
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(4 // ratio, 1)
        kw["head_dim"] = 16
        kw["d_ff"] = 128
        kw["vocab_size"] = 512
        kw["lru_width"] = 64 if self.lru_width else 0
        kw["window"] = min(self.window, 32) if self.window else 0
        kw["rwkv_head_size"] = 16 if self.rwkv_head_size else 0
        kw["enc_layers"] = min(self.enc_layers, 2) if self.enc_layers else 0
        kw["dec_layers"] = min(self.dec_layers, 2) if self.dec_layers else 0
        kw["frontend_len"] = min(self.frontend_len, 8) if self.frontend_len else 0
        kw["attn_q_chunk"] = 32
        kw["attn_k_chunk"] = 32
        kw["rwkv_chunk"] = 16
        kw["microbatches"] = 1
        kw["param_dtype"] = "float32"
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
            )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_shared=64 if self.moe.n_shared_experts else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=128 if self.moe.first_dense_layers else 0,
            )
            kw["n_layers"] = max(kw["n_layers"], (1 if self.moe.first_dense_layers else 0) + 1)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str                          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — skips documented in DESIGN.md §5."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, ("pure full-attention arch: 500k decode context "
                       "is quadratic; skipped per assignment")
    return True, ""
