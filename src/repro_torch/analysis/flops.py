"""Arch-exact analytic FLOPs / HBM-bytes model for the roofline terms.

A copy of ``repro.analysis.flops`` over the port's configs: the count of
work is the model's, whatever implements it, so both packages' rooflines
read the same numbers (``tests/test_torch_analysis.py`` holds every field
equal to the JAX package's).  It walks the exact per-layer products of
every architecture family (attention incl. the causal 1/2 factor and
flash recompute, MLA ranks, MoE capacity dispatch, RG-LRU gates/scan,
RWKV6 time/channel mix) and is cross-validated in tests against
``torch.utils.flop_counter.FlopCounterMode`` over unrolled f32 train
steps of configs small enough to run (the JAX package holds it against
XLA's ``cost_analysis`` of compiled probes).

Conventions:
  * one MAC = 2 FLOPs; backward = 2x forward matmul FLOPs (dgrad + wgrad);
  * remat="full" recomputes the forward in the backward: fwd factor 2;
  * HBM bytes (train) = param traffic (fwd read + bwd read + grad/opt RW)
    + activation traffic ~ 2 bytes * activations written + read (bf16),
    with remat multiplying activation writes;
  * decode bytes = params read + full cache read + small writes.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class CostEstimate:
    flops_global: float            # one step, all devices, fwd(+bwd)
    hbm_bytes_global: float
    breakdown: dict

    def per_device(self, n: int) -> tuple[float, float]:
        return self.flops_global / n, self.hbm_bytes_global / n


def _attn_layer_flops(cfg: ModelConfig, S: int, kv_len: int | None = None,
                      causal: bool = True) -> tuple[float, float]:
    """(matmul_flops, score_flops) per token-sequence of length S, one layer."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    kv_len = kv_len if kv_len is not None else S
    if cfg.attention == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = (
            2 * S * d * m.q_lora_rank
            + 2 * S * m.q_lora_rank * H * qk
            + 2 * S * d * (m.kv_lora_rank + m.qk_rope_head_dim)
            + 2 * S * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            + 2 * S * H * m.v_head_dim * d
        )
        eff = 0.5 if causal else 1.0
        score = 2 * H * S * kv_len * (qk + m.v_head_dim) * eff
        return proj, score
    proj = 2 * S * d * H * hd + 2 * 2 * S * d * Hkv * hd + 2 * S * H * hd * d
    window = cfg.window if cfg.attention == "local" and cfg.window else None
    if window:
        eff_len = min(window, kv_len)
        score = 2 * H * S * eff_len * hd * 2
    else:
        eff = 0.5 if causal else 1.0
        score = 2 * H * S * kv_len * hd * 2 * eff
    return proj, score


def _mlp_flops(d: int, ff: int, S: int, gated: bool) -> float:
    n_mats = 3 if gated else 2
    return n_mats * 2 * S * d * ff


def _moe_layer_flops(cfg: ModelConfig, S: int) -> float:
    m = cfg.moe
    # router + dispatched expert FFN at capacity + shared expert
    f = 2 * S * cfg.d_model * m.n_experts
    dispatched = S * m.top_k * m.capacity_factor
    f += 3 * 2 * dispatched * cfg.d_model * m.d_ff_expert
    if m.n_shared_experts:
        sff = m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
        f += 3 * 2 * S * cfg.d_model * sff
    return f


def _rglru_layer_flops(cfg: ModelConfig, S: int) -> float:
    d, D, H = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.n_heads
    f = 2 * S * d * D * 2          # two input projections
    f += 2 * S * cfg.conv_width * D  # depthwise conv
    f += 2 * 2 * S * (D // H) * D    # block-diagonal gates (2x)
    f += 10 * S * D                  # scan combine (elementwise)
    f += 2 * S * D * d               # out projection
    return f


def _rwkv_layer_flops(cfg: ModelConfig, S: int) -> float:
    d, hd = cfg.d_model, cfg.rwkv_head_size
    H = d // hd
    f = 2 * S * d * (5 * 32) + 2 * S * 5 * 32 * d     # ddlerp lora
    f += 2 * S * d * 64 + 2 * S * 64 * d              # decay lora
    f += 5 * 2 * S * d * d                            # r,k,v,g,o projections
    f += S * H * (3 * 2 * hd * hd)                    # state update + readout
    f += 2 * 2 * S * d * cfg.d_ff + 2 * S * d * d     # channel mix
    return f


def _layer_flops(cfg: ModelConfig, block: str, S: int, *, kv_len=None,
                 causal=True) -> float:
    gated = cfg.act in ("silu", "swiglu", "geglu")
    if block in ("dense_attn", "attn"):
        proj, score = _attn_layer_flops(cfg, S, kv_len, causal)
        ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.first_dense_layers and block == "dense_attn":
            ff = cfg.moe.d_ff_dense or cfg.d_ff
        return proj + score + _mlp_flops(cfg.d_model, ff, S, gated)
    if block == "moe_attn":
        proj, score = _attn_layer_flops(cfg, S, kv_len, causal)
        return proj + score + _moe_layer_flops(cfg, S)
    if block == "rec":
        return _rglru_layer_flops(cfg, S) + _mlp_flops(cfg.d_model, cfg.d_ff, S, gated)
    if block == "rwkv":
        return _rwkv_layer_flops(cfg, S)
    raise ValueError(block)


def _blocks(cfg: ModelConfig) -> list[str]:
    out = []
    for gt, n in cfg.layer_groups():
        if gt.startswith("pattern:"):
            out += gt.split(":", 1)[1].split(",") * n
        else:
            out += [gt] * n
    return out


def forward_flops(cfg: ModelConfig, B: int, S: int, *, kv_len=None,
                  causal=True, with_unembed=True) -> float:
    total = 0.0
    for block in _blocks(cfg):
        total += B * _layer_flops(cfg, block, S, kv_len=kv_len, causal=causal)
    if cfg.family == "encdec":
        # decoder side: self (causal) + cross + mlp; encoder counted above
        pass
    if with_unembed:
        total += 2.0 * B * S * cfg.d_model * cfg.vocab_size
    return total


def _encdec_forward_flops(cfg: ModelConfig, B: int, S_src: int, S_tgt: int) -> float:
    gated = cfg.act in ("silu", "swiglu", "geglu")
    enc = dec = 0.0
    proj_e, score_e = _attn_layer_flops(cfg, S_src, causal=False)
    enc = cfg.enc_layers * (proj_e + score_e + _mlp_flops(cfg.d_model, cfg.d_ff, S_src, gated))
    proj_d, score_d = _attn_layer_flops(cfg, S_tgt, causal=True)
    # cross attention: q from tgt, kv from src
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    cross_proj = 2 * S_tgt * d * H * hd + 2 * 2 * S_src * d * Hkv * hd + 2 * S_tgt * H * hd * d
    cross_score = 2 * H * S_tgt * S_src * hd * 2
    dec = cfg.dec_layers * (
        proj_d + score_d + cross_proj + cross_score
        + _mlp_flops(cfg.d_model, cfg.d_ff, S_tgt, gated)
    )
    unembed = 2.0 * S_tgt * cfg.d_model * cfg.vocab_size
    return B * (enc + dec + unembed)


_REMAT_FWD_FACTOR = {"none": 1.0, "dots": 1.35, "full": 2.0}


def estimate(cfg: ModelConfig, shape: ShapeConfig, n_params: int,
             n_active: int) -> CostEstimate:
    B, S = shape.global_batch, shape.seq_len
    bd: dict = {}
    act_bytes = 2  # bf16 activations

    if shape.kind == "train":
        if cfg.family == "encdec":
            fwd = _encdec_forward_flops(cfg, B, S // 2, S // 2)
            tokens_for_act = B * S
        else:
            S_eff = S  # vlm: frontend_len embeds + text tokens = S total
            fwd = forward_flops(cfg, B, S_eff)
            tokens_for_act = B * S_eff
        remat_f = _REMAT_FWD_FACTOR.get(cfg.remat, 2.0)
        flops = fwd * (remat_f + 2.0)          # fwd(+recompute) + bwd 2x
        bd["fwd_flops"] = fwd
        bd["total_flops"] = flops
        # sanity crosscheck vs 6·N·D
        bd["six_nd"] = 6.0 * n_active * tokens_for_act

        # HBM bytes:
        p_bytes = {"float32": 4, "bfloat16": 2}.get(cfg.param_dtype, 4)
        o_bytes = {"float32": 4, "bfloat16": 2}.get(cfg.opt_dtype, 4)
        n_micro = max(cfg.microbatches, 1)
        param_traffic = n_params * (
            n_micro * 2 * p_bytes      # read per micro: fwd + bwd
            + 4                        # grad write fp32 (accumulated, sharded)
            + 4 * o_bytes + 4          # adam m,v RW + param write
        )
        # activations: per layer ~ 12 * d_model writes+reads per token (attn
        # q/k/v/o + mlp in/gate/out + norms), x2 for bwd reads, x remat
        n_layers = cfg.n_layers if cfg.family != "encdec" else (cfg.enc_layers + cfg.dec_layers)
        act_traffic = (
            tokens_for_act * n_layers * 12 * cfg.d_model * act_bytes
            * (1 + remat_f)
        )
        logits_traffic = 3 * tokens_for_act / n_micro * cfg.vocab_size * 4
        hbm = param_traffic + act_traffic + logits_traffic
        bd.update(param_traffic=param_traffic, act_traffic=act_traffic,
                  logits_traffic=logits_traffic)
        return CostEstimate(flops, hbm, bd)

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            fwd = _encdec_forward_flops(cfg, B, S, max(S // 8, 128))
        else:
            fwd = forward_flops(cfg, B, S, with_unembed=False)
            fwd += 2.0 * B * cfg.d_model * cfg.vocab_size  # last-token logits
        p_bytes = {"float32": 4, "bfloat16": 2}.get(cfg.param_dtype, 4)
        n_layers = cfg.n_layers if cfg.family != "encdec" else (cfg.enc_layers + cfg.dec_layers)
        act_traffic = B * S * n_layers * 12 * cfg.d_model * act_bytes
        cache_write = _cache_bytes(cfg, B, S)
        hbm = n_params * p_bytes + act_traffic + cache_write
        return CostEstimate(fwd, hbm, {"fwd_flops": fwd, "cache_write": cache_write})

    # decode: one token, cache length S
    if cfg.family == "encdec":
        fwd = forward_flops(cfg, B, 1, kv_len=S, causal=False, with_unembed=False)
        fwd += 2.0 * B * cfg.d_model * cfg.vocab_size
    else:
        fwd = forward_flops(cfg, B, 1, kv_len=S, causal=False, with_unembed=False)
        fwd += 2.0 * B * cfg.d_model * cfg.vocab_size
    p_bytes = {"float32": 4, "bfloat16": 2}.get(cfg.param_dtype, 4)
    cache_read = _cache_bytes(cfg, B, S)
    hbm = n_active * p_bytes + cache_read
    return CostEstimate(fwd, hbm, {"cache_read": cache_read, "param_read": n_active * p_bytes})


def scan_estimate(*, n_rows: int, n_terms: int, n_clauses: int,
                  n_queries: int, n_slots: int) -> CostEstimate:
    """Analytic FLOPs / memory-bytes of ONE fused device scan launch.

    Walks the exact stages of the JAX package's
    ``kernels.scan_fused.scan_core_xla`` (kernel B's plain form) over
    N = n_rows plane rows, T terms, C clauses, Q queries and S1 slot
    buckets — every term is derived from the implementation, not a hand
    constant, so the roofline fraction of ``bench_device`` tracks the
    kernel it measures:

      * term eval — per (T, N) element: 4 mask tests, the EXACT code
        compare, the 3-candidate numeric-repr compare + any-reduce, the
        LUT index arithmetic, null/bool-compat logic and the 4-way kind
        select — 23 integer/predicate ops;
      * clause membership matmul  (C, T) @ (T, N)   -> 2·C·T·N FLOPs;
      * query violation matmul    (Q, C) @ (C, N)   -> 2·Q·C·N FLOPs;
      * pushed AND + zone mask + hit combine        -> 4·Q·N;
      * per-slot popcount scatter (counts + cands)  -> 2·Q·N.

    Memory traffic (read-once streaming, the roofline's HBM term): the
    gathered plane columns (4 uint8 masks + 2 int32 code columns per
    term row), the per-row slot id + clause word, the per-slot parameter
    gathers (code_a, lut_off int32; num_codes int32×3; LUT probe uint8),
    one boolean term/clause/query intermediate each, and the (Q, S1)
    int32 outputs.
    """
    N, T, C, Q = n_rows, n_terms, n_clauses, n_queries
    S1 = n_slots + 1
    flops = {
        "term_eval": 23.0 * T * N,
        "clause_matmul": 2.0 * C * T * N,
        "query_matmul": 2.0 * Q * C * N,
        "pushed_and_hit": 4.0 * Q * N,
        "popcount_scatter": 2.0 * Q * N,
    }
    bytes_ = {
        "plane_gather": (4 * 1 + 2 * 4) * T * N,
        "row_meta": (4 + 4) * N,
        "param_gather": (4 + 4 + 3 * 4 + 1) * T * N,
        "intermediates": (T + C + Q) * N,
        "outputs": 2 * 4 * Q * S1,
    }
    bd = {"flops": flops, "bytes": bytes_,
          "shape": {"n_rows": N, "n_terms": T, "n_clauses": C,
                    "n_queries": Q, "n_slots": n_slots}}
    return CostEstimate(sum(flops.values()), sum(bytes_.values()), bd)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Total KV/recurrent cache bytes (bf16) for context length S."""
    if cfg.family == "rwkv":
        hd = cfg.rwkv_head_size
        H = cfg.d_model // hd
        return cfg.n_layers * B * (H * hd * hd * 4 + 2 * cfg.d_model * 4)
    if cfg.family == "hybrid":
        per_attn = 2 * B * min(S, cfg.window + 128) * cfg.n_kv_heads * cfg.hd() * 2
        n_attn = sum(1 for b in _blocks(cfg) if b == "attn")
        n_rec = sum(1 for b in _blocks(cfg) if b == "rec")
        D = cfg.lru_width or cfg.d_model
        return n_attn * per_attn + n_rec * B * D * 4
    if cfg.attention == "mla":
        m = cfg.mla
        return cfg.n_layers * B * S * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    n_layers = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    cache = n_layers * 2 * B * S * cfg.n_kv_heads * cfg.hd() * 2
    if cfg.family == "encdec":
        cache += cfg.dec_layers * 2 * B * 4096 * cfg.n_kv_heads * cfg.hd() * 2
    return cache
