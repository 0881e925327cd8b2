"""Encoder-decoder model (seamless-m4t backbone).

The port of ``repro.models.encdec``.  Encoder: bidirectional
self-attention + MLP blocks over precomputed frame embeddings (the audio
frontend is a stub: ``configs.input_specs`` supplies (B, S_src, d)
frames).  Decoder: causal self-attention + cross-attention + MLP.  Every
attention over a whole sequence is kernel F on a card: unmasked over the
frames in the encoder and for cross attention (Sq != Sk), causal in the
decoder.

Decode path: the decoder's self-attention caches k/v as ``transformer``
does; the encoder memory's cross-attention K/V are projected once at
prefill and kept in the cache (``xk``/``xv``: cross K/V do not depend on
the position).  As in ``transformer.py``, the layers run as a Python loop
over views of the stacked parameters (each under ``cfg.remat``'s
checkpoint where a gradient is wanted, ``transformer.remat_call``; no
block output here is tagged for ``"save_block_io"``, as none is in the
JAX package's encdec), and the cache is preallocated and written in
place.  On a mesh the stream is laid out by ``constrain_act`` where the
JAX package constrains it, as in ``transformer.py``.
"""
from __future__ import annotations

import torch

from . import attention as attn
from .layers import (
    Spec, Stacked, apply_mlp, embed_tokens, init_embeddings, init_mlp,
    model_axes, model_count, model_materialize, model_shapes, rmsnorm,
    rope_tables, torch_dtype, unembed,
)
from repro_torch.dist import sharding
from repro_torch.dist.sharding import constrain_act

from .transformer import _add_then_norm, _unstack, check_ported, remat_call


def _enc_block_spec(cfg) -> dict:
    return {
        "ln1": Spec((cfg.d_model,), "zeros", axes=("embed",)),
        "attn": attn.init_attention(cfg),
        "ln2": Spec((cfg.d_model,), "zeros", axes=("embed",)),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _dec_block_spec(cfg) -> dict:
    return {
        "ln1": Spec((cfg.d_model,), "zeros", axes=("embed",)),
        "self_attn": attn.init_attention(cfg),
        "ln_x": Spec((cfg.d_model,), "zeros", axes=("embed",)),
        "cross_attn": attn.init_attention(cfg, cross=True),
        "ln2": Spec((cfg.d_model,), "zeros", axes=("embed",)),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act),
    }


def param_specs(cfg) -> dict:
    """``{"embed", "enc": Stacked(layer spec, enc_layers), "dec":
    Stacked(layer spec, dec_layers), "ln_enc", "ln_f"}``, the JAX
    package's layout."""
    check_ported(cfg)
    return {"embed": init_embeddings(cfg),
            "enc": Stacked(_enc_block_spec(cfg), cfg.enc_layers),
            "dec": Stacked(_dec_block_spec(cfg), cfg.dec_layers),
            "ln_enc": Spec((cfg.d_model,), "zeros", axes=("embed",)),
            "ln_f": Spec((cfg.d_model,), "zeros", axes=("embed",))}


def param_count(cfg) -> int:
    """Parameters of ``cfg``, from shapes alone (nothing allocated)."""
    return model_count(param_specs(cfg))


def param_axes(cfg) -> dict:
    """Every parameter's logical axes (``"layers"`` first in a stacked
    group), the JAX package's ``split`` axes tree."""
    return model_axes(param_specs(cfg))


def param_shapes(cfg) -> dict:
    """Every parameter's shape, the stacks with their layers axis."""
    return model_shapes(param_specs(cfg))


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Draw every parameter in ``cfg.param_dtype`` on ``device``."""
    return model_materialize(param_specs(cfg), generator, device,
                             torch_dtype(cfg.param_dtype))


def _run(body, x, layers, cfg, *args):
    """``x = body(p_l, x, *args)`` over the layers, each under
    ``cfg.remat`` (the JAX package's ``_remat`` of the scan body)."""
    for p_l in layers:
        x = remat_call(body, cfg, p_l, x, cfg, *args)
    return x


def _iota(n: int) -> torch.Tensor:
    """Positions 0..n-1 on the CPU (kernel F's domain check reads them
    there, with no device sync)."""
    return torch.arange(n, dtype=torch.int32)


def _enc_layer(p, x, cfg, rope, attention=None):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(p["attn"], h, cfg, rope)
    pos = _iota(x.shape[1])
    a = (attention or attn.flash_attention)(
        q, k, v, q_positions=pos, k_positions=pos, mask_mode="none",
        q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    x, h = _add_then_norm(x, attn._out_proj(a, p["attn"]["wo"]), p["ln2"],
                          cfg.norm_eps)
    return constrain_act(x + apply_mlp(p["mlp"], h, cfg.act))


def encode(params, cfg, frames, attention=None):
    """frames: (B, S_src, d) precomputed frontend embeddings -> memory;
    ``attention`` as :func:`forward`'s."""
    x = constrain_act(frames.to(torch_dtype(cfg.compute_dtype)))
    rope = rope_tables(torch.arange(x.shape[1], device=x.device), cfg.hd(),
                       cfg.rope_theta)
    x = _run(_enc_layer, x, _unstack(params["enc"], cfg.enc_layers), cfg,
             rope, attention)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _dec_layer(p, x, cfg, memory, rope, cache=None, attention=None):
    """One decoder layer over the target sequence; with ``cache`` (the
    layer's views) its self k/v and cross k/v are written there;
    ``attention`` as :func:`forward`'s."""
    attention = attention or attn.flash_attention
    S = x.shape[1]
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(p["self_attn"], h, cfg, rope)
    pos = _iota(S)
    a = attention(q, k, v, q_positions=pos, k_positions=pos,
                  mask_mode="causal", q_chunk=cfg.attn_q_chunk,
                  k_chunk=cfg.attn_k_chunk)
    x, h = _add_then_norm(x, attn._out_proj(a, p["self_attn"]["wo"]),
                          p["ln_x"], cfg.norm_eps)
    qx, xk, xv = attn._cross_qkv(p["cross_attn"], h, memory)
    ax = attention(
        qx, xk, xv, q_positions=pos, k_positions=_iota(memory.shape[1]),
        mask_mode="none", q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    x, h = _add_then_norm(x, attn._out_proj(ax, p["cross_attn"]["wo"]),
                          p["ln2"], cfg.norm_eps)
    if cache is not None:
        cache["k"][:, :S].copy_(k)
        cache["v"][:, :S].copy_(v)
        cache["pos"][:S].copy_(torch.arange(S, device=x.device))
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
    return constrain_act(x + apply_mlp(p["mlp"], h, cfg.act))


def _embed(params, cfg, tokens):
    return embed_tokens(params["embed"], tokens,
                        torch_dtype(cfg.compute_dtype))


def decode_train(params, cfg, memory, tokens, attention=None):
    """Teacher-forced decoder logits; memory from :func:`encode`;
    ``attention`` as :func:`forward`'s."""
    x = constrain_act(_embed(params, cfg, tokens))
    rope = rope_tables(torch.arange(x.shape[1], device=x.device), cfg.hd(),
                       cfg.rope_theta)
    x = _run(_dec_layer, x, _unstack(params["dec"], cfg.dec_layers), cfg,
             memory, rope, None, attention)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tied_embeddings)


def forward(params, cfg, frames, tokens, *, attention=None):
    """(logits, aux): aux is 0, as in the JAX package.  ``attention``
    replaces :func:`repro_torch.models.attention.flash_attention` in every
    layer, self and cross (same signature), as ``transformer.forward``'s
    does."""
    with sharding.mesh_ops(params["ln_f"]):
        memory = encode(params, cfg, frames, attention)
        logits = decode_train(params, cfg, memory, tokens, attention)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, s_alloc: int, s_cross: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Zeroed decoder caches, stacked over the decoder's layers: self k/v
    of ``s_alloc`` positions (all -1: empty) and cross k/v of ``s_cross``
    memory positions."""
    check_ported(cfg)
    L, Hkv, hd = cfg.dec_layers, cfg.n_kv_heads, cfg.hd()

    def z(S):
        return torch.zeros((L, batch, S, Hkv, hd), dtype=dtype, device=device)

    return {"k": z(s_alloc), "v": z(s_alloc),
            "pos": torch.full((L, s_alloc), -1, dtype=torch.int32,
                              device=device),
            "xk": z(s_cross), "xv": z(s_cross)}


def prefill(params, cfg, frames, tokens, *, s_alloc: int,
            cache_dtype=torch.bfloat16):
    """Encode the source and teacher-force the target prefix, emitting
    caches (cross k/v at the memory's length).  Returns (last_logits,
    cache)."""
    with sharding.mesh_ops(params["ln_f"]):
        return _prefill(params, cfg, frames, tokens, s_alloc, cache_dtype)


def _prefill(params, cfg, frames, tokens, s_alloc, cache_dtype):
    memory = encode(params, cfg, frames)
    x = _embed(params, cfg, tokens)
    B, S = x.shape[:2]
    rope = rope_tables(torch.arange(S, device=x.device), cfg.hd(),
                       cfg.rope_theta)
    caches = sharding.shard_cache(init_cache(
        cfg, B, s_alloc, memory.shape[1], cache_dtype, x.device), like=x)
    for p_l, c_l in zip(_unstack(params["dec"], cfg.dec_layers),
                        _unstack(caches, cfg.dec_layers)):
        x = _dec_layer(p_l, x, cfg, memory, rope, c_l)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tied_embeddings)[:, 0], caches


def decode_step(params, cfg, caches, tokens, cur_index, *,
                axis_name: str | None = None):
    """One decode step.  tokens: (B,) int; cur_index: int.  Returns
    (logits (B, V), caches), the caches updated in place; ``axis_name``
    as ``transformer.decode_step``'s."""
    with sharding.mesh_ops(params["ln_f"]):
        return _decode_step(params, cfg, caches, tokens, int(cur_index),
                            axis_name)


def _decode_step(params, cfg, caches, tokens, cur_index, axis_name):
    x = _embed(params, cfg, tokens[:, None])
    pos1 = torch.full((1,), cur_index, dtype=torch.int32, device=x.device)
    rope = rope_tables(pos1, cfg.hd(), cfg.rope_theta)
    for p_l, c_l in zip(_unstack(params["dec"], cfg.dec_layers),
                        _unstack(caches, cfg.dec_layers)):
        h = rmsnorm(x, p_l["ln1"], cfg.norm_eps)
        q, k, v = attn._project_qkv(p_l["self_attn"], h, cfg, rope)
        # dynamic_update_slice clamps its start so the update fits
        wslot = min(cur_index, c_l["k"].shape[1] - 1)
        c_l["k"][:, wslot].copy_(k[:, 0])
        c_l["v"][:, wslot].copy_(v[:, 0])
        c_l["pos"][wslot] = cur_index
        o = attn.combine_partials(attn.decode_attention_gqa(
            q[:, 0], c_l["k"], c_l["v"], c_l["pos"]), axis_name)
        x, h = _add_then_norm(
            x, attn._out_proj(o.to(x.dtype), p_l["self_attn"]["wo"])[:, None],
            p_l["ln_x"], cfg.norm_eps)
        qx = attn._proj(h, p_l["cross_attn"]["wq"])
        ox = attn.combine_partials(attn.decode_attention_gqa(
            qx[:, 0], c_l["xk"], c_l["xv"],
            torch.arange(c_l["xk"].shape[1], dtype=torch.int32,
                         device=x.device)), axis_name)
        x, h = _add_then_norm(
            x, attn._out_proj(ox.to(x.dtype), p_l["cross_attn"]["wo"])[:, None],
            p_l["ln2"], cfg.norm_eps)
        x = x + apply_mlp(p_l["mlp"], h, cfg.act)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tied_embeddings)[:, 0], caches
