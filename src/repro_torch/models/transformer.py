"""Decoder-only LM assembly: dense and MoE layers, full or MLA attention.

The port of ``repro.models.transformer`` for ``dense_attn`` and
``moe_attn`` layer groups (deepseek-v3: dense layers, then MoE layers)
with full (causal, GQA) or MLA attention, and the vision frontend's
``extra_embeds`` prepended to the tokens: ``init_params``, ``forward``
(teacher-forced logits and the MoE aux loss), ``init_cache`` (k/v, or
MLA's compressed ``ckv``/``krope``), ``prefill`` (forward + cache
emission) and ``decode_step`` (one token).  Parameters and caches keep
the JAX package's nested dicts, each group stacked on a leading layers
axis.

What differs from the JAX package, and why:

  * The layers run as a Python loop over views of the stacked
    parameters.  ``scan_layers`` shapes what XLA compiles and is read
    nowhere here.  ``forward`` honours ``remat`` as the JAX package's
    ``jax.checkpoint`` of each layer: ``"full"`` (every config's
    default) runs each layer under ``torch.utils.checkpoint`` where a
    gradient is wanted, so the backward recomputes the layer, kernel F
    included; ``"none"`` keeps every activation.  The named-residual
    policies ``"dots"`` and ``"save_block_io"`` raise
    ``NotImplementedError`` (ROADMAP.md Queue 1, item 23).
  * Training passes the f32 master parameters straight in: every use
    casts a matrix to the compute dtype inside the graph, so gradients
    reach the f32 leaves.  Serving casts them once first
    (:func:`compute_params`), which gives the same results.
  * The cache is one preallocated tensor per group, written in place by
    ``prefill`` and ``decode_step``, which return the same dict: the
    counterpart of ``dynamic_update_slice`` with a donated cache.
  * ``constrain_act``/``constrain_seq`` and the flash-decoding path
    (``_use_sharded_decode``) do nothing off a mesh; they come with the
    model mesh (ROADMAP.md Queue 1, item 14).
  * The expert-parallel MoE (``apply_moe_sharded``) comes with the model
    mesh too; off a mesh the JAX package runs ``apply_moe``, as here.
  * Other block types and families (``rec`` and local attention,
    ``rwkv``, ``encdec``) raise ``NotImplementedError`` (ROADMAP.md
    Queue 1, items 18-20).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import moe as moe_mod
from .layers import (
    RopeTables, Spec, apply_mlp, count, embed_tokens, init_embeddings, init_mlp,
    materialize, rmsnorm, rope_tables, torch_dtype, tree_map, unembed,
)

#: leaves a norm reads in f32: never cast to the compute dtype
NORM_KEYS = frozenset({"ln1", "ln2", "ln_f", "q_norm", "k_norm", "kv_norm"})
#: leaves the JAX package reads at their stored precision, whatever the
#: compute dtype, so :func:`compute_params` keeps them as stored: the
#: norms; the MoE router, which ``apply_moe`` casts to f32 (a bf16 copy of
#: f32 master parameters would move the logits, and with them the top-k);
#: MLA's ``wkv_b``, which the absorbed decode reads in f32
KEEP_STORED = NORM_KEYS | {"router", "wkv_b"}

#: where what this port refuses is planned (ROADMAP.md Queue 1)
_ROADMAP_LOCAL = "ROADMAP.md Queue 1, item 18 (local and hybrid)"
_ROADMAP_FAMILY = {"hybrid": _ROADMAP_LOCAL,
                   "rwkv": "ROADMAP.md Queue 1, item 19 (rwkv)",
                   "encdec": "ROADMAP.md Queue 1, item 20 (encdec)"}


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a decoder with full
    or MLA attention (dense or MoE layers, with or without the vision
    frontend): the families this port runs so far."""
    why = None
    if cfg.family != "decoder":
        why = (f"family {cfg.family!r}", _ROADMAP_FAMILY.get(
            cfg.family, "no ROADMAP.md item"))
    elif cfg.attention not in ("full", "mla"):
        why = (f"{cfg.attention!r} attention", _ROADMAP_LOCAL)
    elif cfg.frontend not in ("none", "vision"):
        why = (f"the {cfg.frontend} frontend", _ROADMAP_FAMILY["encdec"])
    elif cfg.block_pattern:
        why = (f"block pattern {cfg.block_pattern}", _ROADMAP_LOCAL)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why[0]} is not ported yet; the port runs decoders "
            f"with full or MLA attention, dense or MoE ({why[1]})")


def _block_spec(cfg, block_type: str) -> dict:
    if block_type not in ("dense_attn", "moe_attn"):
        raise NotImplementedError(
            f"block type {block_type!r} is not ported ({_ROADMAP_LOCAL})")
    p = {
        "ln1": Spec((cfg.d_model,), "zeros"),
        "ln2": Spec((cfg.d_model,), "zeros"),
        "attn": (attn.init_mla(cfg) if cfg.attention == "mla"
                 else attn.init_attention(cfg)),
    }
    if block_type == "moe_attn":
        p["moe"] = moe_mod.init_moe(cfg)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.first_dense_layers:
            d_ff = cfg.moe.d_ff_dense or cfg.d_ff
        p["mlp"] = init_mlp(cfg.d_model, d_ff, cfg.act)
    return p


def param_specs(cfg) -> dict:
    """``{"embed", "ln_f", "group<i>": (layer spec, n_layers)}``; a layer
    spec is ``{"sub0": block}``, the JAX package's layout for a group of
    one block type (deepseek-v3: ``dense_attn`` layers, then
    ``moe_attn``)."""
    check_ported(cfg)
    p = {"embed": init_embeddings(cfg),
         "ln_f": Spec((cfg.d_model,), "zeros")}
    for gi, (gt, n) in enumerate(cfg.layer_groups()):
        p[f"group{gi}"] = ({"sub0": _block_spec(cfg, gt)}, n)
    return p


def param_count(cfg) -> int:
    """Parameters of ``cfg``, from shapes alone (nothing allocated)."""
    total = 0
    for name, spec in param_specs(cfg).items():
        if name.startswith("group"):
            total += count(spec[0], spec[1])
        else:
            total += count(spec)
    return total


def param_shapes(cfg) -> dict:
    """Every parameter's shape, stacked groups with their layers axis."""
    out = {}
    for name, spec in param_specs(cfg).items():
        if name.startswith("group"):
            tree, n = spec
            out[name] = tree_map(lambda s: (n,) + tuple(s.shape), tree)
        else:
            out[name] = tree_map(lambda s: tuple(s.shape), spec)
    return out


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Draw every parameter in ``cfg.param_dtype`` on ``device``."""
    dtype = torch_dtype(cfg.param_dtype)
    out = {}
    for name, spec in param_specs(cfg).items():
        if name.startswith("group"):
            tree, n = spec
            out[name] = materialize(tree, generator, device, dtype, n)
        else:
            out[name] = materialize(spec, generator, device, dtype)
    return out


def compute_params(params, cfg) -> dict:
    """``params`` with every matrix and bias cast once to the compute
    dtype.  Each use casts them so anyway, so the results are the same;
    the leaves of :data:`KEEP_STORED` stay as they are, since the JAX
    package reads them at their stored precision."""
    dt = torch_dtype(cfg.compute_dtype)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v if k in KEEP_STORED or not v.is_floating_point()
                    else v.to(dt))
                for k, v in tree.items()}

    return walk(params)


def _unstack(group, n: int) -> list[dict]:
    """The ``n`` layers of a stacked group as views, one ``unbind`` per
    leaf."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in group.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _write_cache_kv(cache, k, v, positions) -> None:
    """Prefill write into one layer's cache views, in place: ring-aligned
    (slot = pos % alloc, the last ``alloc`` entries) when the prompt fills
    the cache, linear otherwise."""
    alloc = cache["k"].shape[1]
    S = k.shape[1]
    if S >= alloc:
        sel = slice(S - alloc, S)
        shift = S % alloc
        cache["k"].copy_(torch.roll(k[:, sel], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, sel], shift, dims=1))
        cache["pos"].copy_(torch.roll(positions[sel], shift, dims=0))
        return
    cache["k"][:, :S].copy_(k)
    cache["v"][:, :S].copy_(v)
    cache["pos"][:S].copy_(positions)


def _write_cache_mla(cache, ckv, krope, positions) -> None:
    """Prefill write of MLA's compressed cache (``ckv`` (B, S, kv_lora),
    ``krope`` (B, S, rope)), in place, as :func:`_write_cache_kv`."""
    alloc = cache["ckv"].shape[1]
    S = ckv.shape[1]
    if S >= alloc:
        sel = slice(S - alloc, S)
        shift = S % alloc
        cache["ckv"].copy_(torch.roll(ckv[:, sel], shift, dims=1))
        cache["krope"].copy_(torch.roll(krope[:, sel], shift, dims=1))
        cache["pos"].copy_(torch.roll(positions[sel], shift, dims=0))
        return
    cache["ckv"][:, :S].copy_(ckv)
    cache["krope"][:, :S].copy_(krope)
    cache["pos"][:S].copy_(positions)


def _add_then_norm(x, a, scale, eps: float):
    """``(x + a, rmsnorm(x + a))`` for a block's inner residual.  XLA
    fuses the JAX package's add into the norm after it and lets the norm
    read the f32 sum before its rounding to x's type (excess precision);
    the stream keeps the rounded sum.  Both follow it here."""
    s = x.float() + a
    return s.to(x.dtype), rmsnorm(s, scale, eps).to(x.dtype)


class _Positions(NamedTuple):
    """Positions 0..S-1 of one call, made once: on the CPU (kernel F's
    domain check reads them there, with no device sync), on the device
    (cache writes) and as rotary tables."""
    host: torch.Tensor
    device: torch.Tensor
    rope: RopeTables


def _positions(S: int, cfg, device) -> _Positions:
    dev = torch.arange(S, dtype=torch.int32, device=device)
    return _Positions(torch.arange(S, dtype=torch.int32), dev,
                      rope_tables(dev, attn.rope_dim(cfg), cfg.rope_theta))


def _ffn(p, h, cfg, block_type: str):
    """The block's FFN: ``(out, aux)``, aux the MoE's load-balance loss
    (0 for a dense block)."""
    if block_type == "moe_attn":
        return moe_mod.apply_moe(p["moe"], h, cfg)
    return (apply_mlp(p["mlp"], h, cfg.act),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _apply_block_seq(p, x, cfg, block_type: str, pos: _Positions, cache,
                     attention=None):
    """Full-sequence application of a ``dense_attn`` or ``moe_attn``
    block; ``cache`` is None (forward) or the layer's cache views,
    written in place; ``attention`` as :func:`forward`'s.  Returns (x,
    aux)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        parts = attn._mla_qkv(p["attn"], h, cfg, pos.rope)
        a = attn._attend_mla_parts(p["attn"], parts, cfg, pos.host,
                                   attention)
        if cache is not None:
            _write_cache_mla(cache, parts.c_kv, parts.k_rope[:, :, 0],
                             pos.device)
    else:
        q, k, v = attn._project_qkv(p["attn"], h, cfg, pos.rope)
        a = (attention or attn.flash_attention)(
            q, k, v, q_positions=pos.host, k_positions=pos.host,
            mask_mode="causal", window=cfg.window,
            q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk,
        )
        a = attn._out_proj(a, p["attn"]["wo"])
        if cache is not None:
            _write_cache_kv(cache, k, v, pos.device)
    x, h = _add_then_norm(x, a, p["ln2"], cfg.norm_eps)
    f, aux = _ffn(p, h, cfg, block_type)
    return x + f, aux


def _apply_block_decode(p, x, cfg, block_type: str, cache, cur_index: int,
                        rope):
    """One-token application; x: (B, 1, d); ``cache`` written in place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        parts = attn._mla_qkv(p["attn"], h, cfg, rope)
        # dynamic_update_slice clamps its start so the update fits
        wslot = min(cur_index, cache["ckv"].shape[1] - 1)
        cache["ckv"][:, wslot].copy_(parts.c_kv[:, 0])
        cache["krope"][:, wslot].copy_(parts.k_rope[:, 0, 0])
        cache["pos"][wslot] = cur_index
        part = attn.decode_attention_mla(
            parts.q_nope[:, 0], parts.q_rope[:, 0], cache["ckv"],
            cache["krope"], cache["pos"], p["attn"]["wkv_b"],
            nope_dim=cfg.mla.qk_nope_head_dim, scale=attn.mla_scale(cfg))
    else:
        q, k, v = attn._project_qkv(p["attn"], h, cfg, rope)
        wslot = min(cur_index, cache["k"].shape[1] - 1)
        cache["k"][:, wslot].copy_(k[:, 0])
        cache["v"][:, wslot].copy_(v[:, 0])
        cache["pos"][wslot] = cur_index
        part = attn.decode_attention_gqa(q[:, 0], cache["k"], cache["v"],
                                         cache["pos"], q_position=cur_index)
    o = attn.combine_partials(part, None)
    a = attn._out_proj(o.to(x.dtype), p["attn"]["wo"])
    x, h = _add_then_norm(x, a[:, None], p["ln2"], cfg.norm_eps)
    f, _ = _ffn(p, h, cfg, block_type)
    return x + f


def _layers(params, cfg, caches=None):
    """(block type, layer params, layer cache views or None) in order."""
    for gi, (gt, n) in enumerate(cfg.layer_groups()):
        ps = _unstack(params[f"group{gi}"], n)
        cs = [None] * n if caches is None else _unstack(caches[f"group{gi}"], n)
        for p_l, c_l in zip(ps, cs):
            yield gt, p_l["sub0"], (None if c_l is None else c_l["sub0"])


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, tokens, extra_embeds):
    """Token embeddings in the compute dtype, with ``extra_embeds`` (B, F,
    d) (the vision frontend's patch embeddings) cast and prepended."""
    dt = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens, dt)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dt), x], dim=1)
    return x


#: where the remat policies this port lacks are planned
_ROADMAP_REMAT = "ROADMAP.md Queue 1, item 23 (remat policies)"


def forward(params, cfg, tokens, *, extra_embeds=None, attention=None):
    """Teacher-forced logits over the full sequence (``extra_embeds``
    prepended).  Returns (logits, aux), aux the MoE layers' load-balance
    losses summed.

    ``attention`` replaces :func:`repro_torch.models.attention.
    flash_attention` in every layer (same signature); ``chip_smoke.py``
    passes ``flash_attention_plain`` to hold kernel F's gradient route
    against autograd through the plain version on a card.
    """
    check_ported(cfg)
    if cfg.remat not in ("full", "none"):
        raise NotImplementedError(
            f"remat {cfg.remat!r}: the port runs 'full' (each layer "
            f"recomputed in the backward) and 'none'; {_ROADMAP_REMAT}")
    x = _embed_inputs(params, cfg, tokens, extra_embeds)
    pos = _positions(x.shape[1], cfg, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bt, p_l, _ in _layers(params, cfg):
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, a = checkpoint(_apply_block_seq, p_l, x, cfg, bt, pos, None,
                              attention, use_reentrant=False)
        else:
            x, a = _apply_block_seq(p_l, x, cfg, bt, pos, None, attention)
        aux = aux + a
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits, aux


def init_cache(cfg, batch: int, s_alloc: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Zeroed caches with every position -1 (empty): k/v per kv head, or
    MLA's compressed ``ckv``/``krope``."""
    check_ported(cfg)
    caches = {}
    for gi, (_, n) in enumerate(cfg.layer_groups()):
        if cfg.attention == "mla":
            m = cfg.mla
            shapes = {"ckv": (n, batch, s_alloc, m.kv_lora_rank),
                      "krope": (n, batch, s_alloc, m.qk_rope_head_dim)}
        else:
            shape = (n, batch, s_alloc, cfg.n_kv_heads, cfg.hd())
            shapes = {"k": shape, "v": shape}
        cache = {k: torch.zeros(s, dtype=dtype, device=device)
                 for k, s in shapes.items()}
        cache["pos"] = torch.full((n, s_alloc), -1, dtype=torch.int32,
                                  device=device)
        caches[f"group{gi}"] = {"sub0": cache}
    return caches


def prefill(params, cfg, tokens, *, s_alloc: int, cache_dtype=torch.bfloat16,
            extra_embeds=None):
    """Forward over the prompt (``extra_embeds`` prepended), emitting
    caches.  Returns (last_logits, cache)."""
    check_ported(cfg)
    x = _embed_inputs(params, cfg, tokens, extra_embeds)
    B, S = x.shape[:2]
    pos = _positions(S, cfg, x.device)
    caches = init_cache(cfg, B, s_alloc, cache_dtype, x.device)
    for bt, p_l, c_l in _layers(params, cfg, caches):
        x, _ = _apply_block_seq(p_l, x, cfg, bt, pos, c_l)
    x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits[:, 0], caches


def decode_step(params, cfg, caches, tokens, cur_index, *,
                axis_name: str | None = None):
    """One decode step.  tokens: (B,) int; cur_index: int.  Returns
    (logits (B, V), caches), the caches updated in place."""
    check_ported(cfg)
    if axis_name is not None:
        raise NotImplementedError("decode across a mesh axis comes with the "
                                  "model mesh (ROADMAP.md Queue 1, item 14)")
    cur_index = int(cur_index)
    x = _embed_inputs(params, cfg, tokens[:, None], None)
    pos1 = torch.full((1,), cur_index, dtype=torch.int32, device=x.device)
    rope = rope_tables(pos1, attn.rope_dim(cfg), cfg.rope_theta)
    for bt, p_l, c_l in _layers(params, cfg, caches):
        x = _apply_block_decode(p_l, x, cfg, bt, c_l, cur_index, rope)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits[:, 0], caches
