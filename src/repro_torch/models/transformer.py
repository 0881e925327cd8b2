"""Decoder-only LM assembly for dense attention blocks.

The port of ``repro.models.transformer`` for ``dense_attn`` layer groups
with full (causal) attention: ``init_params``, ``forward`` (teacher-forced
logits), ``init_cache``, ``prefill`` (forward + cache emission) and
``decode_step`` (one token).  Parameters and caches keep the JAX
package's nested dicts, each group stacked on a leading layers axis.

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
  * Other block types and families (``moe_attn``, ``rec``, ``rwkv``, MLA,
    local attention, ``encdec``, ``extra_embeds``) raise
    ``NotImplementedError`` (ROADMAP.md Queue 1, items 16-21).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import (
    RopeTables, Spec, apply_mlp, count, embed_tokens, init_embeddings, init_mlp,
    materialize, rmsnorm, rope_tables, torch_dtype, tree_map, unembed,
)

#: leaves a norm reads in f32: never cast to the compute dtype
NORM_KEYS = frozenset({"ln1", "ln2", "ln_f", "q_norm", "k_norm"})


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense decoder
    with full attention: the families this port runs so far."""
    why = None
    if cfg.family != "decoder":
        why = f"family {cfg.family!r}"
    elif cfg.moe is not None:
        why = "MoE layers (moe_attn)"
    elif cfg.attention != "full":
        why = f"{cfg.attention!r} attention"
    elif cfg.frontend != "none":
        why = f"the {cfg.frontend} frontend (extra_embeds)"
    elif cfg.block_pattern:
        why = f"block pattern {cfg.block_pattern}"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported yet; the port runs dense "
            "decoders with full attention (ROADMAP.md Queue 1, items 16-21)")


def _block_spec(cfg, block_type: str) -> dict:
    if block_type != "dense_attn":
        raise NotImplementedError(f"block type {block_type!r} is not ported")
    return {
        "ln1": Spec((cfg.d_model,), "zeros"),
        "ln2": Spec((cfg.d_model,), "zeros"),
        "attn": attn.init_attention(cfg),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act),
    }


def param_specs(cfg) -> dict:
    """``{"embed", "ln_f", "group<i>": (layer spec, n_layers)}``; a layer
    spec is ``{"sub0": block}``, the JAX package's layout for a group of
    one block type."""
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
    norm scales stay as they are, since a norm reads them in f32."""
    dt = torch_dtype(cfg.compute_dtype)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v if k in NORM_KEYS or not v.is_floating_point()
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
                      rope_tables(dev, cfg.hd(), cfg.rope_theta))


def _apply_block_seq(p, x, cfg, pos: _Positions, cache, attention=None):
    """Full-sequence application of a ``dense_attn`` block; ``cache`` is
    None (forward) or the layer's cache views, written in place;
    ``attention`` as :func:`forward`'s."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
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
    return x + apply_mlp(p["mlp"], h, cfg.act)


def _apply_block_decode(p, x, cfg, cache, cur_index: int, rope):
    """One-token application; x: (B, 1, d); ``cache`` written in place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(p["attn"], h, cfg, rope)
    # dynamic_update_slice clamps its start so the update fits
    wslot = min(cur_index, cache["k"].shape[1] - 1)
    cache["k"][:, wslot].copy_(k[:, 0])
    cache["v"][:, wslot].copy_(v[:, 0])
    cache["pos"][wslot] = cur_index
    part = attn.decode_attention_gqa(q[:, 0], cache["k"], cache["v"],
                                     cache["pos"], q_position=cur_index)
    o = attn.combine_partials(part, None)
    a = attn._out_proj(o.to(x.dtype), p["attn"]["wo"])
    x, h = _add_then_norm(x, a[:, None], p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act)


def _layers(params, cfg, caches=None):
    """(layer params, layer cache views or None) in order."""
    for gi, (_, n) in enumerate(cfg.layer_groups()):
        ps = _unstack(params[f"group{gi}"], n)
        cs = [None] * n if caches is None else _unstack(caches[f"group{gi}"], n)
        for p_l, c_l in zip(ps, cs):
            yield p_l["sub0"], (None if c_l is None else c_l["sub0"])


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, tokens, extra_embeds):
    if extra_embeds is not None:
        raise NotImplementedError("extra_embeds (the vlm/audio frontends) "
                                  "are not ported yet (ROADMAP.md Queue 1, "
                                  "item 21)")
    return embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))


#: where the remat policies this port lacks are planned
_ROADMAP_REMAT = "ROADMAP.md Queue 1, item 23 (remat policies)"


def forward(params, cfg, tokens, *, extra_embeds=None, attention=None):
    """Teacher-forced logits over the full sequence.  Returns (logits, aux).

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
    for p_l, _ in _layers(params, cfg):
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(_apply_block_seq, p_l, x, cfg, pos, None,
                           attention, use_reentrant=False)
        else:
            x = _apply_block_seq(p_l, x, cfg, pos, None, attention)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, s_alloc: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Zeroed k/v caches with every position -1 (empty)."""
    check_ported(cfg)
    caches = {}
    for gi, (_, n) in enumerate(cfg.layer_groups()):
        shape = (n, batch, s_alloc, cfg.n_kv_heads, cfg.hd())
        caches[f"group{gi}"] = {"sub0": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((n, s_alloc), -1, dtype=torch.int32,
                              device=device),
        }}
    return caches


def prefill(params, cfg, tokens, *, s_alloc: int, cache_dtype=torch.bfloat16,
            extra_embeds=None):
    """Forward over the prompt, emitting caches.  Returns (last_logits, cache)."""
    check_ported(cfg)
    x = _embed_inputs(params, cfg, tokens, extra_embeds)
    B, S = x.shape[:2]
    pos = _positions(S, cfg, x.device)
    caches = init_cache(cfg, B, s_alloc, cache_dtype, x.device)
    for p_l, c_l in _layers(params, cfg, caches):
        x = _apply_block_seq(p_l, x, cfg, pos, c_l)
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
    rope = rope_tables(pos1, cfg.hd(), cfg.rope_theta)
    for p_l, c_l in _layers(params, cfg, caches):
        x = _apply_block_decode(p_l, x, cfg, c_l, cur_index, rope)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits[:, 0], caches
