"""Decoder-only LM assembly: dense, MoE, hybrid (RG-LRU and local
attention) and RWKV layers, full, local or MLA attention.

The port of ``repro.models.transformer``: ``init_params``, ``forward``
(teacher-forced logits and the MoE aux loss), ``init_cache`` (k/v,
MLA's compressed ``ckv``/``krope``, a ring of ``window + 128`` slots for
local attention, the RG-LRU's ``h``/``conv`` and RWKV's ``S``/``x_tm``/
``x_cm`` states), ``prefill`` (forward + cache emission) and
``decode_step`` (one token), with the vision frontend's
``extra_embeds`` prepended to the tokens.  Layer groups are the JAX
package's ``cfg.layer_groups()``: one block type, or a ``pattern:``
of several (recurrentgemma: ``rec, rec, attn`` repeated, then the
remainder).  Parameters and caches keep the JAX package's nested dicts,
each group stacked on a leading layers axis, one ``sub<i>`` per block
of the pattern.  The encoder-decoder family is ``encdec.py``.

What differs from the JAX package, and why:

  * The layers run as a Python loop over views of the stacked
    parameters.  ``scan_layers`` shapes what XLA compiles and is read
    nowhere here.  ``forward`` honours ``remat`` as the JAX package's
    ``jax.checkpoint`` of each layer (:func:`remat_call`), where a
    gradient is wanted: ``"full"`` (every config's default) runs each
    block under ``torch.utils.checkpoint``, so the backward recomputes
    the block, kernel F included; ``"none"`` keeps every activation;
    ``"dots"`` and ``"save_block_io"`` run it under a selective
    checkpoint (``create_selective_checkpoint_contexts``) whose policy
    saves, for ``"dots"``, the outputs of matrix products without batch
    dims (``aten.mm``, ``aten.addmm``: JAX's
    ``checkpoint_dots_with_no_batch_dims``) and, for
    ``"save_block_io"``, only the block outputs tagged ``attn_out`` and
    ``ffn_out`` by :func:`~repro_torch.models.layers.checkpoint_name`
    (an identity custom op, ``repro_torch::checkpoint_name``, whose name
    argument the policy reads: JAX's ``checkpoint_name`` and
    ``save_only_these_names``); everything else is recomputed.
  * Training passes the f32 master parameters straight in: every use
    casts a matrix to the compute dtype inside the graph, so gradients
    reach the f32 leaves.  Serving casts them once first
    (:func:`compute_params`), which gives the same results.
  * The cache is one preallocated tensor per group, written in place by
    ``prefill`` and ``decode_step``, which return the same dict: the
    counterpart of ``dynamic_update_slice`` with a donated cache.
  * On a mesh (parameters and inputs DTensors, a mesh current through
    ``dist.sharding.use_mesh``) the same code runs on DTensors under
    ``implicit_replication`` (the tensors the model makes itself, such as
    positions and rotary tables, count as replicated): the stream is
    laid out between blocks by ``constrain_act``/``constrain_seq`` where
    the JAX package constrains it (:func:`_constrain_stream`), attention
    runs on each rank's heads (``attention.flash_attention`` under
    ``local_map``; kernel F on a card), the MoE layers take the
    expert-parallel path where the ``model`` axis divides the experts,
    and decode with a ``model`` axis over 1 that divides the cache
    reaches the JAX package's flash-decoding stub
    (:func:`_use_sharded_decode`, ``dist.collectives``), which raises as
    it does there.  Off a mesh these are no-ops.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.dist import collectives, sharding
from repro_torch.dist.sharding import constrain_act, constrain_seq

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .layers import (
    RopeTables, Spec, Stacked, apply_mlp, checkpoint_name, embed_tokens,
    init_embeddings, init_mlp, model_axes, model_count, model_materialize,
    model_shapes, naming, rmsnorm, rope_tables, torch_dtype, unembed,
)

#: leaves a norm reads in f32: never cast to the compute dtype
NORM_KEYS = frozenset({"ln1", "ln2", "ln_f", "q_norm", "k_norm", "kv_norm",
                       "ln_x", "ln_enc"})
#: leaves the JAX package reads at their stored precision, whatever the
#: compute dtype, so :func:`compute_params` keeps them as stored: the
#: norms; the MoE router, which ``apply_moe`` casts to f32 (a bf16 copy of
#: f32 master parameters would move the logits, and with them the top-k);
#: MLA's ``wkv_b``, which the absorbed decode reads in f32; the RG-LRU's
#: ``lam`` and RWKV's ``decay``, ``bonus`` and output norm, read in f32
KEEP_STORED = NORM_KEYS | {"router", "wkv_b", "lam", "decay", "bonus",
                           "ln_x_scale", "ln_x_bias"}

FAMILIES = ("decoder", "hybrid", "rwkv", "encdec")
ATTENTIONS = ("full", "local", "mla")


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family or attention that no
    configuration of the JAX package has (:data:`FAMILIES`,
    :data:`ATTENTIONS`): the port runs every one it has."""
    if cfg.family not in FAMILIES or cfg.attention not in ATTENTIONS:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} "
            f"attention; the port runs the families {FAMILIES} with "
            f"{ATTENTIONS} attention")


def _use_sharded_decode(alloc: int) -> bool:
    """Flash-decoding path: on when the current mesh has a ``model`` axis
    over 1 that divides the cache's sequence dim (the JAX package's
    guard; the path itself is its stub, ``dist.collectives``)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return False
    n = sharding.mesh_sizes(mesh).get("model", 1)
    return n > 1 and alloc % n == 0


def _constrain_stream(x, cfg):
    """Residual-stream layout between blocks: batch over (pod, data);
    with ``seq_parallel`` also seq over model (Megatron-SP)."""
    if cfg.seq_parallel and x.ndim >= 3:
        return constrain_seq(x)
    return constrain_act(x, profile=cfg.sharding_profile)


#: the selective-checkpoint policies of ``remat`` (module docstring)
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_NAMES = ("attn_out", "ffn_out")


def _policy(remat: str):
    def policy(ctx, op, *args, **kwargs):
        if remat == "dots":
            save = op in _MM
        else:
            save = (op == torch.ops.repro_torch.checkpoint_name.default
                    and args[1] in _NAMES)
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat_call(fn, cfg, *args):
    """``fn(*args)`` under ``cfg.remat`` where a gradient is wanted: the
    JAX package's ``_remat`` of a layer ("none": as is; "dots" and
    "save_block_io": a selective checkpoint; any other: a full one)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "save_block_io":
        named = fn

        def fn(*a):
            with naming():
                return named(*a)
    if cfg.remat in ("dots", "save_block_io"):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _policy(cfg.remat)))
    return checkpoint(fn, *args, use_reentrant=False)


def _group_block_types(group_type: str) -> list[str]:
    """The block types of one layer of a group: ``pattern:a,b,c`` or one
    type."""
    if group_type.startswith("pattern:"):
        return group_type.split(":", 1)[1].split(",")
    return [group_type]


def is_local(cfg, block_type: str) -> bool:
    """Whether an attention block attends within ``cfg.window`` (local
    attention, or a hybrid's ``attn`` block with a window), the JAX
    package's rule."""
    return cfg.attention == "local" or (block_type == "attn"
                                        and bool(cfg.window))


def _block_spec(cfg, block_type: str) -> dict:
    p = {"ln1": Spec((cfg.d_model,), "zeros", axes=("embed",)),
         "ln2": Spec((cfg.d_model,), "zeros", axes=("embed",))}
    if block_type in ("dense_attn", "moe_attn", "attn"):
        p["attn"] = (attn.init_mla(cfg) if cfg.attention == "mla"
                     else attn.init_attention(cfg))
        if block_type == "moe_attn":
            p["moe"] = moe_mod.init_moe(cfg)
        else:
            d_ff = cfg.d_ff
            if cfg.moe is not None and cfg.moe.first_dense_layers:
                d_ff = cfg.moe.d_ff_dense or cfg.d_ff
            p["mlp"] = init_mlp(cfg.d_model, d_ff, cfg.act)
    elif block_type == "rec":
        p["rec"] = rglru_mod.init_rglru_block(cfg)
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.act)
    elif block_type == "rwkv":
        p["tm"] = rwkv_mod.init_rwkv_time_mix(cfg)
        p["cm"] = rwkv_mod.init_rwkv_channel_mix(cfg)
    else:
        raise ValueError(f"unknown block type {block_type!r}")
    return p


def param_specs(cfg) -> dict:
    """``{"embed", "ln_f", "group<i>": Stacked(layer spec, n_layers)}``; a
    layer spec is ``{"sub<i>": block}``, one block per type of the group's
    pattern, the JAX package's layout (deepseek-v3: ``dense_attn``
    layers, then ``moe_attn``; recurrentgemma: ``rec, rec, attn``
    layers, then ``rec, rec``)."""
    check_ported(cfg)
    p = {"embed": init_embeddings(cfg),
         "ln_f": Spec((cfg.d_model,), "zeros", axes=("embed",))}
    for gi, (gt, n) in enumerate(cfg.layer_groups()):
        p[f"group{gi}"] = Stacked({f"sub{i}": _block_spec(cfg, bt) for i, bt
                                   in enumerate(_group_block_types(gt))}, n)
    return p


def param_count(cfg) -> int:
    """Parameters of ``cfg``, from shapes alone (nothing allocated)."""
    return model_count(param_specs(cfg))


def param_axes(cfg) -> dict:
    """Every parameter's logical axes (``"layers"`` first in a stacked
    group), the JAX package's ``split`` axes tree."""
    return model_axes(param_specs(cfg))


def param_shapes(cfg) -> dict:
    """Every parameter's shape, stacked groups with their layers axis."""
    return model_shapes(param_specs(cfg))


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Draw every parameter in ``cfg.param_dtype`` on ``device``."""
    return model_materialize(param_specs(cfg), generator, device,
                             torch_dtype(cfg.param_dtype))


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
        if moe_mod.moe_sharding_available(cfg):
            return moe_mod.apply_moe_sharded(p["moe"], h, cfg)
        return moe_mod.apply_moe(p["moe"], h, cfg)
    return apply_mlp(p["mlp"], h, cfg.act), _zero_aux(h)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _write_state(cache, new: dict) -> None:
    """A recurrent block's new state into its cache views, in place."""
    for k, v in new.items():
        cache[k].copy_(v)


def _apply_recurrent(p, x, cfg, block_type: str, state):
    """A ``rec`` or ``rwkv`` block over x (B, S, d) from ``state`` (the
    layer's cache views, or None: zeros), which it overwrites with the
    state after the last step.  Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if block_type == "rec":
        r, new = rglru_mod.rglru_block(p["rec"], h, cfg, state=state)
        x, h = _add_then_norm(x, checkpoint_name(r, "attn_out"), p["ln2"],
                              cfg.norm_eps)
        x = _constrain_stream(x + checkpoint_name(
            apply_mlp(p["mlp"], h, cfg.act), "ffn_out"), cfg)
    else:
        st = state if state is not None else rwkv_mod.init_rwkv_state(
            cfg, x.shape[0], x.device)
        t, tstate = rwkv_mod.time_mix(p["tm"], h, cfg, st)
        x, h = _add_then_norm(x, t, p["ln2"], cfg.norm_eps)
        c, cstate = rwkv_mod.channel_mix(p["cm"], h, st)
        x = constrain_act(x + c)
        new = {**tstate, **cstate}
    if state is not None:
        _write_state(state, new)
    return x


def _apply_block_seq(p, x, cfg, block_type: str, pos: _Positions, cache,
                     attention=None):
    """Full-sequence application of one block; ``cache`` is None
    (forward) or the layer's cache views, written in place; ``attention``
    as :func:`forward`'s.  Returns (x, aux)."""
    if block_type in ("rec", "rwkv"):
        return _apply_recurrent(p, x, cfg, block_type, cache), _zero_aux(x)
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
            mask_mode="local" if is_local(cfg, block_type) else "causal",
            window=cfg.window, q_chunk=cfg.attn_q_chunk,
            k_chunk=cfg.attn_k_chunk,
        )
        a = attn._out_proj(a, p["attn"]["wo"])
        if cache is not None:
            _write_cache_kv(cache, k, v, pos.device)
    a = checkpoint_name(a, "attn_out")
    x, h = _add_then_norm(x, a, p["ln2"], cfg.norm_eps)
    x = _constrain_stream(x, cfg)
    f, aux = _ffn(p, h, cfg, block_type)
    f = checkpoint_name(f, "ffn_out")
    return _constrain_stream(x + f, cfg), aux


def _write_slot(cur_index: int, alloc: int, local: bool) -> int:
    """The cache slot of position ``cur_index``: ``pos % alloc`` in a
    local layer's ring, else ``cur_index``, clamped as
    ``dynamic_update_slice`` clamps its start so the update fits."""
    return cur_index % alloc if local else min(cur_index, alloc - 1)


def _apply_block_decode(p, x, cfg, block_type: str, cache, cur_index: int,
                        rope, axis_name=None):
    """One-token application; x: (B, 1, d); ``cache`` written in place;
    ``axis_name`` as :func:`decode_step`'s."""
    if block_type in ("rec", "rwkv"):
        return _apply_recurrent(p, x, cfg, block_type, cache)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    local = is_local(cfg, block_type)
    if cfg.attention == "mla":
        parts = attn._mla_qkv(p["attn"], h, cfg, rope)
        wslot = _write_slot(cur_index, cache["ckv"].shape[1], local)
        cache["ckv"][:, wslot].copy_(parts.c_kv[:, 0])
        cache["krope"][:, wslot].copy_(parts.k_rope[:, 0, 0])
        cache["pos"][wslot] = cur_index
        part = attn.decode_attention_mla(
            parts.q_nope[:, 0], parts.q_rope[:, 0], cache["ckv"],
            cache["krope"], cache["pos"], p["attn"]["wkv_b"],
            nope_dim=cfg.mla.qk_nope_head_dim, scale=attn.mla_scale(cfg))
    else:
        q, k, v = attn._project_qkv(p["attn"], h, cfg, rope)
        wslot = _write_slot(cur_index, cache["k"].shape[1], local)
        cache["k"][:, wslot].copy_(k[:, 0])
        cache["v"][:, wslot].copy_(v[:, 0])
        cache["pos"][wslot] = cur_index
        if axis_name is None and _use_sharded_decode(cache["k"].shape[1]):
            # the JAX package's flash-decoding path: its stub, which raises
            collectives.sharded_decode_attention_gqa(
                q[:, 0], cache["k"], cache["v"], cache["pos"],
                window=cfg.window if local else 0, q_position=cur_index)
        part = attn.decode_attention_gqa(
            q[:, 0], cache["k"], cache["v"], cache["pos"],
            window=cfg.window if local else 0, q_position=cur_index)
    o = attn.combine_partials(part, axis_name)
    a = attn._out_proj(o.to(x.dtype), p["attn"]["wo"])
    x, h = _add_then_norm(x, a[:, None], p["ln2"], cfg.norm_eps)
    f, _ = _ffn(p, h, cfg, block_type)
    return x + f


def _layers(params, cfg, caches=None):
    """(block type, block params, block cache views or None) in order:
    each layer of each group, each block of its pattern."""
    for gi, (gt, n) in enumerate(cfg.layer_groups()):
        subs = _group_block_types(gt)
        ps = _unstack(params[f"group{gi}"], n)
        cs = [None] * n if caches is None else _unstack(caches[f"group{gi}"], n)
        for p_l, c_l in zip(ps, cs):
            for i, bt in enumerate(subs):
                yield (bt, p_l[f"sub{i}"],
                       None if c_l is None else c_l[f"sub{i}"])


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
    return constrain_act(x, profile=cfg.sharding_profile)


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
    with sharding.mesh_ops(params["ln_f"]):
        x = _embed_inputs(params, cfg, tokens, extra_embeds)
        pos = _positions(x.shape[1], cfg, x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bt, p_l, _ in _layers(params, cfg):
            x, a = remat_call(_apply_block_seq, cfg, p_l, x, cfg, bt, pos,
                              None, attention)
            aux = aux + a
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = constrain_act(unembed(params["embed"], x,
                                       cfg.tied_embeddings),
                               vocab_dim=True, profile=cfg.sharding_profile)
    return logits, aux


def _cache_block(cfg, block_type: str, n: int, batch: int, s_alloc: int,
                 dtype, device) -> dict:
    """One block's cache, stacked over the group's ``n`` layers."""
    if block_type == "rec":
        return rglru_mod.init_rglru_state(cfg, batch, dtype, device, n)
    if block_type == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, device, n)
    alloc = (min(s_alloc, cfg.window + 128) if is_local(cfg, block_type)
             else s_alloc)
    if cfg.attention == "mla":
        m = cfg.mla
        shapes = {"ckv": (n, batch, alloc, m.kv_lora_rank),
                  "krope": (n, batch, alloc, m.qk_rope_head_dim)}
    else:
        shape = (n, batch, alloc, cfg.n_kv_heads, cfg.hd())
        shapes = {"k": shape, "v": shape}
    cache = {k: torch.zeros(s, dtype=dtype, device=device)
             for k, s in shapes.items()}
    cache["pos"] = torch.full((n, alloc), -1, dtype=torch.int32,
                              device=device)
    return cache


def init_cache(cfg, batch: int, s_alloc: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Zeroed caches with every position -1 (empty): k/v per kv head (a
    ring of ``min(s_alloc, window + 128)`` slots in a local layer), or
    MLA's compressed ``ckv``/``krope``; zeroed recurrent states (f32, the
    RG-LRU's conv tail in ``dtype``)."""
    check_ported(cfg)
    caches = {}
    for gi, (gt, n) in enumerate(cfg.layer_groups()):
        caches[f"group{gi}"] = {
            f"sub{i}": _cache_block(cfg, bt, n, batch, s_alloc, dtype, device)
            for i, bt in enumerate(_group_block_types(gt))}
    return caches


def prefill(params, cfg, tokens, *, s_alloc: int, cache_dtype=torch.bfloat16,
            extra_embeds=None):
    """Forward over the prompt (``extra_embeds`` prepended), emitting
    caches.  Returns (last_logits, cache)."""
    check_ported(cfg)
    with sharding.mesh_ops(params["ln_f"]):
        x = _embed_inputs(params, cfg, tokens, extra_embeds)
        B, S = x.shape[:2]
        pos = _positions(S, cfg, x.device)
        caches = sharding.shard_cache(
            init_cache(cfg, B, s_alloc, cache_dtype, x.device), like=x)
        for bt, p_l, c_l in _layers(params, cfg, caches):
            x, _ = _apply_block_seq(p_l, x, cfg, bt, pos, c_l)
        x = rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits[:, 0], caches


def decode_step(params, cfg, caches, tokens, cur_index, *,
                axis_name: str | None = None):
    """One decode step.  tokens: (B,) int; cur_index: int.  Returns
    (logits (B, V), caches), the caches updated in place.

    ``axis_name``: a mesh axis of the current mesh over which each rank's
    cache holds part of the keys (the caller's ``local_map`` or process
    layout, the JAX package's ``shard_map``): the partial softmax stats
    are merged across it (``attention.combine_partials``)."""
    check_ported(cfg)
    cur_index = int(cur_index)
    with sharding.mesh_ops(params["ln_f"]):
        x = _embed_inputs(params, cfg, tokens[:, None], None)
        pos1 = torch.full((1,), cur_index, dtype=torch.int32,
                          device=x.device)
        rope = rope_tables(pos1, attn.rope_dim(cfg), cfg.rope_theta)
        for bt, p_l, c_l in _layers(params, cfg, caches):
            x = _apply_block_decode(p_l, x, cfg, bt, c_l, cur_index, rope,
                                    axis_name)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tied_embeddings)
    return logits[:, 0], caches
