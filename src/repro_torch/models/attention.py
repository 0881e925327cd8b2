"""Attention: GQA / MQA / qk-norm / QKV bias / local window / cross / MLA,
flash attention and decode.

The port of ``repro.models.attention``.

  * :func:`flash_attention` — attention over a whole sequence.  On a
    CPU tensor it runs :func:`flash_attention_plain`, the chunked
    online-softmax version of the JAX package's jnp path, with every mask
    mode (causal, local, none) and ``-1``-padded positions.  On a CUDA
    tensor it launches kernel F (``csrc/flash_attention.cu``, wrapper
    :mod:`repro_torch.kernels.flash_attention`) where F's domain covers
    the call (causal, local as F's band, unmasked with Sq != Sk for
    cross attention), and raises where it does not: it never runs the
    plain version on a card.  F takes v at its own head dim (MLA: v 128
    under q and k at 192), as the JAX package's attention does
    (:func:`run_flash_kernel`).  Where a gradient is wanted it
    launches F through :class:`FlashAttention`, whose backward is the
    gradient of :func:`flash_attention_plain`.
  * On a mesh (q, k, v DTensors) :func:`flash_attention` runs on each
    rank's own heads under ``local_map`` (``shard_map``'s counterpart):
    the batch over (pod, data), the query heads over ``model`` where they
    divide, and the kv heads with them (a rank whose query heads share
    replicated kv heads takes its slice).  Kernel F runs there on a card,
    as off a mesh.
  * :func:`decode_attention_gqa` — one new token over the cache, returning
    partial softmax stats (o, m, l); :func:`combine_partials` normalises
    them, merged across a mesh axis when one is named.  Plain PyTorch on
    every device: the JAX package has no kernel for it either.
  * MLA (deepseek-v3): :func:`attend_mla`, the full-rank expansion for
    prefill and training (kernel F at qk head dim nope + rope, v at its
    own head dim),
    and :func:`decode_attention_mla`, the absorbed decode on the
    compressed cache (plain f32, as the reference's jnp).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.dist import sharding
from repro_torch.kernels import flash_attention as fa_kernel

from .layers import (
    RopeTables, Spec, rmsnorm, rope_tables, rotate, shape_only_active,
)

NEG_INF = -1e30



# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(cfg, *, cross: bool = False) -> dict:
    """Parameter specs of one GQA attention block; a cross-attention block
    (``cross``, encdec) has the same layout, as in the JAX package."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    p = {
        "wq": Spec((d, H, hd), axes=("embed", "heads", "head_dim")),
        "wk": Spec((d, Hkv, hd), axes=("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, Hkv, hd), axes=("embed", "kv_heads", "head_dim")),
        "wo": Spec((H, hd, d), axes=("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Spec((H, hd), "zeros", axes=("heads", "head_dim"))
        p["bk"] = Spec((Hkv, hd), "zeros", axes=("kv_heads", "head_dim"))
        p["bv"] = Spec((Hkv, hd), "zeros", axes=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p["q_norm"] = Spec((hd,), "zeros", axes=("head_dim",))
        p["k_norm"] = Spec((hd,), "zeros", axes=("head_dim",))
    return p


def init_mla(cfg) -> dict:
    """Parameter specs of one MLA attention block (deepseek-v3)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": Spec((d, m.q_lora_rank), axes=("embed", "q_lora")),
        "q_norm": Spec((m.q_lora_rank,), "zeros", axes=("q_lora",)),
        "wq_b": Spec((m.q_lora_rank, H, qk),
                     axes=("q_lora", "heads", "head_dim")),
        "wkv_a": Spec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                      axes=("embed", "kv_lora")),
        "kv_norm": Spec((m.kv_lora_rank,), "zeros", axes=("kv_lora",)),
        "wkv_b": Spec((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                      axes=("kv_lora", "heads", "head_dim")),
        "wo": Spec((H, m.v_head_dim, d), axes=("heads", "head_dim", "embed")),
    }


def rope_dim(cfg) -> int:
    """Head dim that RoPE rotates: MLA's rope part, else the head dim."""
    return cfg.mla.qk_rope_head_dim if cfg.attention == "mla" else cfg.hd()


# ---------------------------------------------------------------------------
# qkv projection
# ---------------------------------------------------------------------------

def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product (on a mesh:
    :func:`_proj_on_mesh`)."""
    if sharding.is_dtensor(x):
        return _proj_on_mesh(x, w)
    d, heads, hd = w.shape
    y = x @ w.to(x.dtype).reshape(d, heads * hd)
    return y.view(*x.shape[:-1], heads, hd)


def _tp_layout(mesh, B: int, heads: int, x_dim: int, w_dim: int,
               out_dim: int, row: bool):
    """Placements of a head-parallel projection on ``mesh`` (the batch over
    (pod, data) where it divides, the heads over ``model`` where they
    divide, everything else gathered): (x, x grad, w, w grad, out).  A
    column-parallel projection (``row=False``: x (..., d) -> heads) takes
    whole x and gives each rank its heads, so x's gradient is a partial
    sum over ``model``; a row-parallel one (heads -> (..., d)) gives a
    partial sum over ``model``.  The weight's gradient is a partial sum
    over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    batch = sharding.batch_entry(mesh, B) or ()
    n = sharding.mesh_sizes(mesh).get("model", 1)
    split = n > 1 and heads % n == 0
    pls = [[], [], [], [], []]
    for name in sharding.mesh_axes(mesh):
        if name in batch:
            row_ = (Shard(0), Shard(0), Replicate(), Partial(), Shard(0))
        elif name == "model" and split:
            row_ = ((Shard(x_dim), Shard(x_dim), Shard(w_dim), Shard(w_dim),
                     Partial()) if row else
                    (Replicate(), Partial(), Shard(w_dim), Shard(w_dim),
                     Shard(out_dim)))
        else:
            row_ = (Replicate(),) * 5
        for lst, p in zip(pls, row_):
            lst.append(p)
    return tuple(tuple(p) for p in pls)


def _proj_on_mesh(x, w):
    """:func:`_proj` of DTensors under ``local_map``: column-parallel over
    the heads (Megatron's), so no head dim is ever split unevenly."""
    from torch.distributed.tensor.experimental import local_map

    d, heads, hd = w.shape
    w = sharding.on_mesh(w, x.device_mesh)
    x_pl, x_grad, w_pl, w_grad, out_pl = _tp_layout(
        x.device_mesh, x.shape[0], heads, x.ndim - 1, 1, x.ndim - 1,
        row=False)

    def local(xl, wl):
        y = xl @ wl.to(xl.dtype).reshape(d, -1)
        return y.view(*xl.shape[:-1], -1, hd)

    return local_map(local, out_placements=(out_pl,),
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, w)


def _project_qkv(p, x, cfg, rope: RopeTables | None):
    """q, k, v of x; rotated by ``rope`` (the tables at x's positions,
    :func:`~repro_torch.models.layers.rope_tables`) unless it is None."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        q, k = rotate(q, rope), rotate(k, rope)
    return q, k, v


def _out_proj(a, wo):
    """``einsum("bshk,hkd->bsd", a, wo)`` as one matrix product (on a mesh
    row-parallel over the heads under ``local_map``, :func:`_tp_layout`;
    the result a partial sum over ``model`` that the residual add
    reduces)."""
    H, hd, d = wo.shape
    if sharding.is_dtensor(a):
        from torch.distributed.tensor.experimental import local_map

        wo = sharding.on_mesh(wo, a.device_mesh)
        a_pl, a_grad, w_pl, w_grad, out_pl = _tp_layout(
            a.device_mesh, a.shape[0], H, a.ndim - 2, 0, a.ndim - 2,
            row=True)

        def local(al, wl):
            return al.reshape(*al.shape[:-2], -1) @ wl.to(al.dtype).reshape(
                -1, d)

        return local_map(local, out_placements=(out_pl,),
                         in_placements=(a_pl, w_pl),
                         in_grad_placements=(a_grad, w_grad),
                         device_mesh=a.device_mesh,
                         redistribute_inputs=True)(a, wo)
    return a.reshape(*a.shape[:-2], H * hd) @ wo.to(a.dtype).reshape(H * hd, d)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _pad_to(x, size: int, dim: int):
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def flash_attention_plain(q, k, v, *, q_positions, k_positions,
                          mask_mode: str = "causal", window: int = 0,
                          q_chunk: int = 1024, k_chunk: int = 1024,
                          scale: float | None = None,
                          p_dtype: torch.dtype | None = None):
    """Chunked online-softmax attention, on any device.

    q: (B, Sq, H, qkd); k: (B, Sk, Hkv, qkd); v: (B, Sk, Hkv, vd).
    positions: int (Sq,) / (Sk,) absolute positions (mask + validity:
    negative k_position == padding), on any device (moved to q's: the
    model hands them over on the CPU).  Scores, stats and the accumulator
    are f32; the result is in q's type.  ``p_dtype`` rounds p to that
    type before each chunk's P.V (l still sums the f32 p), as kernel F's
    bf16 route does with 64-key chunks.
    """
    if mask_mode not in ("causal", "local", "none"):
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    B, Sq, H, qkd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else qkd ** -0.5
    q_positions = q_positions.to(q.device)
    k_positions = k_positions.to(q.device)

    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    nq = -(-Sq // qc)
    nk = -(-Sk // kc)

    qr = _pad_to(q, nq * qc, 1).reshape(B, nq, qc, Hkv, G, qkd)
    kr = _pad_to(k, nk * kc, 1).reshape(B, nk, kc, Hkv, qkd)
    vr = _pad_to(v, nk * kc, 1).reshape(B, nk, kc, Hkv, vd)
    qpos = _pad_to(q_positions, nq * qc, 0).reshape(nq, qc)
    kpos = (_pad_to(k_positions + 1, nk * kc, 0) - 1).reshape(nk, kc)

    outs = []
    for qi in range(nq):
        q_blk = qr[:, qi].float()             # (B, qc, Hkv, G, qkd)
        qp = qpos[qi]                         # (qc,)
        o = torch.zeros((B, Hkv, G, qc, vd), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros((B, Hkv, G, qc), dtype=torch.float32,
                         device=q.device)
        for ki in range(nk):
            k_blk = kr[:, ki].float()         # (B, kc, Hkv, qkd)
            v_blk = vr[:, ki].float()         # (B, kc, Hkv, vd)
            kp = kpos[ki]                     # (kc,)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            valid = (kp >= 0)[None, :]
            if mask_mode == "causal":
                valid = valid & (qp[:, None] >= kp[None, :])
            elif mask_mode == "local":
                diff = qp[:, None] - kp[None, :]
                valid = valid & (diff >= 0) & (diff < window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard: fully-masked rows keep m at NEG_INF; exp(NEG_INF -
            # NEG_INF) would be 1, so clamp the shift argument.
            shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p_ = torch.exp(s - shift[..., None])
            p_ = torch.where(valid, p_, 0.0)
            alpha = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF,
                                          m - shift))
            pv = p_ if p_dtype is None else p_.to(p_dtype).float()
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pv, v_blk)
            l_ = l_ * alpha + p_.sum(dim=-1)
            m = m_new
        out = o / torch.clamp(l_, min=1e-30)[..., None]
        # (B, Hkv, G, qc, vd) -> (B, qc, H, vd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, vd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


class _ShapeOnly(torch.autograd.Function):
    """Attention's output shape on ``meta`` tensors (``layers.shape_only``:
    the dry run, which takes its FLOPs from the analytic model), saving
    q, k and v for the backward as :class:`FlashAttention` does, with
    gradients of their shapes.  Outside ``shape_only`` meta tensors take
    the card's route up to kernel F's wrapper, which refuses them."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return q.new_empty(*q.shape[:-1], v.shape[-1])

    @staticmethod
    def backward(ctx, grad_out):
        return tuple(torch.empty_like(t) for t in ctx.saved_tensors)


def _is_iota(pos, n: int) -> bool:
    """``pos`` is exactly 0..n-1 (a device sync unless pos is on the CPU)."""
    if pos.dim() != 1 or pos.shape[0] != n:
        return False
    return bool(torch.equal(pos, torch.arange(n, dtype=pos.dtype,
                                              device=pos.device)))


class FlashAttention(torch.autograd.Function):
    """Kernel F with a gradient: ``FlashAttention.apply(q, k, v, causal,
    q_chunk, k_chunk[, window])`` in the model's ``(B, S, heads, d)``
    layout, positions 0..S-1 (``window > 0``: the causal band).

    The forward launches F through its wrapper, as a prefill does (on a
    CPU tensor the wrapper runs F's plain version), and saves q, k and v.
    The backward recomputes the attention with autograd through
    :func:`flash_attention_plain`, at the call's chunk sizes, and returns
    ``torch.autograd.grad`` of it.  This is the port of the JAX package's
    training, which differentiates its chunked jnp attention
    (``repro.models.attention.flash_attention``) by autodiff: the TPU
    kernel ``flash_attention_tpu`` has no ``custom_vjp``, so no TPU
    backward kernel exists to be ported.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, k_chunk: int,
                window: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.mask = kernel_mask_mode(causal, window)
        ctx.window, ctx.chunks = window, (q_chunk, k_chunk)
        out = fa_kernel.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, grad_out):
        with tracing.span("attention.backward"), torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = flash_attention_plain(
                q, k, v,
                q_positions=torch.arange(q.shape[1], device=q.device),
                k_positions=torch.arange(k.shape[1], device=k.device),
                mask_mode=ctx.mask, window=ctx.window,
                q_chunk=ctx.chunks[0], k_chunk=ctx.chunks[1])
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None, None, None


def kernel_mask_mode(causal: bool, window: int) -> str:
    """Kernel F's (causal, window) as a mask mode."""
    return "local" if window else "causal" if causal else "none"


def flash_attention(q, k, v, *, q_positions, k_positions,
                    mask_mode: str = "causal", window: int = 0,
                    q_chunk: int = 1024, k_chunk: int = 1024,
                    scale: float | None = None):
    """Chunked online-softmax attention (layouts as
    :func:`flash_attention_plain`).

    On a CPU tensor this is :func:`flash_attention_plain`.  On a CUDA
    tensor it launches kernel F, which covers mask ``causal``, ``local``
    (F's band; ``window`` must be at least 1, else ``ValueError``) and
    ``none`` (also with Sq != Sk), positions 0..S-1 (what the models
    pass, on the CPU, so the check costs no device sync), v at its own
    head dim up to the qk head dim where F has an instance for the pair
    (:data:`repro_torch.kernels.flash_attention.PAIRS`; F's wrapper
    raises ``ValueError`` for any other pair), and the default scale
    ``qkd ** -0.5`` (MLA's ``(nope + rope) ** -0.5`` is that scale); the
    chunk sizes are the jnp path's tiling and do not change the result.
    Any other call on a card raises ``NotImplementedError``.
    """
    if sharding.is_dtensor(q):
        return _flash_on_mesh(q, k, v, dict(
            q_positions=q_positions, k_positions=k_positions,
            mask_mode=mask_mode, window=window, q_chunk=q_chunk,
            k_chunk=k_chunk, scale=scale))
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_positions=q_positions, k_positions=k_positions,
            mask_mode=mask_mode, window=window, q_chunk=q_chunk,
            k_chunk=k_chunk, scale=scale)
    if q.device.type == "meta" and shape_only_active():
        return _ShapeOnly.apply(q, k, v)
    Sq, qkd, Sk, vd = q.shape[1], q.shape[-1], k.shape[1], v.shape[-1]
    if mask_mode not in ("causal", "local", "none"):
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    if mask_mode == "local" and window < 1:
        raise ValueError(f"local attention with window {window}: kernel "
                         f"F's band needs a window of at least 1")
    if vd > qkd or (scale is not None and scale != qkd ** -0.5):
        raise NotImplementedError(
            f"qk head dim {qkd}, v head dim {vd}, scale {scale} on "
            f"{q.device}: kernel F takes a v head dim up to the qk head "
            f"dim and the scale qk head dim ** -0.5 only")
    if not (_is_iota(q_positions, Sq) and _is_iota(k_positions, Sk)):
        raise NotImplementedError(
            f"positions other than 0..S-1 on {q.device}: kernel F masks by "
            f"row and column index, and no model of the port passes others")
    return run_flash_kernel(
        q, k, v, causal=mask_mode != "none",
        window=window if mask_mode == "local" else 0, q_chunk=q_chunk,
        k_chunk=k_chunk)


def _head_layout(mesh, B: int, H: int, Hkv: int, q_dim: int = 2,
                 kv_dim: int = 2):
    """(q placements, kv placements, kv grad placements, kv slice) of
    attention on ``mesh`` (heads at dim ``q_dim`` of q and ``kv_dim`` of
    k and v): the batch over (pod, data) where it divides,
    the query heads over ``model`` where they divide, kv heads with them
    where they divide too; else kv replicated, each rank slicing the kv
    heads its query heads read (``slice(first, first + n)`` per model
    rank, their gradient then a partial sum over ``model``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    sizes = sharding.mesh_sizes(mesh)
    batch = sharding.batch_entry(mesh, B) or ()
    n = sizes.get("model", 1)
    Hl, G = H // n, H // Hkv
    q_split = n > 1 and H % n == 0 and (Hl % G == 0 or G % Hl == 0)
    kv_split = q_split and Hkv % n == 0
    q_pl, kv_pl, kv_grad = [], [], []
    for name in sharding.mesh_axes(mesh):
        if name in batch:
            p = Shard(0)
            q_pl.append(p), kv_pl.append(p), kv_grad.append(p)
        elif name == "model" and q_split:
            q_pl.append(Shard(q_dim))
            kv_pl.append(Shard(kv_dim) if kv_split else Replicate())
            kv_grad.append(Shard(kv_dim) if kv_split else Partial())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    kv_slice = None
    if q_split and not kv_split:
        r = mesh.get_local_rank("model")
        kv_slice = ((r * Hl) // G, max(1, Hl // G))
    return tuple(q_pl), tuple(kv_pl), tuple(kv_grad), kv_slice


def _flash_on_mesh(q, k, v, kw: dict):
    """:func:`flash_attention` of DTensors q, k, v: each rank attends with
    its own batch rows and heads (:func:`_head_layout`) under
    ``local_map``; the result is laid out as q."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl, kv_pl, kv_grad, kv_slice = _head_layout(
        mesh, q.shape[0], q.shape[2], k.shape[2])

    def local(ql, kl, vl):
        if kv_slice is not None:
            first, n = kv_slice
            kl, vl = kl[:, :, first:first + n], vl[:, :, first:first + n]
        return flash_attention(ql, kl, vl, **kw)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def pad_head_dim(x, d: int):
    """``x`` with its last dim zero-padded to ``d`` (itself if it has
    ``d`` already)."""
    return x if x.shape[-1] == d else _pad_to(x, d, x.dim() - 1)


def run_flash_kernel(q, k, v, *, causal: bool, window: int = 0,
                     q_chunk: int = 1024, k_chunk: int = 1024):
    """Kernel F on q, k ``(B, S, heads, qkd)`` and v ``(B, S, Hkv, vd)``
    as they are (v at its own head dim, read in place through its
    strides: MLA's v is a column slice); returns ``(B, Sq, H, vd)``.
    Positions 0..S-1, scale ``qkd ** -0.5``; ``window > 0`` is F's causal
    band.

    With grad mode on and q, k or v requiring a gradient (training), F
    launches through :class:`FlashAttention`, which carries the gradient;
    otherwise (serving) through its wrapper.  On CPU tensors the wrapper
    runs F's plain version.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_chunk, k_chunk,
                                    window)
    out = fa_kernel.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window)
    return out.transpose(1, 2)


def attend_full(p, x, cfg, positions, *, mask_mode=None):
    """Self-attention (prefill path) for GQA-family configs."""
    q, k, v = _project_qkv(p, x, cfg,
                           rope_tables(positions, cfg.hd(), cfg.rope_theta))
    mode = mask_mode or ("local" if cfg.attention == "local" else "causal")
    out = flash_attention(
        q, k, v,
        q_positions=positions, k_positions=positions,
        mask_mode=mode, window=cfg.window,
        q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk,
    )
    return _out_proj(out, p["wo"])


def _cross_qkv(p, x, memory):
    """Cross attention's q from x and k, v from the encoder's memory (no
    rotary embedding)."""
    return _proj(x, p["wq"]), _proj(memory, p["wk"]), _proj(memory, p["wv"])


def attend_cross(p, x, memory, cfg):
    """Cross-attention: queries from x (B, Sq, d), keys and values from
    the encoder's memory (B, Sk, d); unmasked."""
    q, k, v = _cross_qkv(p, x, memory)
    out = flash_attention(
        q, k, v, q_positions=torch.arange(x.shape[1], dtype=torch.int32),
        k_positions=torch.arange(memory.shape[1], dtype=torch.int32),
        mask_mode="none", q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    return _out_proj(out, p["wo"])


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------

class MLAParts(NamedTuple):
    """What :func:`_mla_qkv` projects: per-head q halves and the shared
    compressed kv latent and rotated key (the MLA cache's contents)."""
    q_nope: torch.Tensor    # (B, S, H, nope)
    q_rope: torch.Tensor    # (B, S, H, rope), rotated
    c_kv: torch.Tensor      # (B, S, kv_lora), normed
    k_rope: torch.Tensor    # (B, S, 1, rope), rotated, shared by every head


def _mla_qkv(p, x, cfg, rope: RopeTables) -> MLAParts:
    """MLA's projections; ``rope`` holds the tables at x's positions over
    the rope dims (:func:`rope_dim`)."""
    m = cfg.mla
    cq = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = _proj(cq, p["wq_b"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = rotate(q[..., m.qk_nope_head_dim:], rope)
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = rmsnorm(kv[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = rotate(kv[..., m.kv_lora_rank:][:, :, None, :], rope)
    return MLAParts(q_nope, q_rope, c_kv, k_rope)


def mla_scale(cfg) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _attend_mla_parts(p, parts: MLAParts, cfg, positions, attention=None):
    """Full-rank MLA attention from :func:`_mla_qkv`'s parts: k = [k_nope,
    k_rope on every head], v from ``wkv_b``, scale (nope + rope) ** -0.5,
    then the output projection.  ``positions`` as
    :func:`flash_attention`'s; ``attention`` replaces it (same
    signature)."""
    m = cfg.mla
    kvb = _proj(parts.c_kv, p["wkv_b"])
    k_nope = kvb[..., : m.qk_nope_head_dim]
    v = kvb[..., m.qk_nope_head_dim:]
    H = cfg.n_heads
    k = torch.cat([k_nope, parts.k_rope.expand(
        *parts.k_rope.shape[:2], H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([parts.q_nope, parts.q_rope], dim=-1)
    out = (attention or flash_attention)(
        q, k, v, q_positions=positions, k_positions=positions,
        mask_mode="causal", q_chunk=cfg.attn_q_chunk,
        k_chunk=cfg.attn_k_chunk, scale=mla_scale(cfg))
    return _out_proj(out, p["wo"])


def attend_mla(p, x, cfg, positions):
    """Train/prefill MLA with full-rank expansion."""
    rope = rope_tables(positions.to(x.device), rope_dim(cfg), cfg.rope_theta)
    return _attend_mla_parts(p, _mla_qkv(p, x, cfg, rope), cfg, positions)


# ---------------------------------------------------------------------------
# decode: partial-softmax attention over the cache
# ---------------------------------------------------------------------------

class Partial(NamedTuple):
    o: torch.Tensor  # (B, H, vd) fp32, exp-weighted un-normalized
    m: torch.Tensor  # (B, H) fp32 local max
    l: torch.Tensor  # (B, H) fp32 local sum


def combine_partials(parts: Partial, axis_name: str | None = None):
    """Merge partial softmax stats, across mesh axis ``axis_name`` of the
    current mesh when one is named (each rank's stats its own part of the
    keys): MAX of m over the axis, each part rescaled by exp(m - max),
    then SUM of o and l; then normalise.  The reference's order."""
    o, l_ = parts.o, parts.l
    if axis_name is not None:
        import torch.distributed as dist

        mesh = sharding.current_mesh()
        if mesh is None:
            raise RuntimeError(f"combining across mesh axis {axis_name!r} "
                               "needs a current mesh (dist.sharding."
                               "use_mesh)")
        group = mesh.get_group(axis_name)
        m_all = parts.m.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
        alpha = torch.exp(torch.where(parts.m <= NEG_INF / 2, NEG_INF,
                                      parts.m - m_all))
        o, l_ = parts.o * alpha[..., None], parts.l * alpha
        dist.all_reduce(o, group=group)
        dist.all_reduce(l_, group=group)
    return o / torch.clamp(l_, min=1e-30)[..., None]


def decode_attention_gqa(q, k_cache, v_cache, k_positions, *, window: int = 0,
                         q_position=None, scale=None) -> Partial:
    """q: (B, H, hd); caches: (B, S, Hkv, hd); k_positions: (S,) with -1
    for empty slots.  Returns partial stats (f32).  On DTensors each rank
    takes its own batch rows and heads, as :func:`flash_attention` does,
    under ``local_map``."""
    if sharding.is_dtensor(q):
        return _decode_on_mesh(q, k_cache, v_cache, k_positions,
                               dict(window=window, q_position=q_position,
                                    scale=scale))
    B, H, hd = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    valid = k_positions >= 0
    if window and q_position is not None:
        valid = valid & (q_position - k_positions < window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    p_ = torch.exp(s - shift[..., None])
    p_ = torch.where(valid, p_, 0.0)
    o = torch.einsum("bhgs,bshd->bhgd", p_, v_cache.float())
    l_ = p_.sum(dim=-1)
    return Partial(o=o.reshape(B, H, -1), m=m.reshape(B, H),
                   l=l_.reshape(B, H))


def _decode_on_mesh(q, k_cache, v_cache, k_positions, kw: dict) -> Partial:
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl, kv_pl, _, kv_slice = _head_layout(
        mesh, q.shape[0], q.shape[1], k_cache.shape[2], q_dim=1)
    pos = (k_positions.full_tensor() if sharding.is_dtensor(k_positions)
           else k_positions)

    def local(ql, kl, vl):
        if kv_slice is not None:
            first, n = kv_slice
            kl, vl = kl[:, :, first:first + n], vl[:, :, first:first + n]
        return tuple(decode_attention_gqa(ql, kl, vl, pos, **kw))

    o, m, l_ = local_map(local, out_placements=(q_pl, q_pl, q_pl),
                         in_placements=(q_pl, kv_pl, kv_pl),
                         device_mesh=mesh, redistribute_inputs=True)(
        q, k_cache, v_cache)
    return Partial(o, m, l_)


def decode_attention_mla(q_nope, q_rope, ckv_cache, krope_cache, k_positions,
                         wkv_b, *, nope_dim: int, scale) -> Partial:
    """Absorbed MLA decode on the compressed cache, in f32.

    q_nope: (B, H, nope); q_rope: (B, H, rope); ckv_cache: (B, S,
    kv_lora); krope_cache: (B, S, rope); wkv_b: (kv_lora, H, nope + vd)
    as stored.  W_UK is folded into q, the scores are taken against the
    latent cache, and W_UV is applied to the context: the cache stays
    kv_lora + rope wide.  Returns partial stats.
    """
    wk = wkv_b[..., :nope_dim].float()             # (r, H, nope)
    wv = wkv_b[..., nope_dim:].float()             # (r, H, vd)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), wk)
    s = (torch.einsum("bhr,bsr->bhs", q_abs, ckv_cache.float())
         + torch.einsum("bhp,bsp->bhs", q_rope.float(), krope_cache.float())
         ) * scale
    valid = k_positions >= 0
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    p_ = torch.exp(s - shift[..., None])
    p_ = torch.where(valid, p_, 0.0)
    ctx = torch.einsum("bhs,bsr->bhr", p_, ckv_cache.float())
    o = torch.einsum("bhr,rhv->bhv", ctx, wv)
    return Partial(o=o, m=m, l=p_.sum(dim=-1))
