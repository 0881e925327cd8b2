"""Plain PyTorch versions of the hand-written kernels.

Each is the same function as its kernel, written as whole-tensor torch
ops, so it runs on any device.  They serve the CPU tests and the on-card
comparison in ``chip_smoke.py``; no path calls them on a card.

  * ``clause_bitvectors_ref`` — pushdown (``csrc/pushdown.cu``,
    wrapper :mod:`repro_torch.kernels.fused`);
  * ``multi_match_any_ref`` / ``key_value_match_ref`` — the split path's
    matchers (``csrc/substring_match.cu`` and ``csrc/key_value.cu``,
    wrapper :mod:`repro_torch.kernels.substring_match`);
  * ``bitvector_reduce_ref`` — AND/OR/popcount over packed rows
    (``csrc/bitvector_reduce.cu``, wrapper
    :mod:`repro_torch.kernels.bitvector_ops`);
  * ``flash_attention_ref`` — causal, banded or unmasked GQA attention
    (``csrc/flash_attention.cu``, wrapper
    :mod:`repro_torch.kernels.flash_attention`), and
    ``flash_attention_ref_bf16p``, the numerics of that kernel's bf16
    route (an oracle for the card; the CPU path keeps the former);
    ``flash_attention_lse_ref``, the row log-sum-exp its training
    instance stores, and ``flash_attention_bwd_ref_bf16p``, the numerics
    of its backward kernel.

The plain version of the scan kernel is
:func:`repro_torch.kernels.scan_fused.scan_core`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitvector

DELIM_COMMA = 44
DELIM_BRACE = 125


def _shift_left(x: torch.Tensor, i: int) -> torch.Tensor:
    """x[..., j + i] with zero fill on the right (static i)."""
    if i == 0:
        return x
    return torch.cat([x[..., i:], torch.zeros_like(x[..., :i])], dim=-1)


def _masked_window_eq(data: torch.Tensor, pats: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """bool[U, R, L]: the window at j equals ``pats[u, :lens[u]]``.

    Positions past the stride read as zero, and no pattern byte is zero,
    so a window that runs past ``L`` never matches.
    """
    acc = data[None] == pats[:, 0, None, None]
    for i in range(1, pats.shape[1]):
        eq = _shift_left(data, i)[None] == pats[:, i, None, None]
        acc &= eq | (lens <= i)[:, None, None]
    return acc


def clause_bitvectors_ref(data, ukeys, uklens, uvals, uvlens, uunb,
                          key_ids, val_ids, membership, n_valid: int,
                          *, n_simple: int):
    """Plain version of the fused pushdown pass.

    ``data uint8[R, L]`` and the unique pattern tables of
    :class:`~repro_torch.kernels.plan.CompiledPlan` (tensors on one
    device).  Returns packed per-clause words ``uint32[C, ceil(R/32)]``,
    the OR'd load-mask words ``uint32[W]`` and per-clause popcounts
    ``int32[C]``, with rows ``>= n_valid`` zero.

    A key-value predicate hits when a key window ends at ``p`` and the
    nearest usable value hit at or after ``p`` has no delimiter (``,``
    or ``}``) between ``p`` and itself; a value pattern holding a
    delimiter is searched unbounded (no delimiters at all).
    """
    dev = data.device
    R, L = data.shape
    P = key_ids.shape[0]
    ukey_hit = _masked_window_eq(data, ukeys, uklens)       # (Uk, R, L)
    any_key = ukey_hit.any(dim=2)                           # (Uk, R)

    parts = []
    if n_simple:
        ks = key_ids[:n_simple].long()
        parts.append(any_key[ks] | (uklens[ks] == 0)[:, None])
    if n_simple < P:
        delim_raw = (data == DELIM_COMMA) | (data == DELIM_BRACE)
        val_hit = _masked_window_eq(data, uvals, uvlens)    # (Uv, R, L)
        delim = delim_raw[None] & (uunb == 0)[:, None, None]
        pos = torch.arange(L, device=dev, dtype=torch.int32)
        big = torch.iinfo(torch.int32).max
        usable = torch.where(val_hit & ~delim, pos, big)
        nv = torch.flip(torch.cummin(torch.flip(usable, [-1]), -1).values,
                        [-1])
        # excl[p] = number of delimiters in [0, p): none inside [p, nv[p])
        d32 = delim.to(torch.int32)
        excl = torch.cumsum(d32, -1, dtype=torch.int32) - d32
        found = nv < big
        e_at_nv = torch.gather(excl, -1, torch.where(found, nv, 0).long())
        ucond = found & (e_at_nv == excl)                   # (Uv, R, L)

        kid = key_ids[n_simple:].long()
        vid = val_ids[n_simple:].long()
        mk = uklens[kid].long()                             # (Pkv,)
        at = pos.long()[None, :] + mk[:, None]              # (Pkv, L)
        fits = at < L
        at = torch.where(fits, at, 0)
        cond = ucond[vid]                                   # (Pkv, R, L)
        region = torch.gather(
            cond, 2, at[:, None, :].expand(-1, R, -1)) & fits[:, None, :]
        parts.append((ukey_hit[kid] & region).any(dim=2))
    hits = torch.cat(parts, dim=0)                          # bool[P, R]
    valid = torch.arange(R, device=dev) < int(n_valid)
    mem = membership.bool()
    bits = torch.stack([hits[mem[c]].any(dim=0)
                        for c in range(mem.shape[0])]) & valid[None, :]
    words = bitvector.torch_pack(bits)
    counts = bits.sum(dim=1, dtype=torch.int32)
    return words, bitvector.torch_or_many(words), counts


def multi_match_any_ref(data: torch.Tensor, patterns: torch.Tensor,
                        plens: torch.Tensor) -> torch.Tensor:
    """uint8[P, R]: pattern p occurs anywhere in record r.

    ``data uint8[R, L]``, ``patterns uint8[P, M]`` (zero-padded),
    ``plens int32[P]``.  The first pattern byte is always compared, so an
    empty pattern matches a record that holds a zero byte (one shorter
    than the stride) and not one that fills it, as the TPU kernel does.
    """
    if data.shape[0] == 0 or patterns.shape[0] == 0:
        return torch.zeros((patterns.shape[0], data.shape[0]),
                           dtype=torch.uint8, device=data.device)
    hit = _masked_window_eq(data, patterns, plens)          # (P, R, L)
    return hit.any(dim=2).to(torch.uint8)


def key_value_match_ref(data: torch.Tensor, key: torch.Tensor,
                        val: torch.Tensor, unbounded: bool) -> torch.Tensor:
    """uint8[R]: a ``key`` window at ``j`` and a ``val`` window at some
    ``v >= j + len(key)`` with no ``,``/``}`` in ``[j + len(key), v]``
    (none checked when ``unbounded``).  ``key``/``val`` are ``uint8[m]``,
    both non-empty; bytes past the stride read as zero.
    """
    if key.numel() == 0 or val.numel() == 0:
        raise ValueError("key and value patterns must be non-empty")
    R, L = data.shape
    dev = data.device
    mk = key.numel()
    lens = torch.tensor([mk, val.numel()], device=dev)
    key_hit = _masked_window_eq(data, key[None], lens[:1])[0]
    val_hit = _masked_window_eq(data, val[None], lens[1:])[0]
    if unbounded:
        delim = torch.zeros_like(val_hit)
    else:
        delim = (data == DELIM_COMMA) | (data == DELIM_BRACE)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(R, L)
    big = torch.iinfo(torch.int32).max

    def suffix_first(mask):                 # nearest set position >= p
        at = torch.where(mask, pos, big)
        return torch.flip(torch.cummin(torch.flip(at, [-1]), -1).values, [-1])

    # the nearest usable value hit lies before the nearest delimiter
    cond = suffix_first(val_hit & ~delim) < suffix_first(delim)
    region = _shift_left(cond, mk)          # cond[j + mk], false past L
    return (key_hit & region).any(dim=1).to(torch.uint8)


def bitvector_reduce_ref(bitvecs: torch.Tensor):
    """(and uint32[W], or uint32[W], popcount of the AND as int32[])
    over the rows of ``bitvecs uint32[P, W]``, ``P >= 1``."""
    if bitvecs.shape[0] == 0:
        raise ValueError("bitvector_reduce needs at least one row")
    and_w = bitvector.torch_and_many(bitvecs)
    count = torch.tensor(bitvector.torch_popcount(and_w), dtype=torch.int32,
                         device=bitvecs.device)
    return and_w, bitvector.torch_or_many(bitvecs), count


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version of kernel F in its ``(B, H, S, d)`` layout.

    The model's chunked attention
    (:func:`repro_torch.models.attention.flash_attention_plain`) over
    positions 0..S-1, through transposes, with mask ``causal``, ``none``
    or, for ``window > 0``, ``local`` (keys ``0 <= q - k < window``).
    """
    from repro_torch.models import attention   # the model imports kernels

    Sq, Sk = q.shape[2], k.shape[2]
    out = attention.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q_positions=torch.arange(Sq, dtype=torch.int32, device=q.device),
        k_positions=torch.arange(Sk, dtype=torch.int32, device=q.device),
        mask_mode=attention.kernel_mask_mode(causal, window), window=window)
    return out.transpose(1, 2)


class FlashTile(NamedTuple):
    """The tiles of one instance of kernel F's bf16 route (the source's
    constants): q rows a block (or work item), keys a K/V tile, and q
    rows a consumer, the rows whose own range of key tiles it computes.
    Every instance decides a tile's mask for a warp's 16 rows."""
    q_rows: int
    key_tile: int
    consumer_rows: int


#: kernel F's instances, (qk head dim, v head dim) -> the bf16 route's
#: tiles: ``flash_kernel_mma`` (kBM, kBN; one block walks one range) at d
#: 16 and 32, ``flash_kernel_wgmma`` (its design's BM = 64 NC, BN,
#: kWgRows) from d 64 on: three consumers at (64, 64) and (128, 128), two
#: at d 192 and 256.  Every instance walks 64-key tiles, so the bf16
#: numerics (:func:`flash_attention_ref_bf16p`) are one function at every
#: width.  The f32 route has the same instances, on 64 x 64 tiles.
FLASH_TILES = {
    (16, 16): FlashTile(64, 64, 64), (32, 32): FlashTile(64, 64, 64),
    (64, 64): FlashTile(192, 64, 64), (128, 128): FlashTile(192, 64, 64),
    (192, 128): FlashTile(128, 64, 64), (192, 192): FlashTile(128, 64, 64),
    (256, 256): FlashTile(128, 64, 64),
}


class FlashBwdTile(NamedTuple):
    """The tiles of kernel F's backward, ``flash_bwd_dkdv_wgmma``: keys
    a work item (one (b, kv head)), q rows a tile of its walk over the
    group's query heads, and keys a consumer, the keys whose own q tiles
    it computes.  ``flash_bwd_dq_wgmma`` walks the keys on the forward's
    plan, with :data:`FLASH_BWD_DQ_TILE`.  Every tile is masked for a
    warp's 16 rows (keys or q rows)."""
    key_rows: int
    q_tile: int
    consumer_keys: int


#: the backward's tiles at (128, 128), the source's kBwdRows and kBwdNC
FLASH_BWD_DKDV_TILE = FlashBwdTile(128, 64, 64)
FLASH_BWD_DQ_TILE = FlashTile(128, 64, 64)


def flash_key_tile(d: int, dv: int) -> int:
    """Keys per K/V tile of kernel F's bf16 instance for ``(d, dv)``."""
    return FLASH_TILES[(d, dv)].key_tile


def flash_attention_ref_bf16p(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """Plain version of kernel F's bf16 route: :func:`flash_attention_ref`
    over the key tiles of the instance for q's and v's head dims
    (:func:`flash_key_tile`), with p rounded to bf16 before each tile's
    P.V, where the tensor-core kernel rounds it (l sums the f32 p).
    """
    from repro_torch.models import attention

    Sq, Sk = q.shape[2], k.shape[2]
    out = attention.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q_positions=torch.arange(Sq, dtype=torch.int32, device=q.device),
        k_positions=torch.arange(Sk, dtype=torch.int32, device=q.device),
        mask_mode=attention.kernel_mask_mode(causal, window), window=window,
        k_chunk=flash_key_tile(q.shape[3], v.shape[3]),
        p_dtype=torch.bfloat16)
    return out.transpose(1, 2)


def _flash_valid(q0: int, n: int, Sk: int, causal: bool, window: int,
                 device) -> torch.Tensor:
    """bool (n, Sk): key k is valid for query q0 + i (F's masks)."""
    qp = torch.arange(q0, q0 + n, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones((n, Sk), dtype=torch.bool, device=device)
    if causal:
        valid &= qp >= kp
    if window:
        valid &= qp - kp < window
    return valid


def flash_attention_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                            key_tile: int = 64) -> torch.Tensor:
    """Plain version of the row log-sum-exp that kernel F's training
    instance stores: f32 ``(B, H, Sq)``, ``m + ln l`` of the scaled scores
    ``q.k d**-0.5`` over each row's valid keys, by the kernel's online
    softmax over ``key_tile``-key tiles (m the running max, l the running
    sum rescaled as the max moves); ``1e30`` for a row that sees no key.
    q ``(B, H, Sq, d)``, k ``(B, Hkv, Sk, d)``, F's layout."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    s_all = q.float() @ kf.transpose(-1, -2) * d ** -0.5   # (B, H, Sq, Sk)
    valid = _flash_valid(0, Sq, Sk, causal, window, q.device)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l_ = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, key_tile):
        s = s_all[..., k0:k0 + key_tile]
        ok = valid[:, k0:k0 + key_tile]
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l_ = l_ * torch.exp(m - m_new) + p.sum(-1)
        m = m_new
    return torch.where(l_ > 0, m + torch.log(l_.clamp(min=1e-30)), 1e30)


def flash_attention_bwd_ref_bf16p(q, k, v, o, do, lse, *, causal: bool = True,
                                  window: int = 0, delta=None,
                                  p_dtype: torch.dtype | None = torch.bfloat16,
                                  q_rows: int = 256):
    """Plain version of kernel F's backward kernel: ``(dq, dk, dv)`` in
    f32, F's ``(B, heads, S, d)`` layout (dk and dv summed over each kv
    head's G query heads).

    From the forward's row log-sum-exp ``lse`` (f32 ``(B, H, Sq)``) and
    ``delta = rowsum(do o)`` in f32 (computed from ``o`` unless given):
    ``P = exp(S scale - lse)``, ``dP = dO V^T``, ``dS = P (dP - delta)``,
    0 where masked; ``dV = P^T dO``, ``dK = scale dS^T Q``, ``dQ = scale dS
    K``, with S, dP and the products summed in f32 and P and dS rounded to
    ``p_dtype`` as the operands of their products, where the kernel rounds
    them (``None``: f32 throughout, the exact gradient of the attention
    given ``lse`` and ``delta``).  The kernel's tiles only order its f32
    sums, so this works on whole rows, ``q_rows`` queries at a time."""
    B, H, Sq, d = q.shape
    Hkv, Sk, dv_ = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = d ** -0.5
    qf, of, gf = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    if delta is None:
        delta = (gf * of).sum(-1)

    def rnd(t):
        return t if p_dtype is None else t.to(p_dtype).float()

    dq = torch.empty((B, H, Sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, H, Sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, H, Sk, dv_), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_rows):
        qs, gs = qf[:, :, q0:q0 + q_rows], gf[:, :, q0:q0 + q_rows]
        valid = _flash_valid(q0, qs.shape[2], Sk, causal, window, q.device)
        s = qs @ kf.transpose(-1, -2)
        p = torch.where(valid, torch.exp(
            s * scale - lse[:, :, q0:q0 + q_rows, None].float()), 0.0)
        dp = gs @ vf.transpose(-1, -2)
        ds = torch.where(valid, p * (
            dp - delta[:, :, q0:q0 + q_rows, None].float()), 0.0)
        dv += rnd(p).transpose(-1, -2) @ gs
        dk += rnd(ds).transpose(-1, -2) @ qs
        dq[:, :, q0:q0 + q_rows] = rnd(ds) @ kf
    return (dq * scale, (dk * scale).view(B, Hkv, G, Sk, d).sum(2),
            dv.view(B, Hkv, G, Sk, dv_).sum(2))
