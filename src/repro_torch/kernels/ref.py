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
    route (an oracle for the card; the CPU path keeps the former).

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
