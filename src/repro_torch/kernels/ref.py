"""Plain PyTorch versions of the hand-written kernels.

``clause_bitvectors_ref`` is the plain version of the pushdown kernel
(``csrc/pushdown.cu``, wrapped by :mod:`repro_torch.kernels.fused`): the
same function written as whole-tensor torch ops, so it runs on any device.
It serves the CPU tests and the on-card comparison in ``chip_smoke.py``;
the main path never calls it when a card is present.  The plain version of
the scan kernel is :func:`repro_torch.kernels.scan_fused.scan_core`.
"""
from __future__ import annotations

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
    or_w = torch.zeros(words.shape[1], dtype=torch.int32, device=dev)
    for row in words.view(torch.int32):
        or_w |= row
    counts = bits.sum(dim=1, dtype=torch.int32)
    return words, or_w.view(torch.uint32), counts
