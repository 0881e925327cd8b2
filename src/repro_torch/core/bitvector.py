"""Packed bit-vectors (paper §III/§VI).

Each pushed-down clause gets one bit per record: 1 = the record pattern-matched
the clause (possibly a false positive), 0 = definitely does not satisfy it.
Bit-vectors travel with every JSON chunk, are stored as per-block metadata in
the columnar store, and are ANDed at query time for data skipping.

Layout: little-endian bits in ``uint32`` words — record ``r`` lives at word
``r // 32`` bit ``r % 32``.  All helpers exist in a numpy flavor (host-side
ingest path) and a torch flavor (device-side skipping / kernels).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

WORD_BITS = 32


def num_words(n_records: int) -> int:
    return (n_records + WORD_BITS - 1) // WORD_BITS


# ---------------------------------------------------------------------------
# numpy flavor
# ---------------------------------------------------------------------------

def pack(bits: np.ndarray) -> np.ndarray:
    """Pack a bool/0-1 array (..., R) into uint32 words (..., ceil(R/32))."""
    bits = np.asarray(bits)
    r = bits.shape[-1]
    w = num_words(r)
    pad = w * WORD_BITS - r
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype)], axis=-1
        )
    bits = bits.reshape(bits.shape[:-1] + (w, WORD_BITS)).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (bits << shifts).sum(axis=-1, dtype=np.uint32)


def unpack(words: np.ndarray, n_records: int) -> np.ndarray:
    """Inverse of :func:`pack` -> bool array (..., n_records)."""
    words = np.asarray(words, dtype=np.uint32)
    if words.size == 0:  # zero-clause / zero-record: reshape(-1) can't infer
        return np.zeros(words.shape[:-1] + (n_records,), dtype=bool)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)
    bits = bits.reshape(words.shape[:-1] + (-1,))
    return bits[..., :n_records].astype(bool)


def bv_and(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.bitwise_and(a, b)


def bv_or(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.bitwise_or(a, b)


def bv_and_many(words: np.ndarray) -> np.ndarray:
    """AND-reduce over the leading axis: (P, W) -> (W,)."""
    return np.bitwise_and.reduce(np.asarray(words, dtype=np.uint32), axis=0)


def bv_or_many(words: np.ndarray) -> np.ndarray:
    return np.bitwise_or.reduce(np.asarray(words, dtype=np.uint32), axis=0)


def _popcount_rows_unpack(words: np.ndarray) -> np.ndarray:
    """np.bitwise_count-free per-row popcount (numpy < 2.0)."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    if w.size == 0:
        return np.zeros((w.shape[0],), np.int64)
    bytes_ = w.view(np.uint8).reshape(w.shape[0], -1)
    return np.unpackbits(bytes_, axis=1).sum(axis=1, dtype=np.int64)


if hasattr(np, "bitwise_count"):
    def popcount_rows(words: np.ndarray) -> np.ndarray:
        """int64[P]: per-row popcount of uint32[P, W]."""
        w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
        if w.size == 0:
            return np.zeros((w.shape[0],), np.int64)
        return np.bitwise_count(w).sum(axis=1, dtype=np.int64)
else:  # pragma: no cover — exercised via the _popcount_unpack regression test
    popcount_rows = _popcount_rows_unpack


def popcount(words: np.ndarray) -> int:
    return int(popcount_rows(np.asarray(words, np.uint32).reshape(1, -1)).sum())


def _popcount_unpack(words: np.ndarray) -> int:
    """Fallback-path popcount, exposed for the numpy<2 regression test."""
    return int(_popcount_rows_unpack(
        np.asarray(words, np.uint32).reshape(1, -1)).sum())


def select_indices(words: np.ndarray, n_records: int) -> np.ndarray:
    """Indices of set bits, in record order (data-skipping gather list)."""
    return np.nonzero(unpack(words, n_records))[0]


@dataclass(frozen=True)
class ChunkBitvectors:
    """Everything one chunk evaluation produces, in packed form.

    The fused kernel path (``kernels.fused``) emits all three fields from a
    single device pass; the host engines derive them from their bool hits.
    ``or_words`` is the ingest load mask (OR over clauses) — the server
    uses it directly instead of re-reducing on the host — and ``counts``
    the per-clause popcounts, which ingest accumulates into the store's
    observed per-clause selectivities (planner feedback; DESIGN.md §8).
    """

    words: np.ndarray      # uint32[C, W] — per-clause packed bitvectors
    or_words: np.ndarray   # uint32[W]    — OR over clauses (load mask)
    counts: np.ndarray     # int32[C]     — per-clause popcounts
    n_records: int

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "ChunkBitvectors":
        """Host-side construction from bool hits (C, R)."""
        bits = np.asarray(bits, dtype=bool)
        c, r = bits.shape
        words = pack(bits)
        or_words = (bv_or_many(words) if c
                    else np.zeros((num_words(r),), np.uint32))
        counts = bits.sum(axis=1, dtype=np.int32)
        return cls(words=words, or_words=or_words, counts=counts, n_records=r)


# ---------------------------------------------------------------------------
# torch flavor (used by kernels' plain versions / on-device skipping)
#
# torch has no uint32 shifts on the CPU and no popcount op, so the words are
# built and taken apart in int64 (bit 31 fits without a sign) and
# reinterpreted; the layout is bit-identical to the numpy flavor.
# ---------------------------------------------------------------------------

def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def torch_pack(bits: torch.Tensor) -> torch.Tensor:
    """bool/0-1 tensor (..., R) -> uint32 words (..., ceil(R/32))."""
    r = bits.shape[-1]
    w = num_words(r)
    pad = w * WORD_BITS - r
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (w, WORD_BITS))
    return _to_u32((b << _shifts(bits.device)).sum(dim=-1))


def _to_u32(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32, bit for bit."""
    lo = words64 & 0xFFFFFFFF
    return (lo - ((lo >> 31) << 32)).to(torch.int32).view(torch.uint32)


def _to_i64(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> int64 in [0, 2^32), bit for bit."""
    return words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def torch_unpack(words: torch.Tensor, n_records: int) -> torch.Tensor:
    """Inverse of :func:`torch_pack` -> bool tensor (..., n_records)."""
    w = _to_i64(words.contiguous())
    bits = (w[..., None] >> _shifts(words.device)) & 1
    bits = bits.reshape(words.shape[:-1] + (-1,))
    return bits[..., :n_records].to(torch.bool)


def torch_popcount(words: torch.Tensor) -> int:
    return int(torch_unpack(words.reshape(-1), words.numel() * WORD_BITS)
               .sum())


def torch_and_many(words: torch.Tensor) -> torch.Tensor:
    """AND-reduce over the leading axis: (P, W) -> (W,)."""
    out = torch.full(words.shape[1:], -1, dtype=torch.int32,
                     device=words.device)
    for row in words.view(torch.int32):
        out &= row
    return out.view(torch.uint32)


def torch_or_many(words: torch.Tensor) -> torch.Tensor:
    """OR-reduce over the leading axis: (P, W) -> (W,)."""
    out = torch.zeros(words.shape[1:], dtype=torch.int32,
                      device=words.device)
    for row in words.view(torch.int32):
        out |= row
    return out.view(torch.uint32)
