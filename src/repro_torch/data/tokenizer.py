"""Byte-level tokenizer with arch-sized vocab mapping (copy of
``repro.data.tokenizer``).

The framework trains on CIAO-filtered JSON records.  We tokenize at the byte
level (deterministic, no external vocab files) and fold the 256 byte ids +
specials into whatever vocab size the target architecture declares: byte ids
occupy [0, 256), specials follow, and the remaining id space is reached via a
seeded, fixed *byte-pair folding* (pairs of frequent bytes get dedicated ids)
so embedding tables of the assigned sizes are genuinely exercised.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from types import MappingProxyType

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
N_SPECIALS = 3


@functools.lru_cache(maxsize=8)
def _pair_ids(vocab_size: int, pair_seed: int) -> MappingProxyType:
    """Byte pair (a * 256 + b) -> its id, first pair of the table wins:
    built once per (vocab size, seed), not per record.  At 151,936 ids the
    table holds 65,536 pairs, and building it for every record made
    tokenizing a recipe batch cost seconds of Python."""
    pairs = ByteTokenizer(vocab_size, pair_seed)._pair_table()
    table: dict[int, int] = {}
    for i, (a, b) in enumerate(pairs):
        table.setdefault(int(a) * 256 + int(b), 256 + N_SPECIALS + i)
    return MappingProxyType(table)


@dataclass(frozen=True)
class ByteTokenizer:
    vocab_size: int
    pair_seed: int = 0

    def __post_init__(self) -> None:
        if self.vocab_size < 256 + N_SPECIALS:
            raise ValueError("vocab_size must be >= 259")

    def _pair_table(self) -> np.ndarray:
        """(n_pairs, 2) byte pairs that map to ids >= 259 (seeded, fixed)."""
        n_pairs = min(self.vocab_size - 256 - N_SPECIALS, 65536)
        rng = np.random.default_rng(self.pair_seed)
        pairs = rng.integers(32, 127, size=(n_pairs, 2), dtype=np.int32)
        return pairs

    def encode(self, data: bytes, *, max_len: int | None = None,
               add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
        ids = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
        if self.vocab_size > 256 + N_SPECIALS and len(ids) >= 2:
            table = _pair_ids(self.vocab_size, self.pair_seed)
            # greedy non-overlapping fold of known pairs (vectorized probe)
            key = ids[:-1].astype(np.int64) * 256 + ids[1:]
            out = []
            i = 0
            while i < len(ids):
                if i + 1 < len(ids) and int(key[i]) in table:
                    out.append(table[int(key[i])])
                    i += 2
                else:
                    out.append(int(ids[i]))
                    i += 1
            ids = np.array(out, dtype=np.int32)
        if add_bos:
            ids = np.concatenate([[BOS_ID], ids])
        if add_eos:
            ids = np.concatenate([ids, [EOS_ID]])
        if max_len is not None:
            ids = ids[:max_len]
        return ids.astype(np.int32)

    def pad_batch(self, seqs: list[np.ndarray], seq_len: int) -> np.ndarray:
        out = np.full((len(seqs), seq_len), PAD_ID, dtype=np.int32)
        for i, s in enumerate(seqs):
            n = min(len(s), seq_len)
            out[i, :n] = s[:n]
        return out
