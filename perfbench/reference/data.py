"""Plain reference of the training data path: which records a recipe
selects, and the tokens a batch of them packs into.

* :func:`matches` evaluates one recipe clause (an OR of terms, each
  ``{"kind", "key", "value"}``) on a parsed JSON record: ``exact`` (equal
  string), ``substring`` (in a string value), ``presence`` (key present and
  not null), ``key_value`` (equal value, booleans only equal booleans).
* :class:`ByteTokens` is the byte tokenizer the trainer feeds (a frozen
  copy): bytes are ids 0-255, BOS 257 and EOS 258 wrap a record, and byte
  pairs drawn from a seeded table fold greedily, left to right, into ids
  from 259 up, the first entry of a pair winning.
* :func:`stream` packs records' tokens end to end, over and over, and cuts
  ``(batch, seq)`` arrays of it, every position weighted one.
"""
from __future__ import annotations

import json

import numpy as np

BOS, EOS, SPECIALS = 257, 258, 3


def _term(obj: dict, t: dict) -> bool:
    kind, key, val = t["kind"], t["key"], t["value"]
    if kind == "presence":
        return obj.get(key) is not None
    if key not in obj:
        return False
    v = obj[key]
    if isinstance(v, bool) != isinstance(val, bool):
        return False
    if kind == "exact":
        return v == val
    if kind == "substring":
        return isinstance(v, str) and val in v
    if kind == "key_value":
        return v == val
    raise ValueError(f"unknown term kind {kind!r}")


def matches(record: bytes, clause: list[dict]) -> bool:
    obj = json.loads(record)
    return any(_term(obj, t) for t in clause)


class ByteTokens:
    def __init__(self, vocab: int, pair_seed: int = 0):
        n = min(vocab - 256 - SPECIALS, 65536)
        pairs = np.random.default_rng(pair_seed).integers(32, 127, size=(n, 2))
        self.table: dict[tuple[int, int], int] = {}
        for i, (a, b) in enumerate(pairs.tolist()):
            self.table.setdefault((a, b), 256 + SPECIALS + i)

    def encode(self, data: bytes) -> list[int]:
        out, i = [BOS], 0
        while i < len(data):
            pair = self.table.get((data[i], data[i + 1])) if i + 1 < len(data) else None
            if pair is None:
                out.append(data[i])
                i += 1
            else:
                out.append(pair)
                i += 2
        out.append(EOS)
        return out


def stream(records: list[bytes], tok: ByteTokens, batch: int, seq: int):
    """Yields (tokens (batch, seq) int32, mask of ones) packed from
    ``records``' tokens, the records repeated in order without end."""
    if not records:
        return
    buf: list[int] = []
    n = batch * seq
    while True:
        for r in records:
            buf.extend(tok.encode(r))
            while len(buf) >= n:
                tokens = np.array(buf[:n], dtype=np.int32).reshape(batch, seq)
                del buf[:n]
                yield tokens, np.ones((batch, seq), np.float32)
