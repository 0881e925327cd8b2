"""Client-side predicate evaluation engines (paper §IV).

Clients ship records in fixed-size *chunks*.  We encode a chunk as a dense
``uint8[R, L]`` matrix (records zero-padded to a common stride) — this is the
TPU-native representation every engine shares:

  * :class:`PythonEngine` — the paper-faithful ``bytes.find`` oracle
    (string::find semantics, record at a time).  Slow; ground truth.
  * :class:`NumpyEngine` — vectorized sliding-window matching on the dense
    chunk; the production host-side (ingest server / CPU client) path.
  * the kernel engine — lives in ``repro_torch.kernels`` (``"cuda"``: the
    hand-written CUDA kernel; ``"torch"``: its plain PyTorch version);
    constructed via :func:`get_engine`.

All engines MUST agree exactly: same bits, same false positives.  The
property tests sweep random records × clauses across engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from . import bitvector
from .predicates import Clause, Kind, SimplePredicate


# ---------------------------------------------------------------------------
# chunk encoding
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Chunk:
    """A dense batch of raw JSON records plus true lengths."""

    data: np.ndarray      # uint8[R, L]
    lengths: np.ndarray   # int32[R]

    @property
    def n_records(self) -> int:
        return int(self.data.shape[0])

    @property
    def stride(self) -> int:
        return int(self.data.shape[1])

    def record(self, i: int) -> bytes:
        return self.data[i, : self.lengths[i]].tobytes()

    def records(self) -> list[bytes]:
        return [self.record(i) for i in range(self.n_records)]

    def nbytes(self) -> int:
        return int(self.lengths.sum())


def encode_chunk(records: Sequence[bytes], *, stride: int | None = None,
                 align: int = 128) -> Chunk:
    """Pad records into a dense uint8 matrix.

    ``stride`` defaults to max record length rounded up to ``align`` (lane
    width) — records are never truncated (truncation could cause false
    negatives, which are forbidden).
    """
    if not records:
        return Chunk(np.zeros((0, align), np.uint8), np.zeros((0,), np.int32))
    max_len = max(len(r) for r in records)
    if stride is None:
        stride = ((max_len + align - 1) // align) * align
    if stride < max_len:
        raise ValueError(f"stride {stride} < max record length {max_len}")
    data = np.zeros((len(records), stride), dtype=np.uint8)
    lengths = np.zeros((len(records),), dtype=np.int32)
    for i, r in enumerate(records):
        arr = np.frombuffer(r, dtype=np.uint8)
        data[i, : len(arr)] = arr
        lengths[i] = len(arr)
    return Chunk(data=data, lengths=lengths)


def encode_patterns(patterns: Sequence[bytes], *, max_len: int = 64
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Pad patterns to ``uint8[P, max_len]`` + lengths (kernel input)."""
    m = max((len(p) for p in patterns), default=1)
    if m > max_len:
        max_len = m
    out = np.zeros((len(patterns), max_len), dtype=np.uint8)
    lens = np.zeros((len(patterns),), dtype=np.int32)
    for i, p in enumerate(patterns):
        out[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    return out, lens


# ---------------------------------------------------------------------------
# vectorized matching primitives (numpy; ref.py mirrors these in torch)
# ---------------------------------------------------------------------------

def window_hits(data: np.ndarray, pattern: bytes, *,
                counts: np.ndarray | None = None) -> np.ndarray:
    """bool[R, L-m+1]: window j matches pattern exactly.

    An empty pattern matches at every position (``b"" in x`` semantics) —
    the engine-equivalence contract: PythonEngine and the kernels treat a
    zero-length pattern as match-all.

    Candidate-filtered: instead of ``m`` full (R, L) comparison passes,
    ONE pass on the chunk's rarest pattern byte (``counts``: the chunk's
    byte histogram, computed here when not supplied) yields a sparse
    candidate set, and the remaining pattern bytes verify by gathers over
    the shrinking survivors — ordered rarest-first so dead candidates die
    early.  JSON chunks made the old dense path memory-bound: every
    pattern starts with ``"`` (~10% of chunk bytes), but almost every
    pattern also contains a byte with frequency well under 1%.
    """
    m = len(pattern)
    R, L = data.shape
    if m == 0:
        return np.ones((R, L + 1), dtype=bool)
    W = L - m + 1
    if m > L:
        return np.zeros((R, max(W, 0)), dtype=bool)
    pat = np.frombuffer(pattern, dtype=np.uint8)
    out = np.zeros((R, W), dtype=bool)
    if R == 0:
        return out
    if counts is None:
        counts = np.bincount(data.ravel(), minlength=256)
    order = np.argsort(counts[pat], kind="stable")
    a = int(order[0])
    rs, ps = np.nonzero(data[:, a: a + W] == pat[a])
    for i in order[1:]:
        if not rs.size:
            return out
        keep = data[rs, ps + int(i)] == pat[int(i)]
        rs, ps = rs[keep], ps[keep]
    out[rs, ps] = True
    return out


def any_match(data: np.ndarray, pattern: bytes, *,
              counts: np.ndarray | None = None) -> np.ndarray:
    """bool[R]: pattern occurs anywhere in the record."""
    hits = window_hits(data, pattern, counts=counts)
    return hits.any(axis=1) if hits.size else np.zeros(data.shape[0], bool)


def key_value_match(data: np.ndarray, key_pat: bytes, val_pat: bytes, *,
                    counts: np.ndarray | None = None) -> np.ndarray:
    """bool[R]: paper's key-value semantics on the dense chunk.

    Valid iff there is an occurrence of ``key_pat`` ending at position p such
    that ``val_pat`` occurs entirely within [p, next_delimiter(p)), where the
    delimiters are ',' and '}'.  If the value pattern itself contains a
    delimiter we degrade to an unbounded search after the key (false-positive
    safe; see predicates.SimplePredicate.matches_raw).

    The delimiter-confinement machinery (cumsum + segmented max) is the
    expensive part; it runs only over *active* rows — rows with at least
    one key hit AND one value hit — which selective predicates make a
    small minority of the chunk.
    """
    R, L = data.shape
    mk, mv = len(key_pat), len(val_pat)
    key_hit = window_hits(data, key_pat, counts=counts)   # (R, L-mk+1)
    if not key_hit.any():
        return np.zeros(R, dtype=bool)
    val_hit = window_hits(data, val_pat, counts=counts)   # (R, L-mv+1)
    if not val_hit.any():
        return np.zeros(R, dtype=bool)

    out = np.zeros(R, dtype=bool)
    active = key_hit.any(axis=1) & val_hit.any(axis=1)
    if not active.any():
        return out
    act = np.nonzero(active)[0]
    data = data[act]
    key_hit = key_hit[act]
    val_hit = val_hit[act]
    Ra = len(act)

    unbounded = (b"," in val_pat) or (b"}" in val_pat)
    # any_val_from[r, p] = exists v >= p with (clean) val hit at v, p in [0, L]
    if unbounded:
        ok = val_hit
    else:
        delim = (data == ord(",")) | (data == ord("}"))    # (Ra, L)
        # exclusive prefix count of delimiters: C[r, p] = # delims in [0, p)
        C = np.zeros((Ra, L + 1), dtype=np.int32)
        np.cumsum(delim, axis=1, out=C[:, 1:])
        # clean val hit: no delimiter inside [v, v+mv)
        ok = val_hit & ((C[:, mv : mv + val_hit.shape[1]] - C[:, : val_hit.shape[1]]) == 0)
        if not ok.any():
            return out

    # suffix "exists a usable value at v >= p (same segment unless unbounded)"
    pos = np.where(ok, np.arange(ok.shape[1])[None, :], -1)
    if unbounded:
        # reverse running max of hit positions
        last_from = np.flip(np.maximum.accumulate(np.flip(pos, axis=1), axis=1), axis=1)
        any_from = np.full((Ra, L + 1), False)
        any_from[:, : pos.shape[1]] = last_from >= np.arange(pos.shape[1])[None, :]
        # positions beyond the last window start cannot begin a match
    else:
        # segmented: max usable-value position per (record, segment)
        seg_of_pos = C[:, :L]                                  # segment id of p
        nseg = L + 1
        flat = seg_of_pos[:, : pos.shape[1]] + nseg * np.arange(Ra)[:, None]
        seg_max = np.full(Ra * nseg, -1, dtype=np.int64)
        np.maximum.at(seg_max, flat.ravel(), pos.ravel())
        seg_max = seg_max.reshape(Ra, nseg)
        any_from = np.full((Ra, L + 1), False)
        p_idx = np.arange(L)
        any_from[:, :L] = np.take_along_axis(seg_max, seg_of_pos, axis=1) >= p_idx[None, :]

    # key hit at window j -> value region starts at p = j + mk
    jmax = key_hit.shape[1]
    region = any_from[:, mk : mk + jmax]
    out[act] = (key_hit & region).any(axis=1)
    return out


def eval_simple(data: np.ndarray, pred: SimplePredicate, *,
                counts: np.ndarray | None = None) -> np.ndarray:
    pats = pred.patterns()
    if pred.kind is Kind.KEY_VALUE:
        if len(pats[1]) == 0:
            # empty value pattern degrades to key presence — mirrors
            # kernels.plan.compile_plan and matches_raw (find(b"") != -1)
            return any_match(data, pats[0], counts=counts)
        return key_value_match(data, pats[0], pats[1], counts=counts)
    return any_match(data, pats[0], counts=counts)


def eval_clause(data: np.ndarray, cl: Clause) -> np.ndarray:
    out = np.zeros(data.shape[0], dtype=bool)
    for t in cl.terms:
        out |= eval_simple(data, t)
    return out


def dedup_terms(clauses: Sequence[Clause]
                ) -> tuple[list[SimplePredicate], np.ndarray]:
    """Unique predicates across a clause list + clause-membership matrix.

    Two terms that compile to the same pattern strings (and kind) evaluate
    identically, so they share one slot.  Returns ``(terms, membership)``
    with ``membership bool[C, P]``: clause c contains predicate p.  Every
    engine combines per-clause hits as ``membership @ hits > 0`` — the OR
    over disjuncts — so a disjunct shared by several clauses is evaluated
    once per chunk, not once per clause.
    """
    uniq: dict[tuple, int] = {}
    terms: list[SimplePredicate] = []
    for cl in clauses:
        for t in cl.terms:
            key = (t.kind is Kind.KEY_VALUE, t.patterns())
            if key not in uniq:
                uniq[key] = len(terms)
                terms.append(t)
    membership = np.zeros((len(clauses), len(terms)), dtype=bool)
    for ci, cl in enumerate(clauses):
        for t in cl.terms:
            membership[ci, uniq[(t.kind is Kind.KEY_VALUE, t.patterns())]] = True
    return terms, membership


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

class _HostEngine:
    """Shared packed/fused derivations for the host-side engines."""

    def eval(self, chunk: Chunk, clauses: Sequence[Clause]) -> np.ndarray:
        raise NotImplementedError

    def eval_packed(self, chunk: Chunk, clauses: Sequence[Clause]) -> np.ndarray:
        return bitvector.pack(self.eval(chunk, clauses))

    def eval_fused(self, chunk: Chunk,
                   clauses: Sequence[Clause]) -> bitvector.ChunkBitvectors:
        """Same contract as the fused kernel pass (bitvectors+mask+counts)."""
        return bitvector.ChunkBitvectors.from_bits(self.eval(chunk, clauses))

    def eval_fused_prefix(self, chunk: Chunk, clauses: Sequence[Clause],
                          n_clauses: int) -> bitvector.ChunkBitvectors:
        """Tiered evaluation: the first ``n_clauses`` of ``clauses``.

        Host engines have no jit traces to share, so the view is a plain
        slice — work genuinely scales with the tier.  The kernel engines
        override this with a shape-preserving subset view
        (``KernelEngine.eval_fused_prefix``); both produce bit-identical
        results to ``eval_fused(chunk, clauses[:n_clauses])`` and reject
        the same out-of-range prefixes.
        """
        clauses = list(clauses)
        if not 0 <= n_clauses <= len(clauses):
            raise ValueError(
                f"prefix {n_clauses} out of range 0..{len(clauses)}")
        return self.eval_fused(chunk, clauses[:n_clauses])


class PythonEngine(_HostEngine):
    """Paper-faithful string::find oracle (slow; ground truth)."""

    name = "python"

    def eval(self, chunk: Chunk, clauses: Sequence[Clause]) -> np.ndarray:
        recs = chunk.records()
        out = np.zeros((len(clauses), chunk.n_records), dtype=bool)
        for pi, cl in enumerate(clauses):
            for ri, rec in enumerate(recs):
                out[pi, ri] = cl.matches_raw(rec)
        return out


class NumpyEngine(_HostEngine):
    """Vectorized sliding-window engine on the dense chunk.

    Mirrors the fused kernel's dedup: a disjunct shared by several clauses
    is evaluated once per chunk, then clauses OR their members' hit rows.
    """

    name = "numpy"

    def eval(self, chunk: Chunk, clauses: Sequence[Clause]) -> np.ndarray:
        terms, membership = dedup_terms(clauses)
        R = chunk.n_records
        if not terms or R == 0:
            return np.zeros((len(clauses), R), dtype=bool)
        # one byte histogram per chunk: window_hits anchors every pattern
        # on its rarest byte, amortized across all the plan's terms
        counts = np.bincount(chunk.data.ravel(), minlength=256)
        hits = np.zeros((len(terms), R), dtype=bool)
        for ti, t in enumerate(terms):
            hits[ti] = eval_simple(chunk.data, t, counts=counts)
        return membership @ hits  # bool matmul == OR over member predicates


def get_engine(name: str):
    """Engine factory; kernel-backed engines are imported lazily."""
    if name == "python":
        return PythonEngine()
    if name == "numpy":
        return NumpyEngine()
    if name in ("cuda", "torch"):
        from repro_torch.kernels.engine import KernelEngine

        return KernelEngine(backend=name)
    raise ValueError(f"unknown engine {name!r}")
