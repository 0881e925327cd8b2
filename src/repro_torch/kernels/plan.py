"""Plan compilation: clause list -> device-ready predicate tables.

Three levels of dedup (DESIGN.md §3.3), each mirroring how real plans
repeat themselves:

  * term-level   — a disjunct shared by several clauses gets ONE predicate
    slot (``core.client.dedup_terms``);
  * key-level    — key-value predicates over the same field share one
    window-equality pass (``"age" = 7`` and ``"age" = 11`` search the same
    ``'"age"'`` pattern), and simple patterns live in the SAME unique-key
    table, so ``age != NULL`` reuses it too;
  * value-level  — the value-side confinement scan depends only on
    ``(value pattern, unbounded)``, so repeated values across fields share
    one scan.

``CompiledPlan`` carries the unique tables + index vectors (read by the
plain version), the flat per-predicate arrays, and the CUDA kernel's
packed table built from them (:func:`kernel_table`).  Predicates
are ordered simple-first so the simple/key-value boundary is a static
split point.  Key and value patterns get SEPARATE padded widths — values
are typically much shorter than quoted keys, so the value window loops
stay tight.

The QUERY-side mirror of the same idea is :func:`compile_query_batch`
(DESIGN.md §16): it dedups a multi-query batch query -> clause -> term,
keyed on the predicates' own type-strict equality (not pattern bytes —
see the function docstring), and both multi-query execution planes
consume it: the host :class:`~repro_torch.core.batch_scan.ScanBatcher` and the
device batch compiler (``kernels.scan_fused.compile_scan_batch``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.client import dedup_terms, encode_patterns
from repro_torch.core.predicates import (
    Clause, Kind, Query, SimplePredicate, lowerable,
)

_PAT_ALIGN = 8  # pattern width bucket (stabilizes jit specializations)


def _bucket(n: int) -> int:
    return max(((n + _PAT_ALIGN - 1) // _PAT_ALIGN) * _PAT_ALIGN, _PAT_ALIGN)


@dataclass(frozen=True)
class CompiledPlan:
    """Device-ready encoding of a clause list (see kernels.fused/ref)."""

    # flat per-predicate arrays (kernel_table's source), simple-first
    keys: np.ndarray        # uint8[P, Mk]
    klens: np.ndarray       # int32[P]
    vals: np.ndarray        # uint8[P, Mv]
    vlens: np.ndarray       # int32[P]
    kinds: np.ndarray       # int32[P]   0 = simple, 1 = key-value
    unbounded: np.ndarray   # int32[P]
    membership: np.ndarray  # uint8[C, P]
    # unique tables + index vectors (the plain version's)
    ukeys: np.ndarray       # uint8[Uk, Mk]
    uklens: np.ndarray      # int32[Uk]
    uvals: np.ndarray       # uint8[Uv, Mv]
    uvlens: np.ndarray      # int32[Uv]
    uunb: np.ndarray        # int32[Uv]  unbounded flag per unique value
    key_ids: np.ndarray     # int32[P]   predicate -> unique key row
    val_ids: np.ndarray     # int32[P]   predicate -> unique value row (kv)

    @property
    def n_preds(self) -> int:
        return self.keys.shape[0]

    @property
    def n_simple(self) -> int:
        return int(np.sum(self.kinds == 0))

    @property
    def n_clauses(self) -> int:
        return self.membership.shape[0]

    @functools.cached_property
    def kernel_table(self) -> np.ndarray:
        """The pushdown kernel's table (:func:`kernel_table`), built once."""
        return kernel_table(self)


#: word offsets into :func:`kernel_table`'s header
TABLE_N_SIMPLE, TABLE_N_GROUPS, TABLE_PRED, TABLE_GROUP, TABLE_CSR, \
    TABLE_PAT = range(6)
TABLE_HEADER_WORDS = 8


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def kernel_table(plan: CompiledPlan) -> np.ndarray:
    """The plan as the CUDA pushdown kernel reads it: ``uint32`` words,
    staged whole into shared memory (``csrc/pushdown.cu``).

    * header: ``n_simple, n_groups`` and the word offsets of the four
      sections below (each a multiple of 4, so rows are 16-byte aligned);
    * predicate rows ``(pattern word, compare length, clause list begin,
      end)``: the simple predicates first, their pattern the key (length
      0 matches every row), then the key-value predicates grouped by key,
      their pattern the value;
    * group rows ``(key word, compare length, key shift, unbounded, first
      predicate, end predicate, 0, 0)``: one per (key, unbounded);
    * clause lists (CSR over the membership matrix): clause ids;
    * patterns, 4 bytes to a little-endian word, zero-padded.

    Lengths follow the plain version (``ref.clause_bitvectors_ref``): a
    window compares ``max(1, min(len, width))`` bytes of its padded row and
    a key ends ``klen`` bytes after its start.  Predicates that no clause
    reads (a tier view's neutralised rows) are left out.
    """
    for name in ("klens", "vlens"):
        if np.any(getattr(plan, name) < 0):
            raise ValueError(f"negative pattern length in {name}")
    mem = plan.membership.astype(bool)
    live = mem.any(axis=0)
    Mk, Mv = plan.keys.shape[1], plan.vals.shape[1]
    pats: list[np.ndarray] = []
    n_pat = 0

    def pattern(row: np.ndarray) -> int:
        nonlocal n_pat
        buf = np.zeros(_round4(len(row)), np.uint8)
        buf[:len(row)] = row
        pats.append(buf.view("<u4"))
        n_pat += len(pats[-1])
        return n_pat - len(pats[-1])

    preds: list[tuple[int, int, int, int]] = []
    csr: list[int] = []

    def predicate(row: np.ndarray, m: int, p: int) -> None:
        ids = np.flatnonzero(mem[:, p])
        preds.append((pattern(row[:m]), m, len(csr), len(csr) + len(ids)))
        csr.extend(ids.tolist())

    for p in np.flatnonzero(live & (plan.kinds == 0)):
        predicate(plan.keys[p], min(int(plan.klens[p]), Mk), p)
    n_simple = len(preds)
    by_key: dict[tuple[bytes, int, int], list[int]] = {}
    for p in np.flatnonzero(live & (plan.kinds != 0)):
        klen = int(plan.klens[p])
        key = plan.keys[p, :max(1, min(klen, Mk))].tobytes()
        by_key.setdefault((key, klen, int(plan.unbounded[p] != 0)),
                          []).append(p)
    groups = []
    for (key, klen, unb), members in by_key.items():
        at = pattern(np.frombuffer(key, np.uint8))
        first = len(preds)
        for p in members:
            predicate(plan.vals[p], max(1, min(int(plan.vlens[p]), Mv)), p)
        groups.append((at, len(key), klen, unb, first, len(preds), 0, 0))

    off_pred = TABLE_HEADER_WORDS
    off_group = off_pred + 4 * len(preds)
    off_csr = off_group + 8 * len(groups)
    off_pat = off_csr + _round4(len(csr))
    table = np.zeros(max(_round4(off_pat + n_pat), 4), np.uint32)
    table[:6] = (n_simple, len(groups), off_pred, off_group, off_csr,
                 off_pat)
    table[off_pred:off_group] = np.asarray(preds, np.uint32).reshape(-1)
    table[off_group:off_csr] = np.asarray(groups, np.uint32).reshape(-1)
    table[off_csr:off_csr + len(csr)] = csr
    if pats:
        table[off_pat:off_pat + n_pat] = np.concatenate(pats)
    return table


#: fill byte for neutralized (out-of-tier) predicate patterns.  Records are
#: JSON text and padding is NUL, so 0xFF never occurs in a chunk: the
#: kernel's first-char prefilter retires a neutralized predicate after one
#: vectorized compare over the tile, and the xla oracle's window passes
#: find nothing.  A neutralized pattern keeps FULL width (klen = Mk) so it
#: can never hit the empty-pattern match-all path.
NEUTRAL_BYTE = 0xFF


def tier_view(full: CompiledPlan, n_clauses: int) -> CompiledPlan:
    """Static clause-subset view: the first ``n_clauses`` clauses.

    Tiers of a :class:`~repro_torch.core.server.PlanFamily` are nested prefixes
    of the top tier's clause order, and this view keeps EVERY array shape
    (P, C, Mk, Mv, the unique tables) and the simple/key-value split
    identical to the full compilation — so all tiers of a family share
    ONE jit trace per chunk shape bucket instead of one per tier
    (DESIGN.md §12).  Out-of-tier clauses get zero membership rows (their
    bitvector/count rows emit as zeros and drop out of the load-mask OR);
    predicates and unique key/value table rows no longer referenced by
    any in-tier clause are neutralized to unmatchable ``0xFF`` patterns,
    so the per-predicate grid steps they still occupy exit at the
    first-char prefilter — tier compute scales with the subset while the
    compiled artifact is shared.
    """
    C = full.n_clauses
    if not 0 <= n_clauses <= C:
        raise ValueError(f"tier size {n_clauses} out of range 0..{C}")
    if n_clauses == C:
        return full
    membership = full.membership.copy()
    membership[n_clauses:] = 0
    used = membership.any(axis=0)                      # bool[P]
    keys, klens = full.keys.copy(), full.klens.copy()
    vals, vlens = full.vals.copy(), full.vlens.copy()
    dead = ~used
    keys[dead] = NEUTRAL_BYTE
    klens[dead] = keys.shape[1]
    vals[dead] = NEUTRAL_BYTE
    vlens[dead] = np.where(full.kinds[dead] > 0, vals.shape[1], 0)
    # unique tables (xla-oracle path): neutralize rows unreferenced by any
    # live predicate — a unique key shared with an in-tier predicate stays
    live_k = np.zeros((len(full.ukeys),), bool)
    live_k[full.key_ids[used]] = True
    ukeys, uklens = full.ukeys.copy(), full.uklens.copy()
    ukeys[~live_k] = NEUTRAL_BYTE
    uklens[~live_k] = ukeys.shape[1]
    live_v = np.zeros((len(full.uvals),), bool)
    kv_live = used & (full.kinds > 0)
    live_v[full.val_ids[kv_live]] = True
    uvals, uvlens = full.uvals.copy(), full.uvlens.copy()
    uvals[~live_v] = NEUTRAL_BYTE
    uvlens[~live_v] = uvals.shape[1]
    return CompiledPlan(
        keys=keys, klens=klens, vals=vals, vlens=vlens,
        kinds=full.kinds, unbounded=full.unbounded, membership=membership,
        ukeys=ukeys, uklens=uklens, uvals=uvals, uvlens=uvlens,
        uunb=full.uunb, key_ids=full.key_ids, val_ids=full.val_ids,
    )


def compile_plan(clauses: Sequence[Clause]) -> CompiledPlan:
    terms, membership = dedup_terms(clauses)
    rows = []
    for ti, t in enumerate(terms):
        pats = t.patterns()
        if t.kind is Kind.KEY_VALUE and len(pats[1]) > 0:
            k, v = pats
            rows.append((ti, k, v, 1, int(b"," in v or b"}" in v)))
        else:
            # key-value with an empty value pattern degrades to key presence
            rows.append((ti, pats[0], b"", 0, 0))
    rows.sort(key=lambda r: r[3])  # stable: simple block, then key-value
    P = len(rows)

    uk: dict[bytes, int] = {}
    uv: dict[tuple[bytes, int], int] = {}
    key_ids = np.zeros((P,), np.int32)
    val_ids = np.zeros((P,), np.int32)
    kinds = np.zeros((P,), np.int32)
    unb = np.zeros((P,), np.int32)
    perm = np.zeros((P,), np.int64)
    for i, (ti, k, v, kind, u) in enumerate(rows):
        key_ids[i] = uk.setdefault(k, len(uk))
        if kind:
            val_ids[i] = uv.setdefault((v, u), len(uv))
        kinds[i], unb[i], perm[i] = kind, u, ti

    Mk = _bucket(max((len(k) for k in uk), default=1))
    Mv = _bucket(max((len(v) for v, _ in uv), default=1))
    ukeys, uklens = encode_patterns(list(uk), max_len=Mk)
    uvals, uvlens = encode_patterns([v for v, _ in uv], max_len=Mv)
    uunb = np.array([u for _, u in uv], np.int32).reshape(-1)
    return CompiledPlan(
        keys=ukeys[key_ids], klens=uklens[key_ids],
        vals=uvals[val_ids] if len(uv) else np.zeros((P, Mv), np.uint8),
        vlens=np.where(kinds > 0, uvlens[val_ids] if len(uv) else 0, 0
                       ).astype(np.int32),
        kinds=kinds, unbounded=unb,
        membership=membership[:, perm].astype(np.uint8),
        ukeys=ukeys, uklens=uklens, uvals=uvals, uvlens=uvlens, uunb=uunb,
        key_ids=key_ids, val_ids=val_ids,
    )


# ---------------------------------------------------------------------------
# multi-query batch compilation (DESIGN.md §16)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QueryBatch:
    """Three-level dedup of a query batch: query -> clause -> term.

    The shared front half of both multi-query planes — the host
    :class:`~repro_torch.core.batch_scan.ScanBatcher` evaluates each unique
    clause once per segment and recombines per query through
    ``query_clause``; the device compiler
    (``kernels.scan_fused.compile_scan_batch``) extends the same tables
    into its per-scan parameter form.  First-occurrence order everywhere:
    ``clauses[j]`` is the j-th distinct clause encountered walking the
    batch in query order, so indexes are deterministic for a given batch.
    """

    queries: tuple[Query, ...]
    clauses: tuple[Clause, ...]          # unique clauses across the batch
    terms: tuple[SimplePredicate, ...]   # unique terms across those clauses
    membership: np.ndarray               # uint8[C, T] clause -> term
    query_clause: np.ndarray             # uint8[Q, C] query -> clause
    clause_ids: tuple[tuple[int, ...], ...]   # per query: its clause rows
    lowerable: tuple[bool, ...]          # per query: every term lowerable

    @property
    def n_queries(self) -> int:
        return len(self.queries)

    @property
    def n_clauses(self) -> int:
        return len(self.clauses)

    @property
    def n_terms(self) -> int:
        return len(self.terms)


def compile_query_batch(queries: Sequence[Query]) -> QueryBatch:
    """Dedup clauses and terms across a query batch.

    Mirrors the ingest path's :func:`compile_plan`/``dedup_terms`` shape —
    one slot per unique disjunct, a clause-membership matrix, and here
    additionally a query->clause matrix — but keys the dedup on the
    predicates' own TYPE-STRICT equality (``SimplePredicate.__eq__``
    includes ``type(value)``).  ``dedup_terms`` keys on pattern BYTES,
    which is sound for the raw-matching client engines (identical
    patterns match identical byte positions) but not for columnar
    evaluation: EXACT compiles a value-only pattern, so ``EXACT(a, "x")``
    and ``EXACT(b, "x")`` alias at the byte level while reading different
    columns.
    """
    queries = tuple(queries)
    cl_index: dict[Clause, int] = {}
    clauses: list[Clause] = []
    clause_ids: list[tuple[int, ...]] = []
    for q in queries:
        rows = []
        for c in q.clauses:
            ci = cl_index.get(c)
            if ci is None:
                ci = cl_index[c] = len(clauses)
                clauses.append(c)
            rows.append(ci)
        clause_ids.append(tuple(rows))
    t_index: dict[SimplePredicate, int] = {}
    terms: list[SimplePredicate] = []
    for c in clauses:
        for t in c.terms:
            if t not in t_index:
                t_index[t] = len(terms)
                terms.append(t)
    membership = np.zeros((len(clauses), len(terms)), np.uint8)
    for ci, c in enumerate(clauses):
        for t in c.terms:
            membership[ci, t_index[t]] = 1
    query_clause = np.zeros((len(queries), len(clauses)), np.uint8)
    for qi, rows in enumerate(clause_ids):
        for ci in rows:
            query_clause[qi, ci] = 1
    low = tuple(
        all(lowerable(t) for c in q.clauses for t in c.terms)
        for q in queries
    )
    return QueryBatch(
        queries=queries, clauses=tuple(clauses), terms=tuple(terms),
        membership=membership, query_clause=query_clause,
        clause_ids=tuple(clause_ids), lowerable=low,
    )
