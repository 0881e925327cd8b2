"""Host multi-query execution plane: ScanBatcher + ResultCache (§16).

The host half of multi-query execution (the device half is
``core.device_scan.DeviceScanner.scan_batch``).  A batch of N queries
shares the pushed-down clause work CIAO's premise says workloads repeat
(paper §V: one CELF-selected predicate set amortized over the whole
workload):

  * the batch compiles once through
    :func:`repro_torch.kernels.plan.compile_query_batch` — the three-level
    query -> clause -> term dedup, keyed on type-strict predicate
    equality;
  * every surviving segment is evaluated in ONE pass: zone-prune
    verdicts, pushed-bitvector ANDs, vectorized residual clause masks
    and the non-lowerable per-row fallback are each computed once per
    UNIQUE clause (over the union of the queries' candidate rows — see
    :func:`_resolve_clause` for why that is exact) and recombined per
    query;
  * queries whose predicates defeat batching (unhashable clause values,
    so type-strict dedup cannot index them) fall back to the sequential
    per-query ``columnar.query_mask`` path — at their exact position in
    the batch, so results stay order-faithful.

Results are BIT-IDENTICAL to sequential
:class:`~repro_torch.core.server.DataSkippingScanner` /
:class:`~repro_torch.core.shard.ShardedScanner` scans in the same order —
same counts, same per-(epoch, tier) accounting, same promotion state
evolution (query *i* sees exactly the JIT segments promotions of
queries <= *i* materialized) — pinned by ``tests/test_batch_scan.py``.

On top sits :class:`ResultCache`: entries keyed per shard by the
query's type-strict clause tuple (``SimplePredicate.__eq__`` /
``__hash__`` include ``type(value)``, so ``10``, ``10.0`` and ``True``
never alias), validated by exact ``(epoch, data_version)`` match — any
ingest or JIT promotion bumps ``data_version``, so a stale ``(shard,
epoch)`` entry can never answer.  Cached counts are bit-identical to a
fresh scan; cached ACCOUNTING mirrors the producing scan (e.g. its
``raw_parsed`` reflects the promotions that scan performed — a literal
re-scan would report 0 because there is nothing left to promote).  One
cache instance serves the host batcher, ``ShardedScanner`` and
``DeviceScanner`` alike: all three store per-shard entries under the
same keys and the same validity rule.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.kernels.plan import QueryBatch, compile_query_batch

from .columnar import ColumnarSegment, query_mask
from .predicates import Query
from .server import CiaoStore, ScanResult, TierScan
from .shard import ShardedCiaoStore, merge_scan_results
from .telemetry import TelemetryPlane


def copy_scan_result(r: ScanResult) -> ScanResult:
    """Field-wise deep copy (fresh TierScans) — cache entries must
    survive callers that mutate results (``ShardedScanner`` stamps
    ``shards_scanned`` on per-shard results before merging)."""
    return ScanResult(
        count=r.count, rows_scanned=r.rows_scanned,
        rows_skipped=r.rows_skipped, raw_parsed=r.raw_parsed,
        time_s=r.time_s, used_skipping=r.used_skipping,
        groups={
            k: TierScan(rows_scanned=g.rows_scanned,
                        rows_skipped=g.rows_skipped,
                        raw_parsed=g.raw_parsed, count=g.count,
                        segments_pruned=g.segments_pruned)
            for k, g in r.groups.items()
        },
        segments_pruned=r.segments_pruned,
        segments_scanned=r.segments_scanned,
        shards_scanned=r.shards_scanned,
        shards_pruned=r.shards_pruned,
    )


class ResultCache:
    """Epoch/version-validated per-shard scan-result cache (§16).

    Key: ``(shard_id, query.clauses)`` — the type-strict clause tuple
    (``freq`` is display metadata and never changes a count, so queries
    differing only in freq share one entry).  An entry answers iff its
    stored ``(epoch, data_version)`` exactly match the shard's current
    state: ``data_version`` is bumped by every ingest, JIT promotion and
    restore, so invalidation needs no subscription machinery — stale
    entries simply stop matching.  Entries are LRU-evicted past ``cap``.

    Both :meth:`lookup` and :meth:`store` deep-copy, so cached state is
    never aliased by callers.  Unhashable queries (clause values without
    a type-strict hash) are silently uncacheable: lookups miss, stores
    are dropped.

    Thread-safe (DESIGN.md §17): one cache instance is shared by every
    reader thread of the serve plane, so the LRU dict mutation and the
    hit/miss counters are guarded by a lock.  Snapshot-forked
    ``data_version`` values are negative — already distinct from every
    live-store version, so no extra keying is needed.
    """

    def __init__(self, cap: int = 256):
        self.cap = int(cap)
        self._entries: dict[tuple, tuple[int, int, ScanResult]] = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def _key(shard_id, q: Query):
        try:
            hash(q.clauses)
        except TypeError:
            return None
        return (shard_id, q.clauses)

    def lookup(self, shard_id, q: Query, *, epoch: int,
               data_version: int) -> ScanResult | None:
        """A deep copy of the cached result, or None (miss counted)."""
        key = self._key(shard_id, q)
        with self._lock:
            hit = self._entries.get(key) if key is not None else None
            if hit is not None and hit[0] == epoch \
                    and hit[1] == data_version:
                self._entries[key] = self._entries.pop(key)   # LRU touch
                self.hits += 1
                return copy_scan_result(hit[2])
            self.misses += 1
            return None

    def store(self, shard_id, q: Query, result: ScanResult, *, epoch: int,
              data_version: int) -> None:
        key = self._key(shard_id, q)
        if key is None:
            return
        entry = (int(epoch), int(data_version), copy_scan_result(result))
        with self._lock:
            self._entries.pop(key, None)
            while len(self._entries) >= self.cap:
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = entry

    def invalidate(self, shard_id=None) -> int:
        """Drop entries for one shard (or all); returns how many.
        Correctness never needs this — version validation already fences
        staleness — it only releases memory early."""
        with self._lock:
            if shard_id is None:
                n = len(self._entries)
                self._entries.clear()
                return n
            dead = [k for k in self._entries if k[0] == shard_id]
            for k in dead:
                del self._entries[k]
            return len(dead)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def _resolve_clause(seg: ColumnarSegment, ci: int, batch: "QueryBatch",
                    cands: list[np.ndarray | None]) -> np.ndarray:
    """Exact mask for unique clause ``ci`` over ``seg``, shared by every
    query that contains it.

    ``seg.clause_mask`` gives the vectorized OR over lowerable terms;
    non-lowerable leftovers are resolved with the per-row raw-bytes
    fallback over the UNION of the interested queries' candidate rows
    (each entry of ``cands`` is that query's pushed-AND mask, or None
    for every-row).  Sharing the union is exact per query: a leftover
    bit set at a row outside query *q*'s own candidates cannot change
    ``m_q & cm`` because ``m_q`` is already False there — while every
    row ``q``'s sequential scan would have probed is contained in the
    union, so no bit ``q`` needs is missing.
    """
    cm, leftover = seg.clause_mask(batch.clauses[ci])
    if not leftover:
        return cm
    need = None    # None = all rows (some interested query is unpushed)
    for m in cands:
        if m is None:
            need = None
            break
        need = m if need is None else (need | m)
    # NOTE: when every interested query is pushed, ``need`` is their OR
    need = ~cm if need is None else need & ~cm
    if need.any():
        cm = cm.copy()
        for i in np.nonzero(need)[0]:
            obj = json.loads(seg.record(i))
            if any(t.matches_exact(obj) for t in leftover):
                cm[i] = True
    return cm


class ScanBatcher:
    """N-query COUNT(*) batch over a :class:`CiaoStore` or
    :class:`ShardedCiaoStore`, one pass per segment.

    Execution order per batch (sequential semantics preserved):

      1. global query-order pass — per (query, shard): consult the
         result cache, resolve pushdown, JIT-promote uncovered raw
         groups and snapshot the visible jit-segment prefix, exactly as
         interleaved sequential scans would (partition-refuted shards
         snapshot their resident rows instead and never promote);
      2. per shard, ONE pass over its segments evaluating every
         cache-missed query: zone verdicts / clause masks / leftover
         fallbacks once per unique clause, pushed-bitvector ANDs once
         per distinct pushed tuple (both memoized on the segment, so the
         batcher shares state with the sequential path bit-for-bit);
      3. per query: merge per-shard results in stable shard order
         (sharded stores), fill the cache at the shard's post-batch
         version, record telemetry.

    ``cache`` is an optional :class:`ResultCache`; ``telemetry`` is
    tri-state like :class:`~repro_torch.core.server.DataSkippingScanner`'s
    (None inherits ``store.telemetry``, False disables).
    """

    def __init__(self, store: "CiaoStore | ShardedCiaoStore", *,
                 cache: ResultCache | None = None, log_queries: bool = True,
                 and_reduce: Callable | None = None,
                 telemetry: "TelemetryPlane | bool | None" = None,
                 tenant: str = "default"):
        self.store = store
        self.cache = cache
        self.log_queries = log_queries
        self.and_reduce = and_reduce
        if telemetry is None:
            telemetry = getattr(store, "telemetry", None)
        self.telemetry = telemetry if isinstance(telemetry, TelemetryPlane) \
            else None
        self.tenant = tenant
        # duck-typed, not isinstance: store snapshots (DESIGN.md §17)
        # present the same ``shards`` / ``summaries`` surface without
        # being a ShardedCiaoStore
        self._sharded = hasattr(store, "shards")
        self._shards: list[CiaoStore] = (
            list(store.shards) if self._sharded else [store])

    # -- public API ---------------------------------------------------------
    def scan(self, q: Query) -> ScanResult:
        return self.scan_batch([q])[0]

    def scan_batch(self, queries: Sequence[Query]) -> list[ScanResult]:
        t0 = time.perf_counter()
        store = self.store
        queries = tuple(queries)
        if self.log_queries:
            for q in queries:
                store.log_query(q)
        try:
            batch = compile_query_batch(queries)
        except TypeError:
            batch = None     # unhashable clause values: no shared tables
        Q = len(queries)
        S = len(self._shards)
        n_shards = getattr(store, "n_shards", 1)
        summaries = getattr(store, "summaries", None)

        # -- phase 1: cache / prune / promote in GLOBAL query order --------
        cached: dict[tuple[int, int], ScanResult] = {}
        pruned_shards: list[list[int]] = [[] for _ in range(Q)]
        pruned_rows: dict[tuple[int, int], dict] = {}
        run: dict[tuple[int, int], tuple] = {}   # (qi, s) -> (pm, promoted)
        jit_vis: dict[tuple[int, int], int] = {}
        hits = [0] * Q
        for qi, q in enumerate(queries):
            for s, shard in enumerate(self._shards):
                if self._sharded and not (
                        shard.stats.n_records or shard.blocks
                        or shard.jit_blocks or shard.raw):
                    continue           # empty shard: contributes nothing
                if self._sharded and n_shards > 1 and \
                        not summaries[s].query_possible(q):
                    pruned_shards[qi].append(s)
                    pruned_rows[(qi, s)] = shard.resident_group_rows()
                    continue
                if self.cache is not None:
                    r = self.cache.lookup(
                        s, q, epoch=shard.plan.epoch,
                        data_version=shard.data_version)
                    if r is not None:
                        cached[(qi, s)] = r
                        hits[qi] += 1
                        continue
                pm = shard.pushed_by_epoch(q)
                promoted = dict(shard.promote_uncovered_raw(pm))
                run[(qi, s)] = (pm, promoted)
                jit_vis[(qi, s)] = len(shard.jit_blocks)

        # -- phase 2: one pass per shard over its segments -----------------
        per_shard: dict[tuple[int, int], ScanResult] = {}
        for s, shard in enumerate(self._shards):
            qis = [qi for qi in range(Q) if (qi, s) in run]
            if not qis:
                continue
            results = {qi: ScanResult(count=0, rows_scanned=0,
                                      rows_skipped=0, raw_parsed=0,
                                      time_s=0.0, used_skipping=False)
                       for qi in qis}
            for seg in shard.blocks:
                self._eval_segment(seg, queries, batch, qis, run, results,
                                   s, jit=False)
            for qi in qis:
                for key, n in run[(qi, s)][1].items():
                    results[qi].group(*key).raw_parsed += n
            for si, seg in enumerate(shard.jit_blocks):
                vis = [qi for qi in qis if si < jit_vis[(qi, s)]]
                if vis:
                    self._eval_segment(seg, queries, batch, vis, run,
                                       results, s, jit=True)
            for qi in qis:
                r = results[qi]
                r.sort_groups()
                for g in r.groups.values():
                    r.count += g.count
                    r.rows_scanned += g.rows_scanned
                    r.rows_skipped += g.rows_skipped
                    r.raw_parsed += g.raw_parsed
                r.used_skipping = any(run[(qi, s)][0].values())
                per_shard[(qi, s)] = r
                if self.cache is not None:
                    self.cache.store(s, queries[qi], r,
                                     epoch=shard.plan.epoch,
                                     data_version=shard.data_version)

        # -- phase 3: merge per query in stable shard order ----------------
        out: list[ScanResult] = []
        dt = time.perf_counter() - t0
        for qi, q in enumerate(queries):
            parts = []
            for s in range(S):
                r = per_shard.get((qi, s)) or cached.get((qi, s))
                if r is not None:
                    parts.append(r)
            if not self._sharded:
                merged = parts[0] if parts else ScanResult(
                    count=0, rows_scanned=0, rows_skipped=0, raw_parsed=0,
                    time_s=0.0, used_skipping=False)
            else:
                for r in parts:
                    r.shards_scanned = 1
                if parts:
                    merged = merge_scan_results(parts)
                else:
                    merged = ScanResult(count=0, rows_scanned=0,
                                        rows_skipped=0, raw_parsed=0,
                                        time_s=0.0, used_skipping=False)
                for s in pruned_shards[qi]:
                    merged.shards_pruned += 1
                    for (e, t), n in pruned_rows[(qi, s)].items():
                        merged.group(e, t).rows_skipped += n
                        merged.rows_skipped += n
                if pruned_shards[qi]:
                    merged.sort_groups()
                if not parts:
                    merged.used_skipping = any(
                        store.pushed_by_epoch(q).values())
            merged.time_s = dt / max(Q, 1)
            if self.telemetry is not None:
                self.telemetry.record_scan(
                    merged, tenant=self.tenant, cache_hits=hits[qi],
                    cache_misses=sum(1 for s in range(S) if (qi, s) in run))
            out.append(merged)
        return out

    # -- the single-pass segment core ---------------------------------------
    def _eval_segment(self, seg: ColumnarSegment, queries: tuple,
                      batch: "QueryBatch | None", qis: list[int],
                      run: dict, results: dict, s: int, *,
                      jit: bool) -> None:
        """Evaluate one segment for every active query, sharing per-clause
        work; accounting is field-identical to
        ``DataSkippingScanner._scan_segment`` (and its jit-block loop)."""
        alive: list[tuple[int, tuple[int, ...] | None]] = []
        for qi in qis:
            pm = run[(qi, s)][0]
            pushed = pm[(seg.epoch, seg.n_covered)]
            g = results[qi].group(seg.epoch, seg.tier)
            if jit and pushed:
                # covered JIT rows matched none of the pushed clauses at
                # ingest: skip whole (sequential jit-block branch)
                g.rows_skipped += seg.n_rows
                continue
            alive.append((qi, () if jit else tuple(pushed)))
        if not alive:
            return
        if batch is None:
            for qi, pushed in alive:
                self._eval_fallback(seg, queries[qi], pushed, results[qi])
            return
        # zone verdicts once per unique clause (memoized on the segment)
        pruned_q = []
        survivors = []
        for qi, pushed in alive:
            if any(not seg.clause_possible(batch.clauses[ci])
                   for ci in batch.clause_ids[qi]):
                pruned_q.append(qi)
            else:
                survivors.append((qi, pushed))
        for qi in pruned_q:
            r = results[qi]
            g = r.group(seg.epoch, seg.tier)
            g.rows_skipped += seg.n_rows
            g.segments_pruned += 1
            r.segments_pruned += 1
        if not survivors:
            return
        # pushed-AND candidates once per distinct pushed tuple (the
        # segment memoizes, so repeats across queries are free)
        cand = {
            qi: (seg.pushed_mask(pushed, self.and_reduce) if pushed
                 else None)
            for qi, pushed in survivors
        }
        # residual clause masks + leftover fallback once per unique clause:
        # leftover-FREE clauses resolve first (pure vectorized reads), so
        # clauses needing the per-row parse fallback see each query's
        # candidates narrowed by everything already resolved — the parse
        # set is the union of those narrowed candidates, never wider than
        # the sum of rows the sequential scans would have parsed
        need_ci: dict[int, list[int]] = {}
        for qi, _ in survivors:
            for ci in batch.clause_ids[qi]:
                need_ci.setdefault(ci, []).append(qi)
        resolved: dict[int, np.ndarray] = {}
        deferred: list[int] = []
        for ci in need_ci:
            cm, leftover = seg.clause_mask(batch.clauses[ci])
            if leftover:
                deferred.append(ci)
            else:
                resolved[ci] = cm
        for ci in deferred:
            cands = []
            for qi in need_ci[ci]:
                m = cand[qi]
                for cj in batch.clause_ids[qi]:
                    if cj in resolved:
                        m = resolved[cj] if m is None else m & resolved[cj]
                cands.append(m)
            resolved[ci] = _resolve_clause(seg, ci, batch, cands)
        for qi, pushed in survivors:
            m = cand[qi]
            for ci in batch.clause_ids[qi]:
                cm = resolved[ci]
                m = cm if m is None else m & cm
                if not m.any():
                    break
            count = int(m.sum()) if m is not None else seg.n_rows
            r = results[qi]
            g = r.group(seg.epoch, seg.tier)
            n_cand = int(cand[qi].sum()) if pushed else seg.n_rows
            g.rows_scanned += n_cand
            g.rows_skipped += seg.n_rows - n_cand
            g.count += count
            r.segments_scanned += 1

    def _eval_fallback(self, seg: ColumnarSegment, q: Query,
                       pushed: tuple, result: ScanResult) -> None:
        """Per-query path for batches the dedup cannot index (unhashable
        clause values) — literally the sequential segment scan."""
        g = result.group(seg.epoch, seg.tier)
        mask = query_mask(seg, q, pushed, self.and_reduce)
        if mask is None:
            g.rows_skipped += seg.n_rows
            g.segments_pruned += 1
            result.segments_pruned += 1
            return
        if pushed:
            n_cand = int(seg.pushed_mask(pushed, self.and_reduce).sum())
        else:
            n_cand = seg.n_rows
        g.rows_scanned += n_cand
        g.rows_skipped += seg.n_rows - n_cand
        g.count += int(mask.sum())
        result.segments_scanned += 1
