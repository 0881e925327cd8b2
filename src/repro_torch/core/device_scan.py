"""Device-resident COUNT(*) scanners (DESIGN.md §15).

:class:`DeviceScanner` is the drop-in device counterpart of
:class:`~repro_torch.core.server.DataSkippingScanner`: same ``scan(q) ->
ScanResult`` contract, bit-identical counts and per-(epoch, tier)
accounting, plus ``scan_batch`` — N queries compiled together
(:func:`~repro_torch.kernels.scan_fused.compile_scan_batch`) and evaluated in
ONE device launch over the resident segment plane.  The division of
labor per scan:

  host   — pushdown resolution (``store.pushed_by_epoch``), raw
           promotion, zone-prune verdicts (memoized
           ``ColumnarSegment.clause_possible``), parameter tables;
  device — pushed-bitvector AND, lowered residual eval, per-(query,
           slot) popcount for every cached segment, all queries fused;
  host   — fold device counts + host-fallback segments (open builder
           tails, evicted/oversized segments, non-lowerable queries —
           scanned by the embedded ``DataSkippingScanner``) into the
           standard accounting.

``backend="cuda"`` (the default) launches the hand-written scan kernel
(``csrc/scan.cu``) over a plane resident on ``device``; ``"torch"`` runs
its plain PyTorch version on ``device`` (the CPU in the tests);
``"numpy"`` scans a host mirror with ``scan_core_numpy``.

:class:`ShardedDeviceScanner` mirrors
:class:`~repro_torch.core.shard.ShardedScanner`'s three-level cascade
(partition prune -> per-shard scan -> deterministic
``merge_scan_results`` through ``dist.collectives.tree_reduce``) with one
:class:`DeviceScanner`, and so one resident plane, per shard.  Every
shard's plane lives on the scanner's one device and the shards launch in
turn.  The JAX package can instead run the surviving shards as one
``shard_map`` program with shard *i* on device *i*; its counterpart here,
shards placed on several cards, is not ported yet.

Public contract, shared with every other scanner: ``ScanResult.groups``
sorted by (epoch, tier), deterministic merge order, accounting
bit-identical to the host ``DataSkippingScanner``.  Since DESIGN.md §16
a :class:`~repro_torch.core.batch_scan.ResultCache` can be attached
(distinct from the segment cache: it stores finished ``ScanResult``
objects keyed on type-strict predicates, validated per ``(epoch,
data_version)``) and every scan is folded into the store's
:class:`~repro_torch.core.telemetry.TelemetryPlane`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.batch_scan import ResultCache
from repro_torch.core.device_cache import CacheSlot, DeviceSegmentCache
from repro_torch.core.predicates import Query
from repro_torch.core.server import CiaoStore, DataSkippingScanner, ScanResult
from repro_torch.core.shard import ShardedCiaoStore, merge_scan_results
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.scan_fused import (
    ScanBatch, ScanParams, compile_scan_batch, scan_core_numpy, scan_counts,
    scan_table,
)

@dataclass
class _Prepared:
    """Host-side launch state for one store's query batch."""

    queries: tuple[Query, ...]
    batch: ScanBatch
    pushed_maps: list
    promoted: list[dict]
    jit_vis: list[int]        # per-query visible jit-segment prefix
    slots: list[CacheSlot]
    pushed_bits: np.ndarray   # uint32[Q, S]
    active: np.ndarray        # uint8[Q, S]
    pruned: np.ndarray        # bool[Q, S] zone map refuted a clause
    params: ScanParams | None  # None when no device launch is needed
    table: np.ndarray | None   # the kernel's scan_table of ``params``


class DeviceScanner:
    """Device-plane scanner over a single :class:`CiaoStore`."""

    def __init__(self, store: CiaoStore, *, backend: str = "cuda",
                 device=None, byte_budget: int = 256 << 20,
                 log_queries: bool = True,
                 result_cache: "ResultCache | None" = None,
                 telemetry: "object | bool | None" = None,
                 tenant: str = "default"):
        self.store = store
        if backend not in ("cuda", "torch", "numpy"):
            raise ValueError(f"unknown device scan backend {backend!r}")
        self.backend = backend
        self.device = resolve_device(
            "torch" if backend == "numpy" else backend, device)
        self.log_queries = log_queries
        self.cache = DeviceSegmentCache(byte_budget=byte_budget,
                                        device=self.device)
        # optional ResultCache — NOT the segment cache above: entries are
        # whole per-query ScanResults under the same (shard 0, clauses)
        # keys and (epoch, data_version) validity the host batcher and
        # ShardedScanner use, so host and device paths share one cache and
        # one accounting contract (DESIGN.md §16)
        self.result_cache = result_cache
        from repro_torch.core.telemetry import TelemetryPlane
        if telemetry is None:
            telemetry = getattr(store, "telemetry", None)
        self.telemetry = telemetry if isinstance(telemetry, TelemetryPlane) \
            else None
        self.tenant = tenant
        self._synced_version = -1
        # backend="numpy" baseline: host mirror of the plane, converted
        # once per plane generation (not per scan)
        self._np_plane = None
        self._np_plane_src = None
        # host fallback for open tails / evicted segments / non-lowerable
        # queries; shares the store, so memoized segment state is shared
        self._host = DataSkippingScanner(store, log_queries=False,
                                         telemetry=False)
        self._lock = threading.Lock()      # one scan_batch at a time

    # -- public API ---------------------------------------------------------

    def scan(self, q: Query) -> ScanResult:
        return self.scan_batch([q])[0]

    def scan_batch(self, queries: Sequence[Query]) -> list[ScanResult]:
        """All queries in one launch; results bit-identical to sequential
        ``DataSkippingScanner.scan`` calls in the same order.

        With a ``result_cache`` attached, each query consults it in batch
        order (a hit skips the query's promotion step — valid entries
        imply a re-scan would promote nothing) and misses are compiled
        into one launch; fresh results are stored at the post-batch
        ``data_version``.

        Calls from several threads run one at a time: the segment cache
        updates its resident tensors and slot tables in place, so an
        admission must not interleave with another call's launch.
        """
        with self._lock:
            return self._scan_batch(queries)

    def _scan_batch(self, queries: Sequence[Query]) -> list[ScanResult]:
        t0 = time.perf_counter()
        store = self.store
        queries = tuple(queries)
        if self.log_queries:
            for q in queries:
                store.log_query(q)
        hits: dict[int, ScanResult] = {}
        miss: list[int] = []
        pushed_maps: list = []
        promoted: list[dict] = []
        jit_vis: list[int] = []
        for qi, q in enumerate(queries):
            if self.result_cache is not None:
                r = self.result_cache.lookup(
                    0, q, epoch=store.plan.epoch,
                    data_version=store.data_version)
                if r is not None:
                    hits[qi] = r
                    continue
            pm = store.pushed_by_epoch(q)
            pushed_maps.append(pm)
            promoted.append(dict(store.promote_uncovered_raw(pm)))
            jit_vis.append(len(store.jit_blocks))
            miss.append(qi)
        by_pos: dict[int, ScanResult] = dict(hits)
        if miss:
            prep = self._prepare(
                [queries[qi] for qi in miss], pushed_maps=pushed_maps,
                promoted=promoted, jit_vis=jit_vis)
            counts, cands = self._launch(prep)
            for qi, r in zip(miss, self._assemble(prep, counts, cands)):
                by_pos[qi] = r
                if self.result_cache is not None:
                    self.result_cache.store(
                        0, queries[qi], r, epoch=store.plan.epoch,
                        data_version=store.data_version)
        results = [by_pos[qi] for qi in range(len(queries))]
        dt = time.perf_counter() - t0
        for qi, r in enumerate(results):
            r.time_s = dt / max(len(results), 1)
            if self.telemetry is not None:
                self.telemetry.record_scan(
                    r, tenant=self.tenant,
                    cache_hits=int(qi in hits),
                    cache_misses=int(self.result_cache is not None
                                     and qi not in hits))
        return results

    # -- pipeline stages ------------------------------------------------------

    def _prepare(self, queries: Sequence[Query], *,
                 pushed_maps: list | None = None,
                 promoted: list[dict] | None = None,
                 jit_vis: list[int] | None = None) -> _Prepared:
        store = self.store
        queries = tuple(queries)
        if pushed_maps is None:
            pushed_maps = [store.pushed_by_epoch(q) for q in queries]
        if promoted is None or jit_vis is None:
            # promote raw remainders FIRST (same rows, same order as the
            # sequential host scans), so the promoted segments are
            # admitted by this very sync.  ``jit_vis`` snapshots the
            # jit-segment list length after each query's promotion: query
            # *i* of the batch must account exactly the jit segments a
            # sequential run would have materialized by its turn, not the
            # whole batch's promotions.
            promoted, jit_vis = [], []
            for pm in pushed_maps:
                promoted.append(dict(store.promote_uncovered_raw(pm)))
                jit_vis.append(len(store.jit_blocks))
        version = getattr(store, "data_version", None)
        if version is None or version != self._synced_version:
            self.cache.sync(store)
            if version is not None:
                self._synced_version = version
        batch = compile_scan_batch(queries)
        slots = list(self.cache.slots)
        Q, S = len(queries), len(slots)
        pushed_bits = np.zeros((Q, S), np.uint32)
        active = np.zeros((Q, S), np.uint8)
        pruned = np.zeros((Q, S), bool)
        for si, slot in enumerate(slots):
            seg = slot.seg
            for qi, q in enumerate(queries):
                if not batch.query_ok[qi]:
                    continue   # whole query falls back to the host path
                pushed = pushed_maps[qi][(seg.epoch, seg.n_covered)]
                if slot.is_jit:
                    if pushed:
                        continue   # skipped whole by the assembly stage
                elif pushed:
                    bits = np.uint32(0)
                    for p in pushed:
                        bits |= np.uint32(1) << np.uint32(p)
                    pushed_bits[qi, si] = bits
                if any(not seg.clause_possible(c) for c in q.clauses):
                    pruned[qi, si] = True
                    continue
                active[qi, si] = 1
        params = table = None
        if S and active.any():
            params = self.cache.build_params(
                batch, pushed_bits=pushed_bits, active=active)
            if self.backend != "numpy":
                table = scan_table(params)
            self.cache.touch(
                [si for si in range(S) if active[:, si].any()])
        return _Prepared(
            queries=queries, batch=batch, pushed_maps=pushed_maps,
            promoted=promoted, jit_vis=jit_vis, slots=slots,
            pushed_bits=pushed_bits, active=active, pruned=pruned,
            params=params, table=table,
        )

    def _launch(self, prep: _Prepared):
        if prep.params is None:
            return None, None
        plane = self.cache.plane
        assert plane is not None
        if self.backend == "numpy":
            if self._np_plane_src is not plane.pres:
                self._np_plane = tuple(a.cpu().numpy() for a in plane)
                self._np_plane_src = plane.pres
            return scan_core_numpy(*self._np_plane, prep.params)
        return scan_counts(plane, prep.params, backend=self.backend,
                           table=prep.table)

    def _assemble(self, prep: _Prepared, counts, cands) -> list[ScanResult]:
        store = self.store
        slot_of = {id(s.seg): i for i, s in enumerate(prep.slots)}
        results: list[ScanResult] = []
        for qi, q in enumerate(prep.queries):
            pm = prep.pushed_maps[qi]
            use_device = prep.batch.query_ok[qi]
            result = ScanResult(count=0, rows_scanned=0, rows_skipped=0,
                                raw_parsed=0, time_s=0.0,
                                used_skipping=False)

            def eat(seg, g, si):
                if prep.pruned[qi, si]:
                    g.rows_skipped += seg.n_rows
                    g.segments_pruned += 1
                    result.segments_pruned += 1
                    return
                cand = int(cands[qi, si])
                g.rows_scanned += cand
                g.rows_skipped += seg.n_rows - cand
                g.count += int(counts[qi, si])
                result.segments_scanned += 1

            for seg in store.blocks:
                g = result.group(seg.epoch, seg.tier)
                si = slot_of.get(id(seg)) if use_device else None
                if si is None:
                    self._host._scan_segment(
                        seg, q, pm[(seg.epoch, seg.n_covered)], g, result)
                else:
                    eat(seg, g, si)
            for key, n in prep.promoted[qi].items():
                result.group(*key).raw_parsed += n
            for seg in store.jit_blocks[:prep.jit_vis[qi]]:
                g = result.group(seg.epoch, seg.tier)
                if pm[(seg.epoch, seg.n_covered)]:
                    g.rows_skipped += seg.n_rows
                    continue
                si = slot_of.get(id(seg)) if use_device else None
                if si is None:
                    self._host._scan_segment(seg, q, (), g, result)
                else:
                    eat(seg, g, si)
            result.sort_groups()
            for g in result.groups.values():
                result.count += g.count
                result.rows_scanned += g.rows_scanned
                result.rows_skipped += g.rows_skipped
                result.raw_parsed += g.raw_parsed
            result.used_skipping = any(pm.values())
            results.append(result)
        return results


# ---------------------------------------------------------------------------
# sharded scatter-gather
# ---------------------------------------------------------------------------

class ShardedDeviceScanner:
    """Scatter-gather device scan over a :class:`ShardedCiaoStore`.

    Bit-identical to :class:`~repro_torch.core.shard.ShardedScanner`:
    empty shards contribute nothing, partition-refuted shards contribute
    their resident segment rows as skipped (and never promote), surviving
    shards scan on their device plane, and the per-shard results reduce
    deterministically through ``merge_scan_results``.  The per-shard
    scanners share ``backend`` and ``device``.
    """

    def __init__(self, store: ShardedCiaoStore, *, backend: str = "cuda",
                 device=None, byte_budget: int = 256 << 20,
                 log_queries: bool = True,
                 telemetry: "object | bool | None" = None,
                 tenant: str = "default"):
        self.store = store
        self.log_queries = log_queries
        from repro_torch.core.telemetry import TelemetryPlane
        if telemetry is None:
            telemetry = getattr(store, "telemetry", None)
        self.telemetry = telemetry if isinstance(telemetry, TelemetryPlane) \
            else None
        self.tenant = tenant
        device = resolve_device(
            "torch" if backend == "numpy" else backend, device)
        self._scanners = [
            DeviceScanner(s, backend=backend, device=device,
                          byte_budget=byte_budget, log_queries=False,
                          telemetry=False)
            for s in store.shards
        ]
        self._lock = threading.Lock()

    @property
    def caches(self) -> list[DeviceSegmentCache]:
        return [sc.cache for sc in self._scanners]

    def scan(self, q: Query) -> ScanResult:
        return self.scan_batch([q])[0]

    def scan_batch(self, queries: Sequence[Query]) -> list[ScanResult]:
        """Scatter-gather of one batch; calls from several threads run one
        at a time, as :meth:`DeviceScanner.scan_batch` does."""
        with self._lock:
            return self._scan_batch(queries)

    def _scan_batch(self, queries: Sequence[Query]) -> list[ScanResult]:
        t0 = time.perf_counter()
        store = self.store
        queries = tuple(queries)
        if self.log_queries:
            for q in queries:
                store.log_query(q)
        # per-shard surviving query subsets (partition prune, level 1)
        sub: list[list[int]] = []
        pruned_shards: list[list[int]] = [[] for _ in queries]
        for s in range(store.n_shards):
            shard = store.shards[s]
            if not (shard.stats.n_records or shard.blocks
                    or shard.jit_blocks or shard.raw):
                sub.append([])
                continue
            qs: list[int] = []
            for qi, q in enumerate(queries):
                if store.n_shards > 1 and \
                        not store.summaries[s].query_possible(q):
                    pruned_shards[qi].append(s)
                else:
                    qs.append(qi)
            sub.append(qs)
        # promotions and pruned-shard row snapshots in GLOBAL query
        # order: sequential scatter-gather scans run query i across every
        # shard before query i+1, so a shard pruned for query i accounts
        # its resident rows BEFORE later queries' promotions enlarge them
        pushed_maps: list[list] = [[] for _ in range(store.n_shards)]
        promoted: list[list[dict]] = [[] for _ in range(store.n_shards)]
        jit_vis: list[list[int]] = [[] for _ in range(store.n_shards)]
        pruned_rows: dict[tuple[int, int], dict] = {}
        for qi, q in enumerate(queries):
            for s in range(store.n_shards):
                shard = store.shards[s]
                if qi in sub[s]:
                    pm = shard.pushed_by_epoch(q)
                    pushed_maps[s].append(pm)
                    promoted[s].append(dict(shard.promote_uncovered_raw(pm)))
                    jit_vis[s].append(len(shard.jit_blocks))
                elif s in pruned_shards[qi]:
                    pruned_rows[(qi, s)] = shard.resident_group_rows()
        prepared: dict[int, _Prepared] = {}
        for s, qs in enumerate(sub):
            if qs:
                prepared[s] = self._scanners[s]._prepare(
                    [queries[qi] for qi in qs],
                    pushed_maps=pushed_maps[s], promoted=promoted[s],
                    jit_vis=jit_vis[s])
        # one launch per surviving shard, in shard order, on one device
        shard_results: dict[int, list[ScanResult]] = {}
        for s, p in prepared.items():
            c, d = self._scanners[s]._launch(p)
            shard_results[s] = self._scanners[s]._assemble(p, c, d)
        out: list[ScanResult] = []
        dt = time.perf_counter() - t0
        for qi, q in enumerate(queries):
            results: list[ScanResult] = []
            for s in sorted(prepared):
                if qi in sub[s]:
                    r = shard_results[s][sub[s].index(qi)]
                    r.shards_scanned = 1
                    results.append(r)
            if results:
                merged = merge_scan_results(results)
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
            if not results:
                merged.used_skipping = any(
                    store.pushed_by_epoch(q).values())
            merged.time_s = dt / max(len(queries), 1)
            if self.telemetry is not None:
                self.telemetry.record_scan(merged, tenant=self.tenant)
            out.append(merged)
        return out
