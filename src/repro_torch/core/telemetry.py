"""Per-tenant scan/ingest telemetry plane (DESIGN.md §16).

Every store front-end owns one :class:`TelemetryPlane`; scanners record
one event per finished query (:meth:`TelemetryPlane.record_scan`) and
client shards report their measured eval wall-clock
(:meth:`TelemetryPlane.record_client_eval`).  The plane is pure
bookkeeping — it never influences scan results — and is snapshot as a
JSON-able dict via ``store.stats_report()``.

What it aggregates, per tenant and per (epoch, tier):

  * result-cache hit rates (the :class:`~repro_torch.core.batch_scan.ResultCache`
    consultations a scanner made on the tenant's behalf);
  * skip fractions at all three levels of the cascade, each in its
    natural unit — shards partition-pruned (level 1), segments
    zone-pruned out of segments visited (level 2), rows bitvector-skipped
    out of rows resident in scanned segments (level 3);
  * scan latency histograms (log-spaced buckets, p50/p90/p99).

The per-client eval measurements feed
:class:`repro_torch.data.pipeline.FleetTierAllocator`: with a plane attached,
re-tiering uses measured µs/record and measured record rates instead of
the modeled ``1/speed`` priors.

All counters are derived from the :class:`~repro_torch.core.server.ScanResult`
accounting contract, so telemetry is exactly as trustworthy as the scan
counts themselves (pinned by ``tests/test_batch_scan.py``).
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .server import ScanResult

# log-spaced latency buckets: 1µs .. ~67s, doubling (27 upper edges)
_EDGES_S = tuple(1e-6 * (1 << i) for i in range(27))


class LatencyHistogram:
    """Fixed log-bucket latency histogram (seconds in, µs out)."""

    __slots__ = ("counts", "total_s", "n")

    def __init__(self) -> None:
        self.counts = [0] * (len(_EDGES_S) + 1)
        self.total_s = 0.0
        self.n = 0

    def record(self, seconds: float) -> None:
        self.counts[bisect_left(_EDGES_S, seconds)] += 1
        self.total_s += seconds
        self.n += 1

    def quantile_us(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` (0 when empty)."""
        if not self.n:
            return 0.0
        need = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need:
                edge = _EDGES_S[min(i, len(_EDGES_S) - 1)]
                return edge * 1e6
        return _EDGES_S[-1] * 1e6

    def to_obj(self) -> dict:
        return {
            "n": self.n,
            "mean_us": round(self.total_s / self.n * 1e6, 3) if self.n else 0.0,
            "p50_us": round(self.quantile_us(0.50), 3),
            "p90_us": round(self.quantile_us(0.90), 3),
            "p99_us": round(self.quantile_us(0.99), 3),
        }


class _TenantStats:
    """One tenant's scan counters (summed :class:`ScanResult` fields),
    plus the serve-plane pressure counters (DESIGN.md §17/§18): ingest
    backpressure blocks/rejections and query-admission outcomes."""

    __slots__ = ("scans", "cache_hits", "cache_misses", "count",
                 "rows_scanned", "rows_skipped", "raw_parsed",
                 "segments_scanned", "segments_pruned",
                 "shards_scanned", "shards_pruned", "latency",
                 "ingest_blocked_s", "ingest_rejected",
                 "admitted", "admission_blocked_s", "admission_rejected")

    def __init__(self) -> None:
        self.scans = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.count = 0
        self.rows_scanned = 0
        self.rows_skipped = 0
        self.raw_parsed = 0
        self.segments_scanned = 0
        self.segments_pruned = 0
        self.shards_scanned = 0
        self.shards_pruned = 0
        self.latency = LatencyHistogram()
        self.ingest_blocked_s = 0.0
        self.ingest_rejected = 0
        self.admitted = 0
        self.admission_blocked_s = 0.0
        self.admission_rejected = 0

    def fold(self, r: "ScanResult", *, cache_hits: int, cache_misses: int,
             wall_s: float) -> None:
        self.scans += 1
        self.cache_hits += int(cache_hits)
        self.cache_misses += int(cache_misses)
        self.count += r.count
        self.rows_scanned += r.rows_scanned
        self.rows_skipped += r.rows_skipped
        self.raw_parsed += r.raw_parsed
        self.segments_scanned += r.segments_scanned
        self.segments_pruned += r.segments_pruned
        self.shards_scanned += r.shards_scanned
        self.shards_pruned += r.shards_pruned
        self.latency.record(wall_s)

    def to_obj(self) -> dict:
        lookups = self.cache_hits + self.cache_misses
        shard_visits = self.shards_scanned + self.shards_pruned
        seg_visits = self.segments_scanned + self.segments_pruned
        rows = self.rows_scanned + self.rows_skipped
        return {
            "scans": self.scans,
            "count": self.count,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate":
                round(self.cache_hits / lookups, 4) if lookups else 0.0,
            "rows_scanned": self.rows_scanned,
            "rows_skipped": self.rows_skipped,
            "raw_parsed": self.raw_parsed,
            "segments_scanned": self.segments_scanned,
            "segments_pruned": self.segments_pruned,
            "shards_scanned": self.shards_scanned,
            "shards_pruned": self.shards_pruned,
            # the three-level cascade, each level in its natural unit
            "partition_skip_fraction":
                round(self.shards_pruned / shard_visits, 4)
                if shard_visits else 0.0,
            "zone_skip_fraction":
                round(self.segments_pruned / seg_visits, 4)
                if seg_visits else 0.0,
            "row_skip_fraction":
                round(self.rows_skipped / rows, 4) if rows else 0.0,
            "latency": self.latency.to_obj(),
            "backpressure": {
                "ingest_blocked_s": round(self.ingest_blocked_s, 6),
                "ingest_rejected": self.ingest_rejected,
                "admitted": self.admitted,
                "admission_blocked_s": round(self.admission_blocked_s, 6),
                "admission_rejected": self.admission_rejected,
            },
        }


class _ClientEval:
    """Measured eval wall-clock for one ingest client."""

    __slots__ = ("n_records", "eval_s", "reports")

    def __init__(self) -> None:
        self.n_records = 0
        self.eval_s = 0.0
        self.reports = 0

    def to_obj(self) -> dict:
        return {
            "reports": self.reports,
            "n_records": self.n_records,
            "eval_s": round(self.eval_s, 6),
            "us_per_record":
                round(self.eval_s / self.n_records * 1e6, 4)
                if self.n_records else 0.0,
            "records_per_s":
                round(self.n_records / self.eval_s, 1)
                if self.eval_s > 0 else 0.0,
        }


class TelemetryPlane:
    """Store-resident per-tenant / per-tier scan + ingest statistics.

    Thread-safe for concurrent ``record_*`` calls (scanners may share a
    plane across a thread pool).  Recording never raises into the scan
    path and never changes scan results.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantStats] = {}
        # (epoch, tier) -> summed group accounting over every recorded scan
        self._tiers: dict[tuple[int, int], dict[str, int]] = {}
        self._clients: dict[object, _ClientEval] = {}
        # physical-design tuner counters (DESIGN.md §18)
        self._tuner: dict[str, float] = {
            "migrations": 0, "rows_moved": 0, "rows_kept": 0,
            "segments_moved": 0, "layout_retunes": 0, "router_swaps": 0,
        }

    # -- recording -----------------------------------------------------------
    def record_scan(self, result: "ScanResult", *, tenant: str = "default",
                    cache_hits: int = 0, cache_misses: int = 0,
                    wall_s: float | None = None) -> None:
        """Fold one finished query's :class:`ScanResult` into the plane."""
        wall = result.time_s if wall_s is None else wall_s
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantStats()
            ts.fold(result, cache_hits=cache_hits,
                    cache_misses=cache_misses, wall_s=wall)
            for key, g in result.groups.items():
                tg = self._tiers.get(key)
                if tg is None:
                    tg = self._tiers[key] = {
                        "count": 0, "rows_scanned": 0, "rows_skipped": 0,
                        "raw_parsed": 0, "segments_pruned": 0,
                    }
                tg["count"] += g.count
                tg["rows_scanned"] += g.rows_scanned
                tg["rows_skipped"] += g.rows_skipped
                tg["raw_parsed"] += g.raw_parsed
                tg["segments_pruned"] += g.segments_pruned

    def record_rows(self, *, tenant: str = "default", rows_scanned: int = 0,
                    rows_skipped: int = 0, segments_scanned: int = 0,
                    segments_pruned: int = 0) -> None:
        """Fold counts of a reader that is not a scan (the training
        batcher's pass over the store, segment by segment): the row and
        segment counters only, so ``scans`` and the latency histogram keep
        their per-query meaning."""
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantStats()
            ts.rows_scanned += int(rows_scanned)
            ts.rows_skipped += int(rows_skipped)
            ts.segments_scanned += int(segments_scanned)
            ts.segments_pruned += int(segments_pruned)

    def record_backpressure(self, *, tenant: str = "default",
                            blocked_s: float = 0.0,
                            rejected: int = 0) -> None:
        """One ingest submission's backpressure outcome (serve plane)."""
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantStats()
            ts.ingest_blocked_s += float(blocked_s)
            ts.ingest_rejected += int(rejected)

    def record_admission(self, *, tenant: str = "default",
                         admitted: int = 0, blocked_s: float = 0.0,
                         rejected: int = 0) -> None:
        """One :class:`~repro_torch.serve.store_engine.QueryAdmission` outcome."""
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantStats()
            ts.admitted += int(admitted)
            ts.admission_blocked_s += float(blocked_s)
            ts.admission_rejected += int(rejected)

    def record_tuner(self, *, migrations: int = 0, rows_moved: int = 0,
                     rows_kept: int = 0, segments_moved: int = 0,
                     layout_retunes: int = 0,
                     router_swaps: int = 0) -> None:
        """Fold one physical-design tuner action into the plane."""
        with self._lock:
            t = self._tuner
            t["migrations"] += migrations
            t["rows_moved"] += rows_moved
            t["rows_kept"] += rows_kept
            t["segments_moved"] += segments_moved
            t["layout_retunes"] += layout_retunes
            t["router_swaps"] += router_swaps

    def record_client_eval(self, client_id, seconds: float,
                           n_records: int) -> None:
        """One client-side chunk evaluation's measured wall-clock."""
        with self._lock:
            ce = self._clients.get(client_id)
            if ce is None:
                ce = self._clients[client_id] = _ClientEval()
            ce.reports += 1
            ce.eval_s += float(seconds)
            ce.n_records += int(n_records)

    # -- reads ---------------------------------------------------------------
    def client_eval(self, client_id) -> dict | None:
        """Measured eval stats for one client, or None before any report."""
        with self._lock:
            ce = self._clients.get(client_id)
            return None if ce is None else ce.to_obj()

    def tenant(self, tenant: str = "default") -> dict | None:
        with self._lock:
            ts = self._tenants.get(tenant)
            return None if ts is None else ts.to_obj()

    def snapshot(self) -> dict:
        """JSON-able snapshot of every tenant / tier / client series."""
        with self._lock:
            return {
                "tenants": {
                    name: ts.to_obj()
                    for name, ts in sorted(self._tenants.items())
                },
                "tiers": {
                    f"{e},{t}": dict(v)
                    for (e, t), v in sorted(self._tiers.items())
                },
                "clients": {
                    str(cid): ce.to_obj()
                    for cid, ce in sorted(self._clients.items(),
                                          key=lambda kv: str(kv[0]))
                },
                "tuner": dict(self._tuner),
            }
