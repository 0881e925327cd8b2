"""Sharded store plane: partition-aware CiaoStore (DESIGN.md §14).

The monolithic :class:`~repro_torch.core.server.CiaoStore` stays the per-shard
segment store (and the N=1 degenerate case / differential oracle); this
module scales it out into N shards:

  * :class:`ShardRouter` — deterministic record -> shard assignment: hash
    or workload-derived range partitioning on a *routing key*, by default
    the plan's hottest clause key (:func:`choose_routing_key`).  Routing
    never affects correctness, only locality — partition metadata keeps
    skipping sound whatever the placement.
  * :class:`ShardedCiaoStore` — routes ingest to N per-shard stores and
    maintains per-shard *partition metadata* (:class:`ShardSummary`:
    per-key numeric min/max + bounded value-set summaries over ALL rows
    resident in the shard, raw remainders included).  That metadata is a
    third skipping level above zone maps; the full cascade is
    partition-prune -> zone-prune -> pushed-bitvector AND -> vectorized
    residual.
  * :class:`ShardedScanner` — scatter-gather scan executor: partition
    pruning first, then per-shard :class:`DataSkippingScanner` scans on a
    thread pool (shard-level work queue), merged deterministically —
    stable shard order, binary tree via
    :func:`repro_torch.dist.collectives.tree_reduce`, sorted per-(epoch, tier)
    groups (:func:`merge_scan_results`).
  * format-6 checkpoints — one manifest + per-shard files
    (:meth:`ShardedCiaoStore.save`), per-key summaries serialized by the
    skipping-index registry.  Format-5 manifests (no range bounds /
    n-gram blooms) and formats 2-4 still load
    (:meth:`ShardedCiaoStore.load`) and :func:`reshard` re-partitions a
    store offline onto a new router.

Public contract: every query over a sharded store returns counts AND
accounting bit-identical to the unsharded oracle across engines,
epochs, and tiers — ``ScanResult.groups`` sorted by (epoch, tier),
merge order deterministic regardless of thread scheduling — pinned by
the differential sweep in ``tests/test_shard.py`` and the
``bench_shard`` schema gate.  Since DESIGN.md §16 the scanner optionally
consults a per-shard :class:`~repro_torch.core.batch_scan.ResultCache` before
dispatch (validated against each shard's ``(epoch, data_version)``,
cached shards skipped and merged in the same stable order) and folds
every merged result into the store's
:class:`~repro_torch.core.telemetry.TelemetryPlane`.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from repro_torch.dist import collectives

from . import bitvector
from .client import Chunk
from .columnar import (
    ColumnarSegment, _f64_exact, build_segments, decode_rows,
)
from .predicates import (
    Clause, Query, SimplePredicate, clause_from_obj, clause_to_obj,
    json_scalar,
)
from .skip_index import (
    REGISTRY, KeyStats, NGramBloom, conservative_bounds, range_fold_value,
)
from .server import (
    CiaoStore, DataSkippingScanner, LoadStats, PlanFamily, PushdownPlan,
    RawRemainder, ScanResult, TierScan, _EpochPushdown,
    resolve_ingest_coverage,
)
from .telemetry import TelemetryPlane

# distinct values tracked per key per shard before the value-set summary
# saturates (min/max survives saturation; set-based refutation does not)
SUMMARY_VALUE_CAP = 4096
_CLAUSE_CACHE_CAP = 256


def _crc(token: bytes) -> int:
    return zlib.crc32(token) & 0xFFFFFFFF


def choose_routing_key(plan: "PushdownPlan | PlanFamily",
                       workload=None) -> str | None:
    """The plan's hottest clause key — the default routing key.

    Tallies the JSON keys referenced by the plan's clause terms, weighted
    by workload query frequency when a workload is given (a clause's
    weight is the summed ``freq`` of the queries containing it), else one
    per clause.  Ties break toward the earliest (highest-ranked) clause.
    Returns ``None`` for an empty plan (the router falls back to
    raw-bytes hashing).
    """
    if isinstance(plan, PlanFamily):
        plan = plan.plan
    weight: dict[Clause, float] = {c: 1.0 for c in plan.clauses}
    if workload is not None:
        for q in workload.queries:
            for c in q.clauses:
                if c in weight:
                    weight[c] += float(q.freq)
    score: dict[str, float] = {}
    first_rank: dict[str, int] = {}
    for rank, c in enumerate(plan.clauses):
        for t in c.terms:
            score[t.key] = score.get(t.key, 0.0) + weight[c]
            first_rank.setdefault(t.key, rank)
    if not score:
        return None
    return min(score, key=lambda k: (-score[k], first_rank[k]))


@dataclass(frozen=True)
class ShardRouter:
    """Deterministic record -> shard assignment.

    ``mode="hash"``: crc32 of ``json_scalar(value-at-key)`` (or of the
    raw record bytes when ``key`` is None / absent) modulo ``n_shards``.
    ``mode="range"``: workload-derived range partitioning — ``boundaries``
    are ascending numeric cut points (``n_shards - 1`` of them, typically
    sample quantiles via :meth:`from_samples`); a numeric value lands in
    ``searchsorted(boundaries, v, side="right")``, everything non-numeric
    falls back to the hash rule.  Range mode is what clusters routing-key
    values so partition min/max metadata can refute queries a monolithic
    store's ingest-ordered segments never could.
    """

    n_shards: int
    key: str | None = None
    mode: str = "hash"
    boundaries: tuple[float, ...] = ()

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {self.n_shards}")
        if self.mode not in ("hash", "range"):
            raise ValueError(f"unknown routing mode {self.mode!r}")
        if self.mode == "range":
            if self.key is None:
                raise ValueError("range routing needs a routing key")
            b = tuple(float(x) for x in self.boundaries)
            if len(b) != self.n_shards - 1 or list(b) != sorted(b):
                raise ValueError(
                    f"range routing over {self.n_shards} shards needs "
                    f"{self.n_shards - 1} ascending boundaries, got {b}")
            object.__setattr__(self, "boundaries", b)

    @classmethod
    def from_samples(cls, n_shards: int, key: str,
                     sample_objs: Sequence[dict], *,
                     mode: str = "range") -> "ShardRouter":
        """Router with boundaries at sample quantiles of ``key``.

        Quantile cut points balance ROW counts per shard even when the
        key's value distribution is skewed — the workload-derived flavor
        of range partitioning.
        """
        if mode == "hash":
            return cls(n_shards=n_shards, key=key, mode="hash")
        vals = sorted(
            float(v) for o in sample_objs
            for v in [o.get(key)]
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and v == v and _f64_exact(v))
        if not vals:
            raise ValueError(
                f"no numeric sample values for routing key {key!r}")
        bnd = tuple(
            vals[min(len(vals) - 1, (i * len(vals)) // n_shards)]
            for i in range(1, n_shards))
        return cls(n_shards=n_shards, key=key, mode="range", boundaries=bnd)

    def shard_of(self, obj: dict | None, rec: bytes) -> int:
        if self.key is None or obj is None or self.key not in obj:
            return _crc(rec) % self.n_shards
        v = obj[self.key]
        # range-routes exactly the values the partition summaries admit
        # to their numeric bounds (_f64_exact also rejects NaN and ints
        # beyond float64, which would overflow float(v)); bisect, not
        # np.searchsorted — per-record numpy dispatch dominates routing
        # cost on large chunks
        if self.mode == "range" and isinstance(v, (int, float)) \
                and not isinstance(v, bool) and _f64_exact(v):
            return bisect.bisect_right(self.boundaries, float(v))
        return _crc(json_scalar(v).encode()) % self.n_shards

    def route(self, objs: Sequence[dict], recs: Sequence[bytes]
              ) -> np.ndarray:
        """int32[n]: shard id per record."""
        return np.fromiter(
            (self.shard_of(o, r) for o, r in zip(objs, recs)),
            np.int32, count=len(recs))

    def to_obj(self) -> dict:
        return {"n_shards": self.n_shards, "key": self.key,
                "mode": self.mode, "boundaries": list(self.boundaries)}

    @classmethod
    def from_obj(cls, d: dict) -> "ShardRouter":
        return cls(n_shards=int(d["n_shards"]), key=d.get("key"),
                   mode=d.get("mode", "hash"),
                   boundaries=tuple(d.get("boundaries", ())))


class _KeySummary:
    """One routing partition's metadata for one JSON key.

    The shard-level analogue of a zone map: numeric min/max over the
    f64-exact values, plus bounded ``json_scalar`` / string value sets
    (``None`` = saturated past :data:`SUMMARY_VALUE_CAP` — membership
    refutation unavailable, min/max still live).  ``num_prunable`` goes
    False when a NaN is observed (same poisoning rule as the segment zone
    maps: a min/max comparison against NaN-tainted data is silently
    False, so it must never refute).
    """

    __slots__ = ("num_min", "num_max", "num_prunable", "any_notnull",
                 "reprs", "strs", "rnum_min", "rnum_max", "rnum_prunable",
                 "ngram", "seen")

    def __init__(self) -> None:
        self.num_min = np.inf
        self.num_max = -np.inf
        self.num_prunable = True
        self.any_notnull = False
        self.reprs: set[str] | None = set()
        self.strs: set[str] | None = set()
        # RANGE-index bounds over every range-matchable value (numerics
        # + numeric strings; see skip_index.range_fold_value) — folded
        # incrementally with ulp-widening, so unlike the value sets they
        # never saturate.  rnum_prunable goes False only on format-5
        # restore (bounds unknown).
        self.rnum_min = np.inf
        self.rnum_max = -np.inf
        self.rnum_prunable = True
        # 3-gram bloom over string values; created lazily on the first
        # string (None + empty strs still refutes via membership)
        self.ngram: NGramBloom | None = None
        # up to ``cap`` str and int values already folded in: adding one
        # again changes no field, so a repeat returns at once (bools,
        # floats and None are never skipped: True == 1, -0.0 == 0.0)
        self.seen: set = set()

    def add(self, v, cap: int, strings: list) -> None:
        """Fold ``v`` in; a string also goes to ``strings``, for the
        caller to add to :attr:`ngram` in one batch."""
        t = type(v)
        if t is str or t is int:
            if v in self.seen:
                return
            if len(self.seen) < cap:
                self.seen.add(v)
        if v is not None:
            self.any_notnull = True
        if isinstance(v, bool):
            pass
        elif isinstance(v, float) and v != v:
            self.num_prunable = False
        elif isinstance(v, (int, float)) and _f64_exact(v):
            fv = float(v)
            if fv < self.num_min:
                self.num_min = fv
            if fv > self.num_max:
                self.num_max = fv
        elif isinstance(v, str) and self.strs is not None:
            self.strs.add(v)
            if len(self.strs) > cap:
                self.strs = None
        if isinstance(v, str):
            if self.ngram is None:
                self.ngram = NGramBloom()
            strings.append(v)
        x = range_fold_value(v)
        if x is not None:
            lo, hi = conservative_bounds(x)
            if lo < self.rnum_min:
                self.rnum_min = lo
            if hi > self.rnum_max:
                self.rnum_max = hi
        if self.reprs is not None:
            self.reprs.add(json_scalar(v))
            if len(self.reprs) > cap:
                self.reprs = None

    def stats(self) -> KeyStats:
        """Registry probe view (shared with the segment zone maps)."""
        return KeyStats(
            any_notnull=self.any_notnull,
            num_min=self.num_min, num_max=self.num_max,
            num_prunable=self.num_prunable,
            strs=self.strs, reprs=self.reprs,
            rnum_min=self.rnum_min, rnum_max=self.rnum_max,
            rnum_prunable=self.rnum_prunable, ngram=self.ngram,
        )

    def to_obj(self) -> dict:
        # each registered index serializes its own summary slice
        # (format 6); the membership index's block is byte-compatible
        # with the pre-registry format-5 encoding, +/-inf bounds
        # serialize as null/flags (RFC 8259 has no Infinity tokens)
        return REGISTRY.summary_to_obj(self.stats())

    @classmethod
    def from_obj(cls, d: dict) -> "_KeySummary":
        ks = cls()
        st = REGISTRY.summary_from_obj(d)
        ks.num_min = st.num_min
        ks.num_max = st.num_max
        ks.num_prunable = st.num_prunable
        ks.any_notnull = st.any_notnull
        ks.reprs = st.reprs
        ks.strs = st.strs
        ks.rnum_min = st.rnum_min
        ks.rnum_max = st.rnum_max
        ks.rnum_prunable = st.rnum_prunable
        ks.ngram = st.ngram
        return ks


class ShardSummary:
    """Partition-level skipping metadata for ONE shard.

    Covers EVERY row routed to the shard — loaded segments, JIT-promoted
    segments AND raw remainders (the router parses each record once, so
    the summary sees rows the zone maps never will until promotion).
    That total coverage is what makes partition pruning sound for raw
    rows: a refuted shard cannot hold a match anywhere, so the scan skips
    it without JIT-promoting.

    ``exhaustive=False`` (a store migrated from a pre-shard checkpoint,
    or the N=1 degenerate case where routing is skipped) disables pruning
    entirely — the summary answers "possible" for every clause until
    :func:`reshard` rebuilds it from the full row population.

    Concurrent-read soundness (async serve plane, DESIGN.md §17): every
    field is *monotone-permissive* — mins only fall, maxes only rise,
    value sets only grow (or saturate to ``None``), ``any_notnull`` only
    flips True, ``num_prunable`` only flips False, bloom bits only set.
    :meth:`update` folds a whole batch before it adds the batch's
    strings to the n-gram blooms, so a reader racing ONE writer (the
    serve plane guarantees a single writer per shard) may see a string
    in a value set whose bloom lacks it yet: a state that is no
    fully-applied prefix of the updates.  Soundness rests on ordering
    instead: :meth:`update` returns, blooms included, BEFORE its shard's
    ingest makes the batch's rows visible, so every row any store
    snapshot can contain is fully summarized, and a torn read can only
    misjudge rows no snapshot holds yet.  Cached clause verdicts are
    version-tagged: :meth:`update` bumps ``_version`` after all its
    mutations, retiring any verdict whose compute overlapped them.
    """

    def __init__(self, *, exhaustive: bool = True,
                 value_cap: int = SUMMARY_VALUE_CAP):
        self.exhaustive = exhaustive
        self.value_cap = int(value_cap)
        self.n_rows = 0
        self._keys: dict[str, _KeySummary] = {}
        # clause -> (version-at-compute-start, verdict); valid only while
        # the tag equals the current _version (see class docstring)
        self._possible: dict[Clause, tuple[int, bool]] = {}
        self._version = 0

    def update(self, objs: Sequence[dict]) -> None:
        if not self.exhaustive or not objs:
            return
        cap = self.value_cap
        keys = self._keys
        strings: dict[str, list] = {}
        for obj in objs:
            for k, v in obj.items():
                ks = keys.get(k)
                if ks is None:
                    ks = keys[k] = _KeySummary()
                new = strings.get(k)
                if new is None:
                    new = strings[k] = []
                ks.add(v, cap, new)
        # each key's new strings into its bloom in one batch
        for k, new in strings.items():
            if new:
                keys[k].ngram.add_many(new)
        self.n_rows += len(objs)
        # invalidate cached verdicts LAST: a verdict computed concurrently
        # with the mutations above carries the pre-bump version tag, so
        # this bump retires it even if it lands in the cache afterwards.
        # Fresh dict, never .clear() — readers may hold the old one.
        self._version += 1
        self._possible = {}

    # -- pruning -------------------------------------------------------------
    def term_possible(self, t: SimplePredicate) -> bool:
        """Conservative: False only when provably no shard row matches.

        THE refutation rules are shared with the segment zone maps (the
        ``repro_torch.core.skip_index`` registry) — every kind needs the key
        present, set membership refutes exactly, a saturated value set
        degrades to min/max-only refutation, range bounds refute RANGE,
        and the n-gram bloom refutes substring probes past saturation.
        """
        ks = self._keys.get(t.key)
        if ks is None:
            return False
        try:
            return REGISTRY.term_possible(t, ks.stats())
        except RuntimeError:
            # a concurrent writer grew a value set mid-membership-scan
            # ("set changed size during iteration"): answer conservatively
            return True

    def clause_possible(self, c: Clause) -> bool:
        if not self.exhaustive:
            return True
        ver = self._version          # read BEFORE computing the verdict
        cache = self._possible
        hit = cache.get(c)
        if hit is not None and hit[0] == ver:
            return hit[1]
        p = any(self.term_possible(t) for t in c.terms)
        if len(cache) >= _CLAUSE_CACHE_CAP:
            self._possible = cache = {}
        cache[c] = (ver, p)
        return p

    def query_possible(self, q: Query) -> bool:
        """False iff some query clause provably matches no shard row."""
        return all(self.clause_possible(c) for c in q.clauses)

    # -- persistence ---------------------------------------------------------
    def to_obj(self) -> dict:
        return {
            "exhaustive": self.exhaustive,
            "value_cap": self.value_cap,
            "n_rows": self.n_rows,
            "keys": {k: ks.to_obj() for k, ks in sorted(self._keys.items())},
        }

    @classmethod
    def from_obj(cls, d: dict) -> "ShardSummary":
        s = cls(exhaustive=bool(d["exhaustive"]),
                value_cap=int(d.get("value_cap", SUMMARY_VALUE_CAP)))
        s.n_rows = int(d.get("n_rows", 0))
        s._keys = {k: _KeySummary.from_obj(v) for k, v in d["keys"].items()}
        return s


class ShardedCiaoStore:
    """N per-shard :class:`CiaoStore`\\ s behind one store surface.

    Presents the same protocol the scanner, recipe batcher, replanner and
    ingest coordinator already consume — ``ingest_chunk`` /
    ``advance_epoch`` / ``blocks`` / ``jit_blocks`` / ``pushed_by_epoch``
    / ``observed_selectivities`` / ``stats`` — so every control-plane
    component runs unmodified over a sharded substrate.  Plan state is
    shared: all shards hold the same plan/family objects and advance
    epochs together; statistics are kept per shard and aggregated on read
    (the replanner re-solves from per-shard observed selectivities summed
    into exact fleet totals).

    ``n_shards == 1`` is the degenerate case: ingest delegates straight
    to the single inner store (no routing parse, no partition metadata),
    making it bit-identical — in counts AND in cost shape — to a plain
    :class:`CiaoStore`.
    """

    def __init__(self, plan: "PushdownPlan | PlanFamily", *,
                 router: ShardRouter | None = None,
                 n_shards: int | None = None,
                 segment_capacity: int = 8192,
                 summary_value_cap: int = SUMMARY_VALUE_CAP):
        if router is None:
            router = ShardRouter(n_shards=n_shards or 1)
        elif n_shards is not None and n_shards != router.n_shards:
            raise ValueError(
                f"n_shards {n_shards} contradicts router over "
                f"{router.n_shards} shards")
        self.router = router
        self.segment_capacity = int(segment_capacity)
        self.shards = [
            CiaoStore(plan, segment_capacity=segment_capacity)
            for _ in range(router.n_shards)
        ]
        # a 1-shard store skips routing, so its summary never becomes
        # exhaustive — pruning the only shard is pointless anyway
        self.summaries = [
            ShardSummary(exhaustive=router.n_shards > 1,
                         value_cap=summary_value_cap)
            for _ in range(router.n_shards)
        ]
        self.route_time_s = 0.0
        self.query_log: list[Query] = []
        self.query_log_cap = 4096
        # front-end telemetry plane (DESIGN.md §16): scanners over the
        # sharded store record ONCE here (per merged query), never into
        # the per-shard stores' planes
        self.telemetry = TelemetryPlane()
        # fences snapshot() against in-flight migration moves (DESIGN.md
        # §18): a segment move is remove-from-src + add-to-dst; holding
        # this across both (and across snapshot capture) means no
        # snapshot ever observes a row absent from every shard or
        # present in two.  Lock order: _migration_lock BEFORE any
        # shard's _ingest_lock, never the reverse.
        self._migration_lock = threading.RLock()

    # -- shared plan state ---------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def data_version(self) -> int:
        """Sum of the shards' segment-surface counters (device cache sync
        fast-path, DESIGN.md §15): monotonic, changes iff a shard's did."""
        return sum(s.data_version for s in self.shards)

    @property
    def plan(self) -> PushdownPlan:
        return self.shards[0].plan

    @property
    def family(self) -> PlanFamily:
        return self.shards[0].family

    @property
    def plans(self) -> dict[int, PushdownPlan]:
        return self.shards[0].plans

    @property
    def families(self) -> dict[int, PlanFamily]:
        return self.shards[0].families

    @property
    def epoch(self) -> int:
        return self.plan.epoch

    def advance_epoch(self, new_plan: "PushdownPlan | PlanFamily"
                      ) -> np.ndarray:
        """Install the next plan epoch on every shard; returns the remap."""
        remaps = [s.advance_epoch(new_plan) for s in self.shards]
        return remaps[0]

    # -- aggregated statistics ----------------------------------------------
    @property
    def stats(self) -> LoadStats:
        """Fleet :class:`LoadStats`: exact sums over the shards, plus the
        router's parse/route wall-clock folded into load/parse time."""
        agg = LoadStats()
        for s in self.shards:
            agg.add(s.stats)
        agg.load_time_s += self.route_time_s
        agg.parse_time_s += self.route_time_s
        return agg

    def stats_report(self) -> dict:
        """JSON-able operational snapshot: the front-end telemetry plane
        (where sharded scanners record their merged per-query results)
        plus one nested :meth:`CiaoStore.stats_report` per shard."""
        s = self.stats
        return {
            "epoch": self.epoch,
            "data_version": self.data_version,
            "n_shards": self.n_shards,
            "load": {
                "n_records": s.n_records,
                "n_loaded": s.n_loaded,
                "n_jit_loaded": s.n_jit_loaded,
                "loading_ratio": round(s.loading_ratio, 4),
                "load_time_s": round(s.load_time_s, 6),
                "parse_time_s": round(s.parse_time_s, 6),
                "jit_time_s": round(s.jit_time_s, 6),
            },
            "telemetry": self.telemetry.snapshot(),
            "shards": [sh.stats_report() for sh in self.shards],
        }

    def _sum_epoch(self, attr: str, epoch: int) -> np.ndarray:
        out = None
        for s in self.shards:
            v = getattr(s, attr).get(epoch)
            if v is None:
                continue
            out = np.asarray(v, np.int64) if out is None else out + v
        if out is None:
            out = np.zeros((self.plans[epoch].n,), np.int64)
        return out

    @property
    def clause_counts(self) -> np.ndarray:
        """int64[P]: current epoch's per-clause totals over all shards."""
        return self._sum_epoch("_epoch_counts", self.epoch)

    def epoch_records(self, epoch: int | None = None) -> int:
        e = self.epoch if epoch is None else epoch
        return sum(s._epoch_records.get(e, 0) for s in self.shards)

    def clause_records(self, epoch: int | None = None) -> np.ndarray:
        e = self.epoch if epoch is None else epoch
        return self._sum_epoch("_epoch_clause_records", e)

    def observed_selectivities(self, epoch: int | None = None) -> np.ndarray:
        """float64[P]: per-shard observed selectivities aggregated into
        fleet totals (summed counts over summed per-clause denominators)
        — what the replanner re-solves from."""
        e = self.epoch if epoch is None else epoch
        counts = self._sum_epoch("_epoch_counts", e)
        denom = np.maximum(self._sum_epoch("_epoch_clause_records", e), 1)
        return counts / denom

    @property
    def group_records(self) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for s in self.shards:
            for k, n in s.group_records.items():
                out[k] = out.get(k, 0) + n
        return out

    @property
    def group_loaded(self) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for s in self.shards:
            for k, n in s.group_loaded.items():
                out[k] = out.get(k, 0) + n
        return out

    # -- query-path surface (same contract as CiaoStore) ---------------------
    @property
    def blocks(self) -> list[ColumnarSegment]:
        """All shards' loaded segments, stable shard order."""
        return [seg for s in self.shards for seg in s.blocks]

    @property
    def jit_blocks(self) -> list[ColumnarSegment]:
        return [seg for s in self.shards for seg in s.jit_blocks]

    @property
    def raw(self) -> list[RawRemainder]:
        return [rr for s in self.shards for rr in s.raw]

    def log_query(self, q: Query) -> None:
        self.query_log.append(q)
        if len(self.query_log) > 2 * self.query_log_cap:
            del self.query_log[:-self.query_log_cap]

    def pushed_by_epoch(self, q: Query) -> _EpochPushdown:
        m = _EpochPushdown(self, q)
        m[self.plan.epoch]
        return m

    def promote_uncovered_raw(
        self, pushed: _EpochPushdown,
    ) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for s in self.shards:
            for k, n in s.promote_uncovered_raw(pushed).items():
                out[k] = out.get(k, 0) + n
        return out

    def jit_load_raw(
        self, only_epochs: set[int] | None = None,
        *, only_groups: set[tuple[int, int]] | None = None,
    ) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for s in self.shards:
            for k, n in s.jit_load_raw(only_epochs,
                                       only_groups=only_groups).items():
                out[k] = out.get(k, 0) + n
        return out

    # -- ingest --------------------------------------------------------------
    def ingest_chunk(
        self, chunk: Chunk,
        bitvecs: "np.ndarray | bitvector.ChunkBitvectors",
        *, epoch: int | None = None, tier: int | None = None,
    ) -> LoadStats:
        """Route one chunk's records to their shards and ingest each slice.

        Validation (epoch, tier, bitvector dimensions) runs ONCE up front
        via :func:`repro_torch.core.server.resolve_ingest_coverage` — a rejected
        chunk touches no shard.  Rows are parsed once for routing; the
        parsed objects feed both the partition summaries and the per-shard
        ingest (loaded rows are not re-parsed).  Per-shard bitvector
        slices are repacked from the chunk's bit matrix, so per-clause
        popcounts land on the owning shard and the aggregated observed
        selectivities stay exact.

        Routing uses ``self.router`` at call time: a migration swaps the
        router FIRST, so every slice routed after the swap already lands
        in its final home and never needs moving.
        """
        resolve_ingest_coverage(
            self.plan, self.family, n_records=chunk.n_records,
            bitvecs=bitvecs, epoch=epoch, tier=tier)
        if self.n_shards == 1:  # degenerate case: no routing parse
            self.shards[0].ingest_chunk(chunk, bitvecs,
                                        epoch=epoch, tier=tier)
            return self.stats
        for s, sub_chunk, sub_bv, sub_objs in \
                self.route_slices(chunk, bitvecs):
            self.ingest_slice(s, sub_chunk, sub_bv, sub_objs,
                              epoch=epoch, tier=tier)
        return self.stats

    def route_slices(
        self, chunk: Chunk,
        bitvecs: "np.ndarray | bitvector.ChunkBitvectors",
    ) -> list[tuple[int, Chunk, "bitvector.ChunkBitvectors", list[dict]]]:
        """Parse + route one validated chunk into per-shard slices.

        Returns ``(shard, sub_chunk, sub_bitvectors, sub_objs)`` per
        non-empty target shard.  Split out of :meth:`ingest_chunk` so the
        serve plane (``repro_torch.serve.store_engine``) can route in the
        submitting thread and enqueue each slice onto its shard's writer
        queue.  Callers must have validated the chunk with
        :func:`~repro_torch.core.server.resolve_ingest_coverage` first.
        ``route_time_s`` accumulation is unsynchronized — approximate
        when several submitters race (it is a timing stat, never a gate).
        """
        n = chunk.n_records
        t0 = time.perf_counter()
        recs, objs = decode_rows(chunk.data, chunk.lengths)
        sid = self.router.route(objs, recs)
        words = (bitvecs.words
                 if isinstance(bitvecs, bitvector.ChunkBitvectors)
                 else np.asarray(bitvecs, np.uint32))
        bits = bitvector.unpack(words, n)
        out: list[tuple[int, Chunk, bitvector.ChunkBitvectors, list[dict]]] \
            = []
        for s in range(self.n_shards):
            idx = np.nonzero(sid == s)[0]
            if not idx.size:
                continue
            out.append((
                s,
                Chunk(data=chunk.data[idx], lengths=chunk.lengths[idx]),
                bitvector.ChunkBitvectors.from_bits(bits[:, idx]),
                [objs[i] for i in idx],
            ))
        self.route_time_s += time.perf_counter() - t0
        return out

    def ingest_slice(
        self, s: int, chunk: Chunk,
        bitvecs: "bitvector.ChunkBitvectors", objs: list[dict],
        *, epoch: int | None = None, tier: int | None = None,
    ) -> None:
        """Apply one routed slice to shard ``s``: summary update FIRST,
        then the per-shard ingest — the ordering that keeps partition
        pruning sound for concurrent snapshot readers (every row a
        snapshot can see was already summarized; see
        :class:`ShardSummary`).

        The whole slice is applied under the shard's ingest lock: the
        serve plane's writer queues already assign each shard to exactly
        one writer, but a background migration writer (DESIGN.md §18)
        may place rows into the same shard concurrently — the lock makes
        the two mutators mutually exclusive per shard."""
        sh = self.shards[s]
        with sh._ingest_lock:
            self.summaries[s].update(objs)
            sh.ingest_chunk(chunk, bitvecs,
                            epoch=epoch, tier=tier, objs=objs)

    # -- consistent reads (async serve plane, DESIGN.md §17) -----------------
    def snapshot(self) -> "ShardedStoreSnapshot":
        """Pin an immutable view of every shard.

        Per-shard snapshots are taken sequentially, each under its own
        shard's ingest lock, so the view is *per-shard prefix-consistent*:
        each shard's slice is a prefix of that shard's ingest history.
        Under the serve plane's single-writer-per-shard queues that is
        snapshot isolation per shard; cross-shard atomicity of one
        multi-shard chunk is NOT guaranteed (a snapshot may contain shard
        A's slice of a chunk but not yet shard B's).  Counts still
        quiesce to the oracle because every slice lands exactly once.

        Taken under the migration fence: an in-flight background segment
        move (remove-from-src + add-to-dst, DESIGN.md §18) is atomic
        w.r.t. this capture, so snapshot counts stay bit-identical to
        the oracle THROUGHOUT a migration.
        """
        with self._migration_lock:
            return ShardedStoreSnapshot(self)

    # -- online physical-design migration (DESIGN.md §18) --------------------
    def begin_migration(self, router: ShardRouter, *,
                        batch_rows: int = 4096) -> "SegmentMigration":
        """Swap the routing function and start moving resident rows.

        The new ``router`` (same shard count — changing N is offline
        :func:`reshard`'s job) takes effect for NEW ingest immediately,
        so post-swap rows never need moving; the returned
        :class:`SegmentMigration` then drains the PRE-swap resident
        surface in bounded batches (:meth:`SegmentMigration.step`) while
        scans and ingest stay online.  Open builder tails are sealed at
        the swap point so every pre-swap row lives in an immutable
        segment the migration can move by identity.
        """
        if router.n_shards != self.n_shards:
            raise ValueError(
                f"online migration keeps the shard count: store has "
                f"{self.n_shards}, router wants {router.n_shards}")
        with self._migration_lock:
            self.router = router
            work: list[tuple[str, int, object]] = []
            for s, sh in enumerate(self.shards):
                with sh._ingest_lock:
                    for b in sh._builders.values():
                        if b.n_rows:
                            sh.segments.append(b.seal())
                            sh.data_version += 1
                    work.extend(("loaded", s, seg) for seg in sh.segments)
                    work.extend(("jit", s, seg) for seg in sh.jit_segments)
                    work.extend(("raw", s, rr) for rr in sh.raw)
            return SegmentMigration(self, router, work,
                                    batch_rows=batch_rows)

    # -- persistence (format 6: manifest + per-shard files) ------------------
    def save(self, path: str) -> None:
        """Checkpoint as a DIRECTORY: ``manifest.json`` + one format-4
        ``shard_<i>.npz`` per shard.

        The manifest carries the shard plane's own state — router config,
        partition summaries (which cover raw remainder rows no segment
        restore could rebuild), and the top-level query log; each shard
        file is a complete, independently loadable per-shard store.
        Format 6 extends the format-5 per-key summaries with the
        registry indexes' slices (range bounds, n-gram blooms); format-5
        files still load (missing fields deserialize to "cannot refute").
        """
        os.makedirs(path, exist_ok=True)
        shard_files = []
        for i, s in enumerate(self.shards):
            name = f"shard_{i:05d}.npz"
            s.save(os.path.join(path, name))
            shard_files.append(name)
        manifest = {
            "format": 6,
            "segment_capacity": self.segment_capacity,
            "router": self.router.to_obj(),
            "shard_files": shard_files,
            "summaries": [s.to_obj() for s in self.summaries],
            "route_time_s": self.route_time_s,
            "query_log": [
                {"freq": q.freq,
                 "clauses": [clause_to_obj(c) for c in q.clauses]}
                for q in self.query_log[-self.query_log_cap:]
            ],
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    @classmethod
    def load(cls, path: str,
             plan: PushdownPlan | None = None) -> "ShardedCiaoStore":
        """Restore a checkpoint — format 5/6 (directory) or formats 2-4.

        A pre-shard ``.npz`` checkpoint (format 2/3/4) loads into a
        1-shard store whose summary is non-exhaustive (pruning disabled
        until :func:`reshard` re-partitions it offline); counts and
        coverage claims survive unchanged because the inner store IS the
        migrated :class:`CiaoStore`.
        """
        manifest_path = os.path.join(path, "manifest.json")
        if not os.path.isdir(path):
            inner = CiaoStore.load(path, plan)
            store = cls.__new__(cls)
            store.router = ShardRouter(n_shards=1)
            store.segment_capacity = inner.segment_capacity
            store.shards = [inner]
            store.summaries = [ShardSummary(exhaustive=False)]
            store.route_time_s = 0.0
            store.query_log = list(inner.query_log)
            store.query_log_cap = inner.query_log_cap
            store.telemetry = TelemetryPlane()
            store._migration_lock = threading.RLock()
            return store
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("format") not in (5, 6):
            raise ValueError(
                f"{path}: unsupported sharded checkpoint format "
                f"{manifest.get('format')!r}")
        store = cls.__new__(cls)
        store.router = ShardRouter.from_obj(manifest["router"])
        store.segment_capacity = int(manifest["segment_capacity"])
        store.shards = [
            CiaoStore.load(os.path.join(path, name), plan)
            for name in manifest["shard_files"]
        ]
        store.summaries = [
            ShardSummary.from_obj(d) for d in manifest["summaries"]
        ]
        store.route_time_s = float(manifest.get("route_time_s", 0.0))
        store.query_log = [
            Query(tuple(clause_from_obj(c) for c in q["clauses"]),
                  freq=float(q["freq"]))
            for q in manifest.get("query_log", [])
        ]
        store.query_log_cap = 4096
        store.telemetry = TelemetryPlane()
        store._migration_lock = threading.RLock()
        return store


class ShardedStoreSnapshot:
    """Immutable view of a :class:`ShardedCiaoStore` (DESIGN.md §17).

    ``shards`` holds one :class:`~repro_torch.core.server.StoreSnapshot` per
    shard, so :class:`ShardedScanner`,
    :class:`~repro_torch.core.batch_scan.ScanBatcher` and the device scanners
    run over it unchanged.  ``summaries`` is a shallow COPY of the
    store's summary list: each :class:`ShardSummary` object is still
    shared live (monotone-permissive and updated before its shard's
    ingest, so a concurrent update only makes verdicts more permissive),
    but a migration ``finish()`` installing fresh exhaustive summaries
    into the live list does not retroactively tighten this snapshot —
    the old, over-permissive objects keep covering every row the
    snapshot pinned.

    ``data_version`` is the sum of the per-shard snapshot versions (the
    same composition rule as the live store); snapshot-local JIT
    promotion in any shard forks it negative, keeping cache fencing
    exact (see :class:`~repro_torch.core.server.StoreSnapshot`).
    """

    def __init__(self, store: ShardedCiaoStore):
        self._store = store               # query-log feedback only
        self.router = store.router
        self.segment_capacity = store.segment_capacity
        self.shards = [s.snapshot() for s in store.shards]
        self.summaries = list(store.summaries)
        self.telemetry = store.telemetry
        self.route_time_s = store.route_time_s
        self.base_version = sum(s.base_version for s in self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def data_version(self) -> int:
        return sum(s.data_version for s in self.shards)

    @property
    def plan(self) -> PushdownPlan:
        return self.shards[0].plan

    @property
    def family(self) -> PlanFamily:
        return self.shards[0].family

    @property
    def plans(self) -> dict[int, PushdownPlan]:
        return self.shards[0].plans

    @property
    def families(self) -> dict[int, PlanFamily]:
        return self.shards[0].families

    @property
    def epoch(self) -> int:
        return self.plan.epoch

    @property
    def stats(self) -> LoadStats:
        agg = LoadStats()
        for s in self.shards:
            agg.add(s.stats)
        agg.load_time_s += self.route_time_s
        agg.parse_time_s += self.route_time_s
        return agg

    @property
    def blocks(self) -> list[ColumnarSegment]:
        return [seg for s in self.shards for seg in s.blocks]

    @property
    def jit_blocks(self) -> list[ColumnarSegment]:
        return [seg for s in self.shards for seg in s.jit_blocks]

    @property
    def raw(self) -> list[RawRemainder]:
        return [rr for s in self.shards for rr in s.raw]

    def log_query(self, q: Query) -> None:
        self._store.log_query(q)

    def pushed_by_epoch(self, q: Query) -> _EpochPushdown:
        m = _EpochPushdown(self, q)
        m[self.plan.epoch]
        return m

    def resident_group_rows(self) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for s in self.shards:
            for k, n in s.resident_group_rows().items():
                out[k] = out.get(k, 0) + n
        return out

    def promote_uncovered_raw(
        self, pushed: _EpochPushdown,
    ) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for s in self.shards:
            for k, n in s.promote_uncovered_raw(pushed).items():
                out[k] = out.get(k, 0) + n
        return out

    def close(self) -> None:
        """Retire every per-shard snapshot (see
        :meth:`repro_torch.core.server.StoreSnapshot.close`).  Idempotent."""
        for s in self.shards:
            s.close()


# ---------------------------------------------------------------------------
# row placement primitives (shared by offline reshard + online migration)
# ---------------------------------------------------------------------------


def _account_rows(sh: CiaoStore, epoch: int, tier: int, k: int, *,
                  loaded: int = 0, jit: int = 0) -> None:
    """Adjust one shard's placement-derived counters by ``k`` rows.

    These are exactly the per-shard counters the scan executor consults
    (``group_records``/``group_loaded`` for pruned-shard attribution,
    ``_epoch_records`` + the ``LoadStats`` row counts for the empty-shard
    check and the parallel-dispatch heuristic).  ``k`` (and the
    ``loaded``/``jit`` row deltas) may be negative — a migration removes
    a segment from its source shard before re-placing its rows.
    """
    sh._epoch_records[epoch] = sh._epoch_records.get(epoch, 0) + k
    gkey = (epoch, tier)
    sh.group_records[gkey] = sh.group_records.get(gkey, 0) + k
    sh.stats.n_records += k
    if loaded:
        sh.group_loaded[gkey] = sh.group_loaded.get(gkey, 0) + loaded
        sh.stats.n_loaded += loaded
    if jit:
        sh.stats.n_jit_loaded += jit


def _split_by_shard(sid: np.ndarray, n_shards: int) -> dict[int, np.ndarray]:
    """shard -> row indices, omitting empty targets."""
    out: dict[int, np.ndarray] = {}
    for s in range(n_shards):
        idx = np.nonzero(sid == s)[0]
        if idx.size:
            out[s] = idx
    return out


def _place_loaded(tgt: CiaoStore, seg: ColumnarSegment, idx: np.ndarray,
                  sub_recs: list[bytes], sub_objs: list[dict],
                  bits: np.ndarray) -> None:
    """Append ``seg``'s rows at ``idx`` (with their bitvector slices) to
    ``tgt``'s open builder for the segment's coverage group."""
    tgt.segments.extend(
        tgt._builder(seg.epoch, seg.n_covered, seg.tier)
        .add(sub_recs, sub_objs, bits[:, idx]))


def _place_jit(tgt: CiaoStore, seg: ColumnarSegment,
               sub_recs: list[bytes], sub_objs: list[dict],
               cap: int) -> None:
    """Append JIT-promoted rows (no bitvectors) as fresh segments."""
    tgt.jit_segments.extend(build_segments(
        sub_recs, np.zeros((0, len(sub_recs)), bool), objs=sub_objs,
        epoch=seg.epoch, n_covered=seg.n_covered, tier=seg.tier,
        capacity=cap))


def _place_raw(tgt: CiaoStore, rr: RawRemainder, idx: np.ndarray) -> None:
    """Append the ``idx`` slice of one raw remainder."""
    tgt.raw.append(RawRemainder(
        data=rr.data[idx], lengths=rr.lengths[idx],
        epoch=rr.epoch, n_covered=rr.n_covered, tier=rr.tier))


class SegmentMigration:
    """Incremental background re-partition of one :class:`ShardedCiaoStore`.

    Created by :meth:`ShardedCiaoStore.begin_migration` (which swaps the
    router first, so new ingest needs no moving).  Each :meth:`step`
    drains up to ``batch_rows`` rows of the pre-swap work list; a single
    item (segment or raw remainder) moves atomically w.r.t. snapshots:

      1. route the item's rows with the NEW router OUTSIDE every lock
         (decode + crc are the expensive part);
      2. all-stay fast path: if every row already lives on its target
         shard, the item is untouched (the common case — only segments
         straddling a boundary change pay anything);
      3. else, under the store's migration fence: remove the item from
         its source shard (identity filter, negative accounting, version
         bump) and re-place each row slice on its target shard (summary
         update BEFORE placement — same ordering as live ingest — then
         builder/segment append, positive accounting, version bump).

    Source summaries are never rebuilt mid-migration: they stay
    monotone-over-permissive for departed rows (pruning remains sound,
    merely less sharp) until :meth:`finish` installs fresh exhaustive
    summaries per shard.  A raw remainder that a concurrent scan
    JIT-promoted away is simply skipped (``items_skipped``): its rows
    became resident jit segments of the SOURCE shard — stragglers the
    next migration can move; routing never affects correctness.

    At most one ``SegmentMigration`` should run at a time (the tuner is
    the single driver); ``step`` itself is safe against concurrent
    ingest, scans and snapshots by construction.
    """

    def __init__(self, store: ShardedCiaoStore, router: ShardRouter,
                 work: list[tuple[str, int, object]], *,
                 batch_rows: int = 4096):
        self.store = store
        self.router = router
        self._work = work
        self.batch_rows = int(batch_rows)
        self.rows_moved = 0
        self.rows_kept = 0
        self.segments_moved = 0
        self.items_skipped = 0
        self.batches = 0
        self.finished = False

    @property
    def done(self) -> bool:
        return self.finished

    @property
    def items_left(self) -> int:
        return len(self._work)

    def step(self, max_rows: int | None = None) -> int:
        """Process work items until ``max_rows`` rows were examined (or
        the work list drains, which auto-:meth:`finish`\\ es).  Returns
        the number of rows examined this call."""
        if self.finished:
            return 0
        budget = self.batch_rows if max_rows is None else int(max_rows)
        processed = 0
        while self._work and processed < budget:
            kind, src, item = self._work.pop()
            processed += self._move_item(kind, src, item)
        self.batches += 1
        if not self._work:
            self.finish()
        return processed

    def run(self) -> None:
        """Drain the whole work list (bounded batches, then finish)."""
        while not self.finished:
            self.step()

    def _move_item(self, kind: str, src: int, item) -> int:
        store = self.store
        sh = store.shards[src]
        if kind == "raw":
            rr: RawRemainder = item  # type: ignore[assignment]
            recs, objs = decode_rows(rr.data, rr.lengths)
            n = len(recs)
        else:
            seg: ColumnarSegment = item  # type: ignore[assignment]
            recs, objs = seg.records(), seg.rows
            n = seg.n_rows
        if n == 0:
            return 0
        sid = self.router.route(objs, recs)
        if int(np.count_nonzero(sid != src)) == 0:
            self.rows_kept += n
            return n
        split = _split_by_shard(sid, store.n_shards)
        with store._migration_lock:
            # remove from the source shard first: a fenced snapshot sees
            # the item either fully present or fully re-placed, and an
            # unfenced live reader can only transiently UNDERcount (the
            # same window a racing ingest always had)
            with sh._ingest_lock:
                if kind == "loaded":
                    if not any(g is item for g in sh.segments):
                        self.items_skipped += 1
                        return n
                    sh.segments = [g for g in sh.segments if g is not item]
                    _account_rows(sh, seg.epoch, seg.tier, -n, loaded=-n)
                elif kind == "jit":
                    if not any(g is item for g in sh.jit_segments):
                        self.items_skipped += 1
                        return n
                    sh.jit_segments = [
                        g for g in sh.jit_segments if g is not item]
                    _account_rows(sh, seg.epoch, seg.tier, -n, jit=-n)
                else:
                    # a concurrent scan may have JIT-promoted this
                    # remainder away; its rows are now source-resident
                    # jit segments outside this work list — skip
                    if not any(x is item for x in sh.raw):
                        self.items_skipped += 1
                        return n
                    sh.raw = [x for x in sh.raw if x is not item]
                    _account_rows(sh, rr.epoch, rr.tier, -n)
                sh.data_version += 1
            if kind == "loaded":
                bits = bitvector.unpack(seg.bitvectors, n)
            for dst, idx in split.items():
                tgt = store.shards[dst]
                sub_recs = [recs[i] for i in idx]
                sub_objs = [objs[i] for i in idx]
                with tgt._ingest_lock:
                    if dst != src:
                        # source rows are already covered by the source
                        # summary (over-permissive until finish())
                        store.summaries[dst].update(sub_objs)
                    if kind == "loaded":
                        _place_loaded(tgt, seg, idx, sub_recs, sub_objs,
                                      bits)
                        _account_rows(tgt, seg.epoch, seg.tier, len(idx),
                                      loaded=len(idx))
                    elif kind == "jit":
                        _place_jit(tgt, seg, sub_recs, sub_objs,
                                   store.segment_capacity)
                        _account_rows(tgt, seg.epoch, seg.tier, len(idx),
                                      jit=len(idx))
                    else:
                        _place_raw(tgt, rr, idx)
                        _account_rows(tgt, rr.epoch, rr.tier, len(idx))
                    tgt.data_version += 1
                    if dst != src:
                        self.rows_moved += len(idx)
                    else:
                        self.rows_kept += len(idx)
        self.segments_moved += 1
        return n

    def finish(self) -> None:
        """Install fresh exhaustive per-shard summaries and record the
        migration into the store's telemetry plane.  Idempotent; called
        automatically when :meth:`step` drains the work list.

        Each shard's summary is rebuilt from its ACTUAL resident rows
        (segments, jit segments, decoded raw) under that shard's ingest
        lock — a racing ingest either lands before the rebuild (its rows
        are counted) or blocks until the fresh summary is installed and
        then updates it.  Old snapshots keep the old summary objects
        (their ``summaries`` list was copied), so their pruning stays
        over-permissive, never unsound.
        """
        if self.finished:
            return
        self.finished = True
        store = self.store
        with store._migration_lock:
            for s, sh in enumerate(store.shards):
                old = store.summaries[s]
                with sh._ingest_lock:
                    fresh = ShardSummary(
                        exhaustive=store.n_shards > 1,
                        value_cap=old.value_cap)
                    for seg in (*sh.blocks, *sh.jit_blocks):
                        fresh.update(seg.rows)
                    for rr in sh.raw:
                        _, objs = decode_rows(rr.data, rr.lengths)
                        fresh.update(objs)
                    store.summaries[s] = fresh
        telemetry = getattr(store, "telemetry", None)
        if telemetry is not None:
            telemetry.record_tuner(
                migrations=1, rows_moved=self.rows_moved,
                rows_kept=self.rows_kept,
                segments_moved=self.segments_moved)


def reshard(store: "ShardedCiaoStore | CiaoStore",
            router: ShardRouter, *,
            segment_capacity: int | None = None) -> ShardedCiaoStore:
    """Offline re-partition of a store onto ``router`` (DESIGN.md §14).

    Every resident row — loaded segments, JIT-promoted segments, raw
    remainders — is routed to its new shard with its coverage metadata
    ``(epoch, n_covered, tier)`` and bitvector rows intact, so scan
    counts and coverage claims are preserved bit for bit (pinned by the
    migration tests).  Partition summaries are rebuilt exhaustively from
    the full row population, re-enabling pruning for stores migrated from
    pre-shard checkpoints.

    Statistics split by who reads them: the PER-SHARD counters the scan
    executor consults (``group_records``/``group_loaded`` for
    pruned-shard attribution, ``_epoch_records`` and the ``LoadStats``
    row counts for the empty-shard check and the parallel-dispatch
    heuristic) are re-derived from actual row placement, so they are
    exact for every target shard; the client-feedback arrays
    (``_epoch_counts``/``_epoch_clause_records`` — per-clause popcounts
    that cannot be attributed to rows after the fact) and the load-path
    timings are carried onto shard 0, where only their fleet SUM is ever
    read.

    Placement and accounting go through the same primitives the online
    :class:`SegmentMigration` uses (:func:`_place_loaded` /
    :func:`_place_jit` / :func:`_place_raw` / :func:`_account_rows`) —
    offline reshard is the degenerate migration where every item moves
    into a freshly built store with no concurrent readers.
    """
    src_shards = (store.shards if isinstance(store, ShardedCiaoStore)
                  else [store])
    src0 = src_shards[0]
    cap = segment_capacity or src0.segment_capacity
    current_family = src0.families[src0.plan.epoch]
    out = ShardedCiaoStore(current_family, router=router,
                           segment_capacity=cap)
    # graft the full epoch registry (shared plan objects) onto every shard
    epochs = sorted(src0.plans)
    for sh in out.shards:
        sh.plans = dict(src0.plans)
        sh.families = dict(src0.families)
        sh.plan = src0.plan
        sh.family = current_family
        sh._epoch_records = {e: 0 for e in epochs}
        sh._epoch_counts = {
            e: np.zeros((src0.plans[e].n,), np.int64) for e in epochs}
        sh._epoch_clause_records = {
            e: np.zeros((src0.plans[e].n,), np.int64) for e in epochs}
    # shard 0 carries the fleet-sum-only feedback state
    agg0 = out.shards[0]
    for src in src_shards:
        for e in epochs:
            for attr in ("_epoch_counts", "_epoch_clause_records"):
                v = getattr(src, attr).get(e)
                if v is not None:
                    getattr(agg0, attr)[e] += np.asarray(v, np.int64)
        st = src.stats
        agg0.stats.load_time_s += st.load_time_s
        agg0.stats.parse_time_s += st.parse_time_s
        agg0.stats.jit_time_s += st.jit_time_s
    out.query_log = list(
        store.query_log if isinstance(store, ShardedCiaoStore)
        else src0.query_log)

    def _scatter(recs: list[bytes], objs: list[dict],
                 place: Callable[[int, np.ndarray, list, list], None]
                 ) -> None:
        sid = router.route(objs, recs)
        for s, idx in _split_by_shard(sid, router.n_shards).items():
            sub_recs = [recs[i] for i in idx]
            sub_objs = [objs[i] for i in idx]
            out.summaries[s].update(sub_objs)
            place(s, idx, sub_recs, sub_objs)

    for src in src_shards:
        for seg in src.blocks:
            bits = bitvector.unpack(seg.bitvectors, seg.n_rows)

            def _loaded(s, idx, sub_recs, sub_objs, seg=seg, bits=bits):
                _place_loaded(out.shards[s], seg, idx, sub_recs, sub_objs,
                              bits)
                _account_rows(out.shards[s], seg.epoch, seg.tier, len(idx),
                              loaded=len(idx))

            _scatter(seg.records(), seg.rows, _loaded)
        for seg in src.jit_blocks:
            def _jit(s, idx, sub_recs, sub_objs, seg=seg):
                _place_jit(out.shards[s], seg, sub_recs, sub_objs, cap)
                _account_rows(out.shards[s], seg.epoch, seg.tier, len(idx),
                              jit=len(idx))

            _scatter(seg.records(), seg.rows, _jit)
        for rr in src.raw:
            recs, objs = decode_rows(rr.data, rr.lengths)

            def _raw(s, idx, sub_recs, sub_objs, rr=rr):
                _place_raw(out.shards[s], rr, idx)
                _account_rows(out.shards[s], rr.epoch, rr.tier, len(idx))

            _scatter(recs, objs, _raw)
    return out


def merge_scan_results(results: Sequence[ScanResult]) -> ScanResult:
    """Deterministic scatter-gather merge of per-shard scan results.

    Routed through :func:`repro_torch.dist.collectives.tree_reduce` — the
    association order is fixed by shard position, never by completion
    order — and normalized to the :class:`ScanResult` groups ordering
    contract (ascending (epoch, tier) keys).  Counters sum; per-group
    :class:`TierScan` breakdowns sum field-wise; ``used_skipping`` ORs.
    ``time_s`` is the summed per-shard scan time (the executor overwrites
    it with scatter-gather wall clock).
    """

    def _merge2(a: ScanResult, b: ScanResult) -> ScanResult:
        groups: dict[tuple[int, int], TierScan] = {}
        for src in (a.groups, b.groups):
            for k, g in src.items():
                t = groups.setdefault(k, TierScan())
                t.rows_scanned += g.rows_scanned
                t.rows_skipped += g.rows_skipped
                t.raw_parsed += g.raw_parsed
                t.count += g.count
                t.segments_pruned += g.segments_pruned
        return ScanResult(
            count=a.count + b.count,
            rows_scanned=a.rows_scanned + b.rows_scanned,
            rows_skipped=a.rows_skipped + b.rows_skipped,
            raw_parsed=a.raw_parsed + b.raw_parsed,
            time_s=a.time_s + b.time_s,
            used_skipping=a.used_skipping or b.used_skipping,
            groups=groups,
            segments_pruned=a.segments_pruned + b.segments_pruned,
            segments_scanned=a.segments_scanned + b.segments_scanned,
            shards_scanned=a.shards_scanned + b.shards_scanned,
            shards_pruned=a.shards_pruned + b.shards_pruned,
        )

    # seed with a neutral element: the reduction then always allocates a
    # fresh result, so callers may mutate the merge output even when a
    # single (possibly cached/shared) input was passed
    zero = ScanResult(count=0, rows_scanned=0, rows_skipped=0, raw_parsed=0,
                      time_s=0.0, used_skipping=False)
    merged = collectives.tree_reduce([zero, *results], _merge2)
    merged.sort_groups()
    return merged


class ShardedScanner:
    """Scatter-gather COUNT(*) over a :class:`ShardedCiaoStore`.

    The three-level skipping cascade in execution order:

      1. **partition prune** — shards whose :class:`ShardSummary` refutes
         any query clause are skipped whole (their loaded + JIT segment
         rows land in the merged result as ``rows_skipped``, attributed
         per (epoch, tier) group — the same population a scanned shard
         reports; no JIT promotion happens in a refuted shard, so its
         raw-remainder rows stay out of the accounting on both paths);
      2. **per-shard scan** — surviving shards run the monolithic
         :class:`DataSkippingScanner` (zone-prune -> pushed-bitvector AND
         -> vectorized residual) concurrently on a thread pool;
      3. **deterministic merge** — results gather in stable shard order
         and reduce through :func:`merge_scan_results`.

    Counts are bit-identical to the unsharded oracle by construction
    (rows partition the shards; every level of skipping is sound).
    """

    def __init__(self, store: ShardedCiaoStore, *, log_queries: bool = True,
                 and_reduce: Callable | None = None,
                 max_workers: int | None = None,
                 parallel_threshold_rows: int = 1 << 20,
                 cache: "object | None" = None,
                 telemetry: "TelemetryPlane | bool | None" = None,
                 tenant: str = "default"):
        self.store = store
        self.log_queries = log_queries
        # optional core.batch_scan.ResultCache (duck-typed to avoid the
        # import cycle): per-shard entries under the shared (shard,
        # clauses) keys, validated per shard (epoch, data_version)
        self.cache = cache
        if telemetry is None:
            telemetry = getattr(store, "telemetry", None)
        self.telemetry = telemetry if isinstance(telemetry, TelemetryPlane) \
            else None
        self.tenant = tenant
        self._scanners = [
            DataSkippingScanner(s, log_queries=False, and_reduce=and_reduce,
                                telemetry=False)
            for s in store.shards
        ]
        self._max_workers = max_workers or min(
            store.n_shards, os.cpu_count() or 1)
        # thread dispatch + future gather costs O(100µs)+ per query while
        # the workers contend for the GIL on small per-shard scans: fan
        # out only when the surviving shards hold enough rows (>= 1M by
        # default) for the numpy-released sections to amortize it, else
        # run the shard loop inline (same results, no pool round-trip)
        self.parallel_threshold_rows = parallel_threshold_rows
        self._pool: ThreadPoolExecutor | None = None
        # scan() may run from many serve-plane reader threads at once;
        # without the lock two of them could race _ensure_pool and leak
        # an executor
        self._pool_lock = threading.Lock()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="ciao-shard-scan")
            return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ShardedScanner":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def scan(self, q: Query) -> ScanResult:
        t0 = time.perf_counter()
        store = self.store
        if self.log_queries:
            store.log_query(q)
        run: list[int] = []
        pruned: list[int] = []
        hits: dict[int, ScanResult] = {}
        run_rows = 0
        for s in range(store.n_shards):
            shard = store.shards[s]
            if not (shard.stats.n_records or shard.blocks
                    or shard.jit_blocks or shard.raw):
                continue  # empty shard: contributes nothing
            if store.n_shards > 1 and not store.summaries[s].query_possible(q):
                pruned.append(s)
                continue
            if self.cache is not None:
                r = self.cache.lookup(s, q, epoch=shard.plan.epoch,
                                      data_version=shard.data_version)
                if r is not None:
                    hits[s] = r   # already a private copy
                    continue
            run.append(s)
            run_rows += shard.stats.n_records
        use_pool = (len(run) > 1 and self._max_workers > 1
                    and run_rows >= self.parallel_threshold_rows)
        if use_pool:
            pool = self._ensure_pool()
            futures = [pool.submit(self._scanners[s].scan, q) for s in run]
            scanned = [f.result() for f in futures]  # stable shard order
        else:
            scanned = [self._scanners[s].scan(q) for s in run]
        if self.cache is not None:
            for s, r in zip(run, scanned):
                # post-scan version: the scan's own JIT promotions are
                # folded in, so a valid future hit implies a re-scan
                # would promote nothing and counts stay bit-identical
                self.cache.store(s, q, r, epoch=store.shards[s].plan.epoch,
                                 data_version=store.shards[s].data_version)
        by_shard = dict(zip(run, scanned)) | hits
        results = [by_shard[s] for s in sorted(by_shard)]
        for r in results:
            r.shards_scanned = 1
        if results:
            merged = merge_scan_results(results)
        else:
            merged = ScanResult(count=0, rows_scanned=0, rows_skipped=0,
                                raw_parsed=0, time_s=0.0,
                                used_skipping=False)
        # refuted shards contribute their resident SEGMENT rows (loaded +
        # JIT-promoted) as skipped — the same population a scanned shard
        # reports, so skip rates stay comparable between the pruned and
        # scanned paths (and with the unsharded scanner).  Raw-remainder
        # rows appear on neither path: a scanned shard only surfaces them
        # once promotion parses them (raw_parsed), and a refuted shard
        # never promotes
        for s in pruned:
            merged.shards_pruned += 1
            for (e, t), n in store.shards[s].resident_group_rows().items():
                merged.group(e, t).rows_skipped += n
                merged.rows_skipped += n
        if pruned:
            merged.sort_groups()
        if not results:
            # nothing scanned (all shards pruned or empty): resolve the
            # current epoch's pushdown the way an empty monolithic scan
            # would.  When shards DID run, their merged used_skipping is
            # already correct — the per-shard scanner resolved pushdown
            # per SEGMENT epoch, which a current-epoch-only recomputation
            # here would clobber (e.g. a clause pushed under epoch 0 but
            # dropped by the epoch-1 replan must still report True)
            merged.used_skipping = any(store.pushed_by_epoch(q).values())
        merged.time_s = time.perf_counter() - t0
        if self.telemetry is not None:
            self.telemetry.record_scan(merged, tenant=self.tenant,
                                       cache_hits=len(hits),
                                       cache_misses=len(run))
        return merged
