"""Server side: partial data loading and data skipping (paper §VI).

For each incoming chunk the server loads a record into the columnar store
iff it is valid for >= 1 pushed-down clause (bitwise OR over the chunk's
bit-vectors).  Loaded rows are decomposed into struct-of-arrays *segments*
(``core.columnar``): per-key numeric/dictionary columns with zone maps,
the client clause bit-vectors as per-segment metadata, and the raw JSON
bytes for streaming.  The remaining records stay raw (dense uint8
sub-chunk, zero-copy row selection) for just-in-time loading.

Query path (:class:`DataSkippingScanner`, DESIGN.md §13):
  * segments whose zone map refutes ANY query clause are pruned whole
    (second-level skipping for clauses the client never evaluated);
  * if the query contains >= 1 pushed clause, only loaded segments are
    scanned (sound: clients never produce false negatives => every true
    result row was loaded), and the pushed clauses' bit-vectors are ANDed
    into a candidate mask;
  * surviving rows are re-verified with exact semantics — vectorized over
    whole columns (``columnar.query_mask``; ``matches_exact`` remains
    only as the differential oracle / non-lowerable-term fallback) — then
    popcounted;
  * otherwise loaded segments AND the raw remainder are scanned.  The
    first such query triggers *just-in-time loading* (paper §I): raw
    records are parsed once, promoted to unfiltered segments, and never
    re-parsed.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from . import bitvector
from .client import Chunk
from .columnar import (
    ColumnarSegment, SegmentBuilder, build_segments, decode_rows,
    query_mask, segment_from_packed,
)
from .predicates import Clause, Query, clause_from_obj, clause_to_obj
from .telemetry import TelemetryPlane


class StaleEpochError(ValueError):
    """A chunk evaluated under a superseded plan epoch reached ingest."""


@dataclass
class PushdownPlan:
    """The selected clause set, with stable ids (paper Fig. 2 hashmap).

    ``ids`` are *local* row indices — the position of each clause's
    bitvector row within chunks evaluated under this plan.  ``global_ids``
    are *stable* across plan epochs: a clause that survives a replan keeps
    its global id even when its local row moves, which is what makes
    bitvectors ingested under epoch *k* remain queryable after epoch *k+1*
    (DESIGN.md §11).  Epoch 0 defaults to ``global == local``.
    """

    clauses: list[Clause]
    ids: dict[Clause, int] = field(default_factory=dict)
    epoch: int = 0
    global_ids: dict[Clause, int] = field(default_factory=dict)
    # highest global id ever issued across the whole epoch chain — NOT the
    # max over this plan's survivors: a gid retired two epochs ago must
    # never be re-issued (it would alias another clause's old bitvectors)
    gid_watermark: int = -1

    def __post_init__(self) -> None:
        if not self.ids:
            self.ids = {c: i for i, c in enumerate(self.clauses)}
        if not self.global_ids:
            self.global_ids = dict(self.ids)
        self.gid_watermark = max(
            self.gid_watermark,
            max(self.global_ids.values(), default=-1))

    def pushed_in(self, q: Query) -> list[int]:
        return [self.ids[c] for c in q.clauses if c in self.ids]

    @property
    def n(self) -> int:
        return len(self.clauses)

    def remap_from(self, old: "PushdownPlan") -> np.ndarray:
        """int32[self.n]: new local row -> old local row, -1 if newly pushed.

        Matched on stable global ids, so the table is valid even when a
        clause's local bitvector row moved between epochs.
        """
        by_gid = {old.global_ids[c]: i for c, i in old.ids.items()}
        out = np.full((self.n,), -1, np.int32)
        for c, i in self.ids.items():
            out[i] = by_gid.get(self.global_ids[c], -1)
        return out

    def to_obj(self) -> dict:
        order = sorted(self.ids, key=self.ids.__getitem__)
        return {
            "epoch": self.epoch,
            "clauses": [clause_to_obj(c) for c in order],
            "global_ids": [self.global_ids[c] for c in order],
            "gid_watermark": self.gid_watermark,
        }

    @classmethod
    def from_obj(cls, d: dict) -> "PushdownPlan":
        clauses = [clause_from_obj(t) for t in d["clauses"]]
        return cls(
            clauses=clauses,
            epoch=int(d["epoch"]),
            global_ids=dict(zip(clauses, d["global_ids"])),
            gid_watermark=int(d.get("gid_watermark", -1)),
        )


def evolve_plan(prev: PushdownPlan, clauses: Sequence[Clause]) -> PushdownPlan:
    """Next-epoch plan: surviving clauses keep their stable global ids,
    newly pushed clauses draw fresh ids above the chain-wide watermark (a
    gid retired in ANY earlier epoch is never re-issued)."""
    next_gid = prev.gid_watermark + 1
    gids: dict[Clause, int] = {}
    for c in clauses:
        if c in prev.global_ids:
            gids[c] = prev.global_ids[c]
        else:
            gids[c] = next_gid
            next_gid += 1
    return PushdownPlan(clauses=list(clauses), epoch=prev.epoch + 1,
                        global_ids=gids, gid_watermark=next_gid - 1)


@dataclass
class PlanFamily:
    """Nested budget tiers over ONE epoch's clause universe (paper §VI).

    ``plan`` is the TOP tier: the full clause list in greedy selection
    order, carrying the epoch and the stable global ids.  Tier *t* is the
    prefix of the first ``tier_sizes[t]`` clauses — the nesting invariant
    T0 ⊆ T1 ⊆ … ⊆ Tk lives in local-id space, so a chunk evaluated at
    tier *t* ships bitvector rows for exactly local rows
    ``[0, tier_sizes[t])`` and its coverage is fully described by that one
    prefix length (``n_covered``).  Lower tiers therefore need no plan
    objects of their own: they are index-prefix views of the top tier,
    which is also what lets every tier share one compiled kernel
    (``kernels.plan.tier_view``).
    """

    plan: PushdownPlan
    tier_sizes: tuple[int, ...]
    budgets: tuple[float, ...] = ()       # per-tier budget cut-points (µs)
    tier_costs: tuple[float, ...] = ()    # modeled µs/record per tier
    tier_values: tuple[float, ...] = ()   # expected benefit f(Tt) per tier

    def __post_init__(self) -> None:
        self.tier_sizes = tuple(int(s) for s in self.tier_sizes)
        if not self.tier_sizes:
            raise ValueError("a PlanFamily needs >= 1 tier")
        if any(s < 0 for s in self.tier_sizes) or any(
                b < a for a, b in zip(self.tier_sizes, self.tier_sizes[1:])):
            raise ValueError(
                f"tier sizes must be non-negative and ascending "
                f"(nested tiers): {self.tier_sizes}")
        if self.tier_sizes[-1] != self.plan.n:
            raise ValueError(
                f"top tier must cover the whole plan: sizes "
                f"{self.tier_sizes} vs {self.plan.n} clauses")
        for name in ("budgets", "tier_costs", "tier_values"):
            v = tuple(float(x) for x in getattr(self, name))
            if v and len(v) != len(self.tier_sizes):
                raise ValueError(f"{name} must have one entry per tier")
            setattr(self, name, v)

    @property
    def n_tiers(self) -> int:
        return len(self.tier_sizes)

    @property
    def epoch(self) -> int:
        return self.plan.epoch

    @property
    def top_tier(self) -> int:
        return self.n_tiers - 1

    def tier_clauses(self, tier: int) -> list[Clause]:
        return self.plan.clauses[: self.tier_sizes[tier]]

    def coverage_gids(self, n_covered: int) -> frozenset[int]:
        """Global clause ids covered by the first ``n_covered`` local rows."""
        return frozenset(
            self.plan.global_ids[c]
            for c, i in self.plan.ids.items() if i < n_covered
        )

    def to_obj(self) -> dict:
        return {
            "tier_sizes": list(self.tier_sizes),
            "budgets": list(self.budgets),
            "tier_costs": list(self.tier_costs),
            "tier_values": list(self.tier_values),
        }

    @classmethod
    def from_obj(cls, plan: PushdownPlan, d: dict) -> "PlanFamily":
        return cls(plan=plan, tier_sizes=tuple(d["tier_sizes"]),
                   budgets=tuple(d.get("budgets", ())),
                   tier_costs=tuple(d.get("tier_costs", ())),
                   tier_values=tuple(d.get("tier_values", ())))


def trivial_family(plan: PushdownPlan) -> PlanFamily:
    """Single-tier family: every client runs the whole plan."""
    return PlanFamily(plan=plan, tier_sizes=(plan.n,))


def resolve_ingest_coverage(
    plan: PushdownPlan, family: PlanFamily, *, n_records: int,
    bitvecs: "np.ndarray | bitvector.ChunkBitvectors",
    epoch: int | None, tier: int | None,
) -> tuple[int, int]:
    """Validate one chunk's ingest claim; returns ``(tier_idx, n_cov)``.

    The shared pre-state gate for every store front-end (the monolithic
    :class:`CiaoStore` and the sharded plane's ``ShardedCiaoStore``): a
    stale epoch, an out-of-range tier, or bitvector dimensions that
    contradict the claimed coverage must all raise BEFORE any store state
    is touched, so a rejected ingest can never corrupt record totals or
    observed selectivities.
    """
    if epoch is not None and epoch != plan.epoch:
        raise StaleEpochError(
            f"chunk evaluated under epoch {epoch}, store is at epoch "
            f"{plan.epoch} (re-evaluate under the current plan)")
    if tier is None:
        tier_idx = family.top_tier
        n_cov = plan.n
    else:
        if not 0 <= tier < family.n_tiers:
            raise ValueError(
                f"tier {tier} out of range: family has "
                f"{family.n_tiers} tiers")
        tier_idx = int(tier)
        n_cov = family.tier_sizes[tier_idx]
    if isinstance(bitvecs, bitvector.ChunkBitvectors):
        if bitvecs.n_records != n_records:
            raise ValueError(
                f"bitvectors cover {bitvecs.n_records} records, "
                f"chunk has {n_records}")
        n_cl = bitvecs.words.shape[0]
    else:
        raw = np.asarray(bitvecs)
        n_cl = raw.shape[0]
        if n_cl and raw.shape[-1] != bitvector.num_words(n_records):
            raise ValueError(
                f"bitvector words cover {raw.shape[-1] * 32} records, "
                f"chunk has {n_records}")
    if n_cl != n_cov:
        raise ValueError(
            f"bitvectors cover {n_cl} clauses, tier {tier_idx} of the "
            f"epoch-{plan.epoch} plan covers {n_cov} (stale client "
            f"plan/tier?)")
    return tier_idx, n_cov


def evolve_family(
    prev: "PlanFamily | PushdownPlan",
    order: Sequence[Clause],
    tier_sizes: Sequence[int],
    *,
    budgets: Sequence[float] = (),
    tier_costs: Sequence[float] = (),
    tier_values: Sequence[float] = (),
) -> PlanFamily:
    """Next-epoch family: the top tier evolves via :func:`evolve_plan`
    (stable gids), lower tiers are fresh prefix cut-points of the new
    greedy order.  Nesting holds per epoch by construction; across epochs
    each tier's coverage is reconciled through the remap table exactly
    like a whole plan's."""
    prev_plan = prev.plan if isinstance(prev, PlanFamily) else prev
    return PlanFamily(
        plan=evolve_plan(prev_plan, order),
        tier_sizes=tuple(tier_sizes),
        budgets=tuple(budgets),
        tier_costs=tuple(tier_costs),
        tier_values=tuple(tier_values),
    )


@dataclass
class RawRemainder:
    """Unloaded rows of one chunk, kept as a dense uint8 sub-chunk.

    ``epoch``/``n_covered``: these rows matched NO clause among the first
    ``n_covered`` local rows of that epoch's plan — they are skippable
    exactly for queries with >= 1 clause pushed *within that coverage*.
    A low-tier remainder (small ``n_covered``) may still hold matches for
    clauses outside its tier, so coverage must gate every skip decision.
    """

    data: np.ndarray      # uint8[R, L]
    lengths: np.ndarray   # int32[R]
    epoch: int = 0
    n_covered: int = -1
    tier: int = 0

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    def record(self, i: int) -> bytes:
        return self.data[i, : self.lengths[i]].tobytes()

    def records(self) -> list[bytes]:
        return [self.record(i) for i in range(self.n)]


@dataclass
class LoadStats:
    n_records: int = 0
    n_loaded: int = 0
    n_jit_loaded: int = 0
    load_time_s: float = 0.0
    parse_time_s: float = 0.0
    jit_time_s: float = 0.0

    @property
    def loading_ratio(self) -> float:
        return self.n_loaded / self.n_records if self.n_records else 0.0

    def add(self, other: "LoadStats") -> "LoadStats":
        """Accumulate ``other`` field-wise (fleet aggregation); returns
        self.  The single summing rule for every multi-store aggregator —
        a new counter added here propagates everywhere."""
        self.n_records += other.n_records
        self.n_loaded += other.n_loaded
        self.n_jit_loaded += other.n_jit_loaded
        self.load_time_s += other.load_time_s
        self.parse_time_s += other.parse_time_s
        self.jit_time_s += other.jit_time_s
        return self


class CiaoStore:
    """Columnar segments + raw remainder + per-segment bitvector metadata.

    In the sharded store plane (DESIGN.md §14) this class is the
    PER-SHARD segment store: ``repro_torch.core.shard.ShardedCiaoStore`` routes
    ingest across N of these and aggregates their statistics; a plain
    ``CiaoStore`` remains the N=1 degenerate case and the differential
    oracle every sharded scan is count-checked against.

    The store is *epoch-versioned* (DESIGN.md §11): it keeps a registry of
    every plan epoch it has ingested under, per-epoch clause statistics,
    and tags segments/remainders with their ingest epoch so data loaded
    under epoch *k* stays queryable (and skippable) after a replan to
    *k+1*.  Loaded rows live in struct-of-arrays
    :class:`~repro_torch.core.columnar.ColumnarSegment` groups: one open
    :class:`SegmentBuilder` per ``(epoch, n_covered, tier)`` coverage
    group compacts small per-chunk row sets into segments of
    ``segment_capacity`` rows (DESIGN.md §13).
    """

    def __init__(self, plan: "PushdownPlan | PlanFamily", *,
                 segment_capacity: int = 8192):
        if isinstance(plan, PlanFamily):
            family = plan
            plan = family.plan
        else:
            family = trivial_family(plan)
        self.plan = plan                       # current epoch's plan
        self.family = family                   # current epoch's tier family
        self.plans: dict[int, PushdownPlan] = {plan.epoch: plan}
        self.families: dict[int, PlanFamily] = {plan.epoch: family}
        self.segment_capacity = int(segment_capacity)
        self.segments: list[ColumnarSegment] = []      # sealed, seal order
        self._builders: dict[tuple[int, int, int], SegmentBuilder] = {}
        self._touch = 0                                # builder LRU order
        self.raw: list[RawRemainder] = []
        self.jit_segments: list[ColumnarSegment] = []  # promoted raw rows
        self.stats = LoadStats()
        # per-clause match totals (client popcounts) PER EPOCH:
        # observed-selectivity feedback for the replanner (paper §V)
        self._epoch_counts: dict[int, np.ndarray] = {
            plan.epoch: np.zeros((plan.n,), np.int64)
        }
        self._epoch_records: dict[int, int] = {plan.epoch: 0}
        # per-clause record denominators: with tiered ingest a clause is
        # only evaluated on chunks whose coverage includes it, so observed
        # selectivity needs a PER-CLAUSE denominator, not the epoch total
        self._epoch_clause_records: dict[int, np.ndarray] = {
            plan.epoch: np.zeros((plan.n,), np.int64)
        }
        # per-(epoch, tier) ingest attribution (benchmarks + allocator)
        self.group_records: dict[tuple[int, int], int] = {}
        self.group_loaded: dict[tuple[int, int], int] = {}
        # query feedback for workload re-estimation (replan control plane);
        # bounded: consumers only ever read a recent window
        self.query_log: list[Query] = []
        self.query_log_cap = 4096
        # monotonic counter bumped whenever the resident segment surface
        # changes (ingest, JIT promotion, restore) — the device segment
        # cache (DESIGN.md §15) keys its sync fast-path on it, and the
        # result cache (DESIGN.md §16) validates entries against it, so
        # an ingest or promotion invalidates every cached answer
        self.data_version = 0
        # per-tenant/per-tier scan + ingest statistics (DESIGN.md §16);
        # scanners built over this store record into it by default
        self.telemetry = TelemetryPlane()
        # per-key layout policy (DESIGN.md §18): when set, NEW builder
        # segments eagerly columnarize only these keys; the rest stay raw
        # per segment until a scan first touches them.  Runtime knob
        # (tuner-owned) — None means eager-everything, and already-built
        # segments are unaffected.
        self.layout_eager_keys: frozenset[str] | None = None
        # serializes every mutation of the resident surface (ingest, JIT
        # promotion, epoch advance) and the snapshot() read point, so a
        # snapshot can never observe a half-applied seal-then-extend
        # sequence (DESIGN.md §17).  Reentrant: promote_uncovered_raw
        # calls jit_load_raw under the same lock.  Scans themselves never
        # take it — readers go through immutable snapshots.
        self._ingest_lock = threading.RLock()

    # -- segment surface -----------------------------------------------------
    def _builder(self, epoch: int, n_covered: int, tier: int
                 ) -> SegmentBuilder:
        key = (epoch, n_covered, tier)
        b = self._builders.get(key)
        if b is None:
            b = self._builders[key] = SegmentBuilder(
                epoch=epoch, n_covered=n_covered, tier=tier,
                capacity=self.segment_capacity,
                eager_keys=self.layout_eager_keys)
        self._touch += 1
        b.touch_seq = self._touch
        return b

    @property
    def blocks(self) -> list[ColumnarSegment]:
        """Queryable loaded segments: sealed first, then the open builder
        tails in last-touched order (so ``blocks[-1]`` is the most recent
        ingest's coverage group).  Builder views are cached until their
        next append — repeated scans between ingests pay the column build
        once."""
        open_tails = sorted(
            (b for b in self._builders.values() if b.n_rows),
            key=lambda b: b.touch_seq)
        return self.segments + [b.view() for b in open_tails]

    @property
    def jit_blocks(self) -> list[ColumnarSegment]:
        """Promoted raw remainders (no bitvectors), promotion order."""
        return self.jit_segments

    def resident_group_rows(self) -> dict[tuple[int, int], int]:
        """Per-(epoch, tier) row counts over the queryable segments —
        sealed + open-builder + JIT-promoted, i.e. exactly the population
        a scan reports as scanned/skipped.  Counts come from segment and
        builder attributes, NOT ``blocks``: a partition-pruned shard must
        account its residents without materializing open builder views
        (a column build per open coverage group, invalidated by every
        ingest) for rows nobody will touch."""
        out: dict[tuple[int, int], int] = {}
        # list() the live containers: a concurrent ingest appending to
        # them must not blow up this read-only accounting pass
        for seg in (*list(self.segments), *list(self.jit_segments)):
            k = (seg.epoch, seg.tier)
            out[k] = out.get(k, 0) + seg.n_rows
        for b in list(self._builders.values()):
            if b.n_rows:
                k = (b.epoch, b.tier)
                out[k] = out.get(k, 0) + b.n_rows
        return out

    @property
    def epoch(self) -> int:
        return self.plan.epoch

    def stats_report(self) -> dict:
        """JSON-able operational snapshot: load stats, resident surface,
        and the full per-tenant/per-tier telemetry plane (DESIGN.md §16).
        The monitoring endpoint every front-end exposes — the sharded
        plane's report nests one of these per shard.

        Taken under the ingest lock so a concurrent ingest can't tear the
        counters mid-report (DESIGN.md §17)."""
        with self._ingest_lock:
            return self._stats_report_locked()

    def _stats_report_locked(self) -> dict:
        s = self.stats
        return {
            "epoch": self.plan.epoch,
            "data_version": self.data_version,
            "load": {
                "n_records": s.n_records,
                "n_loaded": s.n_loaded,
                "n_jit_loaded": s.n_jit_loaded,
                "loading_ratio": round(s.loading_ratio, 4),
                "load_time_s": round(s.load_time_s, 6),
                "parse_time_s": round(s.parse_time_s, 6),
                "jit_time_s": round(s.jit_time_s, 6),
            },
            "resident_group_rows": {
                f"{e},{t}": n
                for (e, t), n in sorted(self.resident_group_rows().items())
            },
            "telemetry": self.telemetry.snapshot(),
        }

    @property
    def clause_counts(self) -> np.ndarray:
        """int64[P]: current epoch's per-clause match totals (live view)."""
        return self._epoch_counts[self.plan.epoch]

    @clause_counts.setter
    def clause_counts(self, value: np.ndarray) -> None:
        self._epoch_counts[self.plan.epoch] = np.asarray(value, np.int64)

    def epoch_records(self, epoch: int | None = None) -> int:
        """Records ingested under one epoch (current epoch by default)."""
        return self._epoch_records[self.plan.epoch if epoch is None else epoch]

    def clause_records(self, epoch: int | None = None) -> np.ndarray:
        """int64[P]: records whose coverage reached each clause's local row.

        The per-clause denominator behind :meth:`observed_selectivities` —
        under tiered ingest a clause outside every produced tier has a
        ZERO count, and its observed selectivity of 0 is an artifact of
        no coverage, not a measurement.  Consumers (the replanner's drift
        detector) must gate on this before trusting the observation.
        """
        e = self.plan.epoch if epoch is None else epoch
        return self._epoch_clause_records[e]

    def observed_selectivities(self, epoch: int | None = None) -> np.ndarray:
        """float64[P]: fraction of records matching each clause.

        Per-clause denominators: under tiered ingest, clause *i* is only
        evaluated on chunks whose coverage reaches past local row *i*, so
        its selectivity is counts[i] / records-that-covered-i.  With
        full-coverage ingest every denominator equals the epoch record
        total (the pre-tier behaviour).
        """
        e = self.plan.epoch if epoch is None else epoch
        denom = np.maximum(self._epoch_clause_records[e], 1)
        return self._epoch_counts[e] / denom

    # -- plan epochs ---------------------------------------------------------
    def advance_epoch(self, new_plan: "PushdownPlan | PlanFamily") -> np.ndarray:
        """Install the next plan epoch; returns the new->old remap table.

        Accepts a bare :class:`PushdownPlan` (single-tier deployments) or
        a :class:`PlanFamily` (the family's top tier IS the plan).
        Existing blocks keep their old-epoch bitvectors and stay queryable
        through the registry; new ingests must arrive tagged with the new
        epoch.  Per-epoch stats start fresh so observed selectivities track
        the *current* plan, not a mixture.
        """
        if isinstance(new_plan, PlanFamily):
            family = new_plan
            new_plan = family.plan
        else:
            family = trivial_family(new_plan)
        with self._ingest_lock:
            if new_plan.epoch <= self.plan.epoch:
                raise ValueError(
                    f"epoch must advance: "
                    f"{new_plan.epoch} <= {self.plan.epoch}")
            remap = new_plan.remap_from(self.plan)
            self.plans[new_plan.epoch] = new_plan
            self.families[new_plan.epoch] = family
            self.plan = new_plan
            self.family = family
            self._epoch_counts[new_plan.epoch] = np.zeros(
                (new_plan.n,), np.int64)
            self._epoch_records[new_plan.epoch] = 0
            self._epoch_clause_records[new_plan.epoch] = np.zeros(
                (new_plan.n,), np.int64)
            return remap

    def remap_table(self, from_epoch: int, to_epoch: int) -> np.ndarray:
        """int32[plans[to].n]: to-epoch local row -> from-epoch row or -1."""
        return self.plans[to_epoch].remap_from(self.plans[from_epoch])

    # -- query-path helpers (shared by scanner and recipe batcher) -----------
    def log_query(self, q: Query) -> None:
        self.query_log.append(q)
        if len(self.query_log) > 2 * self.query_log_cap:
            del self.query_log[:-self.query_log_cap]

    def pushed_by_epoch(self, q: Query) -> "_EpochPushdown":
        """Pushed ∩ covered local bitvector rows, per (epoch, coverage).

        Indexed two ways: ``m[epoch]`` gives the query's pushed local rows
        under that epoch's full plan, and ``m[(epoch, n_covered)]`` the
        subset a block with that coverage actually indexes — pushed ∩
        covered, THE (epoch, tier)-skippability invariant (DESIGN.md §12);
        every query path must resolve pushdown through it.  The map
        resolves lazily through the live registry, so a block ingested
        under an epoch created after the map was built (replan racing a
        partially-consumed scan/batch iterator) still resolves instead of
        failing.
        """
        m = _EpochPushdown(self, q)
        m[self.plan.epoch]  # current epoch always resolved (used_skipping)
        return m

    def promote_uncovered_raw(
        self, pushed: "_EpochPushdown",
    ) -> dict[tuple[int, int], int]:
        """JIT-promote raw remainders whose coverage misses the query.

        Rows in a remainder from epoch *e* at coverage *k* matched none of
        the first *k* clauses of that epoch's plan, so they can only be
        skipped when >= 1 query clause was pushed *within that coverage*;
        every other remainder may hold matches and is parsed exactly once.
        Returns rows promoted per (epoch, tier) group.
        """
        stale = {(rr.epoch, rr.n_covered) for rr in self.raw
                 if not pushed[(rr.epoch, rr.n_covered)]}
        if not stale:
            return {}
        return self.jit_load_raw(only_groups=stale)

    # -- ingest -------------------------------------------------------------
    def ingest_chunk(
        self, chunk: Chunk,
        bitvecs: np.ndarray | bitvector.ChunkBitvectors,
        *, epoch: int | None = None, tier: int | None = None,
        objs: Sequence[dict] | None = None,
    ) -> LoadStats:
        """Partial loading of one chunk.

        Accepts either raw ``uint32[P, W]`` client bit-vectors, or the full
        :class:`~repro_torch.core.bitvector.ChunkBitvectors` a fused engine pass
        emits — in that case the load mask arrives precomputed (the kernel
        already OR'd the clauses on device) and no host reduction runs.

        ``epoch`` tags which plan epoch the client evaluated under; a chunk
        carrying a superseded epoch raises :class:`StaleEpochError` before
        any state is touched (the coordinator re-evaluates it under the
        current plan).  ``None`` means "current epoch" (single-plan
        deployments never notice epochs).

        ``tier`` tags which family tier the client evaluated: the chunk's
        coverage mask is the tier's clause prefix, and the bitvector clause
        dimension must equal ``family.tier_sizes[tier]`` exactly — a
        mismatched coverage claim is rejected before any state is touched.
        ``None`` means full coverage (the top tier).

        ``objs`` optionally supplies already-parsed row objects aligned to
        the chunk's rows (the shard router parses once for routing +
        partition metadata); loaded rows then skip the ingest re-parse.

        Thread-safety: the whole mutation runs under ``_ingest_lock``.
        The store supports ONE concurrent writer stream (the serve plane's
        per-shard writer queues guarantee this); the lock exists so
        ``snapshot()`` taken from reader threads sees a consistent surface.
        """
        with self._ingest_lock:
            return self._ingest_chunk_locked(
                chunk, bitvecs, epoch=epoch, tier=tier, objs=objs)

    def _ingest_chunk_locked(
        self, chunk: Chunk,
        bitvecs: np.ndarray | bitvector.ChunkBitvectors,
        *, epoch: int | None, tier: int | None,
        objs: Sequence[dict] | None,
    ) -> LoadStats:
        t0 = time.perf_counter()
        n = chunk.n_records
        e = self.plan.epoch
        # validate epoch, tier coverage AND both dimensions BEFORE touching
        # stats: a rejected ingest must not corrupt n_records / observed
        # selectivities
        tier_idx, n_cov = resolve_ingest_coverage(
            self.plan, self.family, n_records=n, bitvecs=bitvecs,
            epoch=epoch, tier=tier)
        self.stats.n_records += n
        self._epoch_records[e] += n
        self._epoch_clause_records[e][:n_cov] += n
        gkey = (e, tier_idx)
        self.group_records[gkey] = self.group_records.get(gkey, 0) + n
        any_words: np.ndarray | None = None
        if isinstance(bitvecs, bitvector.ChunkBitvectors):
            any_words = bitvecs.or_words
            self.clause_counts[:n_cov] += bitvecs.counts
            bitvecs = bitvecs.words
        elif n_cov:
            self.clause_counts[:n_cov] += bitvector.popcount_rows(bitvecs)
        if self.plan.n == 0:
            # no plan at all: the store degenerates to full upfront loading
            load_idx = np.arange(n)
            keep_idx = np.array([], dtype=np.int64)
            bits = np.zeros((0, n), bool)
        elif n_cov == 0:
            # an EMPTY tier of a non-empty plan pushes nothing: every row
            # stays raw (zero coverage — never skippable, JIT-loaded on
            # the first query that needs it)
            load_idx = np.array([], dtype=np.int64)
            keep_idx = np.arange(n)
            bits = np.zeros((0, 0), bool)
        else:
            if any_words is None:
                any_words = bitvector.bv_or_many(bitvecs)
            load_mask = bitvector.unpack(any_words, n)
            load_idx = np.nonzero(load_mask)[0]
            keep_idx = np.nonzero(~load_mask)[0]
            bits = bitvector.unpack(bitvecs, n)[:, load_idx]

        if len(load_idx):
            # batched parse: ONE fancy-indexed sub-array copy, record bytes
            # as buffer slices, parsed objects straight into the columnar
            # builder (no per-row chunk.record() round-trips)
            tp0 = time.perf_counter()
            recs, sel_objs = decode_rows(chunk.data, chunk.lengths, load_idx,
                                         objs=objs)
            self.segments.extend(
                self._builder(e, n_cov, tier_idx).add(recs, sel_objs, bits))
            self.stats.parse_time_s += time.perf_counter() - tp0
        if len(keep_idx):
            self.raw.append(
                RawRemainder(
                    data=chunk.data[keep_idx],          # numpy fancy-index, O(bytes)
                    lengths=chunk.lengths[keep_idx],
                    epoch=e, n_covered=n_cov, tier=tier_idx,
                )
            )
        self.stats.n_loaded += int(len(load_idx))
        self.group_loaded[gkey] = (
            self.group_loaded.get(gkey, 0) + int(len(load_idx)))
        self.data_version += 1
        self.stats.load_time_s += time.perf_counter() - t0
        return self.stats

    # -- just-in-time loading (paper §I) -------------------------------------
    def jit_load_raw(
        self, only_epochs: set[int] | None = None,
        *, only_groups: set[tuple[int, int]] | None = None,
    ) -> dict[tuple[int, int], int]:
        """Parse raw remainders once, promoting them to unfiltered segments.

        ``only_epochs`` restricts promotion to remainders ingested under
        those epochs; ``only_groups`` to ``(epoch, n_covered)`` coverage
        groups (the scanner promotes exactly the groups whose coverage
        pushes none of a query's clauses); ``None``/``None`` promotes
        everything.  Returns rows promoted per ``(epoch, tier)``.
        """
        with self._ingest_lock:
            return self._jit_load_raw_locked(
                only_epochs, only_groups=only_groups)

    def _jit_load_raw_locked(
        self, only_epochs: set[int] | None = None,
        *, only_groups: set[tuple[int, int]] | None = None,
    ) -> dict[tuple[int, int], int]:
        promoted: dict[tuple[int, int], int] = {}
        if not self.raw:
            return promoted
        t0 = time.perf_counter()
        keep: list[RawRemainder] = []
        # compact BEFORE building: remainders arrive one per chunk, and a
        # segment per chunk-remainder would fragment the query path into
        # hundreds of tiny segments — group rows by full coverage key and
        # build capacity-bounded segments over the concatenation
        grouped: dict[tuple[int, int, int], tuple[list, list]] = {}
        for rr in self.raw:
            if only_epochs is not None and rr.epoch not in only_epochs:
                keep.append(rr)
                continue
            if only_groups is not None and \
                    (rr.epoch, rr.n_covered) not in only_groups:
                keep.append(rr)
                continue
            recs, objs = decode_rows(rr.data, rr.lengths)
            g = grouped.setdefault((rr.epoch, rr.n_covered, rr.tier),
                                   ([], []))
            g[0].extend(recs)
            g[1].extend(objs)
            self.stats.n_jit_loaded += rr.n
            key = (rr.epoch, rr.tier)
            promoted[key] = promoted.get(key, 0) + rr.n
        for (epoch, n_cov, tier), (recs, objs) in grouped.items():
            self.jit_segments.extend(build_segments(
                recs, np.zeros((0, len(recs)), bool), objs=objs,
                epoch=epoch, n_covered=n_cov, tier=tier,
                capacity=self.segment_capacity))
        self.raw = keep
        if promoted:
            self.data_version += 1
        self.stats.jit_time_s += time.perf_counter() - t0
        return promoted

    # -- consistent reads (async serve plane, DESIGN.md §17) -----------------
    def snapshot(self) -> "StoreSnapshot":
        """Pin an immutable ``(epoch, data_version)`` view of the store.

        Taken under the ingest lock, so the snapshot observes every
        fully-applied ingest and nothing of any in-flight one.  Sealed
        segments are shared by reference (immutable once built); open
        builder tails are captured as their current frozen views — a
        builder's ``view()`` object is never mutated, the next append
        *replaces* it.  Scanners built over the snapshot therefore see a
        store that never changes while live ingest continues on the
        parent (DESIGN.md §17).
        """
        with self._ingest_lock:
            return StoreSnapshot(self)

    # -- persistence (ingest checkpointing) ----------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the FULL store state.

        Persists what the replan control plane depends on surviving a
        restart: the plan-epoch registry, per-epoch clause counts and
        record totals (observed selectivities), and :class:`LoadStats` —
        previously these were silently dropped, so
        ``observed_selectivities()`` returned zeros after a restore.
        """
        stats = self.stats
        meta = {
            "format": 4,
            "segment_capacity": self.segment_capacity,
            "current_epoch": self.plan.epoch,
            "plans": [self.plans[e].to_obj() for e in sorted(self.plans)],
            "families": {
                str(e): f.to_obj() for e, f in self.families.items()
            },
            "epoch_records": {str(e): n for e, n in self._epoch_records.items()},
            "epoch_counts": {
                str(e): c.tolist() for e, c in self._epoch_counts.items()
            },
            "epoch_clause_records": {
                str(e): c.tolist()
                for e, c in self._epoch_clause_records.items()
            },
            "group_records": [
                [e, t, n] for (e, t), n in self.group_records.items()
            ],
            "group_loaded": [
                [e, t, n] for (e, t), n in self.group_loaded.items()
            ],
            "stats": {
                "n_records": stats.n_records,
                "n_loaded": stats.n_loaded,
                "n_jit_loaded": stats.n_jit_loaded,
                "load_time_s": stats.load_time_s,
                "parse_time_s": stats.parse_time_s,
                "jit_time_s": stats.jit_time_s,
            },
            # the workload-feedback window (coverage drift survives restore)
            "query_log": [
                {"freq": q.freq, "clauses": [clause_to_obj(c)
                                             for c in q.clauses]}
                for q in self.query_log[-self.query_log_cap:]
            ],
        }
        blocks = self.blocks          # sealed + open tails, query order
        jit = self.jit_segments
        payload: dict[str, Any] = {
            "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            "n_blocks": np.array(len(blocks)),
            "block_epochs": np.array([b.epoch for b in blocks], np.int64),
            "block_ncov": np.array([b.n_covered for b in blocks], np.int64),
            "block_tiers": np.array([b.tier for b in blocks], np.int64),
            "n_raw": np.array(len(self.raw)),
            "raw_epochs": np.array([r.epoch for r in self.raw], np.int64),
            "raw_ncov": np.array([r.n_covered for r in self.raw], np.int64),
            "raw_tiers": np.array([r.tier for r in self.raw], np.int64),
            "n_jit": np.array(len(jit)),
            "jit_epochs": np.array([b.epoch for b in jit], np.int64),
            "jit_ncov": np.array([b.n_covered for b in jit], np.int64),
            "jit_tiers": np.array([b.tier for b in jit], np.int64),
        }
        # format 4: segments persist their raw JSON bytes (blob + offsets)
        # and packed bitvector words; columns are rebuilt at load time from
        # the bytes (one deterministic parse — cheaper than persisting
        # every dictionary/mask array, and immune to column layout drift)
        for bi, seg in enumerate(blocks):
            payload[f"bv_{bi}"] = seg.bitvectors
            payload[f"seg_blob_{bi}"] = seg.raw_blob
            payload[f"seg_off_{bi}"] = seg.raw_offsets
        for ri, rr in enumerate(self.raw):
            payload[f"raw_data_{ri}"] = rr.data
            payload[f"raw_len_{ri}"] = rr.lengths
        for ji, seg in enumerate(jit):
            payload[f"jit_blob_{ji}"] = seg.raw_blob
            payload[f"jit_off_{ji}"] = seg.raw_offsets
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str, plan: PushdownPlan | None = None) -> "CiaoStore":
        """Restore a checkpoint.

        ``plan`` is optional: the plan registry is persisted, so the saved
        current plan is used when omitted.  When given, it must match the
        saved current plan's clause set (a checkpoint restored under a
        different plan would silently mis-index bitvector rows).
        """
        z = np.load(path)
        if "meta" not in getattr(z, "files", ()):
            raise ValueError(
                f"{path}: unsupported checkpoint format (pre-epoch format 1 "
                "has no plan registry / feedback state); re-ingest and save "
                "with this version")

        def _blob_records(blob: np.ndarray, off: np.ndarray) -> list[bytes]:
            b = blob.tobytes()
            return [b[off[i]: off[i + 1]] for i in range(len(off) - 1)]

        def _legacy_records(rows_json: np.ndarray
                            ) -> tuple[list[bytes], list[dict]]:
            # format-2/3 migration: blocks persisted parsed row dicts; the
            # canonical writer encoding reconstructs the raw bytes segments
            # keep (datasets emit exactly this form)
            rows = json.loads(bytes(rows_json.tobytes()).decode())
            recs = [json.dumps(r, separators=(",", ":")).encode()
                    for r in rows]
            return recs, rows
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        plans = [PushdownPlan.from_obj(p) for p in meta["plans"]]
        by_epoch = {p.epoch: p for p in plans}
        current = by_epoch[meta["current_epoch"]]
        if plan is not None:
            if list(plan.clauses) != list(current.clauses):
                raise ValueError(
                    "checkpoint was saved under a different plan "
                    f"(epoch {current.epoch}, {current.n} clauses)")
            current = plan if plan.epoch == current.epoch else current
        families = {
            int(e): PlanFamily.from_obj(by_epoch[int(e)], f)
            for e, f in meta.get("families", {}).items()
        }
        store = cls(families.get(current.epoch, current),
                    segment_capacity=int(meta.get("segment_capacity", 8192)))
        store.plan = current
        store.plans = by_epoch | {current.epoch: current}
        store.families = {
            e: families.get(e, trivial_family(p))
            for e, p in store.plans.items()
        }
        store.family = store.families[current.epoch]
        store._epoch_records = {
            int(e): int(n) for e, n in meta["epoch_records"].items()
        }
        store._epoch_counts = {
            int(e): np.asarray(c, dtype=np.int64)
            for e, c in meta["epoch_counts"].items()
        }
        if "epoch_clause_records" in meta:
            store._epoch_clause_records = {
                int(e): np.asarray(c, dtype=np.int64)
                for e, c in meta["epoch_clause_records"].items()
            }
        else:  # format-2 checkpoint: every ingest was full-coverage
            store._epoch_clause_records = {
                e: np.full((store.plans[e].n,), n, np.int64)
                for e, n in store._epoch_records.items()
            }
        store.group_records = {
            (int(e), int(t)): int(n)
            for e, t, n in meta.get("group_records", [])
        }
        store.group_loaded = {
            (int(e), int(t)): int(n)
            for e, t, n in meta.get("group_loaded", [])
        }
        store.query_log = [
            Query(tuple(clause_from_obj(c) for c in q["clauses"]),
                  freq=float(q["freq"]))
            for q in meta.get("query_log", [])
        ]
        s = meta["stats"]
        store.stats = LoadStats(
            n_records=int(s["n_records"]), n_loaded=int(s["n_loaded"]),
            n_jit_loaded=int(s["n_jit_loaded"]),
            load_time_s=float(s["load_time_s"]),
            parse_time_s=float(s["parse_time_s"]),
            jit_time_s=float(s["jit_time_s"]),
        )
        files = set(getattr(z, "files", ()))

        def _meta_col(name: str, epochs: np.ndarray) -> np.ndarray:
            if name in files:
                return z[name]
            # format-2 checkpoint: full coverage of each item's own epoch
            if name.endswith("ncov"):
                return np.array([store.plans[int(e)].n for e in epochs],
                                np.int64)
            return np.zeros((len(epochs),), np.int64)

        block_epochs = z["block_epochs"]
        block_ncov = _meta_col("block_ncov", block_epochs)
        block_tiers = _meta_col("block_tiers", block_epochs)
        for bi in range(int(z["n_blocks"])):
            if f"seg_blob_{bi}" in files:      # format 4
                recs = _blob_records(z[f"seg_blob_{bi}"], z[f"seg_off_{bi}"])
                objs = None
            else:                              # format 2/3 migration
                recs, objs = _legacy_records(z[f"rows_{bi}"])
            store.segments.append(segment_from_packed(
                recs, z[f"bv_{bi}"], objs=objs,
                epoch=int(block_epochs[bi]),
                n_covered=int(block_ncov[bi]),
                tier=int(block_tiers[bi])))
        raw_epochs = z["raw_epochs"]
        raw_ncov = _meta_col("raw_ncov", raw_epochs)
        raw_tiers = _meta_col("raw_tiers", raw_epochs)
        for ri in range(int(z["n_raw"])):
            store.raw.append(
                RawRemainder(data=z[f"raw_data_{ri}"],
                             lengths=z[f"raw_len_{ri}"],
                             epoch=int(raw_epochs[ri]),
                             n_covered=int(raw_ncov[ri]),
                             tier=int(raw_tiers[ri]))
            )
        jit_epochs = z["jit_epochs"]
        jit_ncov = _meta_col("jit_ncov", jit_epochs)
        jit_tiers = _meta_col("jit_tiers", jit_epochs)
        for ji in range(int(z["n_jit"])):
            if f"jit_blob_{ji}" in files:      # format 4
                recs = _blob_records(z[f"jit_blob_{ji}"], z[f"jit_off_{ji}"])
                objs = None
            else:                              # format 2/3 migration
                recs, objs = _legacy_records(z[f"jit_rows_{ji}"])
            store.jit_segments.append(segment_from_packed(
                recs, np.zeros((0, 0), np.uint32), objs=objs,
                epoch=int(jit_epochs[ji]),
                n_covered=int(jit_ncov[ji]),
                tier=int(jit_tiers[ji])))
        store.data_version += 1
        return store


class _EpochPushdown(dict):
    """Lazy pushed-rows map backed by the plan registry.

    ``m[epoch]`` -> the query's pushed local rows under that epoch's full
    plan; ``m[(epoch, n_covered)]`` -> pushed ∩ covered, i.e. the subset
    with local row < ``n_covered`` (``n_covered < 0`` means full
    coverage).  Tiers are nested prefixes, so one inequality implements
    the coverage intersection.
    """

    def __init__(self, store: CiaoStore, q: Query):
        super().__init__()
        self._store = store
        self._q = q

    def __missing__(self, key) -> list[int]:
        if isinstance(key, tuple):
            epoch, n_cov = key
            if n_cov < 0 or n_cov >= self._store.plans[epoch].n:
                pushed = self[epoch]
            else:
                pushed = [i for i in self[epoch] if i < n_cov]
        else:
            pushed = self._store.plans[key].pushed_in(self._q)
        self[key] = pushed
        return pushed


# process-global id source for snapshot version forks: two snapshots that
# promote raw rows independently must never share a data_version, or the
# result cache would serve one lineage's counts for the other's
_SNAPSHOT_FORKS = itertools.count(1)


class StoreSnapshot:
    """Immutable ``(epoch, data_version)`` view of one :class:`CiaoStore`.

    The reader half of the async serving plane (DESIGN.md §17): scans run
    against the snapshot while ingest keeps appending to the parent.  The
    snapshot exposes the full scanner protocol surface (``blocks`` /
    ``jit_blocks`` / ``raw`` / ``plans`` / ``pushed_by_epoch`` /
    ``promote_uncovered_raw`` / ``stats`` / ``data_version``), so
    ``DataSkippingScanner``, ``ScanBatcher`` and ``DeviceScanner`` work
    over it unchanged.

    Consistency: construction happens under the parent's ingest lock, so
    the captured surface is a prefix of the ingest history — never a torn
    ingest.  Sealed segments and frozen builder views are shared by
    reference; both are immutable after construction.

    JIT promotion is **snapshot-local**: a query whose clauses were never
    pushed must still parse the raw remainder, but doing so on the parent
    would mutate state readers of *other* snapshots depend on.  Promoted
    segments and the shrunken raw list live only in this snapshot; the
    parent store is untouched (it promotes independently on its own query
    path).  Promotion bumps the snapshot's ``data_version`` to a
    **fork-unique negative** value ``-(fork_id << 20 | n_promotions)``:
    live stores only ever produce non-negative versions, so cache entries
    fenced by a forked version can never alias a live-store version or
    another snapshot's fork, keeping ``ResultCache`` /
    ``DeviceSegmentCache`` fencing exact.  Untainted snapshots keep the
    parent's ``base_version`` and therefore share cache entries with it.

    Thread-safety: any number of reader threads may scan one snapshot
    concurrently; the snapshot-local promotion state is guarded by its
    own lock.  ``log_query`` feeds back to the parent store (workload
    drift must observe snapshot reads too).
    """

    def __init__(self, store: CiaoStore):
        # caller must hold store._ingest_lock (use CiaoStore.snapshot())
        self._store = store               # query-log feedback only
        self.plan = store.plan
        self.family = store.family
        self.plans = dict(store.plans)
        self.families = dict(store.families)
        self.segment_capacity = store.segment_capacity
        self.base_version = store.data_version
        self.telemetry = store.telemetry
        self._blocks = list(store.blocks)          # sealed + frozen tails
        self._raw = list(store.raw)
        self._jit = list(store.jit_segments)
        self.stats = LoadStats(**vars(store.stats))
        self._seg_rows: dict[tuple[int, int], int] = {}
        for seg in self._blocks:
            k = (seg.epoch, seg.tier)
            self._seg_rows[k] = self._seg_rows.get(k, 0) + seg.n_rows
        self._fork = next(_SNAPSHOT_FORKS)
        self._promotions = 0
        self._lock = threading.Lock()     # snapshot-local JIT state

    # -- scanner protocol surface --------------------------------------------
    @property
    def epoch(self) -> int:
        return self.plan.epoch

    @property
    def data_version(self) -> int:
        """Parent's version at capture, or a fork-unique negative once
        snapshot-local promotion has run (see class docstring)."""
        with self._lock:
            if not self._promotions:
                return self.base_version
            return -((self._fork << 20) | min(self._promotions, (1 << 20) - 1))

    @property
    def blocks(self) -> list["ColumnarSegment"]:
        return list(self._blocks)

    @property
    def jit_blocks(self) -> list["ColumnarSegment"]:
        with self._lock:
            return list(self._jit)

    @property
    def raw(self) -> list[RawRemainder]:
        with self._lock:
            return list(self._raw)

    def log_query(self, q: Query) -> None:
        self._store.log_query(q)

    def pushed_by_epoch(self, q: Query) -> "_EpochPushdown":
        m = _EpochPushdown(self, q)
        m[self.plan.epoch]
        return m

    def resident_group_rows(self) -> dict[tuple[int, int], int]:
        out = dict(self._seg_rows)
        for seg in self.jit_blocks:
            k = (seg.epoch, seg.tier)
            out[k] = out.get(k, 0) + seg.n_rows
        return out

    def promote_uncovered_raw(
        self, pushed: "_EpochPushdown",
    ) -> dict[tuple[int, int], int]:
        """Snapshot-local JIT promotion (parent store untouched)."""
        with self._lock:
            keep: list[RawRemainder] = []
            take: list[RawRemainder] = []
            for rr in self._raw:
                if pushed[(rr.epoch, rr.n_covered)]:
                    keep.append(rr)
                else:
                    take.append(rr)
            if not take:
                return {}
            t0 = time.perf_counter()
            promoted: dict[tuple[int, int], int] = {}
            grouped: dict[tuple[int, int, int], tuple[list, list]] = {}
            for rr in take:
                recs, objs = decode_rows(rr.data, rr.lengths)
                g = grouped.setdefault((rr.epoch, rr.n_covered, rr.tier),
                                       ([], []))
                g[0].extend(recs)
                g[1].extend(objs)
                self.stats.n_jit_loaded += rr.n
                key = (rr.epoch, rr.tier)
                promoted[key] = promoted.get(key, 0) + rr.n
            for (epoch, n_cov, tier), (recs, objs) in grouped.items():
                self._jit.extend(build_segments(
                    recs, np.zeros((0, len(recs)), bool), objs=objs,
                    epoch=epoch, n_covered=n_cov, tier=tier,
                    capacity=self.segment_capacity))
            self._raw = keep
            self._promotions += 1
            self.stats.jit_time_s += time.perf_counter() - t0
            return promoted

    def close(self) -> None:
        """Retire this snapshot: drop every captured segment reference.

        A tainted snapshot (snapshot-local JIT promotion ran) privately
        holds promoted fork segments the parent store never sees; an
        abandoned-but-reachable snapshot would pin them until GC finds
        the whole object.  ``close()`` severs the references eagerly —
        the snapshot stays safe to scan (it just reads as empty) but no
        longer keeps any segment, raw remainder, or builder view alive.
        Idempotent.
        """
        with self._lock:
            self._blocks = []
            self._raw = []
            self._jit = []
            self._seg_rows = {}


@dataclass
class TierScan:
    """Per-(epoch, tier) slice of one scan (savings attribution)."""

    rows_scanned: int = 0
    rows_skipped: int = 0
    raw_parsed: int = 0
    count: int = 0
    segments_pruned: int = 0


@dataclass
class ScanResult:
    count: int
    rows_scanned: int
    rows_skipped: int
    raw_parsed: int
    time_s: float
    used_skipping: bool
    # (epoch, tier) -> breakdown: which coverage groups produced the
    # skips/scans/JIT parses, so benchmarks and the replanner can
    # attribute savings to tiers instead of a single aggregate.
    # ORDERING CONTRACT: every finished result iterates ``groups`` in
    # ascending (epoch, tier) key order, independent of segment layout or
    # shard completion order — scanners and the scatter-gather merge
    # normalize with :meth:`sort_groups` before returning, so consumers
    # may rely on a stable, comparable iteration order.
    groups: dict[tuple[int, int], TierScan] = field(default_factory=dict)
    # segments skipped whole by their zone maps (second-level skipping —
    # independent of the pushed-bitvector path, so NOT part of
    # used_skipping, which keeps its pushed-clause meaning)
    segments_pruned: int = 0
    # segments whose rows were actually visited (the zone-prune
    # denominator: visited = segments_scanned + segments_pruned)
    segments_scanned: int = 0
    # sharded scatter-gather only (DESIGN.md §14): shards whose partition
    # metadata refuted the query (first-level skipping) vs shards scanned
    shards_scanned: int = 0
    shards_pruned: int = 0

    def group(self, epoch: int, tier: int) -> TierScan:
        return self.groups.setdefault((epoch, tier), TierScan())

    def sort_groups(self) -> None:
        """Normalize ``groups`` to ascending (epoch, tier) key order."""
        self.groups = {k: self.groups[k] for k in sorted(self.groups)}


class DataSkippingScanner:
    """COUNT(*) scan: zone-map prune -> bitvector AND -> vectorized verify.

    Epoch-aware: each segment's bitvector rows are indexed by the plan it
    was ingested under, so skipping resolves the query's pushed clauses
    *per segment epoch* through the store's plan registry.  A raw
    remainder from epoch *e* is skippable iff >= 1 query clause was pushed
    within its coverage (its rows matched none of those clauses);
    remainders whose coverage misses the query are JIT-promoted, exactly
    once.  Per segment (``columnar.query_mask``): the zone map may refute
    a clause outright, pushed clause bitvectors AND into a candidate mask,
    and every clause is re-verified EXACTLY — vectorized over whole
    columns, with ``matches_exact`` surviving only as the per-row fallback
    for non-lowerable terms (and as the differential oracle in tests).

    ``and_reduce`` optionally routes the packed bitvector AND through a
    device kernel (``repro_torch.kernels.residual.bv_and_many_cuda``); the
    default is the host numpy reduction.

    Every scan is appended to ``store.query_log`` — the replan control
    plane's workload-drift signal (paper §V workload estimation) — and
    recorded into the store's telemetry plane (DESIGN.md §16) under
    ``tenant``.  ``telemetry`` is tri-state: ``None`` inherits
    ``store.telemetry``, ``False`` disables recording (inner scanners of
    multi-store front-ends, which record once at the top), or an explicit
    :class:`~repro_torch.core.telemetry.TelemetryPlane`.
    """

    def __init__(self, store: CiaoStore, *, log_queries: bool = True,
                 and_reduce: Callable | None = None,
                 telemetry: "TelemetryPlane | bool | None" = None,
                 tenant: str = "default"):
        self.store = store
        self.log_queries = log_queries
        self.and_reduce = and_reduce
        if telemetry is None:
            telemetry = getattr(store, "telemetry", None)
        self.telemetry = telemetry if isinstance(telemetry, TelemetryPlane) \
            else None
        self.tenant = tenant

    def _scan_segment(self, seg: ColumnarSegment, q: Query,
                      pushed: Sequence[int], g: TierScan,
                      result: ScanResult) -> None:
        mask = query_mask(seg, q, pushed, self.and_reduce)
        if mask is None:                      # zone map refuted a clause
            g.rows_skipped += seg.n_rows
            g.segments_pruned += 1
            result.segments_pruned += 1
            return
        if pushed:
            cand = int(seg.pushed_mask(pushed, self.and_reduce).sum())
        else:
            cand = seg.n_rows
        g.rows_scanned += cand
        g.rows_skipped += seg.n_rows - cand
        g.count += int(mask.sum())
        result.segments_scanned += 1

    def scan(self, q: Query) -> ScanResult:
        t0 = time.perf_counter()
        store = self.store
        if self.log_queries:
            store.log_query(q)
        pushed_by_epoch = store.pushed_by_epoch(q)
        result = ScanResult(count=0, rows_scanned=0, rows_skipped=0,
                            raw_parsed=0, time_s=0.0, used_skipping=False)

        for seg in store.blocks:
            g = result.group(seg.epoch, seg.tier)
            pushed = pushed_by_epoch[(seg.epoch, seg.n_covered)]
            self._scan_segment(seg, q, pushed, g, result)

        # raw remainders whose coverage pushes none of the query may
        # contain matches: JIT-promote those (epoch, coverage) groups
        # once, then scan every promoted segment whose coverage misses
        # the query (covered ones hold no possible match: skip whole)
        for key, n in store.promote_uncovered_raw(pushed_by_epoch).items():
            result.group(*key).raw_parsed += n
        for seg in store.jit_blocks:
            g = result.group(seg.epoch, seg.tier)
            if pushed_by_epoch[(seg.epoch, seg.n_covered)]:
                g.rows_skipped += seg.n_rows
                continue
            self._scan_segment(seg, q, (), g, result)
        result.sort_groups()
        for g in result.groups.values():
            result.count += g.count
            result.rows_scanned += g.rows_scanned
            result.rows_skipped += g.rows_skipped
            result.raw_parsed += g.raw_parsed
        result.time_s = time.perf_counter() - t0
        result.used_skipping = any(pushed_by_epoch.values())
        if self.telemetry is not None:
            self.telemetry.record_scan(result, tenant=self.tenant)
        return result


class FullScanBaseline:
    """Zero-budget baseline: parse + load everything, no skipping."""

    def __init__(self) -> None:
        self.rows: list[dict] = []
        self.stats = LoadStats()

    def ingest_chunk(self, chunk: Chunk) -> None:
        t0 = time.perf_counter()
        for i in range(chunk.n_records):
            self.rows.append(json.loads(chunk.record(i)))
        self.stats.n_records += chunk.n_records
        self.stats.n_loaded += chunk.n_records
        dt = time.perf_counter() - t0
        self.stats.load_time_s += dt
        self.stats.parse_time_s += dt

    def scan(self, q: Query) -> ScanResult:
        t0 = time.perf_counter()
        count = sum(1 for row in self.rows if q.matches_exact(row))
        return ScanResult(
            count=count,
            rows_scanned=len(self.rows),
            rows_skipped=0,
            raw_parsed=0,
            time_s=time.perf_counter() - t0,
            used_skipping=False,
        )
