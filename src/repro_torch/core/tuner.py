"""Online physical-design tuner (DESIGN.md §18).

The :class:`~repro_torch.core.replan.Replanner` closes the LOGICAL
adaptive loop: it re-solves WHICH clauses the clients evaluate when the
workload drifts.  This module closes the PHYSICAL one — in the spirit of
*Workload-Driven Vertical Partitioning over Raw Data* (Zhao et al.) and
the *Cost-based Storage Format Selector* (Munir et al.) from PAPERS.md —
by re-deciding, online, WHERE rows live and WHAT gets columnarized:

  * **incremental background re-partition** — when the observed query
    keys drift off the routing key (``LayoutDrift`` "key-shift") or the
    per-shard row counts skew ("skew"), the tuner builds a fresh
    :class:`~repro_torch.core.shard.ShardRouter` (sample-quantile range
    boundaries on the new hot key, hash fallback when the key has no
    numeric values) and drives a
    :class:`~repro_torch.core.shard.SegmentMigration` in bounded batches —
    scans, snapshots and ingest stay online and bit-identical to the
    unsharded oracle throughout (the migration fence in ``shard.py``
    carries the correctness argument);
  * **workload-driven column layout** — which JSON keys each shard
    eagerly columnarizes at ingest is co-selected from the same
    telemetry.  The cost model is the Zhao/Munir trade reduced to its
    sign: eagerly building key *k*'s column costs decode + column-build
    time and resident memory on EVERY ingested row, and pays off only
    when scans actually evaluate *k* (frequency × per-scan vectorized
    speedup).  Keys whose observed reference share clears
    ``TunerPolicy.layout_min_freq`` — plus the plan's clause keys and
    the routing key, which the scan path touches on every query — go
    eager; everything else stays raw per segment until a scan first
    touches it (``ColumnarSegment.key_col`` materializes lazily, so
    counts never change, only where the decode cost lands).

The tuner is a polling loop: call :meth:`PhysicalDesignTuner.step` after
scans/ingest (or let ``CiaoServeEngine.start_tuner`` drive it from a
background thread).  Each step either advances an in-flight migration by
one bounded batch or runs a drift check; every action is recorded in
``history`` and the store's telemetry plane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from .replan import LayoutDrift, layout_drift_signal
from .shard import SegmentMigration, ShardedCiaoStore, ShardRouter

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .replan import Replanner


@dataclass(frozen=True)
class TunerPolicy:
    """When the tuner acts, and how aggressively."""

    check_every_scans: int = 32    # min logged queries between drift checks
    window: int = 64               # workload window for key frequencies
    min_window: int = 8            # need this many queries to trust a shift
    hot_share_threshold: float = 0.5   # hot key must dominate the window
    margin: float = 1.5            # ...and beat the routing key by this
    skew_threshold: float = 4.0    # max/mean resident rows triggering "skew"
    batch_rows: int = 4096         # rows examined per migration step
    sample_rows: int = 1024        # resident rows sampled for new boundaries
    layout_min_freq: float = 0.02  # eager-columnarize keys above this share
    retune_layout: bool = True     # co-select the per-shard eager key set


@dataclass
class TunerEvent:
    """One tuner action (kept in ``PhysicalDesignTuner.history``)."""

    kind: str                  # "migration-start" | "migration-finish" |
                               # "layout"
    reason: str                # triggering signal ("key-shift", "skew", ...)
    routing_key: str | None    # router key after the action
    detail: dict = field(default_factory=dict)

    def describe(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in sorted(self.detail.items()))
        return f"{self.kind} [{self.reason}] key={self.routing_key} {extra}"


class PhysicalDesignTuner:
    """Watch drift signals; re-partition and re-layout the store online.

    Wraps one :class:`~repro_torch.core.shard.ShardedCiaoStore` (the N=1 case
    degenerates to layout-only tuning — there is nothing to re-route).
    An optional :class:`~repro_torch.core.replan.Replanner` aligns the
    workload window with the clause re-solve's; otherwise the tuner
    reads the store's query log directly.

    Exactly one migration runs at a time; :meth:`step` drives it one
    bounded batch per call, so the caller controls how much ingest/scan
    bandwidth the background writer may steal.
    """

    def __init__(self, store: ShardedCiaoStore, *,
                 replanner: "Replanner | None" = None,
                 policy: TunerPolicy | None = None):
        self.store = store
        self.replanner = replanner
        self.policy = policy or TunerPolicy()
        self.migration: SegmentMigration | None = None
        self.history: list[TunerEvent] = []
        self._checked_at = 0

    # -- signals -------------------------------------------------------------
    def layout_drift(self) -> LayoutDrift:
        if self.replanner is not None:
            return self.replanner.layout_drift()
        return layout_drift_signal(self.store, window=self.policy.window)

    def key_weights(self) -> dict[str, float]:
        """Observed key -> reference weight over the workload window
        (each query counts each referenced key once, times its freq)."""
        recent = self.store.query_log[-self.policy.window:]
        weights: dict[str, float] = {}
        for q in recent:
            for k in {t.key for c in q.clauses for t in c.terms}:
                weights[k] = weights.get(k, 0.0) + float(q.freq)
        return weights

    @property
    def migrating(self) -> bool:
        return self.migration is not None and not self.migration.done

    # -- planning ------------------------------------------------------------
    def _sample_objs(self) -> list[dict]:
        """Up to ``sample_rows`` resident row objects, spread across
        shards (quantile boundaries must see the whole key range, not
        one shard's slice of it)."""
        store = self.store
        quota = max(1, self.policy.sample_rows // max(1, store.n_shards))
        out: list[dict] = []
        for sh in store.shards:
            taken = 0
            for seg in (*sh.blocks, *sh.jit_blocks):
                rows = seg.rows[:quota - taken]
                out.extend(rows)
                taken += len(rows)
                if taken >= quota:
                    break
        return out

    def decide(self) -> tuple[str, ShardRouter] | None:
        """Drift check: returns ``(reason, new_router)`` when the layout
        should change, else ``None``.  Pure planning — no mutation."""
        store = self.store
        if store.n_shards < 2:
            return None
        sig = self.layout_drift()
        p = self.policy
        reason = sig.triggers(
            min_window=p.min_window,
            hot_share_threshold=p.hot_share_threshold,
            margin=p.margin, skew_threshold=p.skew_threshold)
        if reason is None:
            return None
        key = sig.hot_key if reason == "key-shift" else \
            (store.router.key or sig.hot_key)
        if key is None:
            return None
        try:
            router = ShardRouter.from_samples(
                store.n_shards, key, self._sample_objs())
        except ValueError:
            # no numeric sample values: hash-partition the new key
            router = ShardRouter(n_shards=store.n_shards, key=key,
                                 mode="hash")
        if router == store.router:
            return None  # re-quantile landed on the same cut points
        return reason, router

    # -- acting --------------------------------------------------------------
    def step(self) -> TunerEvent | None:
        """One tuner tick: advance the in-flight migration by one batch,
        or run a (throttled) drift check and maybe start one.  Returns
        the event when an action started/finished, else ``None``."""
        mig = self.migration
        if mig is not None and not mig.done:
            mig.step()
            if not mig.done:
                return None
            ev = TunerEvent(
                kind="migration-finish", reason="drain",
                routing_key=self.store.router.key,
                detail={"rows_moved": mig.rows_moved,
                        "rows_kept": mig.rows_kept,
                        "segments_moved": mig.segments_moved,
                        "items_skipped": mig.items_skipped})
            self.history.append(ev)
            return ev
        n_q = len(self.store.query_log)
        if self._checked_at > n_q:       # the log was trimmed
            self._checked_at = n_q
        if n_q - self._checked_at < self.policy.check_every_scans:
            return None
        self._checked_at = n_q
        decision = self.decide()
        if decision is None:
            return None
        reason, router = decision
        self.migration = self.store.begin_migration(
            router, batch_rows=self.policy.batch_rows)
        telemetry = getattr(self.store, "telemetry", None)
        if telemetry is not None:
            telemetry.record_tuner(router_swaps=1)
        if self.policy.retune_layout:
            self.retune_layout(reason=reason)
        ev = TunerEvent(
            kind="migration-start", reason=reason, routing_key=router.key,
            detail={"mode": router.mode,
                    "items": self.migration.items_left})
        self.history.append(ev)
        return ev

    def run_migration(self) -> None:
        """Drain the in-flight migration to completion (tests/benches —
        the serve plane drives :meth:`step` incrementally instead)."""
        while self.migrating:
            self.step()

    def retune_layout(self, *, reason: str = "workload") -> frozenset[str]:
        """Re-select the eager columnarization key set from telemetry.

        The eager set is the cost model's positive side: the plan's
        clause keys and the routing key (touched by every scan's pruning
        cascade) plus every key whose observed reference share clears
        ``layout_min_freq`` — for those, frequency × vectorized-scan
        benefit exceeds the per-row decode + memory cost of building the
        column; everything else stays raw per segment until first touch.
        Applies to NEW segments only (existing columns are never torn
        down — their build cost is sunk and their memory is reclaimed by
        normal segment lifecycle, not by the tuner).
        """
        store = self.store
        weights = self.key_weights()
        total = sum(weights.values())
        eager = {k for k, w in weights.items()
                 if total and w / total >= self.policy.layout_min_freq}
        for c in store.plan.clauses:
            eager.update(t.key for t in c.terms)
        if store.router.key is not None:
            eager.add(store.router.key)
        eager_fs = frozenset(eager)
        for sh in store.shards:
            sh.layout_eager_keys = eager_fs
        telemetry = getattr(store, "telemetry", None)
        if telemetry is not None:
            telemetry.record_tuner(layout_retunes=1)
        self.history.append(TunerEvent(
            kind="layout", reason=reason, routing_key=store.router.key,
            detail={"eager_keys": sorted(eager_fs)}))
        return eager_fs
