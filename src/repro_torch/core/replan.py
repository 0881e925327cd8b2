"""Closed-loop adaptive replanning (plan epochs) — the control plane.

CIAO's planner picks a clause set from *estimated* selectivities and costs;
this module closes the paper's feedback loop (§V workload estimation) by
periodically re-solving the budgeted selection from what the system actually
observed:

  * **selectivity feedback** — ``CiaoStore`` accumulates live per-clause
    popcounts from the fused client kernels; observed selectivities replace
    the sample estimates for every currently pushed clause;
  * **workload feedback** — the scanner logs every query; the re-solve runs
    over a sliding window of the live workload, so a Zipf shift in which
    clauses are *queried* moves the pushed set;
  * **cost feedback** — clients report measured whole-plan eval timings;
    the cost model is recalibrated online (``CostModel.scaled``, §V-D)
    before each re-solve so budgets keep meaning wall-clock µs/record.

A replan emits a new **plan epoch** (``server.evolve_plan``): surviving
clauses keep their stable global ids, the store registers the epoch and
keeps per-epoch stats, and the ingest coordinator broadcasts the new plan
to every client shard mid-stream.  Invariants are in DESIGN.md §11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

from .cost_model import CostModel

if TYPE_CHECKING:  # sharded deployments pass a ShardedCiaoStore
    from .shard import ShardedCiaoStore
from .planner import PlanReport, build_plan, build_plan_family
from .predicates import Clause, Query
from .server import (
    CiaoStore, PlanFamily, PushdownPlan, evolve_family, evolve_plan,
)
from .workload import Workload, estimate_selectivities

SEL_FLOOR = 1e-4


@dataclass(frozen=True)
class ReplanPolicy:
    """When to check for drift, and how much drift triggers a replan."""

    check_every_records: int = 2048   # min records ingested between checks
    min_observe_records: int = 512    # don't trust tiny per-epoch samples
    min_coverage: float = 0.5         # replan if < this fraction of recent
                                      # queries has >= 1 pushed clause
    sel_drift_threshold: float = 0.5  # replan if max relative |obs - plan|
                                      # selectivity error exceeds this
    sel_noise_floor: float = 0.02     # relative-error denominator floor: a
                                      # floored 1e-4 estimate observed at
                                      # 5e-4 is sampling noise, not drift
    workload_window: int = 64         # recent queries used for the re-solve
    min_window_queries: int = 8       # need this many logged queries
    recalibrate_cost: bool = True
    max_cost_scale: float = 100.0     # clamp for the online recalibration


@dataclass(frozen=True)
class DriftSignal:
    """One drift measurement (kept in ``Replanner.history`` for telemetry)."""

    coverage: float        # fraction of window queries with >= 1 pushed clause
    sel_drift: float       # max relative observed-vs-planned selectivity error
    n_observed: int        # records observed under the current epoch
    n_window: int          # queries in the workload window

    def triggers(self, policy: ReplanPolicy) -> str | None:
        if self.n_observed < policy.min_observe_records:
            return None
        if self.n_window >= policy.min_window_queries and \
                self.coverage < policy.min_coverage:
            return "coverage"
        if self.sel_drift > policy.sel_drift_threshold:
            return "selectivity"
        return None


@dataclass(frozen=True)
class LayoutDrift:
    """Physical-design drift: is the PHYSICAL layout still right?

    Orthogonal to :class:`DriftSignal` (which asks whether the pushed
    CLAUSE SET is still right): the store may be pushing exactly the
    right clauses yet routing/partitioning on a key the workload no
    longer filters by, or holding shards whose row counts have skewed
    far apart.  Consumed by ``repro_torch.core.tuner.PhysicalDesignTuner``
    (DESIGN.md §18).
    """

    routing_key: str | None   # the router's current key
    hot_key: str | None       # most-queried key over the window
    hot_share: float          # hot key's share of window key references
    routing_share: float      # routing key's share of same
    n_window: int             # queries in the window
    shard_skew: float = 1.0   # max/mean resident rows across shards

    def triggers(self, *, min_window: int = 8,
                 hot_share_threshold: float = 0.5,
                 margin: float = 1.5,
                 skew_threshold: float = 4.0) -> str | None:
        """``"key-shift"``, ``"skew"`` or ``None``.

        Key-shift needs a real window, a dominant hot key, and the hot
        key beating the current routing key by ``margin``; skew needs
        only the row-count imbalance (it is workload-independent).
        """
        if self.shard_skew > skew_threshold:
            return "skew"
        if (self.n_window >= min_window
                and self.hot_key is not None
                and self.hot_key != self.routing_key
                and self.hot_share >= hot_share_threshold
                and self.hot_share >= margin * self.routing_share):
            return "key-shift"
        return None


def layout_drift_signal(store: "CiaoStore | ShardedCiaoStore", *,
                        window: int = 64) -> LayoutDrift:
    """Measure physical-design drift from the store's own feedback.

    Key frequencies come from the query log's recent window (each query
    contributes each referenced key once, weighted by ``freq``); shard
    skew from the per-shard resident row counts.  Works over a plain
    :class:`CiaoStore` too (no router, skew 1.0) so callers can gate on
    it uniformly.
    """
    router = getattr(store, "router", None)
    routing_key = getattr(router, "key", None)
    recent = store.query_log[-window:]
    weights: dict[str, float] = {}
    for q in recent:
        keys = {t.key for c in q.clauses for t in c.terms}
        for k in keys:
            weights[k] = weights.get(k, 0.0) + float(q.freq)
    total = sum(weights.values())
    hot_key = max(weights, key=weights.get) if weights else None
    hot_share = weights[hot_key] / total if hot_key else 0.0
    routing_share = (weights.get(routing_key, 0.0) / total
                     if total and routing_key else 0.0)
    shards = getattr(store, "shards", None)
    if shards and len(shards) > 1:
        rows = [max(0, sh.stats.n_records) for sh in shards]
        mean = sum(rows) / len(rows)
        skew = (max(rows) / mean) if mean > 0 else 1.0
    else:
        skew = 1.0
    return LayoutDrift(routing_key=routing_key, hot_key=hot_key,
                       hot_share=hot_share, routing_share=routing_share,
                       n_window=len(recent), shard_skew=skew)


@dataclass
class ReplanEvent:
    """One epoch bump: what changed and why."""

    epoch: int
    reason: str
    signal: DriftSignal
    report: PlanReport          # FamilyReport under tiered replanning
    remap: np.ndarray          # new local row -> previous local row, -1 = new
    cost_scale: float

    @property
    def n_survivors(self) -> int:
        return int(np.sum(self.remap >= 0))

    def describe(self) -> str:
        return (
            f"epoch {self.epoch} [{self.reason}] coverage="
            f"{self.signal.coverage:.2f} sel_drift={self.signal.sel_drift:.2f}"
            f" pushed={len(self.remap)} survivors={self.n_survivors}"
            f" cost_scale={self.cost_scale:.3g}"
        )


class Replanner:
    """Closed-loop planner: observe → detect drift → re-solve → bump epoch.

    Wraps one :class:`CiaoStore` (single client class; per-class budgets
    get one replanner per class store, mirroring ``plan_for_clients``) —
    or one :class:`~repro_torch.core.shard.ShardedCiaoStore`, whose feedback
    surface is identical: per-shard observed selectivities, per-clause
    coverage denominators, and record totals are aggregated into exact
    fleet sums BEFORE every drift check and re-solve, and an epoch bump
    fans out to every shard atomically from the replanner's viewpoint.
    Call :meth:`observe_timing` as client timing reports arrive and
    :meth:`step` after every ingest; ``step`` returns the new
    :class:`PushdownPlan` when it advanced the epoch, else ``None``.
    """

    def __init__(
        self,
        store: CiaoStore | ShardedCiaoStore,
        sample_records: Sequence[bytes],
        *,
        budget_us: float | None = None,
        tier_budgets_us: Sequence[float] | None = None,
        base_workload: Workload | None = None,
        cost_model: CostModel | None = None,
        policy: ReplanPolicy | None = None,
        algorithm: str = "celf",
        planned_sel: Mapping[Clause, float] | None = None,
    ):
        if budget_us is None and not tier_budgets_us:
            raise ValueError("need budget_us or tier_budgets_us")
        self.store = store
        self.sample_records = list(sample_records)
        # tiered mode: re-solves emit a whole PlanFamily (nested budget
        # cut-points of one CELF run); the top tier budget IS the budget,
        # so a conflicting explicit budget_us would be silently ignored —
        # reject it instead
        self.tier_budgets_us = (tuple(tier_budgets_us)
                                if tier_budgets_us else None)
        if self.tier_budgets_us is not None and budget_us is not None \
                and float(budget_us) != max(self.tier_budgets_us):
            raise ValueError(
                f"conflicting budgets: budget_us={budget_us} but the top "
                f"tier budget is {max(self.tier_budgets_us)} (tiered "
                "re-solves run under the tier budgets; pass one or the "
                "other)")
        self.budget_us = (float(budget_us) if budget_us is not None
                          else max(self.tier_budgets_us))
        self.base_workload = base_workload
        self.cost_model = cost_model or CostModel()
        self.policy = policy or ReplanPolicy()
        self.algorithm = algorithm
        # selectivity cache: sample-based estimates for pool clauses, plus
        # the values the CURRENT plan was built with (drift reference)
        self._sel_cache: dict[Clause, float] = dict(planned_sel or {})
        self._planned_sel: dict[Clause, float] = {
            c: self._sel_cache.get(c, SEL_FLOOR) for c in store.plan.clauses
        }
        self._records_at_last_check = 0
        # online cost recalibration state (µs totals, predicted vs observed)
        self._pred_us = 0.0
        self._obs_us = 0.0
        self.cost_scale = 1.0
        self.history: list[ReplanEvent] = []

    # -- feedback intake -----------------------------------------------------
    def observe_timing(self, n_records: int, elapsed_s: float,
                       n_clauses: int | None = None) -> None:
        """Client timing report: plan eval of ``n_records`` records.

        ``n_clauses`` names how many leading clauses the client actually
        evaluated (its tier's coverage).  ``None`` means the whole plan —
        a tiered fleet MUST pass its tier size, otherwise a mostly-floor
        fleet's short-prefix timings get compared against whole-plan
        predictions and the recalibration collapses toward the clamp.
        """
        if n_records <= 0 or not self.store.plan.n:
            return
        predicted = self._predicted_plan_us(n_clauses) * n_records
        if predicted <= 0.0:
            return  # empty tier: no cost signal in this report
        self._pred_us += predicted
        self._obs_us += elapsed_s * 1e6
        if self.policy.recalibrate_cost and self._pred_us > 0:
            self.cost_scale = float(np.clip(
                self._obs_us / self._pred_us,
                1.0 / self.policy.max_cost_scale, self.policy.max_cost_scale,
            ))

    def _predicted_plan_us(self, n_clauses: int | None = None) -> float:
        plan = self.store.plan
        clauses = (plan.clauses if n_clauses is None
                   else plan.clauses[:n_clauses])
        sel = self._planned_sel
        return sum(
            self.cost_model.clause_cost(c, sel.get(c, SEL_FLOOR))
            for c in clauses
        )

    # -- drift detection -----------------------------------------------------
    def _window(self) -> list[Query]:
        return self.store.query_log[-self.policy.workload_window:]

    def drift_signal(self) -> DriftSignal:
        store = self.store
        plan = store.plan
        window = self._window()
        if window and plan.n:
            coverage = float(np.mean(
                [1.0 if plan.pushed_in(q) else 0.0 for q in window]))
        else:
            coverage = 1.0 if plan.n else 0.0
        n_obs = store.epoch_records()
        sel_drift = 0.0
        if plan.n and n_obs:
            obs = store.observed_selectivities()
            cov = store.clause_records()
            for c, i in plan.ids.items():
                # a clause no produced tier covered has obs == 0 by
                # construction, not by measurement — drift must only be
                # computed from adequately covered clauses
                if cov[i] < self.policy.min_observe_records:
                    continue
                planned = max(self._planned_sel.get(c, SEL_FLOOR), SEL_FLOOR)
                denom = max(planned, self.policy.sel_noise_floor)
                sel_drift = max(sel_drift,
                                abs(float(obs[i]) - planned) / denom)
        return DriftSignal(coverage=coverage, sel_drift=sel_drift,
                           n_observed=n_obs, n_window=len(window))

    def layout_drift(self) -> LayoutDrift:
        """Physical-design drift over the same workload window the clause
        re-solve uses (see :func:`layout_drift_signal`)."""
        return layout_drift_signal(self.store,
                                   window=self.policy.workload_window)

    # -- the loop ------------------------------------------------------------
    def step(self, force: bool = False) -> "PushdownPlan | PlanFamily | None":
        """Check drift; re-solve and advance the store epoch if triggered.

        Returns the new plan (or, under ``tier_budgets_us``, the new
        :class:`PlanFamily`) when the epoch advanced, else ``None``.
        """
        store = self.store
        if not force:
            since = store.stats.n_records - self._records_at_last_check
            if since < self.policy.check_every_records:
                return None
        self._records_at_last_check = store.stats.n_records
        signal = self.drift_signal()
        reason = "forced" if force else signal.triggers(self.policy)
        if reason is None:
            return None
        return self._replan(reason, signal)

    def _replan(self, reason: str, signal: DriftSignal) -> PushdownPlan | None:
        store = self.store
        window = self._window()
        if len(window) >= self.policy.min_window_queries:
            workload = Workload(name=f"observed@{store.epoch}",
                                queries=list(window))
        elif self.base_workload is not None:
            workload = self.base_workload
        else:
            return None
        # merge selectivities: sample estimates for unseen pool clauses,
        # live observed values for everything the current plan pushes
        pool = workload.clause_pool()
        missing = [c for c in pool if c not in self._sel_cache]
        if missing:
            self._sel_cache.update(
                estimate_selectivities(missing, self.sample_records))
        sel = {c: self._sel_cache[c] for c in pool}
        obs = store.observed_selectivities()
        cov = store.clause_records()
        if signal.n_observed >= self.policy.min_observe_records:
            for c, i in store.plan.ids.items():
                # only clauses with real per-clause coverage update the
                # cache: a tier-uncovered clause's obs of 0 would clobber
                # its sample estimate with a fabricated floor value
                if cov[i] < self.policy.min_observe_records:
                    continue
                self._sel_cache[c] = max(float(obs[i]), SEL_FLOOR)
                if c in sel:
                    sel[c] = self._sel_cache[c]
        cm = (self.cost_model.scaled(self.cost_scale)
              if self.policy.recalibrate_cost else self.cost_model)
        if self.tier_budgets_us is not None:
            return self._replan_tiered(reason, signal, workload, sel, cm)
        report = build_plan(
            workload, self.sample_records, budget_us=self.budget_us,
            cost_model=cm, algorithm=self.algorithm, sel=sel,
        )
        if set(report.plan.clauses) == set(store.plan.clauses):
            # same selection (order is solver-dependent): an epoch bump
            # would only reset the drift-observation sample for nothing.
            # The observed values become the new drift reference — without
            # this the sel-drift trigger never clears and every subsequent
            # check would re-run the whole solve just to land here again.
            self._planned_sel = {
                c: self._sel_cache.get(c, sel.get(c, SEL_FLOOR))
                for c in store.plan.clauses
            }
            return None
        new_plan = evolve_plan(store.plan, report.plan.clauses)
        remap = store.advance_epoch(new_plan)
        self._planned_sel = {c: sel.get(c, SEL_FLOOR)
                             for c in new_plan.clauses}
        self.history.append(ReplanEvent(
            epoch=new_plan.epoch, reason=reason, signal=signal,
            report=report, remap=remap, cost_scale=self.cost_scale,
        ))
        return new_plan

    def _replan_tiered(self, reason: str, signal: DriftSignal,
                       workload: Workload, sel, cm) -> PlanFamily | None:
        """Tiered re-solve: one CELF run, nested cut-points, new family.

        Families are immutable per epoch — a chunk's coverage is validated
        against ITS epoch's tier sizes, so even a pure tier-boundary move
        (same clauses, shifted cut-points from cost recalibration) must
        ride an epoch bump; in-flight chunks then fail with
        StaleEpochError and get re-evaluated, never mis-validated.
        """
        store = self.store
        rep = build_plan_family(
            workload, self.sample_records,
            tier_budgets_us=self.tier_budgets_us, cost_model=cm, sel=sel,
        )
        # no-change guard on per-tier clause SETS, not order: the greedy
        # may swap near-equal-gain clauses within a tier after an obs
        # update, and tiers are prefix cuts — if every cut's set matches
        # (sizes equal), every tier's coverage is semantically identical
        # and an epoch bump would only reset stats / invalidate chunks
        same_tiers = (
            rep.family.tier_sizes == store.family.tier_sizes
            and all(
                set(rep.tiered.order[:s]) == set(store.plan.clauses[:s])
                for s in rep.family.tier_sizes)
        )
        if same_tiers:
            self._planned_sel = {
                c: self._sel_cache.get(c, sel.get(c, SEL_FLOOR))
                for c in store.plan.clauses
            }
            return None
        family = evolve_family(
            store.plan, rep.tiered.order, rep.family.tier_sizes,
            budgets=rep.family.budgets, tier_costs=rep.family.tier_costs,
            tier_values=rep.family.tier_values,
        )
        remap = store.advance_epoch(family)
        self._planned_sel = {c: sel.get(c, SEL_FLOOR)
                             for c in family.plan.clauses}
        self.history.append(ReplanEvent(
            epoch=family.epoch, reason=reason, signal=signal,
            report=rep, remap=remap, cost_scale=self.cost_scale,
        ))
        return family
