"""End-to-end CIAO planning (paper §III Step 1).

Inputs: a query workload, a record sample, a client computation budget
(µs/record), and a calibrated cost model.  Output: a :class:`PushdownPlan`
with per-clause ids and pattern strings, ready to ship to clients.

Per-client budgets: the paper (§I, abstract) notes CIAO "will address the
trade-off between client cost and server savings by setting different budgets
for different clients".  :func:`plan_for_clients` supports a budget per client
class — each class gets its own knapsack solve over the same workload stats,
so under-powered clients push fewer predicates (possibly none).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from .cost_model import CostModel
from .predicates import Clause
from .selection import (
    SelectionProblem,
    SelectionResult,
    TieredSelection,
    combined_celf,
    combined_greedy,
    tiered_celf,
)
from .server import PlanFamily, PushdownPlan
from .workload import Workload, estimate_selectivities


@dataclass
class PlanReport:
    plan: PushdownPlan
    selection: SelectionResult
    sel: dict[Clause, float]
    cost: dict[Clause, float]
    budget_us: float

    def describe(self) -> str:
        lines = [
            f"budget={self.budget_us:.3f}us  {self.selection.describe()}",
        ]
        for c in self.plan.clauses:
            lines.append(
                f"  id={self.plan.ids[c]} sel={self.sel[c]:.4f} "
                f"cost={self.cost[c]:.4f}us  {c.describe()}"
            )
        return "\n".join(lines)


def build_plan(
    workload: Workload,
    sample_records: Sequence[bytes],
    *,
    budget_us: float,
    cost_model: CostModel | None = None,
    algorithm: str = "celf",
    sel: Mapping[Clause, float] | None = None,
) -> PlanReport:
    """Estimate stats, solve the budgeted selection, emit the plan."""
    cost_model = cost_model or CostModel()
    pool = workload.clause_pool()
    sel_map = dict(sel) if sel is not None else estimate_selectivities(pool, sample_records)
    cost_map = {c: cost_model.clause_cost(c, sel_map[c]) for c in pool}
    problem = SelectionProblem(
        queries=tuple(workload.queries),
        sel=sel_map,
        cost=cost_map,
        budget=budget_us,
    )
    solver = combined_celf if algorithm == "celf" else combined_greedy
    result = solver(problem)
    plan = PushdownPlan(clauses=list(result.selected))
    return PlanReport(
        plan=plan, selection=result, sel=sel_map, cost=cost_map, budget_us=budget_us
    )


@dataclass
class FamilyReport:
    """A :class:`PlanFamily` plus the stats it was solved from."""

    family: PlanFamily
    tiered: TieredSelection
    sel: dict[Clause, float]
    cost: dict[Clause, float]

    @property
    def plan(self) -> PushdownPlan:
        return self.family.plan

    def describe(self) -> str:
        lines = [self.tiered.describe()]
        sizes = self.family.tier_sizes
        for i, c in enumerate(self.family.plan.clauses):
            tier = next(t for t, s in enumerate(sizes) if i < s)
            lines.append(
                f"  id={i} tier>={tier} sel={self.sel[c]:.4f} "
                f"cost={self.cost[c]:.4f}us  {c.describe()}"
            )
        return "\n".join(lines)


def build_plan_family(
    workload: Workload,
    sample_records: Sequence[bytes],
    *,
    tier_budgets_us: Sequence[float],
    cost_model: CostModel | None = None,
    sel: Mapping[Clause, float] | None = None,
) -> FamilyReport:
    """Solve every budget tier with ONE CELF run -> nested plan family.

    The paper's per-client-budget trade-off (§VI) without per-class
    re-solves: ``tiered_celf`` cuts the top-budget greedy order at each
    budget, so tier *t* is the prefix-greedy solution for
    ``tier_budgets_us[t]`` and T0 ⊆ T1 ⊆ … ⊆ Tk by construction.  The
    returned family's ``tier_costs``/``tier_values`` feed the fleet
    allocator (``selection.allocate_tiers``).
    """
    cost_model = cost_model or CostModel()
    pool = workload.clause_pool()
    sel_map = (dict(sel) if sel is not None
               else estimate_selectivities(pool, sample_records))
    cost_map = {c: cost_model.clause_cost(c, sel_map[c]) for c in pool}
    problem = SelectionProblem(
        queries=tuple(workload.queries),
        sel=sel_map,
        cost=cost_map,
        budget=max(tier_budgets_us),
    )
    tiered = tiered_celf(problem, tier_budgets_us)
    plan = PushdownPlan(clauses=list(tiered.order))
    family = PlanFamily(
        plan=plan,
        tier_sizes=tiered.tier_sizes,
        budgets=tiered.budgets,
        tier_costs=tuple(tiered.tier_cost(t) for t in range(tiered.n_tiers)),
        tier_values=tiered.objectives,
    )
    return FamilyReport(family=family, tiered=tiered, sel=sel_map,
                        cost=cost_map)


def plan_for_clients(
    workload: Workload,
    sample_records: Sequence[bytes],
    *,
    client_budgets_us: Mapping[str, float],
    cost_model: CostModel | None = None,
    algorithm: str = "celf",
) -> dict[str, PlanReport]:
    """One plan per client class (heterogeneous-budget deployment)."""
    cost_model = cost_model or CostModel()
    pool = workload.clause_pool()
    sel_map = estimate_selectivities(pool, sample_records)
    return {
        cls: build_plan(
            workload,
            sample_records,
            budget_us=b,
            cost_model=cost_model,
            algorithm=algorithm,
            sel=sel_map,
        )
        for cls, b in client_budgets_us.items()
    }
