"""Budgeted predicate selection (paper §V).

Maximize the expected filter benefit

    f(S) = sum_q freq(q) * (1 - prod_{c in S ∩ P_q} sel(c))

subject to  sum_{c in S} cost(c) <= B.   f is submodular (paper §V-B), and
the knapsack-constrained greedy pair (Khuller/Moss/Naor) gives a
(1/2)(1 - 1/e) ≈ 0.316 approximation:

  * Algorithm 1 — naive greedy: argmax_{p} f(S ∪ {p})           (max gain)
  * Algorithm 2 — ratio greedy: argmax_{p} Δf / cost(p)          (max gain/cost)
  * combined    — run both, keep the better f(S).

Beyond-paper: :func:`celf_greedy` implements CELF lazy evaluation (valid by
submodularity: stale marginal gains are upper bounds), which returns the
*identical* set to the eager greedy while evaluating far fewer marginals —
our selection-scaling benchmark quantifies the speedup.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np

from .predicates import Clause, Query


@dataclass(frozen=True)
class SelectionProblem:
    """Immutable problem instance: queries + per-clause selectivity & cost."""

    queries: tuple[Query, ...]
    sel: Mapping[Clause, float]
    cost: Mapping[Clause, float]
    budget: float

    def candidates(self) -> list[Clause]:
        seen: dict[Clause, None] = {}
        for q in self.queries:
            for c in q.clauses:
                if c in self.sel and c in self.cost:
                    seen.setdefault(c, None)
        return list(seen)


@dataclass
class SelectionResult:
    selected: list[Clause]
    objective: float
    total_cost: float
    algorithm: str
    evaluations: int = 0  # marginal-gain evaluations (CELF metric)

    def describe(self) -> str:
        return (
            f"{self.algorithm}: |S|={len(self.selected)} f(S)={self.objective:.4f} "
            f"cost={self.total_cost:.4f} evals={self.evaluations}"
        )


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def objective(problem: SelectionProblem, S: Iterable[Clause]) -> float:
    Sset = set(S)
    total = 0.0
    for q in problem.queries:
        prod = 1.0
        for c in q.clauses:
            if c in Sset:
                prod *= problem.sel[c]
        total += q.freq * (1.0 - prod)
    return total


class _Marginals:
    """Incremental marginal-gain evaluation.

    Keeps per-query running product of selected clauses' selectivities so a
    marginal gain is O(#queries containing the clause).
    """

    def __init__(self, problem: SelectionProblem):
        self.problem = problem
        self.query_prod = [1.0] * len(problem.queries)
        self.by_clause: dict[Clause, list[int]] = {}
        for qi, q in enumerate(problem.queries):
            for c in q.clauses:
                self.by_clause.setdefault(c, []).append(qi)
        self.evaluations = 0

    def gain(self, c: Clause) -> float:
        self.evaluations += 1
        s = self.problem.sel[c]
        g = 0.0
        for qi in self.by_clause.get(c, ()):  # queries containing c
            g += self.problem.queries[qi].freq * self.query_prod[qi] * (1.0 - s)
        return g

    def add(self, c: Clause) -> None:
        s = self.problem.sel[c]
        for qi in self.by_clause.get(c, ()):
            self.query_prod[qi] *= s

    def objective_value(self) -> float:
        return sum(
            q.freq * (1.0 - p) for q, p in zip(self.problem.queries, self.query_prod)
        )


# ---------------------------------------------------------------------------
# Algorithms 1 & 2 (paper) — eager greedy
# ---------------------------------------------------------------------------

def greedy(problem: SelectionProblem, *, ratio: bool) -> SelectionResult:
    """Eager greedy.  ``ratio=False`` -> Alg.1 (max gain); True -> Alg.2."""
    marg = _Marginals(problem)
    remaining = set(problem.candidates())
    S: list[Clause] = []
    spent = 0.0
    while True:
        best_c, best_key = None, -np.inf
        for c in remaining:
            cost_c = problem.cost[c]
            if spent + cost_c > problem.budget + 1e-12:
                continue
            g = marg.gain(c)
            key = g / cost_c if ratio else g
            if key > best_key:
                best_key, best_c = key, c
        if best_c is None:
            break
        S.append(best_c)
        spent += problem.cost[best_c]
        marg.add(best_c)
        remaining.discard(best_c)
    return SelectionResult(
        selected=S,
        objective=marg.objective_value(),
        total_cost=spent,
        algorithm="ratio-greedy" if ratio else "naive-greedy",
        evaluations=marg.evaluations,
    )


def combined_greedy(problem: SelectionProblem) -> SelectionResult:
    """Paper §V-C: better of Alg.1 / Alg.2 — >= 0.316 * OPT."""
    a = greedy(problem, ratio=False)
    b = greedy(problem, ratio=True)
    best = a if a.objective >= b.objective else b
    return SelectionResult(
        selected=best.selected,
        objective=best.objective,
        total_cost=best.total_cost,
        algorithm=f"combined({best.algorithm})",
        evaluations=a.evaluations + b.evaluations,
    )


# ---------------------------------------------------------------------------
# CELF lazy greedy (beyond-paper optimization, identical output)
# ---------------------------------------------------------------------------

def _celf_run(problem: SelectionProblem, *, ratio: bool
              ) -> tuple[list[Clause], list[float], _Marginals]:
    """The CELF loop itself: selection order + cumulative costs + marginals.

    Shared by :func:`celf_greedy` (single budget) and :func:`tiered_celf`
    (nested budget cut-points over ONE run).
    """
    marg = _Marginals(problem)
    heap: list[tuple[float, int, Clause]] = []
    seq = itertools.count()
    for c in problem.candidates():
        g = marg.gain(c)
        key = g / problem.cost[c] if ratio else g
        heapq.heappush(heap, (-key, next(seq), c))
    S: list[Clause] = []
    cum_cost: list[float] = []
    spent = 0.0
    round_id = 0
    fresh: dict[Clause, int] = {c: 0 for c in problem.candidates()}
    while heap:
        negkey, sq, c = heapq.heappop(heap)
        if spent + problem.cost[c] > problem.budget + 1e-12:
            continue  # cannot afford; drop (cost is static, gain only shrinks)
        if fresh[c] == round_id:
            S.append(c)
            spent += problem.cost[c]
            cum_cost.append(spent)
            marg.add(c)
            round_id += 1
        else:
            g = marg.gain(c)
            key = g / problem.cost[c] if ratio else g
            fresh[c] = round_id
            heapq.heappush(heap, (-key, sq, c))
    return S, cum_cost, marg


def celf_greedy(problem: SelectionProblem, *, ratio: bool) -> SelectionResult:
    """Lazy greedy with a max-heap of stale gains (upper bounds).

    Submodularity guarantees a clause's marginal gain only decreases as S
    grows, so a heap entry whose gain was computed at the current round size
    is exact and safe to pop.  Ties are broken identically to the eager
    greedy (by heap order on (-key, seq)).
    """
    S, cum_cost, marg = _celf_run(problem, ratio=ratio)
    return SelectionResult(
        selected=S,
        objective=marg.objective_value(),
        total_cost=cum_cost[-1] if cum_cost else 0.0,
        algorithm="celf-ratio" if ratio else "celf-naive",
        evaluations=marg.evaluations,
    )


def combined_celf(problem: SelectionProblem) -> SelectionResult:
    a = celf_greedy(problem, ratio=False)
    b = celf_greedy(problem, ratio=True)
    best = a if a.objective >= b.objective else b
    return SelectionResult(
        selected=best.selected,
        objective=best.objective,
        total_cost=best.total_cost,
        algorithm=f"combined({best.algorithm})",
        evaluations=a.evaluations + b.evaluations,
    )


# ---------------------------------------------------------------------------
# multi-budget (tiered) selection — one CELF run, nested budget cut-points
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TieredSelection:
    """Nested budget tiers T0 ⊆ T1 ⊆ … ⊆ Tk from ONE CELF run.

    ``order`` is the greedy selection order under the TOP budget; tier *t*
    is the longest prefix whose cumulative cost fits ``budgets[t]``.  The
    greedy prefix property makes every tier the prefix-greedy solution for
    its own budget, and the nesting invariant Ti ⊆ Ti+1 holds by
    construction — which is what lets a fleet run unequal tiers against
    ONE clause universe (clause local ids are prefix-stable across tiers).
    """

    budgets: tuple[float, ...]      # ascending
    order: tuple[Clause, ...]       # greedy order under the top budget
    cum_costs: tuple[float, ...]    # cumulative cost after each selection
    tier_sizes: tuple[int, ...]     # |Tt|, non-decreasing, last == len(order)
    objectives: tuple[float, ...]   # f(Tt) per tier
    evaluations: int = 0

    @property
    def n_tiers(self) -> int:
        return len(self.budgets)

    def tier(self, t: int) -> tuple[Clause, ...]:
        return self.order[: self.tier_sizes[t]]

    def tier_cost(self, t: int) -> float:
        k = self.tier_sizes[t]
        return self.cum_costs[k - 1] if k else 0.0

    def describe(self) -> str:
        parts = [
            f"T{t}: |S|={self.tier_sizes[t]} f={self.objectives[t]:.4f} "
            f"cost={self.tier_cost(t):.3f}/{self.budgets[t]:.3f}"
            for t in range(self.n_tiers)
        ]
        return "tiered-celf  " + "  ".join(parts)


def tiered_celf(problem: SelectionProblem,
                budgets: Sequence[float], *, ratio: bool = True
                ) -> TieredSelection:
    """Solve every budget tier with ONE CELF run (paper §VI trade-off).

    ``problem.budget`` is ignored; the run uses ``max(budgets)``.  Budgets
    must be ascending.  Because CELF emits clauses in greedy order with
    monotone cumulative cost, cutting that order at each budget yields
    nested tiers — no per-tier re-solve, so a k-tier family costs the same
    marginal evaluations as the single top-budget solve.
    """
    if not budgets:
        raise ValueError("need at least one tier budget")
    bs = tuple(float(b) for b in budgets)
    if any(b < 0 for b in bs):
        raise ValueError(f"tier budgets must be non-negative: {bs}")
    if any(b2 < b1 for b1, b2 in zip(bs, bs[1:])):
        raise ValueError(f"tier budgets must be ascending: {bs}")
    top = SelectionProblem(queries=problem.queries, sel=problem.sel,
                           cost=problem.cost, budget=bs[-1])
    order, cum, marg = _celf_run(top, ratio=ratio)
    sizes = []
    for b in bs:
        k = 0
        while k < len(order) and cum[k] <= b + 1e-12:
            k += 1
        sizes.append(k)
    objectives = tuple(objective(problem, order[:k]) for k in sizes)
    return TieredSelection(
        budgets=bs, order=tuple(order), cum_costs=tuple(cum),
        tier_sizes=tuple(sizes), objectives=objectives,
        evaluations=marg.evaluations,
    )


# ---------------------------------------------------------------------------
# fleet tier allocation — split a GLOBAL client-cost budget across clients
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClientProfile:
    """What the allocator knows about one client.

    ``cost_scale`` — measured µs spent per *modeled* µs of plan cost (a
    slow phone has scale ≫ 1; recalibrated online from per-shard timing
    reports).  ``weight`` — the client's share of ingested records per
    unit time (its data volume: savings from pushing a clause set to this
    client scale with how many records it contributes).
    """

    cost_scale: float = 1.0
    weight: float = 1.0


@dataclass
class TierAllocation:
    """Per-client tier assignment under a global cost budget."""

    tiers: list[int]            # tier index per client
    spent: float                # sum_j weight_j * scale_j * tier_cost[t_j]
    budget: float
    expected_savings: float     # sum_j weight_j * tier_value[t_j]
    upgrades: int = 0           # greedy upgrade steps taken

    @property
    def feasible(self) -> bool:
        return self.spent <= self.budget + 1e-9

    def describe(self) -> str:
        return (f"tiers={self.tiers} spent={self.spent:.3f}/"
                f"{self.budget:.3f} savings={self.expected_savings:.4f}")


def allocate_tiers(
    tier_costs: Sequence[float],
    tier_values: Sequence[float],
    clients: Sequence[ClientProfile],
    budget: float,
) -> TierAllocation:
    """Maximize expected server savings under a global client-cost budget.

    Multiple-choice knapsack over the nested tiers: every client starts at
    tier 0 and greedy upgrades are applied in order of marginal savings per
    marginal cost, ``weight_j * Δvalue / (weight_j * scale_j * Δcost)``.
    Along a CELF prefix the per-tier value increments are diminishing
    (submodularity), so each client's upgrade ratios are non-increasing
    and the greedy matches the LP-relaxation optimum up to one fractional
    upgrade — the classical MCKP argument.

    A client whose next upgrade does not fit is frozen (its later upgrades
    are nested behind the unaffordable one).  Tier 0 is never refused: if
    even the floor exceeds the budget the allocation is returned as-is
    with ``feasible == False`` (the caller should widen the family or the
    budget rather than silently dropping clients).
    """
    k = len(tier_costs)
    if k != len(tier_values):
        raise ValueError("tier_costs and tier_values must have equal length")
    if any(c2 < c1 for c1, c2 in zip(tier_costs, tier_costs[1:])):
        raise ValueError("tier costs must be non-decreasing (nested tiers)")
    tiers = [0] * len(clients)
    spent = sum(cl.weight * cl.cost_scale * tier_costs[0] for cl in clients)
    savings = sum(cl.weight * tier_values[0] for cl in clients)
    heap: list[tuple[float, int]] = []

    def push_upgrade(j: int) -> None:
        t = tiers[j]
        if t + 1 >= k:
            return
        cl = clients[j]
        dv = cl.weight * (tier_values[t + 1] - tier_values[t])
        dc = cl.weight * cl.cost_scale * (tier_costs[t + 1] - tier_costs[t])
        if dc <= 0.0:  # free upgrade (identical tier cut): take it outright
            ratio = np.inf
        else:
            ratio = dv / dc
        heapq.heappush(heap, (-ratio, j))

    for j in range(len(clients)):
        push_upgrade(j)
    upgrades = 0
    while heap:
        _, j = heapq.heappop(heap)
        t = tiers[j]
        if t + 1 >= k:
            continue
        cl = clients[j]
        dc = cl.weight * cl.cost_scale * (tier_costs[t + 1] - tier_costs[t])
        if spent + dc > budget + 1e-9:
            continue  # frozen: nested upgrades behind this one cost >= dc
        tiers[j] = t + 1
        spent += dc
        savings += cl.weight * (tier_values[t + 1] - tier_values[t])
        upgrades += 1
        push_upgrade(j)
    return TierAllocation(tiers=tiers, spent=spent, budget=float(budget),
                          expected_savings=savings, upgrades=upgrades)


# ---------------------------------------------------------------------------
# exact OPT (tests only — exponential)
# ---------------------------------------------------------------------------

def brute_force(problem: SelectionProblem, max_candidates: int = 18) -> SelectionResult:
    cands = problem.candidates()
    if len(cands) > max_candidates:
        raise ValueError(f"brute force capped at {max_candidates} candidates")
    best_S: tuple[Clause, ...] = ()
    best_f = 0.0
    for r in range(len(cands) + 1):
        for S in itertools.combinations(cands, r):
            if sum(problem.cost[c] for c in S) > problem.budget + 1e-12:
                continue
            fS = objective(problem, S)
            if fS > best_f:
                best_f, best_S = fS, S
    return SelectionResult(
        selected=list(best_S),
        objective=best_f,
        total_cost=sum(problem.cost[c] for c in best_S),
        algorithm="brute-force",
    )
