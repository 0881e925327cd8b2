"""Query-workload modelling and generation (paper §VII-C).

Queries follow the paper's template  SELECT COUNT(*) FROM t WHERE <conj>,
with conjunctive predicates drawn from a *predicate pool* built from
per-dataset templates (paper Table II).  Each predicate gets an inclusion
probability; the expected number of predicates per query is fixed (3 in the
paper) while the inclusion distribution is varied (Zipfian(1.5) / Zipfian(2)
/ uniform -> workloads A / B / C, Table III).

Also implements the paper's skewness factor (§VII-E3) and sample-based
selectivity estimation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from .predicates import Clause, Query


@dataclass
class Workload:
    name: str
    queries: list[Query]

    def clause_pool(self) -> list[Clause]:
        seen: dict[Clause, None] = {}
        for q in self.queries:
            for c in q.clauses:
                seen.setdefault(c, None)
        return list(seen)

    def total_predicates(self) -> int:
        """Paper Table III '#Predicates': summed over queries (with repeats)."""
        return sum(len(q.clauses) for q in self.queries)

    def min_max_predicates(self) -> tuple[int, int]:
        ns = [len(q.clauses) for q in self.queries]
        return min(ns), max(ns)

    def skewness_factor(self) -> float:
        """Paper §VII-E3 third-moment skewness of predicate→query counts."""
        pool = self.clause_pool()
        counts = np.array(
            [sum(1 for q in self.queries for c in q.clauses if c == p) for p in pool],
            dtype=np.float64,
        )
        n = len(counts)
        if n < 2:
            return 0.0
        mean = counts.mean()
        sigma = np.sqrt(((counts - mean) ** 2).sum() / n)
        if sigma == 0:
            return 0.0
        return float(((counts - mean) ** 3).sum() / ((n - 1) * sigma**3))


def generate_workload(
    pool: Sequence[Clause],
    *,
    n_queries: int,
    expected_preds_per_query: float = 3.0,
    distribution: str = "uniform",
    zipf_a: float = 1.5,
    rng: np.random.Generator | None = None,
    name: str = "workload",
) -> Workload:
    """Draw conjunctive queries from a clause pool (paper §VII-C).

    Each clause i gets inclusion probability w_i * E[#preds] / sum(w), where
    w is uniform or Zipfian-ranked.  Queries with zero clauses are redrawn
    (every paper workload has min #preds >= 1).
    """
    rng = rng or np.random.default_rng(0)
    n = len(pool)
    if distribution == "uniform":
        w = np.ones(n)
    elif distribution == "zipf":
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = ranks ** (-zipf_a)
        w = w[rng.permutation(n)]  # decouple rank from pool order
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    probs = np.clip(w / w.sum() * expected_preds_per_query, 0.0, 1.0)

    queries: list[Query] = []
    while len(queries) < n_queries:
        mask = rng.random(n) < probs
        idx = np.nonzero(mask)[0]
        if len(idx) == 0:
            continue
        queries.append(Query(tuple(pool[i] for i in idx), freq=1.0))
    return Workload(name=name, queries=queries)


def estimate_selectivities(
    clauses: Sequence[Clause],
    sample_records: Sequence[bytes],
    *,
    floor: float = 1e-4,
) -> dict[Clause, float]:
    """Match-based selectivity on a record sample (client semantics).

    Uses the raw pattern-match semantics (including false positives) because
    that is exactly the fraction of bits that will be set — which drives both
    the loading ratio and the cost model's found/not-found split.

    With NO sample at all, falls back to the skipping-index registry's
    per-kind selectivity priors (``SkipIndexRegistry.
    clause_selectivity_prior``) instead of flattening every clause to
    ``floor`` — so CELF selection (``tiered_celf`` via the planner) and
    the Replanner still rank a point lookup above a broad presence probe.
    """
    out: dict[Clause, float] = {}
    if not sample_records:
        from .skip_index import REGISTRY
        for c in clauses:
            out[c] = max(REGISTRY.clause_selectivity_prior(c), floor)
        return out
    n = len(sample_records)
    for c in clauses:
        hits = sum(1 for r in sample_records if c.matches_raw(r))
        out[c] = max(hits / n, floor)
    return out


# ---------------------------------------------------------------------------
# workload drift (replan control plane's test signal; DESIGN.md §11)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DriftPhase:
    """One stationary regime of a piecewise-stationary query stream.

    A phase draws ``n_queries`` from the clause pool with its own Zipf
    parameter and its own rank permutation seed — shifting either between
    phases moves the *hot* clause set, which is exactly the drift a static
    epoch-0 plan cannot follow (Ta-Shma et al.: skipping indexes must track
    workload drift to stay effective).
    """

    n_queries: int
    distribution: str = "zipf"
    zipf_a: float = 1.5
    seed: int = 0
    expected_preds_per_query: float = 3.0


def drifting_workloads(
    pool: Sequence[Clause],
    phases: Sequence[DriftPhase],
    *, name: str = "drift",
) -> list[Workload]:
    """One :class:`Workload` per phase (the piecewise-stationary stream)."""
    out = []
    for i, ph in enumerate(phases):
        out.append(
            generate_workload(
                pool,
                n_queries=ph.n_queries,
                expected_preds_per_query=ph.expected_preds_per_query,
                distribution=ph.distribution,
                zipf_a=ph.zipf_a,
                rng=np.random.default_rng(ph.seed),
                name=f"{name}[{i}]",
            )
        )
    return out


def drifting_query_stream(
    pool: Sequence[Clause],
    phases: Sequence[DriftPhase],
    *, name: str = "drift",
) -> Iterator[Query]:
    """Flat query iterator over the phases, in order (drift at boundaries)."""
    for wl in drifting_workloads(pool, phases, name=name):
        yield from wl.queries


def uniform_frequencies(workload: Workload) -> Workload:
    """Paper: 'we present results with a uniform query frequency'."""
    qs = [Query(q.clauses, freq=1.0 / len(workload.queries)) for q in workload.queries]
    return Workload(name=workload.name, queries=qs)
