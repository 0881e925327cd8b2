"""Selection-algorithm benchmarks on the port (the JAX package's
``benchmarks/bench_selection.py``; host only): eager vs CELF scaling,
combined-greedy quality vs brute-force OPT on small instances.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_selection

Writes ``artifacts/bench_torch_selection.json`` with the card's name and
power limit (``--device cpu``: none).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.benchmarks.common import card, write_artifact
from repro_torch.core.predicates import Query, clause, key_value
from repro_torch.core.selection import (
    SelectionProblem, brute_force, celf_greedy, combined_greedy,
    greedy,
)


def _problem(rng, n_preds, n_queries, budget):
    pool = [clause(key_value(f"k{i}", i)) for i in range(n_preds)]
    sel = {c: float(rng.uniform(0.01, 0.9)) for c in pool}
    cost = {c: float(rng.uniform(0.1, 1.0)) for c in pool}
    queries = [
        Query(tuple(pool[i] for i in rng.choice(n_preds, size=rng.integers(1, 6),
                                                replace=False)))
        for _ in range(n_queries)
    ]
    return SelectionProblem(tuple(queries), sel, cost, budget)


def scaling(sizes=((100, 200), (400, 800), (1000, 2000), (2000, 4000))):
    rng = np.random.default_rng(0)
    rows = []
    for n_preds, n_queries in sizes:
        p = _problem(rng, n_preds, n_queries, budget=10.0)
        t0 = time.perf_counter()
        e = greedy(p, ratio=True)
        t_eager = time.perf_counter() - t0
        t0 = time.perf_counter()
        l = celf_greedy(p, ratio=True)
        t_celf = time.perf_counter() - t0
        assert abs(e.objective - l.objective) < 1e-9
        rows.append({
            "n_preds": n_preds, "n_queries": n_queries,
            "eager_s": round(t_eager, 4), "celf_s": round(t_celf, 4),
            "eager_evals": e.evaluations, "celf_evals": l.evaluations,
            "speedup": round(t_eager / max(t_celf, 1e-9), 2),
        })
        print(f"[selection] P={n_preds} Q={n_queries}: eager {t_eager:.3f}s "
              f"({e.evaluations} evals) vs CELF {t_celf:.3f}s "
              f"({l.evaluations} evals) -> x{rows[-1]['speedup']}")
    return rows


def quality(n_trials=20):
    rng = np.random.default_rng(1)
    worst = 1.0
    for _ in range(n_trials):
        p = _problem(rng, 10, 8, budget=float(rng.uniform(0.5, 3.0)))
        opt = brute_force(p)
        res = combined_greedy(p)
        if opt.objective > 0:
            worst = min(worst, res.objective / opt.objective)
    print(f"[selection] combined-greedy worst-case f/OPT over {n_trials} "
          f"trials: {worst:.3f} (guarantee: 0.316)")
    return {"worst_ratio": round(worst, 4), "n_trials": n_trials}


def main(device: str = "cuda"):
    out = {"device": device, "card": card(device), "scaling": scaling(),
           "quality": quality()}
    print(f"wrote {write_artifact('selection', out)}")
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
