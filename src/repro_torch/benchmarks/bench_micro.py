"""Paper Figs 6-12 on the port: micro-benchmarks (the JAX package's
``benchmarks/bench_micro.py``), with every client chunk's pushed clauses
on kernel A (``KernelEngine("cuda")``; ``--device cpu``: its plain
version).

  * Fig 6: fraction of queries with lower query time due to skipping
    (YCSB, workload C, varied budgets; paper: 37-68%).
  * Figs 7/8: selectivity sensitivity (winlog; sel 0.01/0.15/0.35;
    loading ratio tracks union selectivity; query time drops with sel).
  * Figs 9/10: overlap sensitivity (1/2/4 predicates per query).
  * Figs 11/12: skewness sensitivity (skew factor 0 / 0.5 / 2.0).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_micro [--device cpu]

Writes ``artifacts/bench_torch_micro.json`` with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import (
    BACKEND, card, make_workload, write_artifact,
)
from repro_torch.core.client import encode_chunk
from repro_torch.core.predicates import Query
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, FullScanBaseline, PushdownPlan,
)
from repro_torch.core.workload import Workload, estimate_selectivities
from repro_torch.data.datasets import generate_records, predicate_pool



def _ingest(records, plan, eng, chunk_size=1000):
    store = CiaoStore(plan)
    base = FullScanBaseline()
    for i in range(0, len(records), chunk_size):
        chunk = encode_chunk(records[i: i + chunk_size])
        bv = (eng.eval_packed(chunk, plan.clauses) if plan.n
              else np.zeros((0, 0), np.uint32))
        store.ingest_chunk(chunk, bv)
        base.ingest_chunk(chunk)
    return store, base


# ---------------------------------------------------------------------------
# Fig 6: fraction of queries that benefit
# ---------------------------------------------------------------------------

def query_fraction(eng, n_records=8000,
                   budgets=(0.25, 0.5, 1.0, 2.0)) -> list[dict]:
    from repro_torch.core.planner import build_plan

    records = generate_records("ycsb", n_records, seed=23)
    wl = make_workload("ycsb", "C", n_queries=60, seed=5)
    rows = []
    for budget in budgets:
        rep = build_plan(wl, records[:500], budget_us=budget)
        store, base = _ingest(records, rep.plan, eng)
        scanner = DataSkippingScanner(store)
        store.jit_load_raw()  # exclude one-time JIT from per-query timing
        n_better = 0
        for q in wl.queries:
            t_ciao = min(scanner.scan(q).time_s for _ in range(2))
            t_base = min(base.scan(q).time_s for _ in range(2))
            if t_ciao < t_base:
                n_better += 1
        frac = n_better / len(wl.queries)
        rows.append({"budget_us": budget, "n_pushed": rep.plan.n,
                     "fraction_improved": round(frac, 3)})
        print(f"[fig6] budget={budget}: {frac:.0%} of queries improved "
              f"(paper: 37-68%)")
    return rows


# ---------------------------------------------------------------------------
# Figs 7/8: selectivity
# ---------------------------------------------------------------------------

def _winlog_clauses_by_selectivity(records, target_sel):
    pool = predicate_pool("winlog")
    sel = estimate_selectivities(pool, records[:1000])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - target_sel))
    return ranked, sel


def selectivity_sweep(eng, n_records=8000) -> list[dict]:
    records = generate_records("winlog", n_records, seed=29)
    rows = []
    for target in (0.01, 0.15, 0.35):
        ranked, sel = _winlog_clauses_by_selectivity(records, target)
        pushed = ranked[:2]                      # paper: push 2 predicates
        plan = PushdownPlan(clauses=pushed)
        store, base = _ingest(records, plan, eng)
        q = Query((pushed[0],))
        scanner = DataSkippingScanner(store)
        t_q = min(scanner.scan(q).time_s for _ in range(3))
        t_b = min(base.scan(q).time_s for _ in range(3))
        rows.append({
            "target_sel": target,
            "actual_sel": round(float(np.mean([sel[c] for c in pushed])), 4),
            "loading_ratio": round(store.stats.loading_ratio, 4),
            "load_s": round(store.stats.load_time_s, 4),
            "base_load_s": round(base.stats.load_time_s, 4),
            "query_speedup": round(t_b / max(t_q, 1e-9), 2),
        })
        print(f"[fig7/8] sel~{target}: ratio={rows[-1]['loading_ratio']} "
              f"query x{rows[-1]['query_speedup']}")
    return rows


# ---------------------------------------------------------------------------
# Figs 9/10: predicate overlap
# ---------------------------------------------------------------------------

def overlap_sweep(eng, n_records=8000) -> list[dict]:
    records = generate_records("winlog", n_records, seed=31)
    ranked, sel = _winlog_clauses_by_selectivity(records, 0.15)
    pushed = ranked[:2]
    rows = []
    for name, preds_per_query in (("L_ol", 1), ("M_ol", 2), ("H_ol", 4)):
        # queries that include the pushed predicates `preds_per_query` deep
        queries = []
        for qi in range(5):
            cls = tuple(ranked[qi: qi + preds_per_query]) if preds_per_query > 1 \
                else (ranked[2 + qi],)
            if preds_per_query >= 2:
                cls = tuple(pushed[:preds_per_query]) if preds_per_query <= 2 \
                    else tuple(pushed) + tuple(ranked[2 + qi: 2 + qi + preds_per_query - 2])
            queries.append(Query(cls))
        plan = PushdownPlan(clauses=pushed)
        store, base = _ingest(records, plan, eng)
        scanner = DataSkippingScanner(store)
        covered = sum(1 for q in queries if plan.pushed_in(q))
        t_q = sum(scanner.scan(q).time_s for q in queries)
        t_b = sum(base.scan(q).time_s for q in queries)
        rows.append({
            "workload": name,
            "covered_queries": covered,
            "loading_ratio": round(store.stats.loading_ratio, 4),
            "query_speedup": round(t_b / max(t_q, 1e-9), 2),
        })
        print(f"[fig9/10] {name}: covered={covered}/5 "
              f"query x{rows[-1]['query_speedup']}")
    return rows


# ---------------------------------------------------------------------------
# Figs 11/12: skewness
# ---------------------------------------------------------------------------

def skewness_sweep(eng, n_records=8000) -> list[dict]:
    records = generate_records("winlog", n_records, seed=37)
    ranked, sel = _winlog_clauses_by_selectivity(records, 0.1)
    hot = ranked[0]
    rows = []
    # 5 queries x 2 predicates; vary how many queries contain the hot clause
    for name, n_covered in (("L_sk", 1), ("M_sk", 3), ("H_sk", 5)):
        queries = []
        for qi in range(5):
            if qi < n_covered:
                queries.append(Query((hot, ranked[3 + qi])))
            else:
                queries.append(Query((ranked[3 + qi], ranked[9 + qi])))
        wl = Workload(name=name, queries=queries)
        plan = PushdownPlan(clauses=[hot])       # paper: push ONE predicate
        store, base = _ingest(records, plan, eng)
        scanner = DataSkippingScanner(store)
        t_q = sum(scanner.scan(q).time_s for q in queries)
        t_b = sum(base.scan(q).time_s for q in queries)
        rows.append({
            "workload": name,
            "skewness_factor": round(wl.skewness_factor(), 3),
            "loading_ratio": round(store.stats.loading_ratio, 4),
            "load_s": round(store.stats.load_time_s, 4),
            "base_load_s": round(base.stats.load_time_s, 4),
            "query_speedup": round(t_b / max(t_q, 1e-9), 2),
        })
        print(f"[fig11/12] {name}: skew={rows[-1]['skewness_factor']} "
              f"ratio={rows[-1]['loading_ratio']} query x{rows[-1]['query_speedup']}")
    return rows


# ---------------------------------------------------------------------------
# pattern-compilation memoization (client hot path)
# ---------------------------------------------------------------------------

def patterns_memo(n_records=2000, repeats=3) -> dict:
    """`SimplePredicate.patterns()` must compile once per instance.

    The client engines call it per (record, term); before memoization
    each call re-encoded the pattern bytes.  Asserts the memo (identity
    across calls — deterministic) and reports the raw-match throughput.
    """
    import time

    from repro_torch.core.predicates import between, in_list, key_value, substring

    preds = [substring("f1", "needle"), key_value("f2", 42),
             between("f3", 10, 20), in_list("f4", ["a", "b", "c"])]
    for p in preds:
        assert p.patterns() is p.patterns(), \
            f"patterns() not memoized for {p.describe()}"
    records = [enc for enc in (
        json.dumps({"f1": f"x{i}needle", "f2": i % 100,
                    "f3": i % 37, "f4": "abc"[i % 3]}).encode()
        for i in range(n_records))]
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        hits = sum(1 for r in records for p in preds if p.matches_raw(r))
        best = min(best, time.perf_counter() - t0)
    row = {"n_records": n_records, "n_terms": len(preds),
           "memoized": True, "hits": int(hits),
           "match_us_per_record": round(best / n_records * 1e6, 3)}
    print(f"[patterns] memoized, raw match "
          f"{row['match_us_per_record']}us/record over {len(preds)} terms")
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.kernels.engine import KernelEngine

    eng = KernelEngine(BACKEND[args.device])
    out = {
        "device": args.device, "card": card(args.device),
        "fig6_query_fraction": query_fraction(eng),
        "fig7_8_selectivity": selectivity_sweep(eng),
        "fig9_10_overlap": overlap_sweep(eng),
        "fig11_12_skewness": skewness_sweep(eng),
        "patterns_memo": patterns_memo(),
    }
    print(f"wrote {write_artifact('micro', out)}")
    return out


if __name__ == "__main__":
    main()
