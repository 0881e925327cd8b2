"""Columnar scan engine vs the row-at-a-time query path (DESIGN.md §13) — on the
port (the JAX package's ``benchmarks/bench_scan.py``; host only).

Measures exactly the replacement this repo made: the seed scanner ANDed
pushed bitvectors and then called ``q.matches_exact(row)`` on per-row
dicts; the columnar scanner prunes segments by zone map, ANDs the pushed
bitvectors, and evaluates residual predicates vectorized over whole
struct-of-arrays columns.

Setup: a mixed-epoch / mixed-tier ycsb store — two plan epochs (a replan
mid-ingest), chunks cycling through three nested coverage tiers, raw
remainders pre-promoted so both paths scan the identical row population
(JIT parse noise excluded).  The row-at-a-time baseline gets every
advantage the seed path had: rows pre-parsed into dicts OUTSIDE the
timed region, and the same pushed-bitvector skipping.

Workload (selective, the paper's §VII shape): single pushed clauses from
both epochs, pushed+residual conjunctions, residual-only clauses the
client never evaluated, high-cardinality point lookups and no-match
probes (where zone maps prune whole segments).

Counts are asserted bit-identical per query across BOTH paths and the
``matches_exact`` full-scan oracle — the artifact's ``counts_match`` is a
claim gate, not a note.  ``scan_s`` is steady-state (segment caches
warm, the recurring-workload regime); ``cold_scan_s`` is the first pass.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_scan [--quick]

Writes ``artifacts/bench_torch_scan.json`` with the card's name and
power limit (``--device cpu``: none), and exits 1 if
``validate_scan`` fails.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import BACKEND, card, write_artifact
from repro_torch.core import bitvector
from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.predicates import Query, clause, key_value
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.workload import estimate_selectivities
from repro_torch.data.datasets import generate_records, predicate_pool


def _build_store(n_records: int, chunk_records: int, capacity: int):
    recs = generate_records("ycsb", n_records, seed=7)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:400])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    store = CiaoStore(fam0, segment_capacity=capacity)
    eng = NumpyEngine()

    def ingest(lo: int, hi: int, epoch: int):
        fam = store.family
        for i, start in enumerate(range(lo, hi, chunk_records)):
            tier = i % fam.n_tiers
            chunk = encode_chunk(recs[start: start + chunk_records])
            bv = eng.eval_fused_prefix(chunk, fam.plan.clauses,
                                       fam.tier_sizes[tier])
            store.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)

    half = (n_records // 2) // chunk_records * chunk_records
    ingest(0, half, epoch=0)
    # replan mid-ingest: half the survivors keep their gids, half are new
    order1 = ranked[:4] + ranked[8:12]
    fam1 = evolve_family(fam0, order1, (2, 4, 8))
    store.advance_epoch(fam1)
    ingest(half, n_records, epoch=1)
    # pre-promote every remainder: both measured paths see the same rows
    store.jit_load_raw()
    return store, fam0, fam1, ranked, recs


def _workload(fam0: PlanFamily, fam1: PlanFamily, ranked, recs,
              rng: np.random.Generator) -> list[Query]:
    residual = [c for c in ranked[12:20]]
    qs: list[Query] = []
    # pushed-selective: clauses from both epochs' plans (skipping path)
    for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]:
        qs.append(Query((c,)))
    # pushed AND residual: the vectorized-residual case the tentpole targets
    for i, c in enumerate(fam0.plan.clauses[:4]):
        qs.append(Query((c, residual[i])))
    # residual-only (no clause pushed: full segment evaluation)
    for c in residual[4:8]:
        qs.append(Query((c,)))
    # high-cardinality point lookups: most segments lack the value in
    # their dictionary -> zone maps prune them whole
    for i in rng.choice(len(recs), size=4, replace=False):
        obj = json.loads(recs[int(i)])
        qs.append(Query((clause(key_value("customer_id",
                                          obj["customer_id"])),)))
    # no-match probes: numeric range + dictionary zone maps refute outright
    qs.append(Query((clause(key_value("linear_score", 250)),)))
    qs.append(Query((clause(key_value("phone_country", "ZZ")),)))
    return qs


def _row_scan(store: CiaoStore, rows_cache: dict, q: Query) -> int:
    """The seed row-at-a-time path: bitvector skip -> matches_exact."""
    pushed_by_epoch = store.pushed_by_epoch(q)
    count = 0
    for seg in store.blocks:
        rows = rows_cache[id(seg)]
        pushed = pushed_by_epoch[(seg.epoch, seg.n_covered)]
        if pushed:
            words = bitvector.bv_and_many(seg.bitvectors[pushed])
            idx = bitvector.select_indices(words, seg.n_rows)
            for i in idx:
                if q.matches_exact(rows[i]):
                    count += 1
        else:
            for row in rows:
                if q.matches_exact(row):
                    count += 1
    for seg in store.jit_blocks:
        if pushed_by_epoch[(seg.epoch, seg.n_covered)]:
            continue
        for row in rows_cache[id(seg)]:
            if q.matches_exact(row):
                count += 1
    return count


def _best_of(fn, repeats: int) -> float:
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(n_records: int = 24576, chunk_records: int = 512,
        segment_capacity: int = 8192, repeats: int = 3,
        quick: bool | None = None, device: str = "cuda") -> dict:
    quick = (n_records <= 8192) if quick is None else quick
    store, fam0, fam1, ranked, recs = _build_store(
        n_records, chunk_records, segment_capacity)
    rng = np.random.default_rng(5)
    queries = _workload(fam0, fam1, ranked, recs, rng)

    # oracle + the row-path baseline rows, both OUTSIDE any timed region
    all_objs = [json.loads(r) for r in recs]
    rows_cache = {id(seg): seg.rows
                  for seg in list(store.blocks) + list(store.jit_blocks)}

    scanner = DataSkippingScanner(store, log_queries=False)
    pruned = 0
    cold_counts = []
    t0 = time.perf_counter()
    for q in queries:                       # cold pass: caches empty
        r = scanner.scan(q)
        pruned += r.segments_pruned
        cold_counts.append(r.count)
    cold_columnar_s = time.perf_counter() - t0

    # bit-identical-count gate (untimed): columnar == row path == oracle
    counts_match = True
    for q, got in zip(queries, cold_counts):
        oracle = sum(1 for o in all_objs if q.matches_exact(o))
        if got != oracle or _row_scan(store, rows_cache, q) != oracle:
            counts_match = False

    columnar_s = _best_of(
        lambda: [scanner.scan(q) for q in queries], repeats)
    row_s = _best_of(
        lambda: [_row_scan(store, rows_cache, q) for q in queries], repeats)

    n_segments = len(store.blocks) + len(store.jit_blocks)
    out = {
        "device": device, "card": card(device),
        "quick": bool(quick),
        "n_records": int(n_records),
        "n_loaded": int(store.stats.n_loaded),
        "n_segments": int(n_segments),
        "n_queries": len(queries),
        "n_epochs": 2,
        "n_tiers": fam0.n_tiers,
        "row_at_a_time": {
            "scan_s": round(row_s, 6),
            "us_per_query": round(row_s / len(queries) * 1e6, 1),
        },
        "columnar": {
            "scan_s": round(columnar_s, 6),
            "cold_scan_s": round(cold_columnar_s, 6),
            "us_per_query": round(columnar_s / len(queries) * 1e6, 1),
            "segments_pruned": int(pruned),
        },
        "speedup": round(row_s / columnar_s, 2),
        "cold_speedup": round(row_s / cold_columnar_s, 2),
        "counts_match": bool(counts_match),
    }
    print(f"[scan] {n_records} records, {n_segments} segments, "
          f"{len(queries)} queries (2 epochs x {fam0.n_tiers} tiers)")
    print(f"[scan] row-at-a-time {row_s * 1e3:9.2f} ms/batch")
    print(f"[scan] columnar      {columnar_s * 1e3:9.2f} ms/batch "
          f"(x{out['speedup']}, cold x{out['cold_speedup']}, "
          f"{pruned} segments zone-pruned, counts_match={counts_match})")
    return out


if __name__ == "__main__":
    from repro_torch.benchmarks.bench_schema import validate_scan

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    out = run(n_records=6144 if args.quick else 24576,
              repeats=2 if args.quick else 3, quick=args.quick,
              device=args.device)
    print(f"wrote {write_artifact('scan', out)}")
    validate_scan(out)
