"""Host multi-query batcher + result cache vs sequential scans (§16) — on the
port (the JAX package's ``benchmarks/bench_batch.py``; host only).

Measures what the host half of the multi-query plane buys on the
workload shape CIAO's premise predicts (paper §V: a recurring predicate
set amortized across the whole workload).  A mixed-epoch / mixed-tier
ycsb store is scanned by an 8-query "analytics panel": every query
conjoins one of four recurring wide slice clauses with a shared ad-hoc
AUDIT clause whose operand is non-lowerable (``EXACT`` on an int — the
per-row parsed-record fallback, the expensive residual read).  The
panel's audit value is DISTINCT on every measured pass, so no memoized
clause mask or cached result ever helps either side: the measured gap
is purely the batcher's structural sharing — the audit clause's parse
set resolves ONCE over the union of the panel's narrowed candidates,
where the sequential scanner re-parses it per query.

On top, the :class:`~repro_torch.core.batch_scan.ResultCache` is measured on
the OTHER recurring extreme: the identical panel sent again verbatim,
answered from epoch/version-validated cache entries without touching a
segment.  Claim gates (``bench_schema.validate_batch``):

  * per-query counts BIT-IDENTICAL to the sequential
    ``DataSkippingScanner`` oracle AND the row-at-a-time
    ``matches_exact`` oracle, full accounting surface included;
  * batch-of-8 >= 2x over 8 sequential scans at full size (>= 0.8x for
    reduced-size ``--quick``/CI smoke runs, which gate against collapse
    only — tiny stores leave little parse work to share);
  * warm-cache repeats >= 5x over the uncached batch (>= 1.5x quick).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_batch [--quick]

Writes ``artifacts/bench_torch_batch.json`` with the card's name and
power limit (``--device cpu``: none), and exits 1 if
``validate_batch`` fails.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import BACKEND, card, write_artifact
from repro_torch.core.batch_scan import ResultCache, ScanBatcher
from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.predicates import Kind, Query, SimplePredicate, clause
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.workload import estimate_selectivities
from repro_torch.data.datasets import generate_records, predicate_pool

AUDIT_KEY = "linear_score"
PANEL_SIZE = 8


def _build(recs, fam0, fam1, chunk_records: int, segment_capacity: int):
    store = CiaoStore(fam0, segment_capacity=segment_capacity)
    eng = NumpyEngine()

    def ingest(lo, hi, epoch):
        fam = store.family
        for i, start in enumerate(range(lo, hi, chunk_records)):
            tier = i % fam.n_tiers
            chunk = encode_chunk(recs[start: start + chunk_records])
            bv = eng.eval_fused_prefix(chunk, fam.plan.clauses,
                                       fam.tier_sizes[tier])
            store.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)

    half = (len(recs) // 2) // chunk_records * chunk_records
    ingest(0, half, epoch=0)
    store.advance_epoch(fam1)
    ingest(half, len(recs), epoch=1)
    # pre-promote: both measured paths scan the identical row population
    store.jit_load_raw()
    return store


def _panel(slices, audit_value: int) -> list[Query]:
    """8 recurring slice queries sharing one ad-hoc audit clause.

    The audit term is ``EXACT`` with an int operand — deliberately
    non-lowerable (``core.predicates.lowerable``), forcing the per-row
    parsed-record fallback the batcher exists to share."""
    audit = clause(SimplePredicate(Kind.EXACT, AUDIT_KEY, int(audit_value)))
    return [Query((slices[i % len(slices)], audit))
            for i in range(PANEL_SIZE)]


def _accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.shards_pruned,
            r.used_skipping,
            tuple(sorted(
                (k, (g.count, g.rows_scanned, g.rows_skipped, g.raw_parsed,
                     g.segments_pruned))
                for k, g in r.groups.items())))


def run(n_records: int = 24576, chunk_records: int = 512,
        segment_capacity: int = 256, repeats: int = 3,
        quick: bool | None = None, device: str = "cuda") -> dict:
    quick = (n_records <= 8192) if quick is None else quick
    recs = generate_records("ycsb", n_records, seed=7)
    objs = [json.loads(r) for r in recs]
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    fam1 = evolve_family(fam0, ranked[:4] + ranked[8:12], (2, 4, 8))
    # the four recurring slice clauses: widest selectivity, so the
    # panel's candidate sets overlap — the regime where sharing the
    # audit clause's parse set actually amortizes
    slices = sorted(pool, key=lambda c: -sel[c])[:4]
    store = _build(recs, fam0, fam1, chunk_records, segment_capacity)
    n_segments = len(store.blocks) + len(store.jit_blocks)

    host = DataSkippingScanner(store, log_queries=False)
    batcher = ScanBatcher(store, log_queries=False)

    # counts + accounting gate first (untimed): batch vs the sequential
    # scanner vs the row-at-a-time exact oracle, on one fixed panel
    gate_panel = _panel(slices, audit_value=42)
    got = batcher.scan_batch(gate_panel)
    counts_match = accounting_match = True
    for q, r in zip(gate_panel, got):
        h = host.scan(q)
        exact = sum(1 for o in objs if q.matches_exact(o))
        counts_match &= (r.count == h.count == exact)
        accounting_match &= (_accounting(r) == _accounting(h))

    # timed: DISTINCT audit values per pass — no memo or cache can help,
    # both sides pay the full parse cost of an ad-hoc panel
    seq_s = np.inf
    for k in range(repeats):
        panel = _panel(slices, audit_value=100 + k)
        t0 = time.perf_counter()
        for q in panel:
            host.scan(q)
        seq_s = min(seq_s, time.perf_counter() - t0)
    batch_s = np.inf
    for k in range(repeats):
        panel = _panel(slices, audit_value=200 + k)
        t0 = time.perf_counter()
        batcher.scan_batch(panel)
        batch_s = min(batch_s, time.perf_counter() - t0)
    speedup = seq_s / batch_s

    # warm cache: the identical panel sent again verbatim
    cache = ResultCache()
    cached_batcher = ScanBatcher(store, cache=cache, log_queries=False)
    warm_panel = _panel(slices, audit_value=300)
    cold_res = cached_batcher.scan_batch(warm_panel)     # fills the cache
    warm_s = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        warm_res = cached_batcher.scan_batch(warm_panel)
        warm_s = min(warm_s, time.perf_counter() - t0)
    uncached_s = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        batcher.scan_batch(warm_panel)
        uncached_s = min(uncached_s, time.perf_counter() - t0)
    cache_speedup = uncached_s / warm_s
    for rc, rw in zip(cold_res, warm_res):
        counts_match &= (rc.count == rw.count)
        accounting_match &= (_accounting(rc) == _accounting(rw))

    out = {
        "device": device, "card": card(device),
        "quick": bool(quick),
        "n_records": int(n_records),
        "n_segments": int(n_segments),
        "n_queries": PANEL_SIZE,
        "n_slices": len(slices),
        "audit_key": AUDIT_KEY,
        "sequential": {
            "scan_s": round(float(seq_s), 6),
            "us_per_query": round(seq_s / PANEL_SIZE * 1e6, 1),
        },
        "batched": {
            "scan_s": round(float(batch_s), 6),
            "us_per_query": round(batch_s / PANEL_SIZE * 1e6, 1),
        },
        "speedup": round(float(speedup), 2),
        "cache": {
            "warm_scan_s": round(float(warm_s), 6),
            "uncached_scan_s": round(float(uncached_s), 6),
            "speedup": round(float(cache_speedup), 2),
            "hits": int(cache.hits),
            "misses": int(cache.misses),
            "hit_rate": round(float(cache.hit_rate), 4),
        },
        "cache_speedup": round(float(cache_speedup), 2),
        "counts_match": bool(counts_match),
        "accounting_match": bool(accounting_match),
    }
    print(f"[batch] {n_records} records, {n_segments} segments, "
          f"panel of {PANEL_SIZE} ({len(slices)} recurring slices + "
          f"shared ad-hoc audit on {AUDIT_KEY})")
    print(f"[batch] sequential {seq_s * 1e3:9.2f} ms/panel, "
          f"batched {batch_s * 1e3:9.2f} ms/panel: x{out['speedup']}")
    print(f"[batch] warm cache {warm_s * 1e3:9.3f} ms/panel "
          f"(uncached {uncached_s * 1e3:.2f} ms): x{out['cache_speedup']}, "
          f"hit_rate {out['cache']['hit_rate']:.0%}")
    print(f"[batch] counts_match={out['counts_match']} "
          f"accounting_match={out['accounting_match']}")
    return out


if __name__ == "__main__":
    from repro_torch.benchmarks.bench_schema import validate_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    out = run(n_records=6144 if args.quick else 24576,
              repeats=2 if args.quick else 3, quick=args.quick,
              device=args.device)
    print(f"wrote {write_artifact('batch', out)}")
    validate_batch(out)
