"""Sharded store plane vs the monolithic store (DESIGN.md §14) — on the
port (the JAX package's ``benchmarks/bench_shard.py``; host only).

Measures what partition-aware placement buys the scan path.  A
mixed-epoch / mixed-tier ycsb store is ingested through a
:class:`ShardedCiaoStore` at 1, 4 and 8 shards with RANGE partitioning on
a **skewed routing key** (``visits`` is re-drawn from a power law, so the
quantile boundaries are workload-derived, not uniform).  Range placement
CLUSTERS routing-key values: each shard's partition min/max refutes most
point lookups outright — skipping the monolithic store can never get
from its ingest-ordered segments, whose zone maps all span the full
value range.

The workload is the paper's selective §VII shape, with the twist that
matters for a store front-end: the selective subset uses DISTINCT lookup
values per measured pass (ad-hoc point lookups — no memoized clause mask
ever helps), alongside recurring pushed / pushed+residual /
residual-only queries that exercise the whole cascade.  Claim gates
(``bench_schema.validate_shard``):

  * per-query counts BIT-IDENTICAL to the 1-shard oracle at 4 and 8
    shards (the 1-shard store is itself checked against the unsharded
    ``CiaoStore`` and ``matches_exact``);
  * >= 30% of per-query shard visits partition-pruned on the selective
    subset at 8 shards;
  * >= 2x scan speedup at 8 shards.  Reduced-size ``--quick`` runs only
    gate against collapse (>= 0.8x): tiny per-shard segments leave
    little vectorized work to skip, so the quick ratio sits in
    wall-clock noise on loaded CI runners — the 2x claim is
    full-size-only.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_shard [--quick]

Writes ``artifacts/bench_torch_shard.json`` with the card's name and
power limit (``--device cpu``: none), and exits 1 if
``validate_shard`` fails.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import BACKEND, write_artifact
from repro_torch.benchmarks.common import card as card_name
from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.predicates import Query, clause, key_value
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.shard import ShardedCiaoStore, ShardedScanner, ShardRouter
from repro_torch.core.workload import estimate_selectivities
from repro_torch.data.datasets import generate_records, predicate_pool

ROUTING_KEY = "visits"


def _skewed_records(n_records: int, card: int, seed: int) -> list[bytes]:
    """ycsb records with the routing key re-drawn from a power law over
    ``card`` distinct values (skew: quadratic concentration at 0)."""
    recs = generate_records("ycsb", n_records, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for r in recs:
        obj = json.loads(r)
        obj[ROUTING_KEY] = int(card * float(rng.random()) ** 2)
        out.append(json.dumps(obj, separators=(",", ":")).encode())
    return out


def _build(factory, recs, fam0, fam1, chunk_records: int):
    store = factory(fam0)
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
    # pre-promote every remainder: all measured paths scan the identical
    # row population (JIT parse noise excluded, shard pruning clean)
    store.jit_load_raw()
    return store


def _fixed_queries(fam0, fam1, ranked) -> list[Query]:
    qs = [Query((c,)) for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]]
    qs.append(Query((fam0.plan.clauses[0], ranked[13])))
    qs.append(Query((fam1.plan.clauses[1], ranked[14])))
    qs += [Query((c,)) for c in ranked[15:17]]          # residual-only
    qs.append(Query((clause(key_value("phone_country", "ZZ")),)))
    return qs


def _lookup_sets(objs, card: int, per_set: int, n_sets: int,
                 seed: int) -> list[list[Query]]:
    """Disjoint ad-hoc point-lookup batches on the routing key: mostly
    values present in the store, a few misses beyond the value range."""
    rng = np.random.default_rng(seed)
    present = sorted({o[ROUTING_KEY] for o in objs})
    picks = rng.choice(len(present), size=min(len(present), per_set * n_sets),
                       replace=False)
    sets = []
    for k in range(n_sets):
        vals = [present[int(i)] for i in picks[k * per_set: (k + 1) * per_set]]
        vals += [card + 10 + k * per_set + j for j in range(per_set // 8)]
        sets.append([Query((clause(key_value(ROUTING_KEY, int(v))),))
                     for v in vals])
    return sets


def run(n_records: int = 65536, chunk_records: int = 512,
        segment_capacity: int | None = None, repeats: int = 3,
        quick: bool | None = None, device: str = "cuda") -> dict:
    quick = (n_records <= 16384) if quick is None else quick
    # scaled-down segment size, CONSTANT across every measured store: at a
    # fixed capacity the monolithic store's segment count grows with total
    # data while a shard's grows with data/N — the structural scan-cost
    # asymmetry sharding exists to create.  ~1 row of capacity per 128
    # records keeps the segments-per-store ratio of a production-size
    # store while the benchmark ingest stays tractable.
    if segment_capacity is None:
        segment_capacity = max(256, n_records // 128)
    # routing-key cardinality ~4 distinct values per segment of capacity:
    # LOW-cardinality point lookups are the regime where segment zone
    # maps stop refuting (nearly every segment contains every value) but
    # range placement still prunes whole shards — partition metadata's
    # unique contribution over the existing skipping levels
    card = max(512, segment_capacity * 4)
    recs = _skewed_records(n_records, card, seed=11)
    objs = [json.loads(r) for r in recs]
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:400])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    fam1 = evolve_family(fam0, ranked[:4] + ranked[8:12], (2, 4, 8))
    fixed = _fixed_queries(fam0, fam1, ranked)
    per_set = 48 if quick else 96
    lookup_sets = _lookup_sets(objs, card, per_set, repeats, seed=5)
    batches = [fixed + ls for ls in lookup_sets]

    # unsharded differential oracle (counts only, untimed)
    plain = _build(lambda f: CiaoStore(f, segment_capacity=segment_capacity),
                   recs, fam0, fam1, chunk_records)
    oracle = DataSkippingScanner(plain, log_queries=False)
    oracle_counts = [[oracle.scan(q).count for q in batch]
                     for batch in batches]
    exact0 = [sum(1 for o in objs if q.matches_exact(o))
              for q in batches[0]]
    counts_match = oracle_counts[0] == exact0

    runs = []
    times = {}
    for n_shards in (1, 4, 8):
        router = (ShardRouter.from_samples(n_shards, ROUTING_KEY, objs[:800])
                  if n_shards > 1 else None)
        store = _build(
            lambda f: ShardedCiaoStore(f, router=router, n_shards=n_shards,
                                       segment_capacity=segment_capacity),
            recs, fam0, fam1, chunk_records)
        shard_rows = [s.stats.n_records for s in store.shards]
        with ShardedScanner(store, log_queries=False) as scanner:
            # timed FIRST, on cold caches: each batch's lookups are
            # distinct values, so no memoized clause mask ever helps the
            # selective subset (the recurring fixed queries warm up after
            # batch 0 — on every store equally)
            scan_s = np.inf
            for batch in batches:
                t0 = time.perf_counter()
                for q in batch:
                    scanner.scan(q)
                scan_s = min(scan_s, time.perf_counter() - t0)
            # counts gate + pruning attribution, untimed
            n_match = pruned_sel = scanned_sel = 0
            for batch, want in zip(batches, oracle_counts):
                got = []
                for q in batch:
                    r = scanner.scan(q)
                    got.append(r.count)
                    if len(q.clauses) == 1 and \
                            q.clauses[0].terms[0].key == ROUTING_KEY:
                        pruned_sel += r.shards_pruned
                        scanned_sel += r.shards_scanned
                n_match += got == want
        times[n_shards] = scan_s
        runs.append({
            "n_shards": n_shards,
            "scan_s": round(scan_s, 6),
            "us_per_query": round(scan_s / len(batches[0]) * 1e6, 1),
            "counts_match": n_match == len(batches),
            "selective_pruned_fraction": round(
                pruned_sel / max(pruned_sel + scanned_sel, 1), 4),
            "max_shard_rows": int(max(shard_rows)),
            "min_shard_rows": int(min(shard_rows)),
        })

    at8 = next(r for r in runs if r["n_shards"] == 8)
    out = {
        "device": device, "card": card_name(device),
        "quick": bool(quick),
        "n_records": int(n_records),
        "routing_card": int(card),
        "n_queries": len(batches[0]),
        "n_selective": len(lookup_sets[0]),
        "routing_key": ROUTING_KEY,
        "mode": "range",
        "runs": runs,
        "counts_match": bool(counts_match
                             and all(r["counts_match"] for r in runs)),
        "speedup_4": round(times[1] / times[4], 2),
        "speedup_8": round(times[1] / times[8], 2),
        "selective_pruned_fraction": at8["selective_pruned_fraction"],
    }
    print(f"[shard] {n_records} records, {len(batches[0])} queries/batch "
          f"({len(lookup_sets[0])} ad-hoc lookups, card {card}), "
          f"routing on {ROUTING_KEY} (range)")
    for r in runs:
        print(f"[shard] N={r['n_shards']}: {r['scan_s'] * 1e3:9.2f} ms/batch "
              f"(pruned {r['selective_pruned_fraction']:.0%} of shard visits "
              f"on the selective subset, counts_match={r['counts_match']})")
    print(f"[shard] speedup x{out['speedup_4']} @4, x{out['speedup_8']} @8; "
          f"counts_match={out['counts_match']}")
    return out


if __name__ == "__main__":
    from repro_torch.benchmarks.bench_schema import validate_shard

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    out = run(n_records=16384 if args.quick else 65536,
              repeats=2 if args.quick else 3, quick=args.quick,
              device=args.device)
    print(f"wrote {write_artifact('shard', out)}")
    validate_shard(out)
