"""Skipping-index registry: range/IN/n-gram pruning end-to-end (§19) — on the
port (the JAX package's ``benchmarks/bench_skip.py``; host only).

Before the registry, a substring- or range-shaped workload had ~nothing
to skip with: RANGE and IN did not exist as predicate kinds, and
SUBSTRING refutation died at the shard level once the value-set
summaries saturated.  This benchmark measures what the registry buys on
exactly that workload: selective BETWEEN / one-sided ranges over
ingest-clustered numeric keys, rare-token substring probes, small IN
lists, and range+substring conjunctions, over a range-partitioned
sharded store.

Two measured paths over the SAME store and queries:

  * ``noskip`` — pruning disabled: every segment of every shard gets the
    full vectorized clause evaluation (the "~0% pruning today" shape,
    with every advantage kept: memoized clause masks, no per-row work);
  * ``skip``   — the full three-level cascade: shard partition pruning
    (range bounds + n-gram blooms in the per-shard summaries), segment
    zone-map pruning (registry probe over exact dictionaries), then the
    identical vectorized evaluation on the survivors.

Counts are asserted bit-identical across both paths and the
``matches_exact`` full-scan oracle, and the checkpoint round trip is
gated: a format-6 save must reload, and the same manifest with the
format-5 fields only (registry slices stripped) must load cleanly and
still produce oracle counts — pruning degrades, correctness does not.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_skip [--quick]

Writes ``artifacts/bench_torch_skip.json`` with the card's name and
power limit (``--device cpu``: none), and exits 1 if
``validate_skip`` fails.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.benchmarks.common import BACKEND, card, write_artifact
from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.predicates import (
    Query, between, clause, in_list, key_value, rng as rng_pred, substring,
)
from repro_torch.core.server import PlanFamily, PushdownPlan
from repro_torch.core.shard import ShardedCiaoStore, ShardedScanner, ShardRouter

N_TOKENS = 32


def _records(n: int, seed: int) -> list[bytes]:
    """Synthetic log-ish rows with ingest-clustered numeric keys.

    ``seq`` increases with ingest order and ``score`` tracks it with
    noise — the natural time-correlated shape that makes zone maps
    useful.  Each rare token ``tokNN`` appears only inside its own
    1/N_TOKENS window of rows; every 97th ``score`` is written as a JSON
    string (the §IV-B cross-representation case the range bounds must
    keep sound).
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        score = round(i / n * 1000.0 + float(rng.normal(0.0, 5.0)), 3)
        tok = f"tok{i * N_TOKENS // n:02d}"
        obj = {
            "seq": i,
            "score": str(score) if i % 97 == 0 else score,
            "msg": f"session {int(rng.integers(1_000_000))} {tok} event",
            "status": int(rng.integers(0, 6)),
        }
        out.append(json.dumps(obj, separators=(",", ":")).encode())
    return out


def _build_store(recs, objs, n_shards: int, capacity: int):
    fam = PlanFamily(
        plan=PushdownPlan(clauses=[clause(key_value("status", 1)),
                                   clause(key_value("status", 2))]),
        tier_sizes=(1, 2),
    )
    router = ShardRouter.from_samples(n_shards, "seq", objs[:1024])
    store = ShardedCiaoStore(fam, router=router, n_shards=n_shards,
                             segment_capacity=capacity)
    eng = NumpyEngine()
    chunk_records = 512
    for i, start in enumerate(range(0, len(recs), chunk_records)):
        tier = i % fam.n_tiers
        chunk = encode_chunk(recs[start: start + chunk_records])
        bv = eng.eval_fused_prefix(chunk, fam.plan.clauses,
                                   fam.tier_sizes[tier])
        store.ingest_chunk(chunk, bv, epoch=0, tier=tier)
    store.jit_load_raw()
    return store


def _q(*preds) -> Query:
    return Query(tuple(clause(p) for p in preds))


def _workload(n: int) -> list[Query]:
    qs: list[Query] = []
    # narrow BETWEEN windows on the ingest-clustered key (~2% of rows)
    w = max(n // 50, 8)
    for k in range(6):
        lo = (5 + 15 * k) * n // 100
        qs.append(_q(between("seq", lo, lo + w)))
    # score ranges: two-sided narrow + one-sided tails (score ~ U[0,1000])
    qs.append(_q(rng_pred("score", 101.5, 118.25)))
    qs.append(_q(rng_pred("score", 660, 680, lo_incl=False)))
    qs.append(_q(rng_pred("score", hi=4.0)))
    qs.append(_q(rng_pred("score", lo=996.0, lo_incl=False)))
    # rare tokens: each lives in one 1/32 window of the ingest order
    for t in (3, 11, 19, 27, 30, 6):
        qs.append(_q(substring("msg", f"tok{t:02d}")))
    # small IN lists on the clustered key (point-ish, multi-value)
    qs.append(_q(in_list("seq", [n // 10, n // 10 + 1, n // 10 + 2])))
    qs.append(_q(in_list("seq", [n // 3, 2 * n // 3])))
    qs.append(_q(in_list("seq", [n - 1, n + 5])))
    # range AND substring conjunctions: overlapping and disjoint windows
    qs.append(_q(between("seq", 3 * n // 32, 4 * n // 32),
                 substring("msg", "tok03")))
    qs.append(_q(between("seq", 0, n // 32),
                 substring("msg", "tok31")))   # disjoint: 0 rows
    qs.append(_q(rng_pred("score", 300, 340), substring("msg", "tok10")))
    # provable no-matches (the pure-refutation case)
    qs.append(_q(between("seq", 2 * n, 2 * n + 10)))
    qs.append(_q(substring("msg", "zzqxv")))
    return qs


def _shard_segments(store) -> list[list]:
    return [list(sh.blocks) + list(sh.jit_blocks) for sh in store.shards]


def _noskip_count(segs_by_shard, q: Query) -> int:
    """Pruning disabled: full vectorized evaluation of every segment."""
    count = 0
    for segs in segs_by_shard:
        for seg in segs:
            m = None
            for c in q.clauses:
                cm, leftover = seg.clause_mask(c)
                if leftover:
                    cm = cm.copy()
                    for i in range(seg.n_rows):
                        if not cm[i]:
                            obj = json.loads(seg.record(i))
                            if any(t.matches_exact(obj) for t in leftover):
                                cm[i] = True
                m = cm if m is None else (m & cm)
            count += int(m.sum()) if m is not None else seg.n_rows
    return count


def _scan_counts(store, queries):
    """(counts, seg_scanned, seg_pruned_zone, shard_visits_pruned)."""
    counts, scanned, zone_pruned, sh_pruned = [], 0, 0, 0
    with ShardedScanner(store, log_queries=False) as scanner:
        for q in queries:
            r = scanner.scan(q)
            counts.append(r.count)
            scanned += r.segments_scanned
            zone_pruned += r.segments_pruned
            sh_pruned += r.shards_pruned
    return counts, scanned, zone_pruned, sh_pruned


def _migration_ok(store, queries, oracle_counts) -> bool:
    """format-6 save reloads; format-5 (fields stripped) loads + counts."""
    strip = ("rmin", "rmax", "rmin_inf", "rmax_inf", "rnum_prunable",
             "ngram")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt")
        store.save(path)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("format") != 6:
            return False
        s6 = ShardedCiaoStore.load(path)
        c6, *_ = _scan_counts(s6, queries)
        if c6 != oracle_counts:
            return False
        # rewrite the manifest as a format-5 file: registry slices gone
        manifest["format"] = 5
        for summ in manifest["summaries"]:
            for ks in summ["keys"].values():
                for k in strip:
                    ks.pop(k, None)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        s5 = ShardedCiaoStore.load(path)
        c5, *_ = _scan_counts(s5, queries)
        return c5 == oracle_counts


def _invalidate(store, segs_by_shard) -> None:
    """Simulate segment turnover: drop memoized masks + verdict caches.

    In steady-state serving, segments are continuously sealed and
    retired, so each (segment, clause) mask is evaluated once per
    segment *lifetime* — that first vectorized evaluation is the work
    skipping avoids.  Resetting the memo dicts (fresh dicts, same
    eviction idiom the store itself uses) re-creates that state without
    re-ingesting; the skip path's own probe caches are reset too, so it
    pays its full probe cost every timed pass.
    """
    for segs in segs_by_shard:
        for seg in segs:
            seg._clause_masks = {}
            seg._possible = {}
            seg._and_masks = {}
    for summ in store.summaries:
        summ._possible = {}


def _best_of(fn, repeats: int, setup=None) -> float:
    best = np.inf
    for _ in range(repeats):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(n_records: int = 24576, n_shards: int = 8,
        segment_capacity: int | None = None, repeats: int = 3,
        quick: bool | None = None, device: str = "cuda") -> dict:
    quick = (n_records <= 8192) if quick is None else quick
    if segment_capacity is None:
        segment_capacity = max(256, n_records // 24)
    recs = _records(n_records, seed=17)
    objs = [json.loads(r) for r in recs]
    store = _build_store(recs, objs, n_shards, segment_capacity)
    queries = _workload(n_records)
    segs_by_shard = _shard_segments(store)
    n_segments = sum(len(s) for s in segs_by_shard)

    oracle = [sum(1 for o in objs if q.matches_exact(o)) for q in queries]

    skip_counts, seg_scanned, zone_pruned, sh_pruned = \
        _scan_counts(store, queries)
    noskip_counts = [_noskip_count(segs_by_shard, q) for q in queries]
    counts_match = skip_counts == oracle and noskip_counts == oracle

    # warm steady state (every mask memoized) — informational only: once
    # all masks are cached, both paths reduce to dict hits + tiny ANDs
    with ShardedScanner(store, log_queries=False) as scanner:
        warm_skip_s = _best_of(
            lambda: [scanner.scan(q) for q in queries], repeats)
        warm_noskip_s = _best_of(
            lambda: [_noskip_count(segs_by_shard, q) for q in queries],
            repeats)
        # fresh-evaluation passes (the gated numbers): segment turnover
        # means each mask is computed once per segment lifetime — this is
        # the work pruning actually avoids
        inval = lambda: _invalidate(store, segs_by_shard)
        skip_s = _best_of(
            lambda: [scanner.scan(q) for q in queries], repeats,
            setup=inval)
        noskip_s = _best_of(
            lambda: [_noskip_count(segs_by_shard, q) for q in queries],
            repeats, setup=inval)

    visits = n_segments * len(queries)
    pruned_fraction = 1.0 - seg_scanned / max(visits, 1)
    migration_ok = _migration_ok(store, queries, oracle)

    out = {
        "device": device, "card": card(device),
        "quick": bool(quick),
        "n_records": int(n_records),
        "n_shards": int(n_shards),
        "n_segments": int(n_segments),
        "n_queries": len(queries),
        "noskip": {
            "scan_s": round(noskip_s, 6),
            "us_per_query": round(noskip_s / len(queries) * 1e6, 1),
            "warm_scan_s": round(warm_noskip_s, 6),
        },
        "skip": {
            "scan_s": round(skip_s, 6),
            "us_per_query": round(skip_s / len(queries) * 1e6, 1),
            "warm_scan_s": round(warm_skip_s, 6),
            "segments_scanned": int(seg_scanned),
            "segments_zone_pruned": int(zone_pruned),
            "shard_visits_pruned": int(sh_pruned),
        },
        "pruned_fraction": round(pruned_fraction, 4),
        "speedup": round(noskip_s / skip_s, 2),
        "warm_speedup": round(warm_noskip_s / warm_skip_s, 2),
        "counts_match": bool(counts_match),
        "migration_ok": bool(migration_ok),
    }
    print(f"[skip] {n_records} records, {n_shards} shards, {n_segments} "
          f"segments, {len(queries)} range/IN/substring queries")
    print(f"[skip] noskip {noskip_s * 1e3:9.2f} ms/batch "
          f"(warm {warm_noskip_s * 1e3:.2f} ms)")
    print(f"[skip] skip   {skip_s * 1e3:9.2f} ms/batch "
          f"(x{out['speedup']}; warm {warm_skip_s * 1e3:.2f} ms, "
          f"x{out['warm_speedup']})")
    print(f"[skip] pruned {pruned_fraction:.1%} of segment visits "
          f"({sh_pruned} shard visits refuted at partition level), "
          f"counts_match={counts_match}, migration_ok={migration_ok}")
    return out


if __name__ == "__main__":
    from repro_torch.benchmarks.bench_schema import validate_skip

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    out = run(n_records=6144 if args.quick else 24576,
              repeats=2 if args.quick else 3, quick=args.quick,
              device=args.device)
    print(f"wrote {write_artifact('skip', out)}")
    validate_skip(out)
