"""Online physical-design tuner on the port: drift recovery.

The counterpart of the JAX package's ``benchmarks/bench_tuner.py``: what
:class:`~repro_torch.core.tuner.PhysicalDesignTuner` buys when the query
workload walks away from the layout the store was built for.  One
4-shard store is range-routed on ``linear_score`` and filled (ycsb, seed
7, bitvectors by ``KernelEngine``: kernel A on the card); the workload
then shifts to point lookups on ``visits``, which neither the routing nor
the segments' zone maps know, so every query visits every shard.

  * **before** — panel A (on the routing key), one thread, host scans;
  * **post_drift** — panel B (on ``visits``) on the unchanged layout:
    the static layout's steady state and the recovery's denominator.
    These scans feed the query log, the tuner's only drift signal;
  * **quiesced** — ``query_threads`` readers of a ``CiaoServeEngine``
    answer panel B on the stale layout with no migration running;
  * **during** — the engine's tuner thread notices the drift, swaps the
    router and drains the migration in bounded batches while the same
    readers keep answering, every count held to the oracle;
  * **after** — panel B again, measured as post_drift was.

The readers' modes alternate host and device (``ShardedDeviceScanner``:
kernel B on the card).  Gates, as the JAX package's
``bench_schema.validate_tuner`` sets them: counts equal to the
``matches_exact`` oracle in every phase; the router swapped to
``visits`` and moved rows in >= 2 batches; recovery (after / post_drift
throughput) >= 1.5x (0.8x quick); reader p99 during the migration <= 3x
the quiesced p99 (8x quick).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_tuner   # one card
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_tuner \\
        --device cpu --records 8192                    # plain versions

Writes ``artifacts/bench_torch_tuner.json`` (``--out`` to change it) with
the card's name and power limit, and exits 1 if a gate fails.
``chip_smoke.py``'s tuner phase is built from :func:`panel`,
:func:`timed_panel`, :func:`migrate_under_readers` and
:func:`plane_split`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from repro_torch.benchmarks.bench_serve import Reader, card, pcts, run_readers

PANEL_SIZE = 8
KEY_A = "linear_score"   # routing + plan key the store was built for
KEY_B = "visits"         # the key the workload drifts onto
MODES = ("host", "device")
ARTIFACT = Path(__file__).resolve().parents[3] / "artifacts" / \
    "bench_torch_tuner.json"


def panel(key: str, lo: int, hi: int, n: int = PANEL_SIZE) -> list:
    """``n`` point lookups ``key = v``, v evenly spaced over [lo, hi]."""
    from repro_torch.core.predicates import Query, clause, key_value
    vals = np.linspace(lo, hi, n).astype(int)
    return [Query((clause(key_value(key, int(v))),)) for v in vals]


def timed_panel(store, queries, want, *, passes: int) -> dict:
    """Single-thread passes of the host ``ShardedScanner`` over the live
    store (logging to its query log): the probe of the before,
    post-drift and after phases, one method for all three."""
    from repro_torch.core.shard import ShardedScanner
    scanner = ShardedScanner(store, telemetry=False)
    ok = True
    t0 = time.perf_counter()
    for _ in range(passes):
        for q, w in zip(queries, want):
            ok &= scanner.scan(q).count == w
    dt = time.perf_counter() - t0
    n = passes * len(queries)
    return {"passes": passes, "queries": n, "us_per_query": dt / n * 1e6,
            "qps": n / dt, "counts_match": bool(ok)}


def _exact(readers, want) -> bool:
    return all(lo == hi == want[qi] for r in readers
               for qi, (lo, hi) in r.counts.items())


def migrate_under_readers(serve, tuner, queries, want, *, modes=MODES,
                          query_threads: int = 4, quiesced_s: float = 1.0,
                          interval_s: float = 0.02, before_tuner=None,
                          timeout_s: float = 600.0) -> dict:
    """Readers of ``serve`` answer ``queries`` for ``quiesced_s`` with no
    migration (the quiesced reference), then, after ``before_tuner()``
    if given, again while the engine's tuner thread runs ``tuner`` until
    its migration finishes.  Every count is held to ``want``.  Returns
    both phases' latencies, whether every count was exact, and the
    migration's seconds."""
    def readers(tag: str) -> list:
        return [Reader(serve, queries, modes, offset=i, name=f"{tag}-{i}")
                for i in range(query_threads)]

    quiesced = run_readers(readers("quiesced"), seconds=quiesced_s)
    if before_tuner is not None:
        before_tuner()
    t0 = time.perf_counter()

    def until_finished() -> None:
        serve.start_tuner(tuner, interval_s=interval_s)
        while not any(e.kind == "migration-finish" for e in tuner.history):
            if time.perf_counter() - t0 > timeout_s:
                raise RuntimeError("the migration never finished")
            time.sleep(0.01)

    during = run_readers(readers("during"), until=until_finished)
    migrate_s = time.perf_counter() - t0
    if serve.stats_report()["engine"]["errors"]:
        raise RuntimeError("the engine recorded an error")
    q_lat = [x for r in quiesced for x in r.lat]
    d_lat = [x for r in during for x in r.lat]
    return {"migrate_s": migrate_s,
            "quiesced": dict(zip(("p50_us", "p99_us"), pcts(q_lat)),
                             queries=len(q_lat)),
            "during": dict(zip(("p50_us", "p99_us"), pcts(d_lat)),
                           queries=len(d_lat)),
            "counts_match": _exact(quiesced, want) and _exact(during, want)}


def plane_split(store, device) -> dict:
    """Rows of ``store``'s segments that a device plane on ``device``
    admits (kernel B scans them) against rows it leaves to the host
    fallback (lazy-layout segments, anything past the byte budget): one
    fresh ``DeviceSegmentCache`` per shard, synced as a device scanner
    syncs it; no kernel is launched."""
    from repro_torch.core.device_cache import DeviceSegmentCache
    on_device = host = 0
    for shard in store.shards:
        cache = DeviceSegmentCache(device=device)
        cache.sync(shard)
        for seg in (*shard.blocks, *shard.jit_blocks):
            if cache.slot_for(seg) is not None:
                on_device += seg.n_rows
            else:
                host += seg.n_rows
    return {"device_rows": on_device, "host_rows": host}


def _prepare(n_records: int, chunk_records: int, backend: str):
    from repro_torch.core.client import encode_chunk
    from repro_torch.core.server import PushdownPlan
    from repro_torch.data.datasets import generate_records, predicate_pool
    from repro_torch.kernels.engine import KernelEngine

    recs = generate_records("ycsb", n_records, seed=7)
    objs = [json.loads(r) for r in recs]
    plan = PushdownPlan(clauses=predicate_pool("ycsb")[:6])
    eng = KernelEngine(backend)
    chunks = []
    for start in range(0, n_records, chunk_records):
        ch = encode_chunk(recs[start:start + chunk_records])
        chunks.append((ch, eng.eval_fused(ch, plan.clauses)))
    panel_a, panel_b = panel(KEY_A, 2, 97), panel(KEY_B, 5, 990)
    want = [sum(1 for o in objs if q.matches_exact(o))
            for q in panel_a + panel_b]
    return plan, objs, chunks, panel_a, panel_b, want


def run(n_records: int = 49152, chunk_records: int = 512,
        segment_capacity: int = 1024, n_shards: int = 4,
        query_threads: int = 4, passes: int = 6,
        quick: bool | None = None, device: str = "cuda") -> dict:
    from repro_torch.core.shard import (
        ShardedCiaoStore, ShardedScanner, ShardRouter,
    )
    from repro_torch.core.tuner import PhysicalDesignTuner, TunerPolicy
    from repro_torch.serve.store_engine import CiaoServeEngine

    quick = (n_records <= 16384) if quick is None else quick
    backend = "cuda" if device == "cuda" else "torch"
    plan, objs, chunks, panel_a, panel_b, want = _prepare(
        n_records, chunk_records, backend)
    want_a, want_b = want[:PANEL_SIZE], want[PANEL_SIZE:]

    store = ShardedCiaoStore(
        plan, router=ShardRouter.from_samples(n_shards, KEY_A, objs[:1024]),
        segment_capacity=segment_capacity)
    t0 = time.perf_counter()
    for ch, bv in chunks:
        store.ingest_chunk(ch, bv)
    ingest_s = time.perf_counter() - t0
    # outside every timed window: first scans pay column / zone-map
    # materialization and raw promotion
    warm = ShardedScanner(store, log_queries=False, telemetry=False)
    for q in panel_a + panel_b:
        warm.scan(q)

    before = timed_panel(store, panel_a, want_a, passes=passes)
    post_drift = timed_panel(store, panel_b, want_b, passes=passes)
    serve = CiaoServeEngine(store, queue_depth=4, device_backend=backend)
    try:
        tuner = PhysicalDesignTuner(
            store, policy=TunerPolicy(check_every_scans=1,
                                      batch_rows=max(512, n_records // 48)))
        mig_out = migrate_under_readers(
            serve, tuner, panel_b, want_b, query_threads=query_threads,
            quiesced_s=0.3 if quick else 1.0, interval_s=0.002)
    finally:
        serve.close()
    mig = tuner.migration
    after = timed_panel(store, panel_b, want_b, passes=passes)
    probe = ShardedScanner(store, log_queries=False, telemetry=False)
    pruned_after = sum(probe.scan(q).shards_pruned for q in panel_b)
    q_p99 = mig_out["quiesced"]["p99_us"]
    return {
        "device": device, "card": card(device), "quick": bool(quick),
        "n_records": int(n_records), "n_chunks": len(chunks),
        "n_shards": int(n_shards), "query_threads": int(query_threads),
        "panel_size": PANEL_SIZE, "modes": list(MODES),
        "cpu_count": int(os.cpu_count() or 1),
        "key_before": KEY_A, "key_after": str(store.router.key),
        "router_swapped": store.router.key == KEY_B,
        "ingest_s": ingest_s, "before": before, "post_drift": post_drift,
        "during": dict(mig_out["during"], migrate_s=mig_out["migrate_s"]),
        "quiesced": mig_out["quiesced"], "after": after,
        "migration": {"rows_moved": mig.rows_moved,
                      "rows_kept": mig.rows_kept,
                      "segments_moved": mig.segments_moved,
                      "items_skipped": mig.items_skipped,
                      "batches": mig.batches},
        "telemetry_tuner": {k: int(v) for k, v in
                            store.telemetry.snapshot()["tuner"].items()},
        "tuner_events": [e.describe() for e in tuner.history],
        "recovery_speedup": after["qps"] / post_drift["qps"],
        "p99_ratio": mig_out["during"]["p99_us"] / q_p99 if q_p99 > 0
        else float("inf"),
        "shards_pruned_after": pruned_after,
        "counts_match": bool(before["counts_match"]
                             and post_drift["counts_match"]
                             and after["counts_match"]
                             and mig_out["counts_match"]),
    }


def failed_gates(out: dict) -> list[str]:
    """The JAX package's tuner gates (``validate_tuner``) on ``out``."""
    recovery_min, p99_max = (0.8, 8.0) if out["quick"] else (1.5, 3.0)
    failed = []
    if not out["counts_match"]:
        failed.append("a count != oracle")
    if not out["router_swapped"]:
        failed.append(f"router key {out['key_after']!r}, not {KEY_B!r}")
    mig = out["migration"]
    if mig["batches"] < 2 or mig["rows_moved"] <= 0:
        failed.append(f"migration not incremental: {mig}")
    if out["recovery_speedup"] < recovery_min:
        failed.append(f"recovery {out['recovery_speedup']:.2f}x < "
                      f"{recovery_min}x")
    if out["p99_ratio"] > p99_max:
        failed.append(f"reader p99 {out['p99_ratio']:.2f}x quiesced > "
                      f"{p99_max}x")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--records", type=int, default=49152)
    ap.add_argument("--chunk-records", type=int, default=512)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", type=Path, default=ARTIFACT)
    args = ap.parse_args(argv)
    out = run(args.records, args.chunk_records, query_threads=args.threads,
              device=args.device)
    out["failed_gates"] = failed_gates(out)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    print(f"wrote {args.out}")
    return 1 if out["failed_gates"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
