"""Async store serving plane on the port: concurrent ingest + snapshot scans.

The counterpart of the JAX package's ``benchmarks/bench_serve.py``: what
:class:`~repro_torch.serve.store_engine.CiaoServeEngine` buys over a
serialized ingest-then-scan loop that answers nothing until the load
ends.  Both sides run the same workload: one chunk stream (ycsb, seed 7,
a 3-tier family whose tier 0 pushes nothing, so a third of the stream
stays raw) into a 4-shard store, and one 8-query panel.

  * **serialized** — ingest every chunk, then scan the panel on one
    thread with the host ``ShardedScanner``;
  * **live** — one feeder streams the chunks through the engine's
    write queues while ``query_threads`` readers answer the panel from
    epoch snapshots, their modes cycling host, batch and device
    (``ShardedDeviceScanner``: kernel B on the card).

Bitvectors come from ``KernelEngine`` (kernel A on the card) and are made
before any clock starts.  Gates, as the JAX package's
``bench_schema.validate_serve`` sets them: every live count bounded by
the ``matches_exact`` oracle and every quiesced count equal to it in all
three modes; live p99 <= 3x the quiesced p99 at the same reader
concurrency (8x for a quick run); live throughput >= 2x the serialized
loop's (0.5x quick).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve   # one card
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve \\
        --device cpu --records 4096                    # plain versions

Writes ``artifacts/bench_torch_serve.json`` (``--out`` to change it) with
the card's name and power limit, and exits 1 if a gate fails.  The
pieces ``chip_smoke.py``'s store-serving phase is built from live here
too: :class:`Reader`, :func:`run_readers`, :func:`live_ingest`,
:func:`bundle_report` and :func:`pcts`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

PANEL_SIZE = 8
MODES = ("host", "batch", "device")
ARTIFACT = Path(__file__).resolve().parents[3] / "artifacts" / \
    "bench_torch_serve.json"


def card(device: str) -> str:
    """The card's name and power limit (``nvidia-smi``), or "cpu"."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def pcts(lat_s: list[float]) -> tuple[float, float]:
    """p50 and p99 of latencies in seconds, in µs."""
    arr = np.asarray(lat_s, dtype=np.float64) * 1e6
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


class Reader:
    """One reader thread of a serve engine.

    Loops over ``queries`` until the phase's stop event is set and it
    has made ``min_loops`` loops.  Query *k* goes in mode
    ``modes[(offset + k) % len(modes)]``, or, with ``batch``, the panel
    goes through ``query_batch`` in slices of ``batch``.  Records the
    latency of every call and the least and largest count seen per
    query.
    """

    def __init__(self, serve, queries, modes=("host",), *, offset: int = 0,
                 batch: int = 0, min_loops: int = 2, name: str = "reader"):
        self.serve = serve
        self.queries = list(queries)
        self.modes = tuple(modes)
        self.offset = offset
        self.batch = batch
        self.min_loops = min_loops
        self.name = name
        self.lat: list[float] = []
        self.counts: dict[int, tuple[int, int]] = {}
        self.thread: threading.Thread | None = None

    def _saw(self, qi: int, count: int) -> None:
        lo, hi = self.counts.get(qi, (count, count))
        self.counts[qi] = (min(lo, count), max(hi, count))

    def _loop(self, stop: threading.Event, errors: list) -> None:
        qs, serve = self.queries, self.serve
        try:
            loops = 0
            while True:
                if self.batch:
                    for i in range(0, len(qs), self.batch):
                        t0 = time.perf_counter()
                        rs = serve.query_batch(qs[i:i + self.batch])
                        self.lat.append(time.perf_counter() - t0)
                        for j, r in enumerate(rs):
                            self._saw(i + j, r.count)
                else:
                    for k, q in enumerate(qs):
                        mode = self.modes[(self.offset + k) % len(self.modes)]
                        t0 = time.perf_counter()
                        r = serve.query(q, mode=mode)
                        self.lat.append(time.perf_counter() - t0)
                        self._saw(k, r.count)
                loops += 1
                if stop.is_set() and loops >= self.min_loops:
                    return
        except BaseException as e:      # reported by run_readers' caller
            errors.append(e)

    def start(self, stop: threading.Event, errors: list) -> None:
        self.thread = threading.Thread(target=self._loop, args=(stop, errors),
                                       name=self.name, daemon=True)
        self.thread.start()

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError(f"reader {self.name} did not stop")


def run_readers(readers, *, until=None, seconds: float = 0.0,
                timeout: float = 600.0) -> list:
    """Start ``readers``; stop them when ``until()`` returns (else after
    ``seconds``), join them and raise the first error any of them hit."""
    stop, errors = threading.Event(), []
    for r in readers:
        r.start(stop, errors)
    try:
        if until is not None:
            until()
        else:
            time.sleep(seconds)
    finally:
        stop.set()
        for r in readers:
            r.join(timeout)
    if errors:
        raise errors[0]
    return readers


def live_ingest(serve, items, readers, *, epoch=None, evaluate=None,
                timeout: float = 1800.0) -> dict:
    """One feeder thread submits ``items`` — ``(chunk, bitvecs, tier)``,
    ``bitvecs`` None to have ``evaluate(chunk, tier)`` make them just
    before the submit — while ``readers`` run; then ``quiesce()``.
    Returns the feeder's and the whole phase's wall seconds and the
    seconds spent in ``evaluate``."""
    out = {"chunks": len(items), "eval_s": 0.0}
    errors: list = []

    def feed() -> None:
        try:
            t0 = time.perf_counter()
            for chunk, bv, tier in items:
                if bv is None:
                    te = time.perf_counter()
                    bv = evaluate(chunk, tier)
                    out["eval_s"] += time.perf_counter() - te
                serve.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)
            out["feed_s"] = time.perf_counter() - t0
        except BaseException as e:      # re-raised below
            errors.append(e)

    feeder = threading.Thread(target=feed, name="feeder", daemon=True)
    t0 = time.perf_counter()

    def until() -> None:
        feeder.start()
        feeder.join(timeout)
        if feeder.is_alive():
            raise RuntimeError("the feeder did not finish")

    run_readers(readers, until=until, timeout=timeout)
    if errors:
        raise errors[0]
    serve.quiesce()
    out["wall_s"] = time.perf_counter() - t0
    return out


def bundle_report(snaps: dict) -> dict:
    """The engine's snapshot counters (``stats_report()["snapshots"]``),
    with the device planes' uploads, MiB and host ms in ``sync`` per
    bundle that built a device scanner."""
    planes = max(1, snaps["device_bundles"])
    mib = snaps["upload_bytes"] / 2**20
    return {**snaps, "upload_mib": mib,
            "per_device_bundle": {"uploads": snaps["uploads"] / planes,
                                  "upload_mib": mib / planes,
                                  "sync_ms": snaps["sync_s"] * 1e3 / planes}}


def _prepare(n_records: int, chunk_records: int, backend: str):
    """The JAX bench's chunk stream and panel; bitvectors by kernel A
    (``KernelEngine(backend)``) at each chunk's tier."""
    from repro_torch.core.client import encode_chunk
    from repro_torch.core.predicates import Query
    from repro_torch.core.server import PlanFamily, PushdownPlan
    from repro_torch.data.datasets import generate_records, predicate_pool
    from repro_torch.kernels.engine import KernelEngine

    recs = generate_records("ycsb", n_records, seed=7)
    objs = [json.loads(r) for r in recs]
    pool = predicate_pool("ycsb")
    fam = PlanFamily(plan=PushdownPlan(clauses=pool[:6]),
                     tier_sizes=(0, 2, 6))
    eng = KernelEngine(backend)
    chunks = []
    for i, start in enumerate(range(0, n_records, chunk_records)):
        ch = encode_chunk(recs[start:start + chunk_records])
        tier = i % fam.n_tiers
        bv = eng.eval_fused_prefix(ch, fam.plan.clauses,
                                   fam.tier_sizes[tier])
        chunks.append((ch, bv, tier))
    queries = [Query(clauses=(pool[k],)) for k in range(PANEL_SIZE)]
    oracle = [sum(1 for o in objs if q.matches_exact(o)) for q in queries]
    return fam, chunks, queries, oracle


def _mk_store(fam, n_shards: int, segment_capacity: int):
    from repro_torch.core.shard import (
        ShardedCiaoStore, ShardRouter, choose_routing_key,
    )
    router = ShardRouter(n_shards=n_shards, key=choose_routing_key(fam.plan))
    return ShardedCiaoStore(fam, router=router,
                            segment_capacity=segment_capacity)


def run(n_records: int = 24576, chunk_records: int = 512,
        segment_capacity: int = 1024, n_shards: int = 4,
        query_threads: int = 8, quick: bool | None = None,
        device: str = "cuda") -> dict:
    from repro_torch.core.batch_scan import ScanBatcher
    from repro_torch.core.device_scan import ShardedDeviceScanner
    from repro_torch.core.shard import ShardedScanner
    from repro_torch.serve.store_engine import CiaoServeEngine

    quick = (n_records <= 8192) if quick is None else quick
    backend = "cuda" if device == "cuda" else "torch"
    fam, chunks, queries, oracle = _prepare(n_records, chunk_records, backend)
    epoch = fam.plan.epoch

    # outside every timed window: the first scans build kernel B and
    # import what the batcher and the device scanner need
    warm = _mk_store(fam, n_shards, segment_capacity)
    warm.ingest_chunk(*chunks[0][:2], epoch=epoch, tier=chunks[0][2])
    ScanBatcher(warm, log_queries=False, telemetry=False).scan_batch(queries)
    ShardedScanner(warm, log_queries=False, telemetry=False).scan(queries[0])
    ShardedDeviceScanner(warm, backend=backend, log_queries=False,
                         telemetry=False).scan(queries[0])
    del warm

    # -- serialized baseline: ingest everything, then scan ----------------
    store_s = _mk_store(fam, n_shards, segment_capacity)
    t0 = time.perf_counter()
    for ch, bv, tier in chunks:
        store_s.ingest_chunk(ch, bv, epoch=epoch, tier=tier)
    ingest_s = time.perf_counter() - t0
    scanner = ShardedScanner(store_s, log_queries=False, telemetry=False)
    serial_lat: list[float] = []

    def panel_pass() -> None:
        for q in queries:
            tq = time.perf_counter()
            scanner.scan(q)
            serial_lat.append(time.perf_counter() - tq)

    panel_pass()                  # cold probe: pays promotion + memos
    panel_pass()                  # warm pass: the steady-state panel cost
    warm_s = sum(serial_lat[PANEL_SIZE:])
    passes = 2 if warm_s <= 0 else \
        max(2, min(64, int(ingest_s / (3 * warm_s))))
    for _ in range(passes):
        panel_pass()
    total_serial_s = time.perf_counter() - t0
    serial_qps = len(serial_lat) / total_serial_s

    # -- live engine: feeder + query_threads readers, no result cache -----
    serve = CiaoServeEngine(_mk_store(fam, n_shards, segment_capacity),
                            queue_depth=8, device_backend=backend)
    try:
        readers = [Reader(serve, queries, MODES, offset=i, name=f"reader-{i}")
                   for i in range(query_threads)]
        live = live_ingest(serve, chunks, readers, epoch=epoch)
        bundles = bundle_report(serve.stats_report()["snapshots"])
        live_lat = [x for r in readers for x in r.lat]
        live_qps = len(live_lat) / live["wall_s"]
        live_p50, live_p99 = pcts(live_lat)
        bounded = all(hi <= oracle[qi] for r in readers
                      for qi, (_, hi) in r.counts.items())

        # -- quiesced reference: same reader concurrency, writes stopped --
        quiesced = run_readers([
            Reader(serve, queries, MODES, offset=i,
                   min_loops=max(2, passes // 2), name=f"quiesced-{i}")
            for i in range(query_threads)])
        quiesced_lat = [x for r in quiesced for x in r.lat]
        q_p50, q_p99 = pcts(quiesced_lat)

        # -- exactness: quiesced counts vs the row-at-a-time oracle -------
        counts_match = all(
            [serve.query(q, mode=m).count for q in queries] == oracle
            for m in MODES)
        rep = serve.stats_report()["engine"]
        counts_match &= rep["errors"] == 0 and \
            rep["drained"] == rep["enqueued"]
    finally:
        serve.close()
    p99_ratio = live_p99 / q_p99 if q_p99 > 0 else float("inf")
    out = {
        "device": device, "card": card(device), "quick": bool(quick),
        "n_records": int(n_records), "n_chunks": len(chunks),
        "n_shards": int(n_shards), "query_threads": int(query_threads),
        "panel_size": PANEL_SIZE, "modes": list(MODES),
        "cpu_count": int(os.cpu_count() or 1),
        "serialized": {"ingest_s": ingest_s, "total_s": total_serial_s,
                       "queries": len(serial_lat), "qps": serial_qps},
        "live": {"total_s": live["wall_s"], "feed_s": live["feed_s"],
                 "queries": len(live_lat), "qps": live_qps,
                 "p50_us": live_p50, "p99_us": live_p99,
                 "blocked_s": rep["blocked_s"]},
        "quiesced": {"queries": len(quiesced_lat), "p50_us": q_p50,
                     "p99_us": q_p99},
        "bundles": bundles,
        "throughput_speedup": live_qps / serial_qps,
        "p99_ratio": p99_ratio,
        "counts_match": bool(counts_match),
        "live_counts_bounded": bool(bounded),
    }
    return out


def failed_gates(out: dict) -> list[str]:
    """The JAX package's serve gates (``validate_serve``) on ``out``."""
    quick = out["quick"]
    p99_max, speed_min = (8.0, 0.5) if quick else (3.0, 2.0)
    failed = []
    if not out["counts_match"]:
        failed.append("quiesced counts != oracle")
    if not out["live_counts_bounded"]:
        failed.append("a live count exceeded the oracle")
    if out["p99_ratio"] > p99_max:
        failed.append(f"live p99 {out['p99_ratio']:.2f}x quiesced > "
                      f"{p99_max}x")
    if out["throughput_speedup"] < speed_min:
        failed.append(f"throughput {out['throughput_speedup']:.2f}x "
                      f"serialized < {speed_min}x")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--records", type=int, default=24576)
    ap.add_argument("--chunk-records", type=int, default=512)
    ap.add_argument("--threads", type=int, default=8)
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
