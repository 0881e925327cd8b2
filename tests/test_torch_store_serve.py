"""The port's store serving plane (``repro_torch.serve.store_engine``).

The first part is ``tests/test_serve.py`` of the JAX package, run on the
port: snapshot isolation, the thread safety of the result cache and the
telemetry plane, ``CiaoServeEngine``'s quiesced counts against the
``matches_exact`` oracle in host, batch and device modes (the device
mode on kernel B's plain version, ``device_backend="torch"``),
backpressure, tenant-tier admission, the threaded stress sweep and
snapshot retirement.  Every thread join has a timeout and every engine
is closed.

Then the port against the JAX package on the same seeded chunks and
queries: every quiesced ``ScanResult`` in full accounting in all three
modes (the JAX engine's device mode on ``"xla"`` and, in one case,
``"pallas_interpret"``), the engine counters and the admission stats of
one fixed sequence.  All values compared are integers or strings, so the
tolerance is 0.  Last, the port's own rules: the engine's device queries
run on the card unless asked otherwise, and one snapshot's device
scanner serves concurrent readers with the serial results, admitting
each segment once.
"""
from __future__ import annotations

import gc
import json
import random
import threading
import time
import weakref

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import batch_scan as j_batch_scan  # noqa: E402
from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro.serve import store_engine as j_store_engine  # noqa: E402
from repro_torch.core.batch_scan import ResultCache, ScanBatcher  # noqa: E402
from repro_torch.core.client import NumpyEngine, encode_chunk  # noqa: E402
from repro_torch.core.predicates import Query  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, ScanResult,
    StaleEpochError,
)
from repro_torch.core.shard import (  # noqa: E402
    ShardedCiaoStore, ShardedScanner, ShardRouter, choose_routing_key,
)
from repro_torch.core.telemetry import TelemetryPlane  # noqa: E402
from repro_torch.data.datasets import generate_records, predicate_pool  # noqa: E402
from repro_torch.serve.store_engine import (  # noqa: E402
    AdmissionError, BackpressureError, CiaoServeEngine, QueryAdmission,
    TierPolicy,
)

N_RECORDS = 3000
CHUNK = 250


@pytest.fixture(scope="module")
def ycsb():
    recs = generate_records("ycsb", N_RECORDS, seed=7)
    objs = [json.loads(r) for r in recs]
    pool = predicate_pool("ycsb")
    return recs, objs, pool


def _family(pool) -> PlanFamily:
    # tier 0 has EMPTY coverage: its chunks stay raw remainders, so the
    # JIT-promotion path is exercised by every sweep below
    return PlanFamily(plan=PushdownPlan(clauses=pool[:6]),
                      tier_sizes=(0, 2, 6))


def _encode_chunks(recs, fam):
    eng = NumpyEngine()
    out = []
    for i, start in enumerate(range(0, len(recs), CHUNK)):
        ch = encode_chunk(recs[start:start + CHUNK])
        tier = i % fam.n_tiers
        bv = eng.eval_fused_prefix(ch, fam.plan.clauses,
                                   fam.tier_sizes[tier])
        out.append((ch, bv, tier))
    return out


def _oracle(objs, q: Query) -> int:
    return sum(1 for o in objs if q.matches_exact(o))


# ---------------------------------------------------------------------------
# snapshot isolation
# ---------------------------------------------------------------------------

def test_snapshot_isolation_plain(ycsb):
    """A snapshot pins its view: rows ingested after snapshot() are
    invisible to scans against it, while the live store sees them."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    half = len(chunks) // 2
    half_rows = half * CHUNK

    store = CiaoStore(fam, segment_capacity=256)
    for ch, bv, tier in chunks[:half]:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
    snap = store.snapshot()
    base = snap.base_version
    snap_scanner = DataSkippingScanner(snap, telemetry=False)

    for ch, bv, tier in chunks[half:]:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)

    live_scanner = DataSkippingScanner(store)
    for k in range(6):
        q = Query(clauses=(pool[k],))
        snap_count = snap_scanner.scan(q).count
        assert snap_count == _oracle(objs[:half_rows], q)
        assert live_scanner.scan(q).count == _oracle(objs, q)
    # untainted reads keep the pinned base version
    q_pushed = Query(clauses=(pool[0],))
    assert snap.base_version == base
    assert store.data_version > base


def test_snapshot_isolation_sharded(ycsb):
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    half = len(chunks) // 2
    half_rows = half * CHUNK

    router = ShardRouter(n_shards=4, key=choose_routing_key(fam.plan))
    store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
    for ch, bv, tier in chunks[:half]:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
    snap = store.snapshot()
    scanner = ShardedScanner(snap, telemetry=False)
    batcher = ScanBatcher(snap, cache=ResultCache(), telemetry=False)

    for ch, bv, tier in chunks[half:]:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)

    queries = [Query(clauses=(pool[k],)) for k in range(6)]
    for q in queries:
        assert scanner.scan(q).count == _oracle(objs[:half_rows], q)
    got = [r.count for r in batcher.scan_batch(queries)]
    assert got == [_oracle(objs[:half_rows], q) for q in queries]


def test_snapshot_local_promotion_leaves_parent_untouched(ycsb):
    """JIT promotion triggered by a snapshot scan stays snapshot-local:
    the parent keeps its raw remainders and data_version, and the
    snapshot's version forks negative so ResultCache entries from
    different lineages can never alias."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)

    store = CiaoStore(fam, segment_capacity=256)
    for ch, bv, tier in chunks:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
    parent_raw = len(store.raw)
    parent_version = store.data_version
    assert parent_raw > 0            # tier 0 left raw remainders

    snap = store.snapshot()
    scanner = DataSkippingScanner(snap, telemetry=False)
    q = Query(clauses=(pool[0],))
    assert scanner.scan(q).count == _oracle(objs, q)

    assert len(store.raw) == parent_raw          # parent untouched
    assert store.data_version == parent_version
    assert len(snap.raw) < parent_raw            # snapshot promoted
    assert snap.data_version < 0                 # forked version
    # repeat scan promotes nothing further and stays exact
    jit_before = len(snap.jit_blocks)
    assert scanner.scan(q).count == _oracle(objs, q)
    assert len(snap.jit_blocks) == jit_before


# ---------------------------------------------------------------------------
# shared-structure thread safety
# ---------------------------------------------------------------------------

def test_result_cache_thread_safe():
    """Concurrent store/lookup/invalidate churn must never corrupt the
    LRU dict or blow past the capacity bound."""
    cache = ResultCache(cap=32)
    qs = [Query(clauses=(predicate_pool("ycsb")[k],)) for k in range(8)]
    res = ScanResult(count=1, rows_scanned=1, rows_skipped=0,
                     raw_parsed=0, time_s=0.0, used_skipping=True)
    errors: list[BaseException] = []

    def churn(seed: int) -> None:
        rng = random.Random(seed)
        try:
            for _ in range(400):
                q = qs[rng.randrange(len(qs))]
                sid = rng.randrange(4)
                op = rng.randrange(10)
                if op < 5:
                    cache.store(sid, q, res, epoch=0,
                                data_version=rng.randrange(3))
                elif op < 9:
                    hit = cache.lookup(sid, q, epoch=0,
                                       data_version=rng.randrange(3))
                    if hit is not None:
                        assert hit.count == 1
                else:
                    cache.invalidate(sid if rng.random() < 0.5 else None)
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert not errors
    assert len(cache) <= cache.cap
    assert cache.hits + cache.misses > 0


def test_telemetry_thread_safe():
    """Concurrent record_scan/record_client_eval + snapshot() reads:
    counters must end exactly at the submitted totals (no lost updates)
    and snapshots must never raise mid-mutation."""
    tele = TelemetryPlane()
    res = ScanResult(count=3, rows_scanned=10, rows_skipped=5,
                     raw_parsed=0, time_s=0.001, used_skipping=True)
    n_threads, per_thread = 8, 300
    errors: list[BaseException] = []

    def record(i: int) -> None:
        try:
            for k in range(per_thread):
                tele.record_scan(res, tenant=f"t{i % 3}")
                if k % 16 == 0:
                    tele.record_client_eval(f"c{i}", 0.0005, n_records=100)
                if k % 32 == 0:
                    tele.snapshot()
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=record, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert not errors
    snap = tele.snapshot()
    total = sum(t["scans"] for t in snap["tenants"].values())
    assert total == n_threads * per_thread


def test_telemetry_stats_report_consistent_under_ingest(ycsb):
    """stats_report() runs under the ingest lock: a report taken while a
    writer is mid-stream is a consistent snapshot (counters agree with
    each other), not a torn read."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    store = CiaoStore(fam, segment_capacity=256)

    stop = threading.Event()
    errors: list[BaseException] = []

    def ingest() -> None:
        try:
            for ch, bv, tier in chunks:
                store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        except BaseException as e:      # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=ingest)
    t.start()
    while not stop.is_set():
        rep = store.stats_report()
        s = rep["load"]
        # chunk-atomic: rows land in n_records in chunk multiples
        assert s["n_records"] % CHUNK == 0
        assert s["n_records"] <= len(recs)
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert not errors
    assert store.stats_report()["load"]["n_records"] == len(recs)


# ---------------------------------------------------------------------------
# serve engine
# ---------------------------------------------------------------------------

def test_engine_quiesced_counts_match_oracle(ycsb):
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    router = ShardRouter(n_shards=4, key=choose_routing_key(fam.plan))
    store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
    queries = [Query(clauses=(pool[k],)) for k in range(6)]
    oracle = [_oracle(objs, q) for q in queries]

    with CiaoServeEngine(store, queue_depth=8, device_backend="torch",
                         result_cache=ResultCache()) as serve:
        for ch, bv, tier in chunks:
            serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        serve.quiesce()
        for mode in ("host", "batch", "device"):
            assert [serve.query(q, mode=mode).count
                    for q in queries] == oracle, mode
        assert [r.count for r in serve.query_batch(queries)] == oracle
        rep = serve.stats_report()
        assert rep["engine"]["drained"] == rep["engine"]["enqueued"]
        assert rep["engine"]["errors"] == 0


def test_engine_snapshot_pins_before_ingest(ycsb):
    """A query answered from the engine's snapshot must not see rows
    from an ingest submitted after the snapshot was taken."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    store = CiaoStore(fam, segment_capacity=256)
    q = Query(clauses=(pool[0],))

    with CiaoServeEngine(store) as serve:
        for ch, bv, tier in chunks[:6]:
            serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        serve.quiesce()
        snap = serve.snapshot()
        before = serve.query(q).count
        assert before == _oracle(objs[:6 * CHUNK], q)
        for ch, bv, tier in chunks[6:]:
            serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        serve.quiesce()
        # the pinned snapshot still answers the old view
        assert DataSkippingScanner(snap, telemetry=False).scan(q).count \
            == before
        # the engine re-snapshots and sees everything
        assert serve.query(q).count == _oracle(objs, q)


def test_engine_stale_epoch_raises_at_submit(ycsb):
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    store = CiaoStore(fam, segment_capacity=256)
    with CiaoServeEngine(store) as serve:
        serve.ingest_chunk(*chunks[0][:2], epoch=fam.plan.epoch,
                           tier=chunks[0][2])
        fam2 = PlanFamily(
            plan=PushdownPlan(clauses=pool[:6], epoch=fam.plan.epoch + 1),
            tier_sizes=(0, 2, 6))
        serve.advance_epoch(fam2)
        with pytest.raises(StaleEpochError):
            serve.ingest_chunk(*chunks[1][:2], epoch=fam.plan.epoch,
                               tier=chunks[1][2])


def test_engine_backpressure_reject(ycsb):
    """With the drain stalled (writer blocked on the store's ingest
    lock), reject policy raises once the bounded queue fills — and after
    the stall clears, everything that WAS accepted lands exactly."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    store = CiaoStore(fam, segment_capacity=256)
    serve = CiaoServeEngine(store, queue_depth=2, backpressure="reject")
    try:
        accepted = 0
        with store._ingest_lock:         # stall the writer mid-drain
            serve.ingest_chunk(*chunks[0][:2], epoch=fam.plan.epoch,
                               tier=chunks[0][2])
            accepted += 1
            deadline = time.time() + 5.0
            while serve._queues[0].qsize() > 0:   # writer picked it up
                assert time.time() < deadline, "writer never dequeued"
                time.sleep(0.001)
            with pytest.raises(BackpressureError):
                for ch, bv, tier in chunks[1:]:
                    serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch,
                                       tier=tier)
                    accepted += 1
        assert accepted >= 3             # 1 in flight + queue_depth
        serve.quiesce()
        n_rows = accepted * CHUNK
        q = Query(clauses=(pool[0],))
        assert serve.query(q).count == _oracle(objs[:n_rows], q)
        assert serve.stats_report()["engine"]["rejected"] == 1
    finally:
        serve.close()


def test_engine_backpressure_block(ycsb):
    """Block policy: a submitter against a full queue waits (accounted
    in blocked_s) and completes once the drain resumes — nothing lost."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)[:6]
    store = CiaoStore(fam, segment_capacity=256)
    serve = CiaoServeEngine(store, queue_depth=1, backpressure="block")
    errors: list[BaseException] = []

    def feed() -> None:
        try:
            for ch, bv, tier in chunks:
                serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        except BaseException as e:      # pragma: no cover
            errors.append(e)

    try:
        with store._ingest_lock:
            t = threading.Thread(target=feed)
            t.start()
            time.sleep(0.05)             # let the feeder hit the full queue
            assert t.is_alive()          # blocked, not failed
        t.join(timeout=10.0)
        assert not t.is_alive() and not errors
        serve.quiesce()
        q = Query(clauses=(pool[0],))
        assert serve.query(q).count == _oracle(objs[:len(chunks) * CHUNK], q)
        assert serve.stats_report()["engine"]["blocked_s"] > 0.0
    finally:
        serve.close()


def test_admission_control(ycsb):
    recs, objs, pool = ycsb
    # unit: reject tier refuses at quota, block tier queues
    adm = QueryAdmission(
        {"gold": TierPolicy(2, on_full="block"),
         "free": TierPolicy(1, on_full="reject")},
        tenant_tiers={"freeloader": "free"}, default_tier="gold")
    tier = adm.acquire("freeloader")
    with pytest.raises(AdmissionError):
        adm.acquire("freeloader")
    adm.release(tier)
    adm.acquire("freeloader")            # slot freed

    t1 = adm.acquire("vip")
    t2 = adm.acquire("vip")
    unblocked = threading.Event()

    def blocked_acquire() -> None:
        t3 = adm.acquire("vip")          # waits for a slot
        unblocked.set()
        adm.release(t3)

    t = threading.Thread(target=blocked_acquire)
    t.start()
    time.sleep(0.05)
    assert not unblocked.is_set()        # still waiting
    adm.release(t1)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert unblocked.is_set()
    adm.release(t2)
    assert adm.stats()["gold"]["blocked_s"] > 0.0

    # integration: engine gates queries through the same policy
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)[:3]
    store = CiaoStore(fam, segment_capacity=256)
    adm2 = QueryAdmission({"gold": TierPolicy(4),
                           "free": TierPolicy(0, on_full="reject")},
                          tenant_tiers={"freeloader": "free"},
                          default_tier="gold")
    with CiaoServeEngine(store, admission=adm2) as serve:
        for ch, bv, tier_ in chunks:
            serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier_)
        serve.quiesce()
        q = Query(clauses=(pool[0],))
        with pytest.raises(AdmissionError):
            serve.query(q, tenant="freeloader")
        assert serve.query(q, tenant="vip").count \
            == _oracle(objs[:3 * CHUNK], q)
        assert serve.stats_report()["admission"]["free"]["rejected"] == 1


def test_threaded_stress_sweep(ycsb):
    """2 concurrent writers + 3 mixed-mode readers with a random tier
    mix: live counts stay bounded by the oracle, nothing deadlocks, and
    after quiesce every query is bit-identical to matches_exact across
    all three scan modes."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    router = ShardRouter(n_shards=4, key=choose_routing_key(fam.plan))
    store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
    queries = [Query(clauses=(pool[k],)) for k in range(8)]
    oracle = [_oracle(objs, q) for q in queries]
    serve = CiaoServeEngine(store, queue_depth=4, device_backend="torch",
                            result_cache=ResultCache())
    writers_done = threading.Event()
    errors: list[BaseException] = []

    def write(slice_: list) -> None:
        try:
            for ch, bv, tier in slice_:
                serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        except BaseException as e:      # pragma: no cover
            errors.append(e)

    def read(seed: int) -> None:
        rng = random.Random(seed)
        try:
            while not writers_done.is_set():
                k = rng.randrange(len(queries))
                mode = rng.choice(("host", "batch", "device"))
                r = serve.query(queries[k], mode=mode)
                assert 0 <= r.count <= oracle[k], (mode, k)
        except BaseException as e:      # pragma: no cover
            errors.append(e)

    try:
        ws = [threading.Thread(target=write, args=(chunks[0::2],)),
              threading.Thread(target=write, args=(chunks[1::2],))]
        rs = [threading.Thread(target=read, args=(i,)) for i in range(3)]
        for t in ws + rs:
            t.start()
        for t in ws:
            t.join(timeout=120.0)
            assert not t.is_alive(), "writer deadlocked"
        writers_done.set()
        for t in rs:
            t.join(timeout=120.0)
            assert not t.is_alive(), "reader deadlocked"
        assert not errors, errors
        serve.quiesce()
        for mode in ("host", "batch", "device"):
            assert [serve.query(q, mode=mode).count
                    for q in queries] == oracle, mode
        rep = serve.stats_report()
        assert rep["engine"]["errors"] == 0
        assert rep["engine"]["drained"] == rep["engine"]["enqueued"]
    finally:
        serve.close()


# ---------------------------------------------------------------------------
# snapshot retirement + per-tenant pressure telemetry (DESIGN.md §18)
# ---------------------------------------------------------------------------

def test_snapshot_close_releases_promoted_fork(ycsb):
    """An abandoned tainted snapshot (its scan promoted raw remainders
    into fork-local jit segments) must not pin those segments after an
    explicit close(): the retire hook drops every fork-held reference,
    so gc reclaims them while the parent stays intact and exact."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    store = CiaoStore(fam, segment_capacity=256)
    for ch, bv, tier in chunks:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)

    snap = store.snapshot()
    scanner = DataSkippingScanner(snap, telemetry=False)
    q = Query(clauses=(pool[0],))
    assert scanner.scan(q).count == _oracle(objs, q)
    assert snap.jit_blocks               # tainted: fork-local promotion ran
    refs = [weakref.ref(seg) for seg in snap.jit_blocks]

    snap.close()
    assert not snap.jit_blocks and not snap.raw and not snap.blocks
    del scanner, snap
    gc.collect()
    assert all(r() is None for r in refs)   # nothing pins the fork segments
    # the parent never saw the fork: still raw, still exact
    assert store.raw
    assert DataSkippingScanner(store, telemetry=False).scan(q).count \
        == _oracle(objs, q)


def test_sharded_snapshot_close_delegates(ycsb):
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    router = ShardRouter(n_shards=4, key=choose_routing_key(fam.plan))
    store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
    for ch, bv, tier in chunks:
        store.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
    snap = store.snapshot()
    scanner = ShardedScanner(snap, log_queries=False)
    q = Query(clauses=(pool[0],))
    assert scanner.scan(q).count == _oracle(objs, q)
    assert snap.jit_blocks
    refs = [weakref.ref(seg) for seg in snap.jit_blocks]
    snap.close()
    assert not snap.blocks and not snap.jit_blocks and not snap.raw
    del scanner
    gc.collect()
    assert all(r() is None for r in refs)
    assert ShardedScanner(store, log_queries=False).scan(q).count \
        == _oracle(objs, q)


def test_backpressure_and_admission_telemetry_per_tenant(ycsb):
    """Serve-plane pressure shows up in the per-tenant telemetry:
    ingest rejections under the submitting tenant, admission rejections
    and admitted counts under the querying tenant — all inside the
    store's stats_report, next to the tenant's scan counters."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    store = CiaoStore(fam, segment_capacity=256)
    adm = QueryAdmission({"gold": TierPolicy(4),
                          "free": TierPolicy(0, on_full="reject")},
                         tenant_tiers={"freeloader": "free"},
                         default_tier="gold")
    serve = CiaoServeEngine(store, queue_depth=1, backpressure="reject",
                            admission=adm)
    try:
        assert adm.telemetry is store.telemetry   # wired by the engine
        with store._ingest_lock:         # stall the writer mid-drain
            serve.ingest_chunk(*chunks[0][:2], epoch=fam.plan.epoch,
                               tier=chunks[0][2], tenant="acme")
            deadline = time.time() + 5.0
            while serve._queues[0].qsize() > 0:
                assert time.time() < deadline, "writer never dequeued"
                time.sleep(0.001)
            with pytest.raises(BackpressureError):
                for ch, bv, tier in chunks[1:]:
                    serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch,
                                       tier=tier, tenant="acme")
        serve.quiesce()
        q = Query(clauses=(pool[0],))
        with pytest.raises(AdmissionError):
            serve.query(q, tenant="freeloader")
        assert serve.query(q, tenant="vip").count > 0
        tenants = serve.stats_report()["store"]["telemetry"]["tenants"]
        assert tenants["acme"]["backpressure"]["ingest_rejected"] >= 1
        assert tenants["freeloader"]["backpressure"]["admission_rejected"] \
            == 1
        assert tenants["vip"]["backpressure"]["admitted"] >= 1
    finally:
        serve.close()


def test_backpressure_block_wait_telemetry_per_tenant(ycsb):
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)[:6]
    store = CiaoStore(fam, segment_capacity=256)
    serve = CiaoServeEngine(store, queue_depth=1, backpressure="block")
    errors: list[BaseException] = []

    def feed() -> None:
        try:
            for ch, bv, tier in chunks:
                serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier,
                                   tenant="bulk")
        except BaseException as e:      # pragma: no cover
            errors.append(e)

    try:
        with store._ingest_lock:
            t = threading.Thread(target=feed)
            t.start()
            time.sleep(0.05)             # feeder hits the full queue
            assert t.is_alive()
        t.join(timeout=10.0)
        assert not t.is_alive() and not errors
        serve.quiesce()
        bp = serve.stats_report()["store"]["telemetry"]["tenants"]["bulk"][
            "backpressure"]
        assert bp["ingest_blocked_s"] > 0.0
        assert bp["ingest_rejected"] == 0
    finally:
        serve.close()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def _full(r) -> tuple:
    """Every ScanResult field but time, groups in their (sorted) order."""
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.shards_scanned,
            r.shards_pruned, r.used_skipping,
            tuple((k, (g.count, g.rows_scanned, g.rows_skipped,
                       g.raw_parsed, g.segments_pruned))
                  for k, g in r.groups.items()))


def _j_family(fam):
    plan = j_server.PushdownPlan.from_obj(json.loads(json.dumps(
        fam.plan.to_obj())))
    return j_server.PlanFamily.from_obj(plan, json.loads(json.dumps(
        fam.to_obj())))


def _jq(q):
    from repro_torch.core.predicates import clause_to_obj
    return j_pred.Query(tuple(j_pred.clause_from_obj(clause_to_obj(c))
                              for c in q.clauses), freq=q.freq)


def _j_chunks(recs, fam):
    """``_encode_chunks`` in the JAX package, on its copy of ``fam``."""
    fam = _j_family(fam)
    eng = j_client.NumpyEngine()
    out = []
    for i, start in enumerate(range(0, len(recs), CHUNK)):
        ch = j_client.encode_chunk(recs[start:start + CHUNK])
        tier = i % fam.n_tiers
        bv = eng.eval_fused_prefix(ch, fam.plan.clauses,
                                   fam.tier_sizes[tier])
        out.append((ch, bv, tier))
    return out


def _engine_run(serve, chunks, epoch, queries):
    """Submit every chunk, quiesce, then every query in host, batch and
    device mode and as one batch: the results and the engine counters."""
    for ch, bv, tier in chunks:
        serve.ingest_chunk(ch, bv, epoch=epoch, tier=tier)
    serve.quiesce()
    out = {mode: [_full(serve.query(q, mode=mode)) for q in queries]
           for mode in ("host", "batch", "device")}
    out["query_batch"] = [_full(r) for r in serve.query_batch(queries)]
    eng = serve.stats_report()["engine"]
    out["engine"] = {k: eng[k] for k in (
        "writers", "submitted", "enqueued", "drained", "rejected", "errors")}
    return out


@pytest.mark.parametrize("shards,j_backend", [
    (4, "xla"), (1, "xla"), (4, "pallas_interpret")])
def test_quiesced_engine_matches_jax(ycsb, shards, j_backend):
    """The same seeded chunks through the JAX engine (device mode on
    ``j_backend``) and the port's (``"torch"``), each with a result
    cache: every quiesced ScanResult equal in full accounting in host,
    batch and device mode and through ``query_batch``, and the engine
    counters equal."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    queries = [Query(clauses=(pool[k],)) for k in range(8)]
    queries.append(Query(clauses=(pool[0], pool[9])))
    if shards > 1:
        router = ShardRouter(n_shards=shards,
                             key=choose_routing_key(fam.plan))
        store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
        j_store = j_shard.ShardedCiaoStore(
            _j_family(fam), segment_capacity=256,
            router=j_shard.ShardRouter.from_obj(router.to_obj()))
    else:
        store = CiaoStore(fam, segment_capacity=256)
        j_store = j_server.CiaoStore(_j_family(fam), segment_capacity=256)
    with CiaoServeEngine(store, queue_depth=8, device_backend="torch",
                         result_cache=ResultCache()) as serve:
        got = _engine_run(serve, _encode_chunks(recs, fam),
                          fam.plan.epoch, queries)
    with j_store_engine.CiaoServeEngine(
            j_store, queue_depth=8, device_backend=j_backend,
            result_cache=j_batch_scan.ResultCache()) as j_serve:
        want = _engine_run(j_serve, _j_chunks(recs, fam), fam.plan.epoch,
                           [_jq(q) for q in queries])
    assert got == want
    assert [r[0] for r in got["device"]] == [_oracle(objs, q)
                                             for q in queries]


def _admission_sequence(mod) -> dict:
    """One fixed acquire/release sequence (nothing blocks)."""
    adm = mod.QueryAdmission(
        {"gold": mod.TierPolicy(2, on_full="block"),
         "free": mod.TierPolicy(1, on_full="reject"),
         "none": mod.TierPolicy(0, on_full="reject")},
        tenant_tiers={"freeloader": "free", "banned": "none"},
        default_tier="gold")
    held = [adm.acquire("vip"), adm.acquire("freeloader")]
    outcomes = []
    for tenant in ("freeloader", "banned", "freeloader"):
        try:
            held.append(adm.acquire(tenant))
            outcomes.append("admitted")
        except mod.AdmissionError:
            outcomes.append("rejected")
    adm.release(held.pop(1))
    held.append(adm.acquire("freeloader"))
    adm.release(held.pop(0))
    stats = adm.stats()
    return {"outcomes": outcomes, "stats": stats,
            "tiers": [adm.tier_of(t) for t in ("vip", "freeloader",
                                               "banned")]}


def test_admission_stats_match_jax():
    got = _admission_sequence(__import__(
        "repro_torch.serve.store_engine", fromlist=["_"]))
    assert got == _admission_sequence(j_store_engine)
    assert got["outcomes"] == ["rejected", "rejected", "rejected"]
    assert got["stats"]["free"]["admitted"] == 2


# ---------------------------------------------------------------------------
# the port's own rules: the card by default, one device scanner per bundle
# ---------------------------------------------------------------------------

def test_engine_device_queries_default_to_the_card(ycsb, monkeypatch):
    """``device_backend`` defaults to ``"cuda"``: host queries run, and
    the first device query raises where there is no card instead of
    falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)[:3]
    store = CiaoStore(fam, segment_capacity=256)
    q = Query(clauses=(pool[0],))
    with CiaoServeEngine(store) as serve:
        assert serve.device_backend == "cuda"
        for ch, bv, tier in chunks:
            serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        serve.quiesce()
        assert serve.query(q).count == _oracle(objs[:3 * CHUNK], q)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.query(q, mode="device")
    with pytest.raises(ValueError, match="device backend"):
        CiaoServeEngine(store, device_backend="xla")


def test_one_bundle_device_scanner_serves_threads(ycsb, monkeypatch):
    """Eight threads query one snapshot bundle's device scanner at once:
    each gets the oracle's counts (and the serial pass's), and every
    segment of the snapshot is admitted to the resident plane once.  The
    first admission waits for a second thread to enter ``_admit``; the
    scanner's lock keeps it out, so the wait runs out."""
    from repro_torch.core.device_cache import DeviceSegmentCache
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    router = ShardRouter(n_shards=4, key=choose_routing_key(fam.plan))
    store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
    queries = [Query(clauses=(pool[k],)) for k in range(6)]
    oracle = [_oracle(objs, q) for q in queries]
    admitted: list[tuple[str, int]] = []
    first_in, second_in = threading.Event(), threading.Event()
    real = DeviceSegmentCache._admit

    def admit(self, pairs):
        me = threading.current_thread().name
        if any(name != me for name, _ in admitted):
            second_in.set()
        admitted.extend((me, id(seg)) for seg, _ in pairs)
        if not first_in.is_set():
            first_in.set()
            second_in.wait(timeout=0.5)
        return real(self, pairs)

    monkeypatch.setattr(DeviceSegmentCache, "_admit", admit)
    serve = CiaoServeEngine(store, device_backend="torch",
                            refresh_interval_s=0)
    try:
        for ch, bv, tier in chunks:
            serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
        serve.quiesce()
        got: list[list[int]] = []
        errors: list[BaseException] = []

        def read() -> None:
            try:
                got.append([serve.query(q, mode="device").count
                            for q in queries])
            except BaseException as e:      # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=read) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        assert not errors, errors
        assert got == [oracle] * 8
        serial = [serve.query(q, mode="device").count for q in queries]
        assert serial == oracle
        assert not second_in.is_set()
        ids = [i for _, i in admitted]
        assert ids and len(ids) == len(set(ids))
    finally:
        serve.close()


def test_engine_counts_snapshot_bundles_and_device_planes(ycsb):
    """``stats_report()["snapshots"]`` counts the snapshot bundles, those
    that built a device scanner, and those scanners' plane syncs,
    admissions and uploads, a dropped bundle's included: the totals are
    the sums over every device scanner the engine built."""
    recs, objs, pool = ycsb
    fam = _family(pool)
    chunks = _encode_chunks(recs, fam)
    router = ShardRouter(n_shards=2, key=choose_routing_key(fam.plan))
    store = ShardedCiaoStore(fam, router=router, segment_capacity=256)
    q = Query(clauses=(pool[0],))
    keys = ("syncs", "admitted", "uploads", "upload_bytes")
    want = dict.fromkeys(keys, 0)
    serve = CiaoServeEngine(store, device_backend="torch",
                            refresh_interval_s=0)
    try:
        snaps = serve.stats_report()["snapshots"]
        assert snaps["bundles"] == snaps["device_bundles"] == 0
        assert snaps["uploads"] == 0 and snaps["capture_s"] == 0.0
        first = None
        for part in (chunks[:6], chunks[6:]):
            for ch, bv, tier in part:
                serve.ingest_chunk(ch, bv, epoch=fam.plan.epoch, tier=tier)
            serve.quiesce()
            n = sum(1 for o in objs[:(len(part) if first is None
                                      else len(chunks)) * CHUNK]
                    if q.matches_exact(o))
            assert serve.query(q, mode="device").count == n
            bundle = serve._reader_bundle()
            for k in keys:
                want[k] += sum(getattr(c, k) for c in bundle.device.caches)
            if first is None:
                first = weakref.ref(bundle)
            del bundle
        gc.collect()
        assert first() is None          # dropped, and still counted
        snaps = serve.stats_report()["snapshots"]
        assert snaps["bundles"] == snaps["device_bundles"] == 2
        assert want["uploads"] > 0 and want["admitted"] > 0
        assert {k: snaps[k] for k in keys} == want
        assert snaps["sync_s"] > 0.0
        assert 0.0 < snaps["capture_max_s"] <= snaps["capture_s"]
    finally:
        serve.close()
