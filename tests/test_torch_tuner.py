"""The port's online physical-design tuner (``repro_torch.core.tuner``).

The first part is ``tests/test_tuner.py`` of the JAX package, run on the
port: the incremental migration (counts equal to the unsharded oracle
before, during and after), the lazy per-key layout, the drift triggers
and the tuner loop.  Its threaded migration test runs here on records
from five seeds under a short thread switch interval, and must pass
every time.

Then the builder-view race it used to lose: ``SegmentBuilder.view()``
built its open-tail segment over the builder's live lists, so a view
racing an ``add`` could raise or be cached without the appended rows,
and a migration's summary rebuild from that view pruned a shard that
held a match.  Two tests force ``view()`` to interleave with ``add()``
and with ``seal()`` through an ``Event``.

Last, the port's tuner against the JAX package's on twin stores built
from the same seeded records and the same query log: ``decide()``'s
router (key, mode, boundaries), every ``history`` event, the eager key
sets and the counts after the migration.  All values compared are
integers, strings or key lists, so the tolerance is 0.
"""
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro.core import tuner as j_tuner  # noqa: E402
from repro_torch.core import columnar  # noqa: E402
from repro_torch.core.client import NumpyEngine, encode_chunk  # noqa: E402
from repro_torch.core.columnar import ColumnarSegment  # noqa: E402
from repro_torch.core.predicates import Query, clause, key_value  # noqa: E402
from repro_torch.core.replan import LayoutDrift, layout_drift_signal  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, PushdownPlan,
)
from repro_torch.core.shard import (  # noqa: E402
    ShardedCiaoStore, ShardedScanner, ShardRouter, reshard,
)
from repro_torch.core.tuner import PhysicalDesignTuner, TunerPolicy  # noqa: E402
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import generate_records, predicate_pool  # noqa: E402

CHUNK = 256
N_RECORDS = 2048
KEY_A = "linear_score"
KEY_B = "visits"


@pytest.fixture(scope="module")
def ycsb():
    recs = generate_records("ycsb", N_RECORDS, seed=11)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    objs = [json.loads(r) for r in recs]
    return recs, objs, ranked


def _plan(ranked):
    return PushdownPlan(clauses=ranked[:6])


def _ingest(store, recs, plan, *, jit=False):
    eng = NumpyEngine()
    for start in range(0, len(recs), CHUNK):
        chunk = encode_chunk(recs[start: start + CHUNK])
        bv = eng.eval_fused(chunk, plan.clauses)
        store.ingest_chunk(chunk, bv)
    if jit:
        store.jit_load_raw()
    return store


def _queries(objs, key, n=12):
    vals = sorted({o[key] for o in objs})
    step = max(1, len(vals) // n)
    qs = [Query((clause(key_value(key, v)),)) for v in vals[::step][:n]]
    qs.append(Query((clause(key_value(key, -1)),)))   # no match
    return qs


def _counts(scanner, qs):
    return [scanner.scan(q).count for q in qs]


# ---------------------------------------------------------------------------
# incremental migration: exactness before / during / after
# ---------------------------------------------------------------------------

def test_migration_counts_exact_every_batch(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]),
            segment_capacity=256),
        recs, plan, jit=True)
    oracle = _ingest(CiaoStore(plan, segment_capacity=256), recs, plan,
                     jit=True)
    qs = _queries(objs, KEY_B) + _queries(objs, KEY_A, n=4)
    want = _counts(DataSkippingScanner(oracle), qs)
    sc = ShardedScanner(store)
    assert _counts(sc, qs) == want                      # before

    mig = store.begin_migration(
        ShardRouter.from_samples(4, KEY_B, objs[:400]), batch_rows=300)
    batches = 0
    while not mig.done:
        mig.step()
        batches += 1
        assert _counts(sc, qs) == want                  # during, live store
        snap = store.snapshot()
        assert _counts(ShardedScanner(snap, log_queries=False),
                       qs) == want                      # during, snapshot
    assert batches > 2                                  # actually incremental
    assert mig.rows_moved > 0
    assert _counts(sc, qs) == want                      # after
    assert store.router.key == KEY_B

    # placement-derived counters are exact: rows partition the shards
    assert sum(sh.stats.n_records for sh in store.shards) == N_RECORDS
    assert sum(sh.stats.n_loaded for sh in store.shards) == \
        oracle.stats.n_loaded
    per_group = {}
    for sh in store.shards:
        for k, n in sh.group_records.items():
            per_group[k] = per_group.get(k, 0) + n
    assert per_group == dict(oracle.group_records)

    # partition pruning recovered on the NEW key: point lookups off the
    # hot key now refute whole shards
    pruned = sum(sc.scan(q).shards_pruned for q in _queries(objs, KEY_B))
    assert pruned > 0
    tele = store.telemetry.snapshot()["tuner"]
    assert tele["migrations"] == 1
    assert tele["rows_moved"] == mig.rows_moved


def test_migration_summaries_rebuilt_and_old_snapshots_sound(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]),
            segment_capacity=256),
        recs, plan)
    pre = store.snapshot()
    pre_summaries = list(pre.summaries)
    qs = _queries(objs, KEY_B)
    want = _counts(ShardedScanner(pre), qs)
    mig = store.begin_migration(
        ShardRouter.from_samples(4, KEY_B, objs[:400]))
    mig.run()
    # live store got FRESH exhaustive summaries; the old snapshot kept
    # its (now over-permissive) ones and still answers exactly
    assert all(a is not b for a, b in zip(store.summaries, pre_summaries))
    assert all(s.exhaustive for s in store.summaries)
    assert _counts(ShardedScanner(pre), qs) == want


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_migration_concurrent_with_ingest_and_scans(seed):
    """The JAX package's test on records from several seeds, with a short
    thread switch interval so that the feeder, the scanner and the
    migration interleave often: the port's builder views must never lose
    or tear a row (``SegmentBuilder``'s lock)."""
    recs = generate_records("ycsb", N_RECORDS, seed=seed)
    objs = [json.loads(r) for r in recs]
    sel = estimate_selectivities(predicate_pool("ycsb"), recs[:300])
    ranked = sorted(predicate_pool("ycsb"), key=lambda c: abs(sel[c] - 0.2))
    plan = _plan(ranked)
    half = N_RECORDS // 2
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]),
            segment_capacity=256),
        recs[:half], plan)
    oracle = _ingest(CiaoStore(plan, segment_capacity=256), recs, plan)
    qs = _queries(objs, KEY_B, n=6)
    errors: list[BaseException] = []
    mig = store.begin_migration(
        ShardRouter.from_samples(4, KEY_B, objs[:400]), batch_rows=200)

    def feed():
        try:
            eng = NumpyEngine()
            for start in range(half, N_RECORDS, CHUNK):
                chunk = encode_chunk(recs[start: start + CHUNK])
                store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    def read():
        try:
            sc = ShardedScanner(store, log_queries=False)
            while not mig.done:
                for q in qs:
                    sc.scan(q)
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=feed),
               threading.Thread(target=read)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        while not mig.done:
            mig.step()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive(), "a thread never finished"
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    # quiesced: every row landed exactly once, counts match the oracle
    want = _counts(DataSkippingScanner(oracle), qs)
    assert _counts(ShardedScanner(store), qs) == want
    assert sum(sh.stats.n_records for sh in store.shards) == N_RECORDS


def test_migration_requires_same_shard_count(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = ShardedCiaoStore(
        plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]))
    with pytest.raises(ValueError, match="shard count"):
        store.begin_migration(
            ShardRouter.from_samples(8, KEY_A, objs[:400]))


def test_reshard_still_matches_oracle_after_delegation(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]),
            segment_capacity=256),
        recs, plan, jit=True)
    oracle = _ingest(CiaoStore(plan, segment_capacity=256), recs, plan,
                     jit=True)
    out = reshard(store, ShardRouter.from_samples(8, KEY_B, objs[:400]))
    qs = _queries(objs, KEY_B) + _queries(objs, KEY_A, n=4)
    want = _counts(DataSkippingScanner(oracle), qs)
    assert _counts(ShardedScanner(out), qs) == want
    assert sum(sh.stats.n_records for sh in out.shards) == N_RECORDS
    assert dict(out.group_records) == dict(oracle.group_records)


# ---------------------------------------------------------------------------
# per-key layout policy
# ---------------------------------------------------------------------------

def test_lazy_layout_counts_identical(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    eager = _ingest(CiaoStore(plan, segment_capacity=256), recs, plan)
    lazy = CiaoStore(plan, segment_capacity=256)
    plan_keys = {t.key for c in plan.clauses for t in c.terms}
    lazy.layout_eager_keys = frozenset(plan_keys | {KEY_A})
    _ingest(lazy, recs, plan)
    qs = (_queries(objs, KEY_A, n=4) + _queries(objs, KEY_B, n=4)
          + _queries(objs, "phone_country", n=3)
          + [Query((clause(key_value("isActive", True)),))])
    want = _counts(DataSkippingScanner(eager), qs)
    assert _counts(DataSkippingScanner(lazy), qs) == want
    # the lazy store really deferred some columns, then materialized
    # exactly the touched ones
    segs = [b for b in lazy.blocks if isinstance(b, ColumnarSegment)]
    assert any(KEY_B in s.key_cols for s in segs)       # touched -> built
    assert all("email" not in s.key_cols for s in segs)  # untouched -> raw


def test_lazy_key_absent_vs_deferred():
    objs = [{"a": i, "b": i * 2} for i in range(8)]
    recs = [json.dumps(o).encode() for o in objs]
    seg = ColumnarSegment(
        records=recs, bitvectors=np.zeros((0, 1), np.uint32),
        epoch=0, n_covered=0, tier=0, objs=objs,
        eager_keys=frozenset({"a"}))
    assert seg.lazy_keys == frozenset({"b"})
    # genuinely absent key refutes without materializing anything
    assert not seg.clause_possible(Query((clause(key_value("zz", 1)),))
                                   .clauses[0])
    assert seg.lazy_keys == frozenset({"b"})
    # deferred key materializes on first touch, with exact results
    c = clause(key_value("b", 6))
    assert seg.clause_possible(c)
    mask, leftover = seg.clause_mask(c)
    assert int(mask.sum()) == 1 and not leftover
    assert "b" in seg.key_cols and not seg.lazy_keys


def test_lazy_materialization_race_is_single_winner():
    objs = [{"a": i, "b": i % 5} for i in range(512)]
    recs = [json.dumps(o).encode() for o in objs]
    seg = ColumnarSegment(
        records=recs, bitvectors=np.zeros((0, 16), np.uint32),
        epoch=0, n_covered=0, tier=0, objs=objs,
        eager_keys=frozenset({"a"}))
    cols, errors = [], []

    def touch():
        try:
            cols.append(seg.key_col("b"))
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=touch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert not errors
    assert all(c is cols[0] for c in cols)      # one winner, shared column
    assert cols[0].num_valid.sum() == 512


def test_device_cache_refuses_lazy_segments():
    from repro_torch.core.device_cache import DeviceSegmentCache
    objs = [{"a": i, "b": i} for i in range(16)]
    recs = [json.dumps(o).encode() for o in objs]
    lazy = ColumnarSegment(
        records=recs, bitvectors=np.zeros((1, 1), np.uint32),
        epoch=0, n_covered=1, tier=0, objs=objs,
        eager_keys=frozenset({"a"}))
    full = ColumnarSegment(
        records=recs, bitvectors=np.zeros((1, 1), np.uint32),
        epoch=0, n_covered=1, tier=0, objs=objs)
    assert not DeviceSegmentCache._eligible(lazy)
    assert DeviceSegmentCache._eligible(full)
    # materializing every lazy key restores eligibility
    lazy.key_col("b")
    assert not lazy.lazy_keys
    assert DeviceSegmentCache._eligible(lazy)


def test_plane_split_counts_rows_the_plane_refuses(ycsb):
    """``bench_tuner.plane_split``: with every key eager each loaded or
    promoted row is a device row; under a lazy layout (one eager key, as
    ``retune_layout`` leaves it) the lazy segments' rows are host-fallback
    rows; either way the two add up to the store's rows."""
    from repro_torch.benchmarks.bench_tuner import plane_split
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    chunks = _chunks(recs, plan)
    router = ShardRouter.from_samples(2, "linear_score", objs[:512])
    splits = []
    for layout in (None, frozenset({"linear_score"})):
        store = ShardedCiaoStore(plan, router=router, segment_capacity=256)
        for sh in store.shards:
            sh.layout_eager_keys = layout
        for chunk, bv in chunks:
            store.ingest_chunk(chunk, bv)
        store.jit_load_raw()
        split = plane_split(store, "cpu")
        rows = sum(seg.n_rows for sh in store.shards
                   for seg in (*sh.blocks, *sh.jit_blocks))
        assert rows > store.stats.n_loaded > 0
        assert split["device_rows"] + split["host_rows"] == rows
        splits.append(split)
    assert splits[0]["host_rows"] == 0
    assert splits[1]["host_rows"] > 0


# ---------------------------------------------------------------------------
# drift signal + tuner loop
# ---------------------------------------------------------------------------

def test_layout_drift_triggers():
    sig = LayoutDrift(routing_key=KEY_A, hot_key=KEY_B, hot_share=0.8,
                      routing_share=0.1, n_window=32)
    assert sig.triggers() == "key-shift"
    assert LayoutDrift(routing_key=KEY_A, hot_key=KEY_A, hot_share=0.9,
                       routing_share=0.9, n_window=32).triggers() is None
    assert LayoutDrift(routing_key=KEY_A, hot_key=KEY_B, hot_share=0.8,
                       routing_share=0.1, n_window=2).triggers() is None
    assert LayoutDrift(routing_key=KEY_A, hot_key=KEY_A, hot_share=1.0,
                       routing_share=1.0, n_window=32,
                       shard_skew=8.0).triggers() == "skew"


def test_layout_drift_signal_reads_query_log(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400])),
        recs, plan)
    for q in _queries(objs, KEY_B):
        store.log_query(q)
    sig = layout_drift_signal(store)
    assert sig.routing_key == KEY_A
    assert sig.hot_key == KEY_B
    assert sig.hot_share > 0.9
    assert sig.triggers() == "key-shift"


def test_tuner_migrates_on_key_shift_and_retunes_layout(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]),
            segment_capacity=256),
        recs, plan)
    oracle = _ingest(CiaoStore(plan, segment_capacity=256), recs, plan)
    tuner = PhysicalDesignTuner(
        store, policy=TunerPolicy(check_every_scans=8, batch_rows=512))
    sc = ShardedScanner(store)
    qs = _queries(objs, KEY_B)
    want = _counts(DataSkippingScanner(oracle), qs)
    assert _counts(sc, qs) == want
    assert tuner.step() is None or tuner.migrating  # throttled or started
    while not tuner.migrating:
        for q in qs:
            sc.scan(q)
        tuner.step()
    tuner.run_migration()
    assert store.router.key == KEY_B
    assert _counts(sc, qs) == want
    kinds = [e.kind for e in tuner.history]
    assert "migration-start" in kinds and "migration-finish" in kinds
    # layout co-selection: the hot key and plan keys went eager
    eager = store.shards[0].layout_eager_keys
    assert KEY_B in eager
    assert {t.key for c in plan.clauses for t in c.terms} <= eager
    tele = store.telemetry.snapshot()["tuner"]
    assert tele["router_swaps"] == 1 and tele["layout_retunes"] == 1


def test_tuner_stable_workload_no_action(ycsb):
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    store = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400])),
        recs, plan)
    tuner = PhysicalDesignTuner(store, policy=TunerPolicy(check_every_scans=4))
    sc = ShardedScanner(store)
    for q in _queries(objs, KEY_A):          # workload ON the routing key
        sc.scan(q)
    for _ in range(8):
        assert tuner.step() is None
    assert store.router.key == KEY_A and not tuner.history


def test_tuner_skew_triggers_requantile():
    # range boundaries fitted to a key distribution that then drifted:
    # the live rows all land past the last cut point
    plan = PushdownPlan(clauses=(clause(key_value("flag", True)),))
    rng = np.random.default_rng(3)
    warm = [{"k": float(v), "flag": True} for v in rng.uniform(0, 100, 400)]
    store = ShardedCiaoStore(
        plan, router=ShardRouter.from_samples(6, "k", warm),
        segment_capacity=128)
    objs = [{"k": float(v), "flag": bool(i % 2)}
            for i, v in enumerate(rng.uniform(85, 100, 1200))]
    recs = [json.dumps(o).encode() for o in objs]
    eng = NumpyEngine()
    for start in range(0, len(recs), 200):
        chunk = encode_chunk(recs[start: start + 200])
        store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    rows = [sh.stats.n_records for sh in store.shards]
    assert max(rows) / (sum(rows) / len(rows)) > 4.0    # genuinely skewed
    tuner = PhysicalDesignTuner(
        store, policy=TunerPolicy(check_every_scans=0, batch_rows=600))
    ev = tuner.step()
    assert ev is not None and ev.reason == "skew"
    tuner.run_migration()
    rows = [sh.stats.n_records for sh in store.shards]
    assert sum(rows) == 1200
    assert max(rows) / (sum(rows) / len(rows)) < 2.0    # re-balanced


# ---------------------------------------------------------------------------
# the builder-view race, forced: view() interleaved with add() / seal()
# ---------------------------------------------------------------------------

def _builder_rows(n, start=0):
    objs = [{"a": i, "b": i % 7} for i in range(start, start + n)]
    return [json.dumps(o).encode() for o in objs], objs, np.ones((1, n), bool)


@pytest.mark.parametrize("writer", ["add", "seal"])
def test_builder_view_never_misses_rows_or_tears(writer, monkeypatch):
    """A ``view()`` is held inside its column build (``build_key_columns``)
    while the main thread appends a chunk or seals the tail.  The view
    in flight must stay internally whole (as many key-column rows as
    records) and raise nothing; the NEXT view must hold exactly the
    builder's rows.  Before the repair the view was built over the live
    lists and cached after the append had cleared it: the next view
    lacked the appended rows, and after a seal it still held the sealed
    rows (counted twice beside the sealed segment)."""
    b = columnar.SegmentBuilder(epoch=0, n_covered=1, tier=0, capacity=1024)
    b.add(*_builder_rows(100))
    entered, proceed = threading.Event(), threading.Event()
    real = columnar.build_key_columns
    viewer: list[threading.Thread] = []

    def held(*args, **kw):
        if threading.current_thread() in viewer:
            entered.set()
            assert proceed.wait(timeout=30.0)
        return real(*args, **kw)

    monkeypatch.setattr(columnar, "build_key_columns", held)
    got: list = []
    errors: list[BaseException] = []

    def view():
        try:
            got.append(b.view())
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    t = threading.Thread(target=view)
    viewer.append(t)
    t.start()
    try:
        assert entered.wait(timeout=30.0)
        if writer == "add":
            b.add(*_builder_rows(50, start=100))
            sealed = None
        else:
            sealed = b.seal()
    finally:
        proceed.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert not errors, errors
    (inflight,) = got
    assert inflight.n_rows == 100            # the state it was asked for
    assert all(len(c.num_valid) == inflight.n_rows
               for c in inflight.key_cols.values())
    now = b.view()
    if writer == "add":
        assert now.n_rows == b.n_rows == 150
        assert [o["a"] for o in now.rows] == list(range(150))
    else:
        assert sealed.n_rows == 100
        assert b.n_rows == 0 and now.n_rows == 0


def _chunks(recs, plan):
    eng = NumpyEngine()
    out = []
    for start in range(0, len(recs), CHUNK):
        chunk = encode_chunk(recs[start: start + CHUNK])
        out.append((chunk, eng.eval_fused(chunk, plan.clauses)))
    return out


def test_store_blocks_under_concurrent_ingest_are_whole(ycsb):
    """Lock-free ``CiaoStore.blocks`` readers racing ingest see only
    whole segments (every key column as long as its segment), never
    raise, and never count a row twice: the rows ``blocks`` holds never
    exceed the rows loaded through the chunk being ingested.  After the
    feeder ends, ``blocks`` holds every loaded row once, in the segments a
    serial ingest makes."""
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    chunks = _chunks(recs, plan)
    serial = CiaoStore(plan, segment_capacity=512)
    upto = []                       # rows loaded once chunk i is in
    for chunk, bv in chunks:
        serial.ingest_chunk(chunk, bv)
        upto.append(serial.stats.n_loaded)
    store = CiaoStore(plan, segment_capacity=512)
    ceiling = [0]                   # loaded rows through the current chunk
    done = threading.Event()
    errors: list[BaseException] = []

    def feed():
        try:
            for (chunk, bv), most in zip(chunks, upto):
                ceiling[0] = most
                store.ingest_chunk(chunk, bv)
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)
        finally:
            done.set()

    def read():
        try:
            while not done.is_set():
                segs = store.blocks
                most = ceiling[0]
                for seg in segs:
                    for col in seg.key_cols.values():
                        assert len(col.num_valid) == seg.n_rows
                total = sum(seg.n_rows for seg in segs)
                assert total <= most, f"{total} rows > {most} loaded"
        except BaseException as e:      # pragma: no cover - failure path
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=feed)] + [
        threading.Thread(target=read) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert [seg.n_rows for seg in store.blocks] == \
        [seg.n_rows for seg in serial.blocks]
    assert sum(seg.n_rows for seg in store.blocks) == store.stats.n_loaded


def test_store_blocks_never_counts_a_tail_sealed_under_it(ycsb):
    """A tail viewed by ``blocks`` and sealed before ``blocks`` returns
    (an ingest on another thread, forced here from inside ``view()``) is
    counted at most once: ``blocks`` reads the sealed list before it views
    the tails, so the newly sealed segment is missing, never doubled."""
    recs, objs, ranked = ycsb
    plan = _plan(ranked)
    chunks = _chunks(recs, plan)
    probe = CiaoStore(plan)
    probe.ingest_chunk(*chunks[0])
    n0 = probe.stats.n_loaded
    assert n0 > 0
    # the next chunk's first loaded row seals the tail
    store = CiaoStore(plan, segment_capacity=n0 + 1)
    store.ingest_chunk(*chunks[0])
    (builder,) = [b for b in store._builders.values() if b.n_rows]
    view = builder.view

    def view_then_seal():
        seg = view()
        store.ingest_chunk(*chunks[1])
        assert len(store.segments) == 1     # the viewed tail, sealed
        return seg

    builder.view = view_then_seal
    try:
        seen = store.blocks
    finally:
        del builder.view
    assert sum(seg.n_rows for seg in seen) <= store.stats.n_loaded
    assert [seg.n_rows for seg in seen] == [n0]


# ---------------------------------------------------------------------------
# the port's tuner against the JAX package's
# ---------------------------------------------------------------------------

def _jq(q):
    return j_pred.Query(tuple(j_pred.clause_from_obj(_clause_obj(c))
                              for c in q.clauses), freq=q.freq)


def _clause_obj(c):
    from repro_torch.core.predicates import clause_to_obj
    return clause_to_obj(c)


def _twin_stores(recs, objs, ranked):
    """The same records, plan and range router in both packages."""
    plan = _plan(ranked)
    port = _ingest(
        ShardedCiaoStore(
            plan, router=ShardRouter.from_samples(4, KEY_A, objs[:400]),
            segment_capacity=256),
        recs, plan)
    j_plan = j_server.PushdownPlan(
        clauses=tuple(j_pred.clause_from_obj(_clause_obj(c))
                      for c in plan.clauses))
    jax_store = j_shard.ShardedCiaoStore(
        j_plan, router=j_shard.ShardRouter.from_samples(4, KEY_A, objs[:400]),
        segment_capacity=256)
    eng = j_client.NumpyEngine()
    for start in range(0, len(recs), CHUNK):
        chunk = j_client.encode_chunk(recs[start: start + CHUNK])
        jax_store.ingest_chunk(chunk, eng.eval_fused(chunk, j_plan.clauses))
    return port, jax_store


def _router(r):
    return (r.key, r.mode, tuple(r.boundaries or ()))


def _events(history):
    return [(e.kind, e.reason, e.routing_key, json.dumps(e.detail,
                                                        sort_keys=True))
            for e in history]


@pytest.mark.parametrize("drift_key", [KEY_B, "phone_country"])
def test_tuner_decisions_history_and_layout_match_jax(ycsb, drift_key):
    """Both tuners read one query log (point lookups on ``drift_key``):
    ``decide()`` gives the same router (range boundaries on ``visits``;
    a hash router on ``phone_country``, which has no numeric values),
    the stepped loop the same events with the same details, and the
    stores the same eager key sets, router and counts afterwards."""
    recs, objs, ranked = ycsb
    port, jax_store = _twin_stores(recs, objs, ranked)
    qs = _queries(objs, drift_key, n=10)
    for q in qs * 3:
        port.log_query(q)
        jax_store.log_query(_jq(q))
    policy = dict(check_every_scans=4, batch_rows=300)
    pt = PhysicalDesignTuner(port, policy=TunerPolicy(**policy))
    jt = j_tuner.PhysicalDesignTuner(
        jax_store, policy=j_tuner.TunerPolicy(**policy))
    (p_reason, p_router), (j_reason, j_router) = pt.decide(), jt.decide()
    assert p_reason == j_reason == "key-shift"
    assert _router(p_router) == _router(j_router)
    assert p_router.key == drift_key
    for _ in range(64):
        pt.step()
        jt.step()
        if not (pt.migrating or jt.migrating) and pt.history:
            break
    assert not pt.migrating and not jt.migrating
    assert _events(pt.history) == _events(jt.history)
    assert [e.kind for e in pt.history] == [
        "layout", "migration-start", "migration-finish"]
    assert _router(port.router) == _router(jax_store.router)
    for ps, js in zip(port.shards, jax_store.shards):
        assert ps.layout_eager_keys == js.layout_eager_keys
        assert ps.stats.n_records == js.stats.n_records
    want = [j_shard.ShardedScanner(jax_store, log_queries=False)
            .scan(_jq(q)) for q in qs]
    got = [ShardedScanner(port, log_queries=False).scan(q) for q in qs]
    assert [(r.count, r.shards_pruned) for r in got] == \
        [(r.count, r.shards_pruned) for r in want]
