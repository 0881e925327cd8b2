"""The port's multi-query batcher and result cache
(``repro_torch.core.batch_scan``).

The first part is ``tests/test_batch_scan.py`` of the JAX package, run on
the port: :class:`ScanBatcher` results are BIT-IDENTICAL to sequential
``DataSkippingScanner`` / ``ShardedScanner`` scans issued in the same
order, across mixed epochs and tiers, shard counts, promoted and
un-promoted stores and partition-pruning range routers; the
:class:`ResultCache` contract (warm repeats, order independence,
invalidation by ingest and by epoch); and telemetry.  The second part
holds the port's batcher (with and without a cache, with the AND hook on
kernel C's plain version) and the port's ``DeviceScanner`` with a real
``ResultCache`` against the JAX package's ``ShardedScanner`` on twin
stores, in every ``ScanResult`` field (tolerance 0: integers only).
"""
import json

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro_torch.core.batch_scan import ResultCache, ScanBatcher, copy_scan_result
from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.predicates import (
    Clause, Kind, Query, SimplePredicate, clause, key_value,
)
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.shard import ShardedCiaoStore, ShardedScanner, ShardRouter
from repro_torch.core.telemetry import TelemetryPlane
from repro_torch.core.workload import estimate_selectivities
from repro_torch.data.datasets import generate_records, predicate_pool

CHUNK = 256
N_RECORDS = 2048


def _accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.shards_pruned,
            r.used_skipping,
            tuple(sorted(
                (k, (g.count, g.rows_scanned, g.rows_skipped, g.raw_parsed,
                     g.segments_pruned))
                for k, g in r.groups.items())))


@pytest.fixture(scope="module")
def ycsb():
    recs = generate_records("ycsb", N_RECORDS, seed=7)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    objs = [json.loads(r) for r in recs]
    return recs, objs, ranked


def _families(ranked):
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    fam1 = evolve_family(fam0, ranked[:4] + ranked[8:12], (2, 4, 8))
    return fam0, fam1


def _build(store, recs, fam0, fam1, *, jit=True):
    """Mixed-epoch / mixed-tier ingest, replan at the halfway point."""
    eng = NumpyEngine()

    def ingest(lo, hi, epoch):
        fam = store.family
        for i, start in enumerate(range(lo, hi, CHUNK)):
            tier = i % fam.n_tiers
            chunk = encode_chunk(recs[start: start + CHUNK])
            bv = eng.eval_fused_prefix(chunk, fam.plan.clauses,
                                       fam.tier_sizes[tier])
            store.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)

    half = (len(recs) // 2) // CHUNK * CHUNK
    ingest(0, half, epoch=0)
    store.advance_epoch(fam1)
    ingest(half, len(recs), epoch=1)
    if jit:
        store.jit_load_raw()
    return store


def _workload(fam0, fam1, ranked):
    qs = [Query((c,)) for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]]
    qs += [Query((fam0.plan.clauses[0], ranked[13]))]   # pushed + residual
    qs += [Query((c,)) for c in ranked[14:17]]          # residual-only
    for v in (3, 55, 97, 250):                          # 250: no match
        qs.append(Query((clause(key_value("linear_score", v)),)))
    qs.append(Query((clause(key_value("phone_country", "ZZ")),)))
    return qs


def _ingest_more(store, recs, fam1, lo=0, hi=64):
    eng = NumpyEngine()
    chunk = encode_chunk(recs[lo:hi])
    bv = eng.eval_fused_prefix(chunk, fam1.plan.clauses, 4)
    store.ingest_chunk(chunk, bv, epoch=1, tier=1)


# ---------------------------------------------------------------------------
# batch-of-N vs sequential, monolithic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jit", [True, False])
def test_batch_bit_identical_to_sequential(ycsb, jit):
    """Promoted AND un-promoted stores: the un-promoted case pins the
    sequential promotion semantics (query i sees only jit segments
    promoted by queries <= i)."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    queries = _workload(fam0, fam1, ranked)
    a = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1,
               jit=jit)
    b = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1,
               jit=jit)
    batched = ScanBatcher(a, log_queries=False).scan_batch(queries)
    host = DataSkippingScanner(b, log_queries=False)
    for q, r in zip(queries, batched):
        oracle = sum(1 for o in objs if q.matches_exact(o))
        h = host.scan(q)
        assert r.count == oracle, q.describe()
        assert _accounting(r) == _accounting(h), q.describe()
        assert list(r.groups) == sorted(r.groups)


def test_single_query_scan_matches_scanner(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    bat = ScanBatcher(store, log_queries=False)
    host = DataSkippingScanner(store, log_queries=False)
    for q in _workload(fam0, fam1, ranked)[:4]:
        assert _accounting(bat.scan(q)) == _accounting(host.scan(q))


# ---------------------------------------------------------------------------
# batch-of-N vs sequential, sharded (hash + pruning range router)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_batch_bit_identical(ycsb, n_shards):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = (ShardRouter(n_shards=n_shards, key="linear_score", mode="hash")
              if n_shards > 1 else None)
    a = _build(ShardedCiaoStore(fam0, router=router, n_shards=n_shards,
                                segment_capacity=512), recs, fam0, fam1)
    b = _build(ShardedCiaoStore(fam0, router=router, n_shards=n_shards,
                                segment_capacity=512), recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked)
    batched = ScanBatcher(a, log_queries=False).scan_batch(queries)
    with ShardedScanner(b, log_queries=False) as sc:
        for q, r in zip(queries, batched):
            oracle = sum(1 for o in objs if q.matches_exact(o))
            h = sc.scan(q)
            assert r.count == oracle, q.describe()
            assert _accounting(r) == _accounting(h), q.describe()


def test_sharded_batch_range_router_prunes(ycsb):
    """Partition-refuted shards: snapshot rows_skipped, never promote."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter.from_samples(4, "linear_score", objs[:400])
    a = _build(ShardedCiaoStore(fam0, router=router, segment_capacity=512),
               recs, fam0, fam1)
    b = _build(ShardedCiaoStore(fam0, router=router, segment_capacity=512),
               recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked)
    batched = ScanBatcher(a, log_queries=False).scan_batch(queries)
    pruned = 0
    with ShardedScanner(b, log_queries=False) as sc:
        for q, r in zip(queries, batched):
            assert _accounting(r) == _accounting(sc.scan(q)), q.describe()
            pruned += r.shards_pruned
    assert pruned > 0          # the range router actually refuted shards


# ---------------------------------------------------------------------------
# result cache: warm repeats, order independence, invalidation
# ---------------------------------------------------------------------------

def test_cache_warm_repeat_bit_identical(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(ShardedCiaoStore(
        fam0, router=ShardRouter(n_shards=4, key="linear_score",
                                 mode="hash"),
        segment_capacity=512), recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked)
    cache = ResultCache()
    bat = ScanBatcher(store, cache=cache, log_queries=False)
    cold = bat.scan_batch(queries)
    assert cache.hits == 0 and cache.misses > 0
    warm = bat.scan_batch(queries)
    assert cache.hits > 0
    for q, rc, rw in zip(queries, cold, warm):
        assert _accounting(rc) == _accounting(rw), q.describe()


def test_cache_scan_order_independent_counts(ycsb):
    """Counts never depend on the order cached/uncached queries run in."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    queries = _workload(fam0, fam1, ranked)
    perm = list(reversed(range(len(queries))))
    a = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1,
               jit=False)
    b = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1,
               jit=False)
    ba = ScanBatcher(a, cache=ResultCache(), log_queries=False)
    bb = ScanBatcher(b, cache=ResultCache(), log_queries=False)
    fwd = ba.scan_batch(queries) + ba.scan_batch(queries)        # cold + warm
    rev = bb.scan_batch([queries[i] for i in perm])
    rev = [rev[perm.index(i)] for i in range(len(queries))]
    rev += [r for r in rev]                                       # warm = cold
    for q, rf, rr in zip(queries, fwd, rev):
        oracle = sum(1 for o in objs if q.matches_exact(o))
        assert rf.count == oracle == rr.count, q.describe()


def test_cache_invalidated_by_ingest(ycsb):
    """data_version bump on ingest: stale (shard, epoch) entries never
    answer — post-ingest batch counts match the fresh oracle."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(ShardedCiaoStore(
        fam0, router=ShardRouter(n_shards=4, key="linear_score",
                                 mode="hash"),
        segment_capacity=512), recs, fam0, fam1)
    twin = _build(ShardedCiaoStore(
        fam0, router=ShardRouter(n_shards=4, key="linear_score",
                                 mode="hash"),
        segment_capacity=512), recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked)
    cache = ResultCache()
    bat = ScanBatcher(store, cache=cache, log_queries=False)
    bat.scan_batch(queries)
    bat.scan_batch(queries)            # cache fully warm
    hits_before = cache.hits
    versions = [sh.data_version for sh in store.shards]
    # ingest records routed to shard 0 ONLY: its version bumps, the rest
    # keep their cached entries valid
    router = store.router
    picked = [i for i in range(len(recs))
              if router.shard_of(objs[i], recs[i]) == 0][:48]
    extra = [recs[i] for i in picked]
    eng = NumpyEngine()
    chunk = encode_chunk(extra)
    bv = eng.eval_fused_prefix(chunk, fam1.plan.clauses, 4)
    store.ingest_chunk(chunk, bv, epoch=1, tier=1)
    twin.ingest_chunk(chunk, bv, epoch=1, tier=1)
    after = [sh.data_version for sh in store.shards]
    assert after[0] > versions[0] and after[1:] == versions[1:]
    objs2 = objs + [objs[i] for i in picked]
    got = bat.scan_batch(queries)
    with ShardedScanner(twin, log_queries=False) as sc:
        for q, r in zip(queries, got):
            oracle = sum(1 for o in objs2 if q.matches_exact(o))
            h = sc.scan(q)
            assert r.count == oracle, q.describe()
            assert _accounting(r) == _accounting(h), q.describe()
    # shards untouched by the ingest keep answering from cache
    assert cache.hits > hits_before


def test_cache_epoch_match_required(ycsb):
    """advance_epoch alone (new plan, same data) must invalidate."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked)[:5]
    cache = ResultCache()
    bat = ScanBatcher(store, cache=cache, log_queries=False)
    before = bat.scan_batch(queries)
    fam2 = evolve_family(store.family, ranked[:8], (2, 4, 8))
    store.advance_epoch(fam2)
    hits0 = cache.hits
    after = bat.scan_batch(queries)
    assert cache.hits == hits0          # nothing answered stale
    for q, r0, r1 in zip(queries, before, after):
        assert r0.count == r1.count     # same data, same counts


def test_cache_lru_and_unhashable(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    cache = ResultCache(cap=2)
    r = ScanBatcher(_build(CiaoStore(fam0, segment_capacity=512), recs,
                           fam0, fam1), cache=cache,
                    log_queries=False).scan(Query((ranked[0],)))
    cache.store(0, Query((ranked[1],)), r, epoch=0, data_version=1)
    cache.store(0, Query((ranked[2],)), r, epoch=0, data_version=1)
    cache.store(0, Query((ranked[3],)), r, epoch=0, data_version=1)
    assert len(cache) == 2             # LRU evicted past cap
    # unhashable clause values are silently uncacheable
    bad = Query((Clause(terms=(SimplePredicate(
        Kind.KEY_VALUE, "k", ["not", "hashable"]),)),))
    cache.store(0, bad, r, epoch=0, data_version=1)
    assert cache.lookup(0, bad, epoch=0, data_version=1) is None
    assert len(cache) == 2
    # invalidate() drops per-shard and globally
    assert cache.invalidate(0) == 2
    assert len(cache) == 0


def test_copy_scan_result_is_deep(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    r = ScanBatcher(store, log_queries=False).scan(Query((ranked[0],)))
    c = copy_scan_result(r)
    assert _accounting(c) == _accounting(r)
    c.shards_scanned += 1
    next(iter(c.groups.values())).count += 99
    assert _accounting(c) != _accounting(r)   # no aliasing


# ---------------------------------------------------------------------------
# scanner cache wiring: ShardedScanner shares the same cache contract
# ---------------------------------------------------------------------------

def test_sharded_scanner_cache_wiring(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(ShardedCiaoStore(
        fam0, router=ShardRouter(n_shards=4, key="linear_score",
                                 mode="hash"),
        segment_capacity=512), recs, fam0, fam1)
    queries = [Query((c,)) for c in ranked[:6]]     # six DISTINCT clauses
    cache = ResultCache()
    with ShardedScanner(store, cache=cache, log_queries=False) as sc:
        cold = [sc.scan(q) for q in queries]
        assert cache.hits == 0
        warm = [sc.scan(q) for q in queries]
        assert cache.hits > 0
    for q, rc, rw in zip(queries, cold, warm):
        assert _accounting(rc) == _accounting(rw), q.describe()
    # one cache serves batcher and scanner alike: the batcher now hits
    bat = ScanBatcher(store, cache=cache, log_queries=False)
    h0 = cache.hits
    again = bat.scan_batch(queries)
    assert cache.hits > h0
    for q, rw, rb in zip(queries, warm, again):
        assert _accounting(rw) == _accounting(rb), q.describe()


# ---------------------------------------------------------------------------
# telemetry: counters agree with the ScanResult accounting they fold
# ---------------------------------------------------------------------------

def test_telemetry_counters_match_results(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked)
    bat = ScanBatcher(store, cache=ResultCache(), log_queries=False)
    got = bat.scan_batch(queries) + bat.scan_batch(queries)
    snap = store.telemetry.snapshot()
    t = snap["tenants"]["default"]
    assert t["scans"] == len(got)
    assert t["count"] == sum(r.count for r in got)
    assert t["rows_scanned"] == sum(r.rows_scanned for r in got)
    assert t["rows_skipped"] == sum(r.rows_skipped for r in got)
    assert t["raw_parsed"] == sum(r.raw_parsed for r in got)
    assert t["segments_pruned"] == sum(r.segments_pruned for r in got)
    assert t["segments_scanned"] == sum(r.segments_scanned for r in got)
    assert t["cache_hits"] == bat.cache.hits
    assert t["cache_misses"] == bat.cache.misses
    assert 0.0 < t["cache_hit_rate"] <= 1.0
    assert 0.0 <= t["zone_skip_fraction"] <= 1.0
    assert t["latency"]["n"] == len(got)
    # per-(epoch, tier) aggregates cover exactly the groups scanned
    by_tier = snap["tiers"]
    want = {}
    for r in got:
        for (e, tr), g in r.groups.items():
            k = f"{e},{tr}"
            want[k] = want.get(k, 0) + g.count
    assert {k: v["count"] for k, v in by_tier.items()} == want


def test_telemetry_tenant_isolation(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    q = Query((ranked[0],))
    ScanBatcher(store, tenant="alpha", log_queries=False).scan(q)
    ScanBatcher(store, tenant="beta", log_queries=False).scan_batch([q, q])
    tn = store.telemetry.snapshot()["tenants"]
    assert tn["alpha"]["scans"] == 1
    assert tn["beta"]["scans"] == 2


def test_stats_report_shape(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(ShardedCiaoStore(
        fam0, router=ShardRouter(n_shards=2, key="linear_score",
                                 mode="hash"),
        segment_capacity=512), recs, fam0, fam1)
    ScanBatcher(store, log_queries=False).scan(Query((ranked[0],)))
    rep = store.stats_report()
    assert rep["n_shards"] == 2
    assert rep["data_version"] == store.data_version
    assert len(rep["shards"]) == 2
    assert "telemetry" in rep and "tenants" in rep["telemetry"]
    assert json.dumps(rep)              # JSON-serializable end to end


def test_telemetry_feeds_allocator_profiles(ycsb):
    """Measured client rates override the speed*chunk prior."""
    recs, objs, ranked = ycsb
    plane = TelemetryPlane()
    plane.record_client_eval(0, 0.10, 1000)   # 10k rec/s measured
    plane.record_client_eval(1, 0.10, 30000)  # 300k rec/s measured
    m0, m1 = plane.client_eval(0), plane.client_eval(1)
    assert m0["records_per_s"] == pytest.approx(10000.0)
    assert m1["records_per_s"] == pytest.approx(300000.0)

    class _C:                                   # allocator's view of a client
        def __init__(self, shard_id, speed):
            self.shard_id = shard_id
            self.speed = speed
            self.chunk_records = 512
            self.cost_scale = 1.0 / speed

    from repro_torch.data.pipeline import FleetTierAllocator
    fam0, _ = _families(ranked)
    fam = PlanFamily(plan=fam0.plan, tier_sizes=(2, 4, 8),
                     tier_costs=(10.0, 20.0, 40.0),
                     tier_values=(1.0, 2.0, 4.0))
    # equal priors, wildly different measured rates -> weights follow
    alloc = FleetTierAllocator(fam, budget_us=30.0, telemetry=plane)
    w = [p.weight for p in alloc.profiles([_C(0, 1.0), _C(1, 1.0)])]
    assert w[1] == pytest.approx(30 * w[0])
    # no telemetry -> priors (equal speeds, equal weights)
    alloc2 = FleetTierAllocator(fam, budget_us=30.0)
    w2 = [p.weight for p in alloc2.profiles([_C(0, 1.0), _C(1, 1.0)])]
    assert w2[0] == pytest.approx(w2[1])


def test_scanner_telemetry_tristate(ycsb):
    """None inherits store.telemetry, False disables, instance overrides."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    q = Query((ranked[0],))
    own = TelemetryPlane()
    DataSkippingScanner(store, log_queries=False).scan(q)            # inherit
    DataSkippingScanner(store, log_queries=False,
                        telemetry=False).scan(q)                     # off
    DataSkippingScanner(store, log_queries=False,
                        telemetry=own).scan(q)                       # explicit
    assert store.telemetry.snapshot()["tenants"]["default"]["scans"] == 1
    assert own.snapshot()["tenants"]["default"]["scans"] == 1


# ---------------------------------------------------------------------------
# the port against the JAX package, on twin stores
# ---------------------------------------------------------------------------

from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro.core.batch_scan import ResultCache as JResultCache  # noqa: E402
from repro.core.batch_scan import ScanBatcher as JScanBatcher  # noqa: E402
from repro_torch.core.device_scan import DeviceScanner  # noqa: E402
from repro_torch.core.predicates import clause_to_obj  # noqa: E402
from repro_torch.kernels import residual  # noqa: E402


def _full(r) -> tuple:
    return _accounting(r) + (r.shards_scanned,)


def _jq(q):
    return j_pred.Query(tuple(j_pred.clause_from_obj(clause_to_obj(c))
                              for c in q.clauses), freq=q.freq)


def _j_family(fam):
    plan = j_server.PushdownPlan.from_obj(json.loads(json.dumps(
        fam.plan.to_obj())))
    return j_server.PlanFamily.from_obj(plan, json.loads(json.dumps(
        fam.to_obj())))


def _build_jax(recs, fam0, fam1, router, n, *, jit):
    store = j_shard.ShardedCiaoStore(
        _j_family(fam0), n_shards=n, segment_capacity=512,
        router=None if router is None else j_shard.ShardRouter.from_obj(
            router.to_obj()))
    eng = j_client.NumpyEngine()
    half = (len(recs) // 2) // CHUNK * CHUNK
    for lo, hi, epoch in ((0, half, 0), (half, len(recs), 1)):
        if epoch:
            store.advance_epoch(_j_family(fam1))
        fam = store.family
        for i, start in enumerate(range(lo, hi, CHUNK)):
            tier = i % fam.n_tiers
            chunk = j_client.encode_chunk(recs[start: start + CHUNK])
            store.ingest_chunk(chunk, eng.eval_fused_prefix(
                chunk, fam.plan.clauses, fam.tier_sizes[tier]),
                epoch=epoch, tier=tier)
    if jit:
        store.jit_load_raw()
    return store


def _router(mode, n, objs):
    if n == 1:
        return None
    if mode == "range":
        return ShardRouter.from_samples(n, "linear_score", objs[:400])
    return ShardRouter(n_shards=n, key="linear_score", mode="hash")


@pytest.mark.parametrize("mode,n,jit", [("hash", 1, False), ("hash", 2, True),
                                        ("hash", 4, False),
                                        ("range", 4, False)])
def test_batcher_with_and_without_cache_matches_jax(ycsb, mode, n, jit):
    """Port batchers (no cache; the AND hook on kernel C's plain version;
    a ResultCache, run cold then warm) against the JAX package on twin
    stores: the uncached ones and the cold pass equal the JAX
    ShardedScanner query by query, the warm pass equals the JAX batcher
    with its own cache, hits and misses included."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = _router(mode, n, objs)
    queries = _workload(fam0, fam1, ranked)
    jq = [_jq(q) for q in queries]
    theirs = _build_jax(recs, fam0, fam1, router, n, jit=jit)
    with j_shard.ShardedScanner(theirs, log_queries=False) as sc:
        want = [_full(sc.scan(q)) for q in jq]
    jbat = JScanBatcher(_build_jax(recs, fam0, fam1, router, n, jit=jit),
                        cache=JResultCache(), log_queries=False)
    assert [_full(r) for r in jbat.scan_batch(jq)] == want
    # a warm repeat serves each query from the cache entry its clauses
    # last stored (the workload repeats some clause lists)
    warm = [_full(r) for r in jbat.scan_batch(jq)]
    hook = lambda w: residual.bv_and_many_cuda(  # noqa: E731
        w, backend="torch", device="cpu")
    for kw in ({}, {"and_reduce": hook}, {"cache": ResultCache()}):
        ours = _build(ShardedCiaoStore(fam0, router=router, n_shards=n,
                                       segment_capacity=512),
                      recs, fam0, fam1, jit=jit)
        bat = ScanBatcher(ours, log_queries=False, **kw)
        assert [_full(r) for r in bat.scan_batch(queries)] == want, kw
    assert [_full(r) for r in bat.scan_batch(queries)] == warm
    assert (bat.cache.hits, bat.cache.misses, len(bat.cache)) == \
        (jbat.cache.hits, jbat.cache.misses, len(jbat.cache))
    if mode == "range":
        assert sum(w[6] for w in want) > 0   # shards_pruned


def test_batcher_and_cache_counters_match_jax_batcher(ycsb):
    """The port's batcher and cache equal the JAX package's batcher and
    cache: results, hits, misses and cache size, cold and warm, around
    an ingest that invalidates one shard."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter(n_shards=4, key="linear_score", mode="hash")
    queries = _workload(fam0, fam1, ranked)
    ours = _build(ShardedCiaoStore(fam0, router=router,
                                   segment_capacity=512),
                  recs, fam0, fam1, jit=False)
    theirs = _build_jax(recs, fam0, fam1, router, 4, jit=False)
    a = ScanBatcher(ours, cache=ResultCache(cap=64), log_queries=False)
    b = JScanBatcher(theirs, cache=JResultCache(cap=64), log_queries=False)
    jq = [_jq(q) for q in queries]

    def same():
        assert [_full(r) for r in a.scan_batch(queries)] == \
            [_full(r) for r in b.scan_batch(jq)]
        assert (a.cache.hits, a.cache.misses, len(a.cache)) == \
            (b.cache.hits, b.cache.misses, len(b.cache))

    same()
    same()
    picked = [i for i in range(len(recs))
              if router.shard_of(objs[i], recs[i]) == 0][:48]
    extra = [recs[i] for i in picked]
    ours.ingest_chunk(*_eval(encode_chunk(extra), fam1, NumpyEngine()),
                      epoch=1, tier=1)
    theirs.ingest_chunk(*_eval(j_client.encode_chunk(extra),
                               theirs.family, j_client.NumpyEngine()),
                        epoch=1, tier=1)
    same()


def _eval(chunk, fam, eng):
    return chunk, eng.eval_fused_prefix(chunk, fam.plan.clauses, 4)


def test_device_scanner_with_result_cache_matches_jax(ycsb):
    """The port's DeviceScanner with a real ResultCache attached against
    the JAX package's DeviceScanner ("xla") with its own: the same
    results cold and warm, the same hits and misses; the cold batch also
    equals the JAX host scanner."""
    from repro.core.device_scan import DeviceScanner as JDeviceScanner

    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    queries = _workload(fam0, fam1, ranked)
    jq = [_jq(q) for q in queries]
    host = j_server.DataSkippingScanner(
        _build_jax(recs, fam0, fam1, None, 1, jit=False).shards[0],
        log_queries=False)
    want = [_accounting(host.scan(q)) for q in jq]
    jdev = JDeviceScanner(
        _build_jax(recs, fam0, fam1, None, 1, jit=False).shards[0],
        backend="xla", result_cache=JResultCache(), log_queries=False)
    ours = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1,
                  jit=False)
    cache = ResultCache()
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        result_cache=cache, log_queries=False)
    for i in range(2):
        got = [_accounting(r) for r in dev.scan_batch(queries)]
        assert got == [_accounting(r) for r in jdev.scan_batch(jq)]
        if i == 0:
            assert got == want
        assert (cache.hits, cache.misses) == \
            (jdev.result_cache.hits, jdev.result_cache.misses)
    assert cache.hits == len(queries)
