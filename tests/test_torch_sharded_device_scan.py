"""The port's sharded device scanner against the JAX package, exactly.

``ShardedDeviceScanner(backend="torch", device="cpu")`` runs one port
``DeviceScanner`` per shard (kernel B's plain PyTorch version over each
shard's resident plane, the shards in turn) and must reproduce the JAX
package's ``ShardedScanner`` and its ``ShardedDeviceScanner(backend=
"xla", spmd=False)`` in every ``ScanResult`` field: count, rows scanned
and skipped, raw rows parsed, segments pruned and scanned, shards
scanned and pruned, and every (epoch, tier) group.  The stores keep raw
remainders, so the batch promotes them in global query order and a
pruned shard accounts its rows before later promotions grow them.  All
values are integers: the tolerance is 0.

Also here: the JAX package's sharded device tests
(``tests/test_device_scan.py``, the sharded sweep and the range-router
prune), the port's device scanner on ``tests/test_batch_scan.py``'s
range-router case and ``tests/test_shard.py``'s pruned-shard accounting,
the AND hook called from the sharded scanner's thread pool, and the
build lock that hook relies on.
"""
import ctypes
import json
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import client as j_client  # noqa: E402
from repro.core import device_scan as j_device_scan  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro_torch.core.client import NumpyEngine, encode_chunk  # noqa: E402
from repro_torch.core.device_scan import ShardedDeviceScanner  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    Query, clause, clause_to_obj, key_value,
)
from repro_torch.core.server import (  # noqa: E402
    PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.shard import (  # noqa: E402
    ShardedCiaoStore, ShardedScanner, ShardRouter,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels import bitvector_ops, cuda_build  # noqa: E402
from repro_torch.kernels import residual, scan_fused  # noqa: E402

CHUNK = 256
N_RECORDS = 2048


def _accounting(r) -> tuple:
    """The JAX package's ``tests/test_device_scan.py`` accounting."""
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.shards_pruned, r.used_skipping,
            tuple(sorted(
                (k, (g.count, g.rows_scanned, g.rows_skipped, g.raw_parsed,
                     g.segments_pruned))
                for k, g in r.groups.items())))


def _full(r) -> tuple:
    """Every field, groups in their (sorted) iteration order."""
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.shards_scanned,
            r.shards_pruned, r.used_skipping,
            tuple((k, (g.count, g.rows_scanned, g.rows_skipped,
                       g.raw_parsed, g.segments_pruned))
                  for k, g in r.groups.items()))


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


def _j_family(fam):
    plan = j_server.PushdownPlan.from_obj(json.loads(json.dumps(
        fam.plan.to_obj())))
    return j_server.PlanFamily.from_obj(plan, json.loads(json.dumps(
        fam.to_obj())))


def _jq(q):
    return j_pred.Query(tuple(j_pred.clause_from_obj(clause_to_obj(c))
                              for c in q.clauses), freq=q.freq)


def _build(recs, fam0, fam1, router, n, *, jax=False, jit=True):
    """Mixed-epoch / mixed-tier ingest into either package's sharded
    store, each package evaluating with its own engine."""
    if jax:
        store = j_shard.ShardedCiaoStore(
            _j_family(fam0), n_shards=n, segment_capacity=512,
            router=None if router is None else
            j_shard.ShardRouter.from_obj(router.to_obj()))
        eng, enc, f1 = j_client.NumpyEngine(), j_client.encode_chunk, \
            _j_family(fam1)
    else:
        store = ShardedCiaoStore(fam0, router=router, n_shards=n,
                                 segment_capacity=512)
        eng, enc, f1 = NumpyEngine(), encode_chunk, fam1
    half = (len(recs) // 2) // CHUNK * CHUNK
    for lo, hi, epoch in ((0, half, 0), (half, len(recs), 1)):
        if epoch:
            store.advance_epoch(f1)
        fam = store.family
        for i, start in enumerate(range(lo, hi, CHUNK)):
            tier = i % fam.n_tiers
            chunk = enc(recs[start: start + CHUNK])
            store.ingest_chunk(chunk, eng.eval_fused_prefix(
                chunk, fam.plan.clauses, fam.tier_sizes[tier]),
                epoch=epoch, tier=tier)
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


def _router(mode, n, objs):
    if n == 1:
        return None
    if mode == "range":
        return ShardRouter.from_samples(n, "linear_score", objs[:400])
    return ShardRouter(n_shards=n, key="linear_score", mode="hash")


def _dev(store, **kw):
    return ShardedDeviceScanner(store, backend="torch", device="cpu",
                                log_queries=False, **kw)


# ---------------------------------------------------------------------------
# the JAX package's sharded device tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_sharded_device_bit_identical(ycsb, n_shards):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = _router("hash", n_shards, objs)
    s_host = _build(recs, fam0, fam1, router, n_shards)
    s_dev = _build(recs, fam0, fam1, router, n_shards)
    queries = _workload(fam0, fam1, ranked)
    got = _dev(s_dev).scan_batch(queries)
    with ShardedScanner(s_host, log_queries=False) as sc:
        for q, r in zip(queries, got):
            oracle = sum(1 for o in objs if q.matches_exact(o))
            h = sc.scan(q)
            assert r.count == oracle, q.describe()
            assert _accounting(r) == _accounting(h), q.describe()
            assert list(r.groups) == sorted(r.groups)


def test_sharded_device_range_router_prunes_shards(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter.from_samples(4, "linear_score", objs[:400])
    s_host = _build(recs, fam0, fam1, router, 4)
    s_dev = _build(recs, fam0, fam1, router, 4)
    queries = _workload(fam0, fam1, ranked)
    got = _dev(s_dev).scan_batch(queries)
    pruned = 0
    with ShardedScanner(s_host, log_queries=False) as sc:
        for q, r in zip(queries, got):
            assert _accounting(r) == _accounting(sc.scan(q)), q.describe()
            pruned += r.shards_pruned
    assert pruned > 0   # partition metadata demonstrably engaged


def test_sharded_device_batch_range_router_unpromoted(ycsb):
    """``tests/test_batch_scan.py``'s range-router case with the device
    scanner as the batch: partition-refuted shards snapshot their rows
    skipped and never promote, in global query order."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter.from_samples(4, "linear_score", objs[:400])
    a = _build(recs, fam0, fam1, router, 4, jit=False)
    b = _build(recs, fam0, fam1, router, 4, jit=False)
    queries = _workload(fam0, fam1, ranked)
    batched = _dev(a).scan_batch(queries)
    pruned = 0
    with ShardedScanner(b, log_queries=False) as sc:
        for q, r in zip(queries, batched):
            assert _full(r) == _full(sc.scan(q)), q.describe()
            pruned += r.shards_pruned
    assert pruned > 0


def test_pruned_shard_skip_accounting_on_the_device_scanner():
    """``tests/test_shard.py``'s pruned-shard accounting: every shard
    refuted, the skipped rows are the loaded + JIT segment rows, never
    the raw remainders."""
    import random
    rows = [{"score": 100 + i, "tag": "n"} for i in range(200)]
    rows += [{"score": "10", "tag": "s"}] * 8
    random.Random(5).shuffle(rows)
    recs = [json.dumps(r).encode() for r in rows]
    plan = PushdownPlan(clauses=[clause(key_value("tag", "n"))])
    eng = NumpyEngine()
    sharded = ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key="score"),
        segment_capacity=64, summary_value_cap=16)
    for lo in range(0, len(recs), 50):
        chunk = encode_chunk(recs[lo: lo + 50])
        sharded.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    (r,) = _dev(sharded).scan_batch([Query((clause(key_value("score",
                                                               9999)),))])
    assert r.count == 0
    assert r.shards_pruned == sharded.n_shards
    seg_rows = sum(seg.n_rows for s in sharded.shards
                   for seg in (*s.blocks, *s.jit_blocks))
    raw_rows = sum(rr.n for s in sharded.shards for rr in s.raw)
    assert raw_rows > 0
    assert r.rows_skipped == seg_rows
    assert r.rows_scanned == 0
    assert sum(g.rows_skipped for g in r.groups.values()) == seg_rows


# ---------------------------------------------------------------------------
# against the JAX package on twin stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,n", [("hash", 1), ("hash", 2), ("hash", 4),
                                    ("range", 2), ("range", 4)])
def test_sharded_device_scanner_matches_jax(ycsb, mode, n):
    """Un-promoted twin stores, two batches: the port's sharded device
    scanner equals the JAX ShardedScanner and the JAX
    ShardedDeviceScanner ("xla", sequential shards) in every field; zero
    uploads on the repeat once the promotions are resident."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = _router(mode, n, objs)
    queries = _workload(fam0, fam1, ranked)
    jq = [_jq(q) for q in queries]
    j_host = j_shard.ShardedScanner(
        _build(recs, fam0, fam1, router, n, jax=True, jit=False),
        log_queries=False)
    j_dev = j_device_scan.ShardedDeviceScanner(
        _build(recs, fam0, fam1, router, n, jax=True, jit=False),
        backend="xla", spmd=False, log_queries=False)
    dev = _dev(_build(recs, fam0, fam1, router, n, jit=False))
    for rep in range(3):
        got = [_full(r) for r in dev.scan_batch(queries)]
        assert got == [_full(r) for r in j_dev.scan_batch(jq)]
        assert got == [_full(j_host.scan(q)) for q in jq]
        if rep == 1:
            uploads = [c.uploads for c in dev.caches]
    assert [c.uploads for c in dev.caches] == uploads
    assert len(dev.caches) == n
    if mode == "range":
        assert sum(r[7] for r in got) > 0
    j_host.close()


def test_sharded_device_scanner_numpy_backend_and_one_query(ycsb):
    """The host-mirror backend and ``scan`` (a batch of one) agree with
    the JAX package's ShardedScanner too."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = _router("range", 4, objs)
    queries = _workload(fam0, fam1, ranked)
    with j_shard.ShardedScanner(
            _build(recs, fam0, fam1, router, 4, jax=True),
            log_queries=False) as sc:
        want = [_full(sc.scan(_jq(q))) for q in queries]
    dev = ShardedDeviceScanner(_build(recs, fam0, fam1, router, 4),
                               backend="numpy", log_queries=False)
    assert [_full(r) for r in dev.scan_batch(queries)] == want
    one = _dev(_build(recs, fam0, fam1, router, 4))
    assert [_full(one.scan(q)) for q in queries] == want


def test_sharded_device_scanner_defaults_to_the_card(ycsb, monkeypatch):
    """``backend="cuda"`` is the default, and without a card it raises
    rather than falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs, objs, ranked = ycsb
    fam0, _ = _families(ranked)
    store = ShardedCiaoStore(fam0, n_shards=2, segment_capacity=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedDeviceScanner(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedDeviceScanner(store, backend="cuda", device="cuda")


def test_hooked_sharded_scanner_from_its_thread_pool_matches_jax(ycsb):
    """The AND hook on kernel C's plain version, called from the sharded
    scanner's thread pool (threshold 0 forces the pool), equals the JAX
    package's sharded scanner."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = _router("hash", 4, objs)
    queries = _workload(fam0, fam1, ranked)
    with j_shard.ShardedScanner(
            _build(recs, fam0, fam1, router, 4, jax=True, jit=False),
            log_queries=False) as sc:
        want = [_full(sc.scan(_jq(q))) for q in queries]
    calls = []

    def hook(words):
        calls.append(threading.current_thread().name)
        return residual.bv_and_many_cuda(words, backend="torch",
                                         device="cpu")

    with ShardedScanner(_build(recs, fam0, fam1, router, 4, jit=False),
                        log_queries=False, and_reduce=hook,
                        max_workers=4, parallel_threshold_rows=0) as sc:
        assert [_full(sc.scan(q)) for q in queries] == want
    assert any(n.startswith("ciao-shard-scan") for n in calls), set(calls)


# ---------------------------------------------------------------------------
# the build lock the threaded hook relies on
# ---------------------------------------------------------------------------

def test_first_load_from_many_threads_builds_and_loads_once(monkeypatch):
    """Sixteen threads (more than the cores) make kernel C's first call
    together, switching every microsecond: one build, one load, one
    typed library shared by all."""
    builds, loads = [], []

    def fake_build(names=None):
        builds.append(list(names))
        time.sleep(0.05)        # hold the window open for the others
        return 0.0

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            time.sleep(0.05)

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_build, "build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(cuda_build, "_libs", {})
    n = 16
    barrier = threading.Barrier(n, timeout=30)
    got = [None] * n

    def first_call(i):
        barrier.wait()
        got[i] = bitvector_ops._lib()

    threads = [threading.Thread(target=first_call, args=(i,))
               for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["bitvector_reduce"]]
    assert len(loads) == 1
    assert all(g is got[0] for g in got)
    fn = got[0].ciao_bitvector_reduce
    assert fn.restype is ctypes.c_int and len(fn.argtypes) == 8


class _CardRows:
    """Stands for a contiguous ``uint32[P, W]`` tensor on the card."""
    dtype = torch.uint32
    device = torch.device("cuda", 0)

    def __init__(self, P, W):
        self.shape = torch.Size((P, W))

    def dim(self):
        return 2

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def test_launch_counter_adds_up_across_threads(monkeypatch):
    """Eight threads make 2,000 calls each of kernel C's wrapper, on rows
    that claim to be on the card, through a library that launches
    nothing: the counter reads every launch, 16,000."""
    launched = []

    class Lib:
        def ciao_bitvector_reduce(self, *args):
            launched.append(args)
            return 0

    empty = torch.empty
    monkeypatch.setattr(bitvector_ops, "_lib", Lib)
    monkeypatch.setattr(torch, "empty",
                        lambda shape, dtype, device: empty(shape, dtype=dtype))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 0}))
    monkeypatch.setattr(bitvector_ops, "launches", 0)
    n, m = 8, 2000
    barrier = threading.Barrier(n, timeout=30)

    def calls():
        barrier.wait()
        for _ in range(m):
            out = bitvector_ops.bitvector_reduce_buffer(_CardRows(2, 256))
            assert out.shape == (2 * 256 + 1,)

    threads = [threading.Thread(target=calls) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(launched) == n * m
    assert bitvector_ops.launches == n * m
