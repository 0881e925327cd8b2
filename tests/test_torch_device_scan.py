"""The port's device scan plane against the JAX package, exactly.

Twin stores are built in both packages from the same records, plans and
bitvectors.  The port's ``DeviceScanner(backend="torch", device="cpu")``
(the plain PyTorch version of the CUDA scan kernel over a resident plane)
must reproduce the JAX host ``DataSkippingScanner`` and the JAX
``DeviceScanner(backend="pallas_interpret")`` (the TPU kernel,
interpreted) in full ``ScanResult`` accounting: count, rows scanned and
skipped, raw rows parsed, segments pruned and every (epoch, tier) group.
All values are integers, so every comparison is exact.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import bitvector as j_bitvector  # noqa: E402
from repro.core import device_scan as j_device_scan  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core.client import NumpyEngine as JNumpyEngine  # noqa: E402
from repro.core.client import encode_chunk as j_encode_chunk  # noqa: E402
from repro.core.predicates import clause_from_obj as j_clause  # noqa: E402
from repro.core.predicates import query as j_query  # noqa: E402
from repro.kernels import scan_fused as j_scan_fused  # noqa: E402
from repro_torch.core.client import encode_chunk  # noqa: E402
from repro_torch.core.device_scan import DeviceScanner  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    Query, clause, clause_to_obj, exact, key_value, presence, substring,
)
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels import scan_fused  # noqa: E402
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

CHUNK = 256
N_RECORDS = 2048


def accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.used_skipping,
            tuple(sorted(
                (k, (g.count, g.rows_scanned, g.rows_skipped, g.raw_parsed,
                     g.segments_pruned))
                for k, g in r.groups.items())))


def _jc(c):
    return j_clause(clause_to_obj(c))


def _jq(q):
    return j_query(*[_jc(c) for c in q.clauses])


def _j_bits(bv):
    return j_bitvector.ChunkBitvectors(
        words=bv.words, or_words=bv.or_words, counts=bv.counts,
        n_records=bv.n_records)


def _j_family(fam):
    return j_server.PlanFamily(
        plan=j_server.PushdownPlan(clauses=[_jc(c) for c in fam.plan.clauses],
                                   epoch=fam.plan.epoch),
        tier_sizes=fam.tier_sizes)


@pytest.fixture(scope="module")
def ycsb():
    recs = generate_records("ycsb", N_RECORDS, seed=7)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    fam1 = evolve_family(fam0, ranked[:4] + ranked[8:12], (2, 4, 8))
    # every chunk's bitvectors, computed once by the port's pushdown
    eng = KernelEngine("torch")
    half = N_RECORDS // 2
    ingest = []
    for epoch, fam, lo, hi in ((0, fam0, 0, half), (1, fam1, half, N_RECORDS)):
        for i, start in enumerate(range(lo, hi, CHUNK)):
            tier = i % fam.n_tiers
            batch = recs[start:start + CHUNK]
            bv = eng.eval_fused_prefix(encode_chunk(batch), fam.plan.clauses,
                                       fam.tier_sizes[tier])
            ingest.append((epoch, tier, batch, bv))
    return recs, ranked, fam0, fam1, ingest


def _build(data, *, jax: bool, jit: bool = True):
    """Mixed-epoch / mixed-tier store, replanned halfway (either package)."""
    recs, ranked, fam0, fam1, ingest = data
    if jax:
        store = j_server.CiaoStore(_j_family(fam0), segment_capacity=512)
        enc, bits, fam1 = j_encode_chunk, _j_bits, _j_family(fam1)
    else:
        store = CiaoStore(fam0, segment_capacity=512)
        enc, bits = encode_chunk, (lambda bv: bv)
    for epoch, tier, batch, bv in ingest:
        if epoch == 1 and store.plan.epoch == 0:
            store.advance_epoch(fam1)
        store.ingest_chunk(enc(batch), bits(bv), epoch=epoch, tier=tier)
    if jit:
        store.jit_load_raw()
    return store


def _workload(data):
    recs, ranked, fam0, fam1, _ = data
    qs = [Query((c,)) for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]]
    qs += [Query((fam0.plan.clauses[0], ranked[13]))]   # pushed + residual
    qs += [Query((c,)) for c in ranked[14:17]]          # residual-only
    for v in (3, 55, 97, 250):                          # 250: no match
        qs.append(Query((clause(key_value("linear_score", v)),)))
    qs.append(Query((clause(key_value("phone_country", "ZZ")),)))
    qs.append(Query((clause(substring("email", "alpha"),
                            exact("age_group", "child")),
                     clause(presence("visits")))))
    return qs


@pytest.mark.parametrize("jit", [True, False])
def test_device_scan_matches_jax_host(ycsb, jit):
    """Batched port scan vs sequential JAX host scans; un-promoted stores
    must interleave raw promotions exactly as the sequential run does."""
    ours = _build(ycsb, jax=False, jit=jit)
    theirs = _build(ycsb, jax=True, jit=jit)
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False)
    host = j_server.DataSkippingScanner(theirs, log_queries=False)
    queries = _workload(ycsb)
    got = dev.scan_batch(queries)
    for q, r in zip(queries, got):
        assert accounting(r) == accounting(host.scan(_jq(q))), q.describe()
    assert len(dev.cache.slots) >= 2 and scan_fused.launches == 0
    if jit:     # promoted up front: the port's own host scanner agrees too
        mine = DataSkippingScanner(ours, log_queries=False)
        for q, r in zip(queries, got):
            assert accounting(r) == accounting(mine.scan(q)), q.describe()


def test_device_scan_matches_jax_pallas_interpret(ycsb):
    ours = _build(ycsb, jax=False)
    theirs = _build(ycsb, jax=True)
    queries = _workload(ycsb)[:5]       # the interpreter walks the grid
    got = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False).scan_batch(queries)
    want = j_device_scan.DeviceScanner(
        theirs, backend="pallas_interpret", log_queries=False
    ).scan_batch([_jq(q) for q in queries])
    for q, a, b in zip(queries, got, want):
        assert accounting(a) == accounting(b), q.describe()


def test_scan_cores_agree_on_one_plane(ycsb):
    """Kernel level: the port's plain version and numpy copy against the
    JAX Pallas kernel (interpreted) and numpy reference, same inputs."""
    store = _build(ycsb, jax=False)
    dev = DeviceScanner(store, backend="torch", device="cpu",
                        log_queries=False)
    prep = dev._prepare(_workload(ycsb))
    plane, params = dev.cache.plane, prep.params
    counts, cands = scan_fused.scan_core_cuda(plane, params)   # CPU: plain
    host = [a.numpy() for a in plane]
    want = scan_fused.scan_core_numpy(*host, params)
    j_params = j_scan_fused.ScanParams(*params)
    j_plane = j_scan_fused.DevicePlaneArrays(*(jnp.asarray(a) for a in host))
    for got in ((counts.numpy(), cands.numpy()), want,
                j_scan_fused.scan_core_numpy(*host, j_params),
                j_scan_fused.scan_counts(j_plane, j_params,
                                         backend="pallas_interpret")):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert np.array_equal(
        scan_fused.scan_counts(plane, params, backend="numpy")[0], want[0])
    assert counts.dtype == torch.int32 and counts.shape == want[0].shape


def test_packed_tables_hold_every_table_in_place(ycsb):
    """The kernel's single staging buffer: each table at its aligned
    offset, byte for byte; the batch's terms, clauses and queries as one
    ``scan_table`` (decoded against the dense tables in
    ``tests/test_torch_scan_match_model.py``)."""
    store = _build(ycsb, jax=False)
    dev = DeviceScanner(store, backend="torch", device="cpu",
                        log_queries=False)
    params = dev._prepare(_workload(ycsb)).params
    host, offsets = scan_fused.pack_params(params)
    want = dict(params._asdict(), table=scan_fused.scan_table(params))
    assert set(offsets) == {"code_a", "num_codes", "lut_off", "lut_flat",
                            "pushed_tbl", "active", "table"}
    for name, off in offsets.items():
        table = np.ascontiguousarray(want[name])
        assert off % 16 == 0
        got = host[off:off + table.nbytes].view(table.dtype)
        assert np.array_equal(got, table.reshape(-1)), name
    assert host.nbytes == max(offsets.values()) + -(
        -want["table"].nbytes // 16) * 16


def test_numpy_backend_matches_torch(ycsb):
    store = _build(ycsb, jax=False)
    queries = _workload(ycsb)
    a = DeviceScanner(store, backend="torch", device="cpu",
                      log_queries=False).scan_batch(queries)
    b = DeviceScanner(store, backend="numpy",
                      log_queries=False).scan_batch(queries)
    assert [accounting(r) for r in a] == [accounting(r) for r in b]


def test_empty_store_and_all_pruned_segments(ycsb):
    _, ranked, fam0, _, _ = ycsb
    empty = DeviceScanner(CiaoStore(fam0, segment_capacity=512),
                          backend="torch", device="cpu", log_queries=False)
    r = empty.scan(Query((ranked[0],)))
    assert (r.count, r.rows_scanned, r.rows_skipped) == (0, 0, 0)
    ours, theirs = _build(ycsb, jax=False), _build(ycsb, jax=True)
    q = Query((clause(key_value("linear_score", 250)),))
    got = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False).scan(q)
    want = j_server.DataSkippingScanner(theirs, log_queries=False).scan(
        _jq(q))
    assert got.count == 0 and accounting(got) == accounting(want)
    assert got.segments_pruned == len(ours.blocks) + len(ours.jit_blocks)


def test_steady_state_zero_uploads_and_ingest_resync(ycsb):
    ours, theirs = _build(ycsb, jax=False), _build(ycsb, jax=True)
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False)
    host = j_server.DataSkippingScanner(theirs, log_queries=False)
    queries = _workload(ycsb)
    dev.scan_batch(queries)
    warm = dev.cache.uploads
    assert warm > 0 and dev.cache.upload_bytes > 0
    dev.scan_batch(queries)
    dev.scan_batch(queries[:4])
    assert dev.cache.uploads == warm      # plane resident: zero transfers
    epoch, tier, batch, bv = ycsb[4][0]
    ours.ingest_chunk(encode_chunk(batch), bv, epoch=1, tier=0)
    theirs.ingest_chunk(j_encode_chunk(batch), _j_bits(bv), epoch=1, tier=0)
    for q, r in zip(queries, dev.scan_batch(queries)):
        assert accounting(r) == accounting(host.scan(_jq(q))), q.describe()
    assert dev.cache.uploads > warm


def test_cache_eviction_mid_sweep_stays_identical(ycsb):
    ours, theirs = _build(ycsb, jax=False), _build(ycsb, jax=True)
    host = j_server.DataSkippingScanner(theirs, log_queries=False)
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        byte_budget=200 << 10, log_queries=False)
    queries = _workload(ycsb)
    for q in queries:                     # one at a time: LRU churns
        assert accounting(dev.scan(q)) == accounting(host.scan(_jq(q))), \
            q.describe()
    assert dev.cache.evictions > 0 and len(dev.cache.slots) >= 1
    for q, r in zip(queries, dev.scan_batch(queries)):
        assert accounting(r) == accounting(host.scan(_jq(q))), q.describe()


def test_dictionary_strings_and_nan_zone_bounds():
    """Exotic strings and NaN numerics: dictionary codes and zone
    verdicts reproduce the JAX host scanner exactly."""
    objs = []
    words = ["par,is", "ab}c", "a b", "", "tokén", "zz"]
    for i in range(256):
        o = {"s": words[i % len(words)], "n": 10.0 * (i % 7)}
        if i % 5 == 0:
            o["n"] = float("nan")
        if i % 3 == 0:
            o["extra"] = "x%d" % (i % 4)
        objs.append(o)
    recs = [json.dumps(o).encode() for o in objs]
    cl = [clause(exact("s", "par,is")), clause(substring("s", "b"))]
    fam = PlanFamily(plan=PushdownPlan(clauses=tuple(cl)), tier_sizes=(2,))
    ours = CiaoStore(fam, segment_capacity=128)
    theirs = j_server.CiaoStore(_j_family(fam), segment_capacity=128)
    eng, jeng = KernelEngine("torch"), JNumpyEngine()
    jcl = [_jc(c) for c in cl]
    for start in range(0, len(recs), 64):
        batch = recs[start:start + 64]
        ours.ingest_chunk(encode_chunk(batch),
                          eng.eval_fused(encode_chunk(batch), cl))
        theirs.ingest_chunk(j_encode_chunk(batch),
                            jeng.eval_fused(j_encode_chunk(batch), jcl))
    ours.jit_load_raw()
    theirs.jit_load_raw()
    queries = [Query((clause(t),)) for t in (
        exact("s", "par,is"), exact("s", ""), substring("s", "b"),
        substring("s", "é"), presence("extra"), key_value("extra", "x1"),
        key_value("n", 30), key_value("n", 30.0),
        key_value("n", float("nan")), key_value("n", 7.5))]
    got = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False).scan_batch(queries)
    host = j_server.DataSkippingScanner(theirs, log_queries=False)
    for q, r in zip(queries, got):
        assert r.count == sum(1 for o in objs if q.matches_exact(o))
        assert accounting(r) == accounting(host.scan(_jq(q))), q.describe()


def test_scanner_backend_validation():
    store = CiaoStore(PushdownPlan(clauses=[clause(presence("a"))]))
    with pytest.raises(ValueError):
        DeviceScanner(store, backend="xla")
    with pytest.raises(ValueError):
        DeviceScanner(store, backend="cuda", device="cpu")
    params = scan_fused.ScanParams(*([np.zeros(1)] * 12))
    with pytest.raises(ValueError):
        scan_fused.scan_counts(
            scan_fused.DevicePlaneArrays(*([torch.zeros(1)] * 8)), params,
            backend="cuda")
