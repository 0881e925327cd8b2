"""The port's client engines, partial loading and data skipping
(``repro_torch.core.{client, server}``).

The first part runs the JAX package's ``tests/test_client_server.py`` on
the port (engines' agreement, the kernel engine's plain version beside
them, the partial-load partition, exact counts, skipping, save/load, the
zero-budget plan).  The second part holds the port against the JAX
package on the same records: engines' bits, the store's partition and
every scan's accounting.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro_torch.core.client import NumpyEngine, PythonEngine, encode_chunk  # noqa: E402
from repro_torch.core.predicates import Query, clause_to_obj  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, FullScanBaseline, PushdownPlan,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import generate_records, predicate_pool  # noqa: E402
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

DATASETS = ("yelp", "winlog", "ycsb")


@pytest.mark.parametrize("dataset", DATASETS)
def test_numpy_engine_matches_python_oracle(dataset):
    recs = generate_records(dataset, 200, seed=11)
    pool = predicate_pool(dataset)
    rng = np.random.default_rng(3)
    clauses = [pool[i] for i in rng.choice(len(pool), size=25, replace=False)]
    chunk = encode_chunk(recs)
    a = NumpyEngine().eval(chunk, clauses)
    b = PythonEngine().eval(chunk, clauses)
    assert np.array_equal(a, b)
    # the kernel engine's plain version (kernel A's, on the CPU)
    assert np.array_equal(KernelEngine("torch").eval(chunk, clauses), a)


def test_chunk_roundtrip():
    recs = generate_records("yelp", 50, seed=0)
    chunk = encode_chunk(recs)
    assert chunk.records() == recs
    assert chunk.data.shape[1] % 128 == 0


def _build_store(dataset, n=1500, budget_clauses=4, chunk_size=500, seed=2):
    recs = generate_records(dataset, n, seed=seed)
    pool = predicate_pool(dataset)
    sel = estimate_selectivities(pool, recs[:300])
    # choose mid-selectivity clauses so both loaded and unloaded rows exist
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    plan = PushdownPlan(clauses=ranked[:budget_clauses])
    store = CiaoStore(plan)
    eng = NumpyEngine()
    for i in range(0, n, chunk_size):
        chunk = encode_chunk(recs[i : i + chunk_size])
        store.ingest_chunk(chunk, eng.eval_packed(chunk, plan.clauses))
    base = FullScanBaseline()
    for i in range(0, n, chunk_size):
        base.ingest_chunk(encode_chunk(recs[i : i + chunk_size]))
    return store, base, plan, recs


@pytest.mark.parametrize("dataset", DATASETS)
def test_partial_loading_partition(dataset):
    """loaded ∪ raw == all records; loaded == records matching >=1 clause."""
    store, base, plan, recs = _build_store(dataset)
    n_loaded = sum(b.n_rows for b in store.blocks)
    n_raw = sum(r.n for r in store.raw)
    assert n_loaded + n_raw == len(recs)
    expected_loaded = sum(
        1 for r in recs if any(c.matches_raw(r) for c in plan.clauses)
    )
    assert n_loaded == expected_loaded
    assert 0 < n_loaded < len(recs), "need a non-trivial split for this test"


@pytest.mark.parametrize("dataset", DATASETS)
def test_query_counts_match_full_scan(dataset):
    """Pushed-down and non-pushed queries both return exact counts."""
    store, base, plan, recs = _build_store(dataset)
    scanner = DataSkippingScanner(store)
    # queries over pushed clauses (skipping path)
    for c in plan.clauses[:2]:
        q = Query((c,))
        r1, r2 = scanner.scan(q), base.scan(q)
        assert r1.count == r2.count
        assert r1.used_skipping
    # conjunctive query mixing two pushed clauses
    q = Query(tuple(plan.clauses[:2]))
    assert scanner.scan(q).count == base.scan(q).count
    # query with NO pushed clause (must scan raw too)
    pool = predicate_pool("ycsb" if dataset == "ycsb" else dataset)
    other = [c for c in pool if c not in set(plan.clauses)][0]
    q = Query((other,))
    r1, r2 = scanner.scan(q), base.scan(q)
    assert r1.count == r2.count
    assert not r1.used_skipping
    assert r1.raw_parsed > 0


def test_skipping_actually_skips():
    store, base, plan, recs = _build_store("ycsb")
    scanner = DataSkippingScanner(store)
    q = Query((plan.clauses[0],))
    r = scanner.scan(q)
    assert r.rows_skipped > 0


def test_store_save_load_roundtrip(tmp_path):
    store, base, plan, recs = _build_store("winlog", n=600)
    path = str(tmp_path / "store.npz")
    store.save(path)
    from repro_torch.core.server import CiaoStore

    loaded = CiaoStore.load(path, plan)
    s1 = DataSkippingScanner(store)
    s2 = DataSkippingScanner(loaded)
    q = Query((plan.clauses[0],))
    assert s1.scan(q).count == s2.scan(q).count


def test_zero_budget_plan_loads_everything():
    recs = generate_records("yelp", 300, seed=5)
    plan = PushdownPlan(clauses=[])
    store = CiaoStore(plan)
    chunk = encode_chunk(recs)
    store.ingest_chunk(chunk, np.zeros((0, 0), np.uint32))
    assert store.stats.loading_ratio == 1.0


# ---- held against the JAX package on the same inputs

def _j_build_store(dataset, n=1500, budget_clauses=4, chunk_size=500, seed=2):
    recs = j_datasets.generate_records(dataset, n, seed=seed)
    pool = j_datasets.predicate_pool(dataset)
    sel = j_workload.estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    plan = j_server.PushdownPlan(clauses=ranked[:budget_clauses])
    store = j_server.CiaoStore(plan)
    eng = j_client.NumpyEngine()
    for i in range(0, n, chunk_size):
        chunk = j_client.encode_chunk(recs[i: i + chunk_size])
        store.ingest_chunk(chunk, eng.eval_packed(chunk, plan.clauses))
    return store, plan, recs


def _to_jax(q):
    return j_pred.Query(tuple(
        j_pred.clause_from_obj(json.loads(json.dumps(clause_to_obj(c))))
        for c in q.clauses))


def _acc(r):
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.used_skipping, r.segments_pruned)


@pytest.mark.parametrize("dataset", DATASETS)
def test_engines_bits_match_jax(dataset):
    recs = generate_records(dataset, 300, seed=11)
    assert recs == j_datasets.generate_records(dataset, 300, seed=11)
    pool = predicate_pool(dataset)
    jpool = j_datasets.predicate_pool(dataset)
    idx = np.random.default_rng(3).choice(len(pool), size=25, replace=False)
    chunk, jchunk = encode_chunk(recs), j_client.encode_chunk(recs)
    assert np.array_equal(chunk.data, jchunk.data)
    want = j_client.NumpyEngine().eval_fused(jchunk, [jpool[i] for i in idx])
    for eng in (NumpyEngine(), KernelEngine("torch")):
        got = eng.eval_fused(chunk, [pool[i] for i in idx])
        assert np.array_equal(got.words, want.words)
        assert np.array_equal(got.or_words, want.or_words)
        assert np.array_equal(got.counts, want.counts)


@pytest.mark.parametrize("dataset", DATASETS)
def test_store_and_scans_match_jax(dataset):
    store, base, plan, recs = _build_store(dataset)
    jstore, jplan, jrecs = _j_build_store(dataset)
    assert recs == jrecs
    assert [clause_to_obj(c) for c in plan.clauses] == \
        [j_pred.clause_to_obj(c) for c in jplan.clauses]
    assert [b.n_rows for b in store.blocks] == \
        [b.n_rows for b in jstore.blocks]
    assert [r.n for r in store.raw] == [r.n for r in jstore.raw]
    assert store.stats.loading_ratio == jstore.stats.loading_ratio
    pool = predicate_pool(dataset)
    queries = [Query((c,)) for c in plan.clauses] + \
        [Query(tuple(plan.clauses[:2]))] + \
        [Query((c,)) for c in pool if c not in set(plan.clauses)][:3]
    a, b = DataSkippingScanner(store), j_server.DataSkippingScanner(jstore)
    for q in queries:
        r = a.scan(q)
        assert _acc(r) == _acc(b.scan(_to_jax(q))), q.describe()
        assert r.count == base.scan(q).count
