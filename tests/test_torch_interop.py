"""State carried between the two packages: plans and store checkpoints.

This system has no weights; its state is the pushdown plan and the store.
Plans travel as JSON-able objects (``clause_to_obj`` / ``to_obj``) and
stores as numpy + JSON checkpoints (``CiaoStore.save``, no pickle).  A
checkpoint written by either package must load in the other and answer
every query with the same counts and accounting.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import bitvector as j_bitvector  # noqa: E402
from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro_torch.core.client import encode_chunk  # noqa: E402
from repro_torch.core.device_scan import DeviceScanner  # noqa: E402
from repro_torch.core.planner import build_plan  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    clause_from_obj, clause_to_obj,
)
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.workload import generate_workload  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

N_RECORDS, CHUNK = 1536, 256


def accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned,
            tuple(sorted((k, (g.count, g.rows_scanned, g.rows_skipped,
                              g.raw_parsed))
                         for k, g in r.groups.items())))


@pytest.fixture(scope="module")
def setup():
    recs = generate_records("ycsb", N_RECORDS, seed=21)
    wl = generate_workload(predicate_pool("ycsb"), n_queries=40,
                           distribution="zipf", zipf_a=1.5,
                           rng=np.random.default_rng(3))
    plan = build_plan(wl, recs[:300], budget_us=4.0).plan
    eng = KernelEngine("torch")
    fam0 = PlanFamily(plan=plan, tier_sizes=(1, plan.n))
    fam1 = evolve_family(fam0, list(plan.clauses[:1]) + [
        c for c in wl.clause_pool() if c not in plan.clauses][:3], (2, 4))
    ingest = []
    for i, start in enumerate(range(0, N_RECORDS, CHUNK)):
        fam = fam0 if start < N_RECORDS // 2 else fam1
        tier = i % 2
        batch = recs[start:start + CHUNK]
        bv = eng.eval_fused_prefix(encode_chunk(batch), fam.plan.clauses,
                                   fam.tier_sizes[tier])
        ingest.append((fam is fam1, tier, batch, bv))
    return fam0, fam1, ingest, list(wl.queries)


def _j_family(fam):
    plan = j_server.PushdownPlan.from_obj(
        json.loads(json.dumps(fam.plan.to_obj())))
    return j_server.PlanFamily.from_obj(
        plan, json.loads(json.dumps(fam.to_obj())))


def _store(setup, *, jax: bool):
    fam0, fam1, ingest, _ = setup
    if jax:
        store = j_server.CiaoStore(_j_family(fam0), segment_capacity=512)
        f1, enc = _j_family(fam1), j_client.encode_chunk
        bits = lambda bv: j_bitvector.ChunkBitvectors(  # noqa: E731
            words=bv.words, or_words=bv.or_words, counts=bv.counts,
            n_records=bv.n_records)
    else:
        store = CiaoStore(fam0, segment_capacity=512)
        f1, enc, bits = fam1, encode_chunk, (lambda bv: bv)
    for second, tier, batch, bv in ingest:
        if second and store.plan.epoch == 0:
            store.advance_epoch(f1)
        epoch = 1 if second else 0
        store.ingest_chunk(enc(batch), bits(bv), epoch=epoch, tier=tier)
    return store


def _jq(q):
    return j_pred.query(*[j_pred.clause_from_obj(clause_to_obj(c))
                          for c in q.clauses])


def test_plan_objects_round_trip_between_packages(setup):
    fam0, fam1, _, queries = setup
    for fam in (fam0, fam1):
        obj = json.loads(json.dumps(fam.plan.to_obj()))
        theirs = j_server.PushdownPlan.from_obj(obj)
        assert theirs.to_obj() == obj
        assert PushdownPlan.from_obj(theirs.to_obj()).clauses == \
            fam.plan.clauses
    for q in queries:
        for c in q.clauses:
            back = clause_from_obj(j_pred.clause_to_obj(
                j_pred.clause_from_obj(clause_to_obj(c))))
            assert back == c and hash(back) == hash(c)


def test_jax_checkpoint_loads_in_port(setup, tmp_path):
    theirs = _store(setup, jax=True)
    path = str(tmp_path / "jax_store.npz")
    theirs.save(path)
    ours = CiaoStore.load(path)
    assert ours.stats.n_records == theirs.stats.n_records
    assert ours.stats.n_loaded == theirs.stats.n_loaded
    assert np.array_equal(ours.clause_counts, theirs.clause_counts)
    queries = setup[3]
    host = j_server.DataSkippingScanner(theirs, log_queries=False)
    want = [accounting(host.scan(_jq(q))) for q in queries]
    mine = DataSkippingScanner(ours, log_queries=False)
    assert [accounting(mine.scan(q)) for q in queries] == want
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False)
    assert [accounting(r) for r in dev.scan_batch(queries)] == want


def test_port_checkpoint_loads_in_jax(setup, tmp_path):
    ours = _store(setup, jax=False)
    path = str(tmp_path / "port_store.npz")
    ours.save(path)
    theirs = j_server.CiaoStore.load(path)
    assert theirs.stats.n_records == ours.stats.n_records
    assert theirs.stats.n_loaded == ours.stats.n_loaded
    assert theirs.epoch == ours.epoch == 1
    queries = setup[3]
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False)
    got = [accounting(r) for r in dev.scan_batch(queries)]
    host = j_server.DataSkippingScanner(theirs, log_queries=False)
    assert [accounting(host.scan(_jq(q))) for q in queries] == got


def test_checkpoint_round_trip_through_both(setup, tmp_path):
    """port -> JAX -> port: the restored store still equals the original."""
    ours = _store(setup, jax=False)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ours.save(a)
    j_server.CiaoStore.load(a).save(b)
    back = CiaoStore.load(b)
    queries = setup[3]
    s1 = DataSkippingScanner(ours, log_queries=False)
    s2 = DataSkippingScanner(back, log_queries=False)
    for q in queries:
        assert accounting(s1.scan(q)) == accounting(s2.scan(q)), q.describe()
    assert sorted(back.plans) == sorted(ours.plans)
