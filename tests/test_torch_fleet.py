"""The port's ingest coordination and replanning
(``repro_torch.data.pipeline``, ``repro_torch.core.replan``).

The first part runs the JAX package's tests on the port:
``tests/test_replan.py`` (plan epochs, remap stability, the closed
control loop), ``tests/test_pipeline.py`` (work stealing, recipe
batching, prefetch, tokenizer) and the tests of ``tests/test_tiers.py``
that reach the pipeline or the replanner (fleet allocation and tier
tags, re-tiering on cost drift, tiered replans, per-prefix timing, the
drift signal, engines on every tier).  The second part holds the client
fleet and the replanner against the JAX package under the same seeds:
the same tier per client, the same per-(epoch, tier) ingest, the same
epochs and chosen clauses, exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro_torch.core.client import (  # noqa: E402
    NumpyEngine, PythonEngine, encode_chunk,
)
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.planner import build_plan, build_plan_family  # noqa: E402
from repro_torch.core.predicates import Query, clause, presence  # noqa: E402
from repro_torch.core.replan import Replanner, ReplanPolicy  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, FullScanBaseline, PlanFamily,
    PushdownPlan, StaleEpochError, evolve_plan,
)
from repro_torch.core.workload import (  # noqa: E402
    DriftPhase, drifting_workloads, estimate_selectivities,
    generate_workload,
)
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.data.pipeline import (  # noqa: E402
    ClientShard, FleetTierAllocator, IngestCoordinator, Prefetcher,
    RecipeBatcher,
)
from repro_torch.data.tokenizer import PAD_ID, ByteTokenizer  # noqa: E402


# ---- tests/test_replan.py

def _ycsb_plans():
    pool = predicate_pool("ycsb")
    recs = generate_records("ycsb", 600, seed=2)
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    return ranked, recs


def test_evolve_plan_stable_global_ids_and_remap():
    a, b, c, d = (clause(presence("a")), clause(presence("b")),
                  clause(presence("c")), clause(presence("d")))
    p0 = PushdownPlan(clauses=[a, b, c])
    assert p0.epoch == 0 and p0.global_ids == p0.ids
    # drop b, keep c (moves local row), add d
    p1 = evolve_plan(p0, [c, d, a])
    assert p1.epoch == 1
    assert p1.global_ids[a] == p0.global_ids[a]   # survivor keeps gid
    assert p1.global_ids[c] == p0.global_ids[c]
    assert p1.global_ids[d] == 3                   # fresh monotonic id
    remap = p1.remap_from(p0)
    assert remap.tolist() == [p0.ids[c], -1, p0.ids[a]]
    # dropped-then-repushed clause draws a FRESH id (old bitvector rows
    # were computed under a plan that still had it, so reuse would alias)
    p2 = evolve_plan(p1, [b, d])
    assert p2.global_ids[d] == p1.global_ids[d]
    assert p2.global_ids[b] == 4
    assert p2.remap_from(p1).tolist() == [-1, p1.ids[d]]


def test_retired_global_id_never_reissued():
    """A gid freed two epochs ago must not alias a brand-new clause.

    Regression: the fresh-id counter once ran off the PREVIOUS plan's
    survivors only, so [a,b] -> [a] -> [a,c] re-issued b's gid to c and
    remap_table(0, 2) mapped c onto b's epoch-0 bitvector rows.
    """
    a, b, c = (clause(presence("a")), clause(presence("b")),
               clause(presence("c")))
    p0 = PushdownPlan(clauses=[a, b])          # gids a:0, b:1
    p1 = evolve_plan(p0, [a])                  # b's gid 1 retired
    p2 = evolve_plan(p1, [a, c])
    assert p2.global_ids[c] == 2               # NOT b's retired gid 1
    assert p2.remap_from(p0).tolist() == [0, -1]  # c is no epoch-0 survivor
    assert p2.gid_watermark == 2


def test_scan_iterator_survives_mid_stream_epoch_advance():
    """pushed_by_epoch resolves epochs created after the map was built
    (replan racing a partially-consumed batch iterator)."""
    ranked, recs = _ycsb_plans()
    plan0 = PushdownPlan(clauses=ranked[:2])
    store = CiaoStore(plan0)
    eng = NumpyEngine()
    chunk = encode_chunk(recs[:200])
    store.ingest_chunk(chunk, eng.eval_fused(chunk, plan0.clauses))
    recipe = Query((ranked[0],))
    pushed = store.pushed_by_epoch(recipe)
    # epoch 1 appears while the consumer holds the map
    plan1 = evolve_plan(plan0, [ranked[0], ranked[3]])
    store.advance_epoch(plan1)
    chunk2 = encode_chunk(recs[200:400])
    store.ingest_chunk(chunk2, eng.eval_fused(chunk2, plan1.clauses), epoch=1)
    for blk in store.blocks:
        assert pushed[blk.epoch] is not None  # lazy resolve, no KeyError
    # end-to-end: the batcher iterator built before the bump keeps working
    from repro_torch.data.pipeline import RecipeBatcher
    from repro_torch.data.tokenizer import ByteTokenizer

    store2 = CiaoStore(PushdownPlan(clauses=ranked[:2]))
    store2.ingest_chunk(chunk, eng.eval_fused(chunk, ranked[:2]))
    batcher = RecipeBatcher(store2, ByteTokenizer(vocab_size=1024),
                            seq_len=32, batch_size=2)
    it = batcher.matching_records(recipe)
    next(it)  # start the generator (snapshots the epoch map)
    store2.advance_epoch(evolve_plan(store2.plan, [ranked[0], ranked[3]]))
    store2.ingest_chunk(chunk2, eng.eval_fused(chunk2, store2.plan.clauses),
                        epoch=1)
    n = sum(1 for _ in it)  # must not raise KeyError on epoch-1 blocks
    assert n >= 0


def test_advance_epoch_rejects_non_monotonic():
    plan = PushdownPlan(clauses=[clause(presence("a"))])
    store = CiaoStore(plan)
    with pytest.raises(ValueError):
        store.advance_epoch(PushdownPlan(clauses=[clause(presence("b"))]))
    new = evolve_plan(plan, [clause(presence("b"))])
    remap = store.advance_epoch(new)
    assert store.epoch == 1 and remap.tolist() == [-1]
    assert store.remap_table(0, 1).tolist() == [-1]


def test_stale_epoch_ingest_raises_without_corruption():
    ranked, recs = _ycsb_plans()
    plan0 = PushdownPlan(clauses=ranked[:3])
    store = CiaoStore(plan0)
    eng = NumpyEngine()
    chunk = encode_chunk(recs[:200])
    store.ingest_chunk(chunk, eng.eval_fused(chunk, plan0.clauses),
                       epoch=0)
    plan1 = evolve_plan(plan0, ranked[2:5])
    store.advance_epoch(plan1)
    before = (store.stats.n_records, store.stats.n_loaded,
              len(store.blocks), store.epoch_records(1),
              store.clause_counts.copy())
    # a chunk evaluated under the superseded plan must be rejected whole
    stale_bv = eng.eval_fused(chunk, plan0.clauses)
    with pytest.raises(StaleEpochError):
        store.ingest_chunk(chunk, stale_bv, epoch=0)
    assert (store.stats.n_records, store.stats.n_loaded,
            len(store.blocks), store.epoch_records(1)) == before[:4]
    assert np.array_equal(store.clause_counts, before[4])
    # re-evaluated under the current plan it is accepted
    store.ingest_chunk(chunk, eng.eval_fused(chunk, plan1.clauses), epoch=1)
    assert store.epoch_records(1) == 200


def test_cross_epoch_scan_counts_match_baseline():
    """Bitvectors ingested under epoch k stay queryable after k+1."""
    ranked, recs = _ycsb_plans()
    plan0 = PushdownPlan(clauses=ranked[:3])
    store = CiaoStore(plan0)
    base = FullScanBaseline()
    eng = NumpyEngine()
    for lo in range(0, 300, 100):
        chunk = encode_chunk(recs[lo:lo + 100])
        store.ingest_chunk(chunk, eng.eval_fused(chunk, plan0.clauses))
        base.ingest_chunk(chunk)
    plan1 = evolve_plan(plan0, [ranked[2], ranked[4], ranked[5]])
    store.advance_epoch(plan1)
    for lo in range(300, 600, 100):
        chunk = encode_chunk(recs[lo:lo + 100])
        store.ingest_chunk(chunk, eng.eval_fused(chunk, plan1.clauses),
                           epoch=1)
        base.ingest_chunk(chunk)
    scanner = DataSkippingScanner(store)
    # pushed in both epochs / only old / only new / never pushed
    probes = [ranked[2], ranked[0], ranked[4], ranked[7]]
    for c in probes:
        q = Query((c,))
        assert scanner.scan(q).count == base.scan(q).count, c.describe()
    q = Query((ranked[2], ranked[4]))
    assert scanner.scan(q).count == base.scan(q).count
    assert store.stats.n_jit_loaded > 0  # old-only probes promoted some raw


def test_epoch1_raw_remainder_not_promoted_for_covered_queries():
    ranked, recs = _ycsb_plans()
    plan0 = PushdownPlan(clauses=ranked[:2])
    store = CiaoStore(plan0)
    eng = NumpyEngine()
    chunk = encode_chunk(recs[:300])
    store.ingest_chunk(chunk, eng.eval_fused(chunk, plan0.clauses))
    plan1 = evolve_plan(plan0, [ranked[0], ranked[3]])
    store.advance_epoch(plan1)
    chunk2 = encode_chunk(recs[300:600])
    store.ingest_chunk(chunk2, eng.eval_fused(chunk2, plan1.clauses), epoch=1)
    scanner = DataSkippingScanner(store)
    # ranked[0] is pushed in BOTH epochs: fully covered, zero JIT loads
    r = scanner.scan(Query((ranked[0],)))
    assert r.used_skipping and r.raw_parsed == 0
    assert store.stats.n_jit_loaded == 0
    # ranked[3] is pushed only in epoch 1: epoch-0 raw promoted, epoch-1 kept
    r = scanner.scan(Query((ranked[3],)))
    assert r.raw_parsed > 0
    assert all(rr.epoch == 1 for rr in store.raw)


def test_save_load_preserves_selectivities_stats_and_epochs(tmp_path):
    ranked, recs = _ycsb_plans()
    plan0 = PushdownPlan(clauses=ranked[:3])
    store = CiaoStore(plan0)
    eng = NumpyEngine()
    chunk = encode_chunk(recs[:300])
    store.ingest_chunk(chunk, eng.eval_fused(chunk, plan0.clauses))
    plan1 = evolve_plan(plan0, [ranked[2], ranked[4]])
    store.advance_epoch(plan1)
    chunk2 = encode_chunk(recs[300:500])
    store.ingest_chunk(chunk2, eng.eval_fused(chunk2, plan1.clauses), epoch=1)
    # force a JIT promotion so every block list is non-trivial
    DataSkippingScanner(store).scan(Query((ranked[7],)))

    path = str(tmp_path / "store.npz")
    store.save(path)
    loaded = CiaoStore.load(path)

    # the replanner's feedback state survives the restore
    assert loaded.epoch == 1
    # ... including the workload window (coverage drift resumes warm)
    assert loaded.query_log == store.query_log
    assert sorted(loaded.plans) == [0, 1]
    assert loaded.plans[0].clauses == plan0.clauses
    assert loaded.plan.global_ids == plan1.global_ids
    for e in (0, 1):
        assert loaded.epoch_records(e) == store.epoch_records(e)
        assert np.array_equal(loaded.observed_selectivities(e),
                              store.observed_selectivities(e))
    assert loaded.observed_selectivities().any()  # regression: was all-zero
    s0, s1 = store.stats, loaded.stats
    assert (s0.n_records, s0.n_loaded, s0.n_jit_loaded) == \
        (s1.n_records, s1.n_loaded, s1.n_jit_loaded)
    assert s1.loading_ratio == s0.loading_ratio

    # scans agree block-for-block after restore
    q = Query((ranked[4],))
    r1 = DataSkippingScanner(store, log_queries=False).scan(q)
    r2 = DataSkippingScanner(loaded, log_queries=False).scan(q)
    assert (r1.count, r1.rows_scanned) == (r2.count, r2.rows_scanned)

    # restoring under a mismatched plan is rejected loudly
    with pytest.raises(ValueError):
        CiaoStore.load(path, PushdownPlan(clauses=ranked[5:7]))


def _drift_setup(n_queries=60):
    pool = predicate_pool("ycsb")
    wl1, wl2 = drifting_workloads(
        pool,
        [DriftPhase(n_queries, "zipf", 1.5, seed=1),
         DriftPhase(n_queries, "zipf", 2.0, seed=7)],
    )
    sample = generate_records("ycsb", 300, seed=17)
    return pool, wl1, wl2, sample


def test_replanner_bumps_epoch_on_coverage_drift():
    pool, wl1, wl2, sample = _drift_setup()
    sel = estimate_selectivities(wl1.clause_pool(), sample)
    hot = sorted(wl1.clause_pool(),
                 key=lambda c: sum(1 for q in wl1.queries if c in q.clauses))
    plan0 = PushdownPlan(clauses=hot[-2:])
    store = CiaoStore(plan0)
    policy = ReplanPolicy(check_every_records=256, min_observe_records=128,
                          workload_window=24, min_window_queries=8)
    repl = Replanner(store, sample, budget_us=60.0, base_workload=wl1,
                     cost_model=CostModel().scaled(20.0), policy=policy,
                     planned_sel=sel)
    eng = NumpyEngine()
    scanner = DataSkippingScanner(store)
    shards = [ClientShard("ycsb", i, eng, plan0, chunk_records=128)
              for i in range(2)]
    q1, q2 = iter(wl1.queries), iter(wl2.queries)

    def on_chunk(done):
        src = q1 if store.epoch == 0 and done <= 4 else q2
        for _ in range(4):
            q = next(src, None)
            if q is not None:
                scanner.scan(q)

    coord = IngestCoordinator(shards, store, replanner=repl,
                              on_chunk=on_chunk)
    coord.run(chunks_per_client=6)
    assert coord.epoch_bumps >= 1
    assert store.epoch >= 1
    assert repl.history[0].reason == "coverage"
    # the broadcast reached every shard: all evaluate the current plan
    assert all(s.plan is store.plan for s in shards)
    # ingest continued under the new epoch
    assert store.epoch_records(store.epoch) > 0
    # client timing reports recalibrated the cost model
    assert repl.cost_scale != 1.0


def test_replanner_quiet_without_drift():
    pool, wl1, _, sample = _drift_setup()
    sel = estimate_selectivities(wl1.clause_pool(), sample)
    hot = sorted(wl1.clause_pool(),
                 key=lambda c: sum(1 for q in wl1.queries if c in q.clauses))
    plan0 = PushdownPlan(clauses=hot[-2:])
    store = CiaoStore(plan0)
    policy = ReplanPolicy(check_every_records=256, min_observe_records=128,
                          workload_window=24, min_window_queries=8)
    repl = Replanner(store, sample, budget_us=60.0, base_workload=wl1,
                     cost_model=CostModel().scaled(20.0), policy=policy,
                     planned_sel=sel)
    eng = NumpyEngine()
    scanner = DataSkippingScanner(store)
    shards = [ClientShard("ycsb", i, eng, plan0, chunk_records=128)
              for i in range(2)]
    qs = iter(wl1.queries * 2)  # stationary workload: same distribution

    def on_chunk(done):
        for _ in range(4):
            q = next(qs, None)
            if q is not None:
                scanner.scan(q)

    coord = IngestCoordinator(shards, store, replanner=repl,
                              on_chunk=on_chunk)
    coord.run(chunks_per_client=6)
    assert store.epoch == 0 and coord.epoch_bumps == 0


def test_observe_timing_recalibrates_and_clamps():
    ranked, recs = _ycsb_plans()
    plan0 = PushdownPlan(clauses=ranked[:2])
    store = CiaoStore(plan0)
    repl = Replanner(store, recs[:100], budget_us=5.0,
                     policy=ReplanPolicy(max_cost_scale=50.0))
    predicted = repl._predicted_plan_us()
    assert predicted > 0
    # observed exactly 3x the predicted cost -> scale 3
    repl.observe_timing(1000, predicted * 3 * 1000 / 1e6)
    assert repl.cost_scale == pytest.approx(3.0, rel=1e-6)
    # absurd reports clamp at the policy bound
    repl.observe_timing(1000, predicted * 1e6 * 1000 / 1e6)
    assert repl.cost_scale <= 50.0
    m = CostModel()
    s = m.scaled(2.0)
    assert s.clause_cost(plan0.clauses[0], 0.1) == pytest.approx(
        2.0 * m.clause_cost(plan0.clauses[0], 0.1))
    with pytest.raises(ValueError):
        m.scaled(0.0)


def test_query_log_stays_bounded():
    plan = PushdownPlan(clauses=[clause(presence("a"))])
    store = CiaoStore(plan)
    store.query_log_cap = 10
    q = Query((plan.clauses[0],))
    for _ in range(100):
        store.log_query(q)
    assert len(store.query_log) <= 20  # trimmed at 2x cap, back to cap
    assert store.query_log[-1] is q


def test_forced_step_same_selection_is_a_noop():
    pool, wl1, _, sample = _drift_setup()
    rep_sel = estimate_selectivities(wl1.clause_pool(), sample)
    from repro_torch.core.planner import build_plan
    cm = CostModel().scaled(20.0)
    rep = build_plan(wl1, sample, budget_us=60.0, cost_model=cm)
    store = CiaoStore(PushdownPlan(clauses=list(rep.plan.clauses)))
    repl = Replanner(store, sample, budget_us=60.0, base_workload=wl1,
                     cost_model=cm, planned_sel=rep_sel,
                     policy=ReplanPolicy(recalibrate_cost=False))
    # no observations at all: the re-solve reproduces the same selection
    assert repl.step(force=True) is None
    assert store.epoch == 0 and not repl.history


# ---- tests/test_pipeline.py

def _plan(dataset="ycsb", budget=1.5, seed=0):
    pool = predicate_pool(dataset)
    rng = np.random.default_rng(seed)
    wl = generate_workload(pool, n_queries=20, distribution="zipf",
                           zipf_a=1.5, rng=rng)
    return build_plan(wl, generate_records(dataset, 300, seed=seed + 1),
                      budget_us=budget)


def test_work_stealing_improves_makespan():
    rep = _plan()
    eng = NumpyEngine()

    def clients():
        return [
            ClientShard("ycsb", i, eng, rep.plan, chunk_records=64,
                        speed=(0.2 if i == 0 else 1.0))
            for i in range(4)
        ]

    c1 = IngestCoordinator(clients(), CiaoStore(rep.plan), steal=True)
    c1.run(chunks_per_client=3)
    c2 = IngestCoordinator(clients(), CiaoStore(rep.plan), steal=False)
    c2.run(chunks_per_client=3)
    assert c1.makespan < c2.makespan * 0.5
    assert c1.stolen > 0
    # same amount of data either way
    assert c1.store.stats.n_records == c2.store.stats.n_records


def test_ingest_exactly_once():
    rep = _plan()
    eng = NumpyEngine()
    store = CiaoStore(rep.plan)
    clients = [ClientShard("ycsb", i, eng, rep.plan, chunk_records=32)
               for i in range(3)]
    coord = IngestCoordinator(clients, store)
    coord.run(chunks_per_client=5)
    assert store.stats.n_records == 3 * 5 * 32


def test_recipe_batcher_shapes_and_vocab():
    rep = _plan()
    eng = NumpyEngine()
    store = CiaoStore(rep.plan)
    clients = [ClientShard("ycsb", i, eng, rep.plan, chunk_records=256)
               for i in range(4)]
    IngestCoordinator(clients, store).run(chunks_per_client=4)
    recipe = Query((rep.plan.clauses[0],))
    tok = ByteTokenizer(vocab_size=151936)
    b = RecipeBatcher(store, tok, seq_len=64, batch_size=4)
    it = iter(b.batches(recipe))
    for _ in range(3):
        tokens, mask = next(it)
        assert tokens.shape == (4, 64)
        assert tokens.dtype == np.int32
        assert tokens.max() < 151936 and tokens.min() >= 0
        assert mask.shape == (4, 64)


def test_recipe_rows_actually_match():
    rep = _plan()
    eng = NumpyEngine()
    store = CiaoStore(rep.plan)
    clients = [ClientShard("ycsb", i, eng, rep.plan, chunk_records=256)
               for i in range(2)]
    IngestCoordinator(clients, store).run(chunks_per_client=2)
    recipe = Query((rep.plan.clauses[0],))
    b = RecipeBatcher(store, ByteTokenizer(vocab_size=1024), seq_len=32, batch_size=2)
    import json

    n = 0
    for rec in b.matching_records(recipe):
        assert recipe.matches_exact(json.loads(rec))
        n += 1
    assert n > 0


def test_prefetcher_propagates_and_finishes():
    it = Prefetcher(iter(range(5)), depth=2)
    assert list(it) == [0, 1, 2, 3, 4]

    def boom():
        yield 1
        raise ValueError("boom")

    it = Prefetcher(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError):
        for _ in it:
            pass


def test_prefetcher_close_releases_blocked_worker():
    """An abandoned consumer must not leave the worker parked on a full
    queue forever: close() unblocks and joins it."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = Prefetcher(gen(), depth=2)
    assert next(it) == 0  # worker is now blocked on the full queue
    it.close()
    assert not it._t.is_alive()
    assert len(produced) < 1000  # the stream was genuinely abandoned early
    # closed iterator terminates cleanly instead of hanging
    assert list(it) == []
    it.close()  # idempotent


def test_prefetcher_close_surfaces_worker_exception():
    def boom():
        yield 1
        raise RuntimeError("worker died")

    it = Prefetcher(boom(), depth=4)
    assert next(it) == 1
    it._t.join(timeout=5)  # let the failure land before we abandon it
    with pytest.raises(RuntimeError, match="worker died"):
        it.close()
    it.close()  # exception is raised once, close stays idempotent


def test_prefetcher_close_reports_unreleasable_worker():
    """A worker stuck INSIDE the wrapped iterator can't be released —
    close() must say so instead of returning as if the thread exited."""
    import threading

    gate = threading.Event()

    def stuck():
        yield 0
        gate.wait()   # stuck in the iterator, not in the queue handoff
        yield 1

    it = Prefetcher(stuck(), depth=1)
    assert next(it) == 0
    it._JOIN_S = 0.2
    try:
        with pytest.raises(RuntimeError, match="cannot be released"):
            it.close()
    finally:
        gate.set()    # let the thread finish
    it._t.join(timeout=5)
    assert not it._t.is_alive()


def test_prefetcher_context_manager():
    with Prefetcher(iter(range(100)), depth=2) as it:
        assert next(it) == 0
    assert not it._t.is_alive()

    # a consumer-side exception propagates (not masked by close)
    with pytest.raises(ValueError, match="consumer"):
        with Prefetcher(iter(range(100)), depth=2) as it:
            raise ValueError("consumer bug")
    assert not it._t.is_alive()


def test_tokenizer_determinism_and_padding():
    tok = ByteTokenizer(vocab_size=65536)
    a = tok.encode(b'{"x": 1}')
    b2 = tok.encode(b'{"x": 1}')
    assert np.array_equal(a, b2)
    batch = tok.pad_batch([a], seq_len=32)
    assert batch.shape == (1, 32)
    assert batch[0, -1] == PAD_ID


# ---- tests/test_tiers.py (pipeline and replan)

def _ycsb_family(n_tiers=(1, 2, 4)):
    pool = predicate_pool("ycsb")
    recs = generate_records("ycsb", 600, seed=2)
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    plan = PushdownPlan(clauses=ranked[: n_tiers[-1]])
    fam = PlanFamily(plan=plan, tier_sizes=tuple(n_tiers))
    return fam, ranked, recs


def test_recipe_batcher_exact_under_mixed_tiers():
    import json

    from repro_torch.data.pipeline import RecipeBatcher
    from repro_torch.data.tokenizer import ByteTokenizer

    fam, ranked, recs = _ycsb_family()
    store = CiaoStore(fam)
    eng = NumpyEngine()
    for lo, tier in ((0, 0), (150, 2), (300, 1)):
        chunk = encode_chunk(recs[lo:lo + 150])
        k = fam.tier_sizes[tier]
        store.ingest_chunk(chunk,
                           eng.eval_fused_prefix(chunk, fam.plan.clauses, k),
                           tier=tier)
    recipe = Query((ranked[1],))
    b = RecipeBatcher(store, ByteTokenizer(vocab_size=1024),
                      seq_len=32, batch_size=2)
    want = sum(1 for r in recs[:450] if recipe.matches_exact(json.loads(r)))
    got = 0
    for rec in b.matching_records(recipe):
        assert recipe.matches_exact(json.loads(rec))
        got += 1
    assert got == want


@pytest.mark.parametrize("backend", ["torch"])
def test_engines_bit_identical_on_every_tier(backend):
    """The JAX package runs this on "xla" and "pallas_interpret"; the
    port's CPU engine is kernel A's plain version ("cuda" needs a card)."""
    from repro_torch.kernels.engine import KernelEngine

    recs = generate_records("winlog", 300, seed=4)
    pool = tuple(predicate_pool("winlog")[:5])
    chunk = encode_chunk(recs)
    kern = KernelEngine(backend)
    hosts = [PythonEngine(), NumpyEngine()]
    for k in range(len(pool) + 1):
        want = hosts[0].eval_fused_prefix(chunk, pool, k)
        for e in (*hosts[1:], kern):
            got = e.eval_fused_prefix(chunk, pool, k)
            assert got.words.shape[0] == k
            assert np.array_equal(got.words, want.words), (e, k)
            assert np.array_equal(got.or_words, want.or_words), (e, k)
            assert np.array_equal(got.counts, want.counts), (e, k)
        # the view must equal a direct subset compile bit-for-bit
        direct = kern.eval_fused(chunk, pool[:k])
        assert np.array_equal(direct.words, want.words)


def _tiered_setup(budget_frac=0.6, speeds=(4.0, 1.0, 1.0, 0.25, 0.25)):
    pool = predicate_pool("ycsb")
    rng = np.random.default_rng(1)
    wl = generate_workload(pool, n_queries=40, distribution="zipf",
                           zipf_a=1.5, rng=rng)
    sample = generate_records("ycsb", 300, seed=17)
    from repro_torch.core.cost_model import CostModel
    cm = CostModel().scaled(20.0)
    sel = estimate_selectivities(wl.clause_pool(), sample)
    costs = sorted(cm.clause_cost(c, sel[c]) for c in wl.clause_pool())
    med = costs[len(costs) // 2]
    rep = build_plan_family(wl, sample, cost_model=cm,
                            tier_budgets_us=[med, 3 * med, 8 * med])
    budget = budget_frac * rep.family.tier_costs[-1]
    eng = NumpyEngine()
    shards = [ClientShard("ycsb", i, eng, rep.family.plan, chunk_records=64,
                          speed=s) for i, s in enumerate(speeds)]
    return rep, budget, shards, wl, sample, cm


def test_allocator_assigns_fleet_and_coordinator_tags_tiers():
    rep, budget, shards, wl, sample, cm = _tiered_setup()
    store = CiaoStore(rep.family)
    alloc = FleetTierAllocator(rep.family, budget, retier_every_records=10**9)
    # steal=False: every shard must produce its own chunks so each tier's
    # ingest tagging is observable
    coord = IngestCoordinator(shards, store, allocator=alloc, steal=False)
    tiers = [s.tier for s in shards]
    # fast shard never runs a lower tier than a slow shard
    assert tiers[0] == max(tiers)
    assert tiers[3] == tiers[4] == min(tiers)
    assert alloc.allocation.feasible
    coord.run(chunks_per_client=2)
    # chunks arrived tagged with the shard's (epoch, tier)
    seen = set(store.group_records)
    assert seen == {(0, t) for t in set(tiers)}
    assert store.stats.n_records == sum(s.eval_records for s in shards)


def test_retier_on_cost_drift():
    rep, budget, shards, wl, sample, cm = _tiered_setup()
    store = CiaoStore(rep.family)
    alloc = FleetTierAllocator(rep.family, budget, retier_every_records=64)
    coord = IngestCoordinator(shards, store, allocator=alloc)
    t0 = shards[0].tier
    assert t0 == max(s.tier for s in shards)
    # the fast shard's device degrades 100x: its measured cost scale
    # spikes, and the next re-tier check must demote it
    shards[0].cost_scale = 100.0
    coord.run(chunks_per_client=2)
    assert alloc.retier_events >= 1
    assert shards[0].tier < t0


def test_tiered_replan_broadcasts_family_and_retiers():
    from repro_torch.core.replan import Replanner, ReplanPolicy
    from repro_torch.core.workload import DriftPhase, drifting_workloads

    pool = predicate_pool("ycsb")
    wl1, wl2 = drifting_workloads(
        pool, [DriftPhase(60, "zipf", 1.5, seed=1),
               DriftPhase(60, "zipf", 2.0, seed=7)])
    sample = generate_records("ycsb", 300, seed=17)
    from repro_torch.core.cost_model import CostModel
    cm = CostModel().scaled(20.0)
    rep = build_plan_family(wl1, sample, cost_model=cm,
                            tier_budgets_us=[15.0, 40.0, 90.0])
    store = CiaoStore(rep.family)
    scanner = DataSkippingScanner(store)
    policy = ReplanPolicy(check_every_records=256, min_observe_records=128,
                          workload_window=24, min_window_queries=8)
    repl = Replanner(store, sample, tier_budgets_us=[15.0, 40.0, 90.0],
                     base_workload=wl1, cost_model=cm, policy=policy,
                     planned_sel=rep.sel)
    eng = NumpyEngine()
    shards = [ClientShard("ycsb", i, eng, rep.family.plan, chunk_records=128,
                          speed=(4.0 if i == 0 else 1.0)) for i in range(3)]
    alloc = FleetTierAllocator(
        rep.family, budget_us=float(np.mean(rep.family.tier_costs)),
        retier_every_records=10**9)
    q1, q2 = iter(wl1.queries), iter(wl2.queries)

    def on_chunk(done):
        src = q1 if store.epoch == 0 and done <= 4 else q2
        for _ in range(4):
            q = next(src, None)
            if q is not None:
                scanner.scan(q)

    coord = IngestCoordinator(shards, store, replanner=repl,
                              allocator=alloc, on_chunk=on_chunk)
    coord.run(chunks_per_client=6)
    assert store.epoch >= 1 and coord.epoch_bumps >= 1
    # the family broadcast reached every shard and re-ran the allocator
    assert all(s.family is store.family for s in shards)
    assert alloc.family is store.family
    # nested invariant holds for every registered epoch
    for fam in store.families.values():
        for a, b in zip(fam.tier_sizes, fam.tier_sizes[1:]):
            assert a <= b
    # per-tier ingest kept flowing after the bump
    assert any(e == store.epoch for e, _ in store.group_records)


def test_observe_timing_predicts_over_the_evaluated_prefix():
    """A tiered client reports timings for its PREFIX, not the whole
    plan — the recalibration must compare like with like (regression:
    floor-heavy fleets collapsed cost_scale toward the clamp)."""
    from repro_torch.core.replan import Replanner, ReplanPolicy

    fam, ranked, recs = _ycsb_family(n_tiers=(1, 4))
    store = CiaoStore(fam)
    repl = Replanner(store, recs[:100], tier_budgets_us=[5.0, 50.0],
                     policy=ReplanPolicy(max_cost_scale=50.0))
    full = repl._predicted_plan_us()
    prefix = repl._predicted_plan_us(1)
    assert 0 < prefix < full
    # a report timed against the floor tier, exactly 2x its predicted
    # cost, must calibrate scale ~2 (not 2 * prefix/full)
    repl.observe_timing(1000, prefix * 2 * 1000 / 1e6, n_clauses=1)
    assert repl.cost_scale == pytest.approx(2.0, rel=1e-6)
    # an empty tier carries no cost signal and must not move the scale
    repl.observe_timing(1000, 1.0, n_clauses=0)
    assert repl.cost_scale == pytest.approx(2.0, rel=1e-6)


def test_tiered_replan_noop_on_within_tier_order_flip(monkeypatch):
    """Same per-tier clause SETS (order flipped inside a tier) must not
    bump the epoch — a bump would only reset stats and invalidate
    in-flight chunks for a semantically identical family."""
    from repro_torch.core import replan as replan_mod
    from repro_torch.core.planner import FamilyReport
    from repro_torch.core.selection import TieredSelection
    from repro_torch.core.workload import Workload

    fam, ranked, recs = _ycsb_family(n_tiers=(1, 3))
    a, b, c = fam.plan.clauses
    store = CiaoStore(fam)
    eng = NumpyEngine()
    chunk = encode_chunk(recs[:600])
    store.ingest_chunk(chunk, eng.eval_fused(chunk, fam.plan.clauses))

    def fake_family(order, sizes):
        plan = PushdownPlan(clauses=list(order))
        famx = PlanFamily(plan=plan, tier_sizes=sizes)
        tiered = TieredSelection(
            budgets=(5.0, 50.0)[: len(sizes)], order=tuple(order),
            cum_costs=tuple(float(i + 1) for i in range(len(order))),
            tier_sizes=sizes, objectives=tuple(0.0 for _ in sizes))
        return FamilyReport(family=famx, tiered=tiered,
                            sel={cl: 0.1 for cl in order},
                            cost={cl: 1.0 for cl in order})

    base = Workload("base", [Query((x,)) for x in (a, b, c)])
    repl = replan_mod.Replanner(
        store, recs[:100], tier_budgets_us=[5.0, 50.0], base_workload=base)
    # within-tier flip: [a | b, c] -> [a | c, b]: every cut set matches
    monkeypatch.setattr(replan_mod, "build_plan_family",
                        lambda *args, **kw: fake_family((a, c, b), (1, 3)))
    assert repl.step(force=True) is None
    assert store.epoch == 0 and not repl.history
    # a moved cut point IS a semantic change: the epoch must advance
    monkeypatch.setattr(replan_mod, "build_plan_family",
                        lambda *args, **kw: fake_family((a, c, b), (2, 3)))
    out = repl.step(force=True)
    assert out is not None and store.epoch == 1


def test_drift_signal_ignores_tier_uncovered_clauses():
    """A clause no produced tier covered has observed selectivity 0 by
    construction — it must not fire a 'selectivity' replan nor clobber
    its cached sample estimate (regression: coverage-blind drift)."""
    from repro_torch.core.replan import Replanner, ReplanPolicy

    fam, ranked, recs = _ycsb_family(n_tiers=(1, 2))
    store = CiaoStore(fam)
    eng = NumpyEngine()
    # every chunk at tier 0: clause 1 never gets coverage
    for lo in range(0, 600, 200):
        chunk = encode_chunk(recs[lo:lo + 200])
        store.ingest_chunk(
            chunk, eng.eval_fused_prefix(chunk, fam.plan.clauses, 1), tier=0)
    obs0 = float(store.observed_selectivities()[0])
    assert store.clause_records()[1] == 0
    planned = {fam.plan.clauses[0]: max(obs0, 1e-4),
               fam.plan.clauses[1]: 0.3}
    from repro_torch.core.workload import Workload
    base = Workload("base", [Query((c,)) for c in fam.plan.clauses])
    repl = Replanner(store, recs[:200], tier_budgets_us=[5.0, 50.0],
                     base_workload=base,
                     policy=ReplanPolicy(min_observe_records=128),
                     planned_sel=planned)
    sig = repl.drift_signal()
    # clause 1's fake obs of 0 vs planned 0.3 would be drift 1.0 — it
    # must be excluded; clause 0 matches its planned value exactly
    assert sig.sel_drift < 0.5
    assert sig.triggers(repl.policy) != "selectivity"
    # the re-solve path must not overwrite clause 1's estimate either
    repl._replan("forced", sig)
    assert repl._sel_cache[fam.plan.clauses[1]] == pytest.approx(0.3)


# ---------------------------------------------------------------------------
# the port against the JAX package, under the same seeds
# ---------------------------------------------------------------------------

import json  # noqa: E402

from repro.core import client as j_client  # noqa: E402
from repro.core import cost_model as j_cost_model  # noqa: E402
from repro.core import planner as j_planner  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import replan as j_replan  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro_torch.core.predicates import clause_to_obj  # noqa: E402
from repro_torch.core.shard import (  # noqa: E402
    ShardedCiaoStore, ShardedScanner, ShardRouter, choose_routing_key,
)
from repro_torch.data.datasets import record_stream  # noqa: E402
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

#: the JAX package's fleet benchmark (benchmarks/bench_tiers.py): one
#: fast client, four nominal, eight slow
FLEET_SPEEDS = (4.0,) + (1.0,) * 4 + (0.25,) * 8


def _objs(clauses, jax: bool):
    to = j_pred.clause_to_obj if jax else clause_to_obj
    return [json.loads(json.dumps(to(c))) for c in clauses]


def _full(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.shards_scanned,
            r.shards_pruned, r.used_skipping,
            tuple((k, (g.count, g.rows_scanned, g.rows_skipped,
                       g.raw_parsed, g.segments_pruned))
                  for k, g in r.groups.items()))


def _fleet_family(jax: bool):
    """``_tiered_setup``'s family, built by either package."""
    pool_of = j_datasets.predicate_pool if jax else predicate_pool
    gen = j_workload.generate_workload if jax else generate_workload
    recs_of = j_datasets.generate_records if jax else generate_records
    est = j_workload.estimate_selectivities if jax else \
        estimate_selectivities
    cm = (j_cost_model.CostModel if jax else CostModel)().scaled(20.0)
    fam_of = j_planner.build_plan_family if jax else build_plan_family
    wl = gen(pool_of("ycsb"), n_queries=40, distribution="zipf",
             zipf_a=1.5, rng=np.random.default_rng(1))
    sample = recs_of("ycsb", 300, seed=17)
    sel = est(wl.clause_pool(), sample)
    costs = sorted(cm.clause_cost(c, sel[c]) for c in wl.clause_pool())
    med = costs[len(costs) // 2]
    rep = fam_of(wl, sample, cost_model=cm,
                 tier_budgets_us=[med, 3 * med, 8 * med])
    return rep.family, wl


def _run_fleet(jax: bool):
    """13 clients at the fleet benchmark's speeds, one budget split by
    the allocator, the coordinator feeding a 4-shard store."""
    fam, wl = _fleet_family(jax)
    pipe = j_pipeline if jax else None
    Client = pipe.ClientShard if jax else ClientShard
    Alloc = pipe.FleetTierAllocator if jax else FleetTierAllocator
    Coord = pipe.IngestCoordinator if jax else IngestCoordinator
    Store = j_shard.ShardedCiaoStore if jax else ShardedCiaoStore
    Router = j_shard.ShardRouter if jax else ShardRouter
    key = (j_shard.choose_routing_key if jax else choose_routing_key)(fam)
    clients = [Client("ycsb", i,
                      j_client.NumpyEngine() if jax else
                      KernelEngine("torch"),
                      fam.plan, chunk_records=64, speed=s)
               for i, s in enumerate(FLEET_SPEEDS)]
    store = Store(fam, router=Router(n_shards=4, key=key, mode="hash"),
                  segment_capacity=256)
    alloc = Alloc(fam, budget_us=0.6 * fam.tier_costs[-1],
                  retier_every_records=10 ** 9)
    coord = Coord(clients, store, allocator=alloc)
    coord.run(chunks_per_client=2)
    return fam, wl, clients, alloc, coord, store


def test_client_fleet_matches_jax():
    """Same family, same tier per client, same work stealing and the same
    per-(epoch, tier) ingest into the same shards; every scan equals the
    JAX package's and the full scan of the records the clients made."""
    ours, theirs = _run_fleet(jax=False), _run_fleet(jax=True)
    (fam, wl, clients, alloc, coord, store) = ours
    (jfam, jwl, jclients, jalloc, jcoord, jstore) = theirs
    assert _objs(fam.plan.clauses, False) == _objs(jfam.plan.clauses, True)
    assert (fam.tier_sizes, fam.tier_costs, fam.tier_values) == \
        (jfam.tier_sizes, jfam.tier_costs, jfam.tier_values)
    tiers = [c.tier for c in clients]
    assert tiers == [c.tier for c in jclients]
    assert tiers == list(alloc.allocation.tiers)
    assert len(set(tiers)) > 1          # different budgets, different tiers
    a, b = alloc.allocation, jalloc.allocation
    assert (a.tiers, a.spent, a.budget, a.expected_savings, a.upgrades) == \
        (b.tiers, b.spent, b.budget, b.expected_savings, b.upgrades)
    assert a.feasible
    assert (coord.stolen, coord.makespan) == (jcoord.stolen, jcoord.makespan)
    assert [c.eval_records for c in clients] == \
        [c.eval_records for c in jclients]
    assert store.group_records == jstore.group_records
    assert {(0, t) for t in tiers} >= set(store.group_records)
    assert [s.stats.n_records for s in store.shards] == \
        [s.stats.n_records for s in jstore.shards]
    base = FullScanBaseline()
    for c in clients:
        stream = record_stream("ycsb", seed=1000 + c.shard_id)
        recs = [next(stream) for _ in range(c.eval_records)]
        base.ingest_chunk(encode_chunk(recs))
    jq = [j_pred.Query(tuple(j_pred.clause_from_obj(o) for o in
                             _objs(q.clauses, False)), freq=q.freq)
          for q in wl.queries]
    with ShardedScanner(store, log_queries=False) as a, \
            j_shard.ShardedScanner(jstore, log_queries=False) as b:
        for q, q2 in zip(wl.queries, jq):
            r = a.scan(q)
            assert r.count == base.scan(q).count, q.describe()
            assert _full(r) == _full(b.scan(q2)), q.describe()


def _sharded_replan(jax: bool, tiered: bool):
    """``tests/test_shard.py``'s replanner over a 4-shard store (untiered)
    or the tiered replan loop of ``tests/test_tiers.py``, with timing out
    of every decision (no cost recalibration, frozen cost scales)."""
    pool = (j_datasets.predicate_pool if jax else predicate_pool)("ycsb")
    wl1, wl2 = (j_workload.drifting_workloads if jax else
                drifting_workloads)(
        pool, [(j_workload.DriftPhase if jax else DriftPhase)(
                   60, "zipf", 1.5, seed=1),
               (j_workload.DriftPhase if jax else DriftPhase)(
                   60, "zipf", 2.0, seed=7)])
    sample = (j_datasets.generate_records if jax else
              generate_records)("ycsb", 300, seed=17)
    cm = (j_cost_model.CostModel if jax else CostModel)().scaled(20.0)
    R = j_replan if jax else None
    Policy = R.ReplanPolicy if jax else ReplanPolicy
    policy = Policy(check_every_records=256, min_observe_records=128,
                    workload_window=24, min_window_queries=8,
                    recalibrate_cost=False)
    Store = j_shard.ShardedCiaoStore if jax else ShardedCiaoStore
    Router = j_shard.ShardRouter if jax else ShardRouter
    budgets = [15.0, 40.0, 90.0]
    if tiered:
        rep = (j_planner.build_plan_family if jax else build_plan_family)(
            wl1, sample, cost_model=cm, tier_budgets_us=budgets)
        plan0, sel = rep.family, rep.sel
    else:
        est = j_workload.estimate_selectivities if jax else \
            estimate_selectivities
        sel = est(wl1.clause_pool(), sample)
        hot = sorted(wl1.clause_pool(), key=lambda c: sum(
            1 for q in wl1.queries if c in q.clauses))
        plan0 = (j_server.PushdownPlan if jax else PushdownPlan)(
            clauses=hot[-2:])
    store = Store(plan0, router=Router(n_shards=4, key="linear_score"),
                  segment_capacity=512)
    kw = {"tier_budgets_us": budgets} if tiered else {"budget_us": 60.0}
    repl = (R.Replanner if jax else Replanner)(
        store, sample, base_workload=wl1, cost_model=cm, policy=policy,
        planned_sel=sel, **kw)
    pipe = j_pipeline if jax else None
    eng = j_client.NumpyEngine() if jax else KernelEngine("torch")
    fam0 = plan0 if tiered else None
    clients = [(pipe.ClientShard if jax else ClientShard)(
        "ycsb", i, eng, plan0.plan if tiered else plan0, chunk_records=128,
        speed=(4.0 if i == 0 else 1.0), family=fam0, cost_ewma_alpha=0.0)
        for i in range(3)]
    alloc = (pipe.FleetTierAllocator if jax else FleetTierAllocator)(
        plan0, budget_us=float(np.mean(plan0.tier_costs)),
        retier_every_records=10 ** 9) if tiered else None
    scanner = (j_shard.ShardedScanner if jax else ShardedScanner)(store)
    q1, q2 = iter(wl1.queries), iter(wl2.queries)

    def on_chunk(done):
        src = q1 if store.epoch == 0 and done <= 4 else q2
        for _ in range(4):
            q = next(src, None)
            if q is not None:
                scanner.scan(q)

    coord = (pipe.IngestCoordinator if jax else IngestCoordinator)(
        clients, store, replanner=repl, allocator=alloc, on_chunk=on_chunk)
    coord.run(chunks_per_client=6)
    scanner.close()
    return store, repl, clients, coord


@pytest.mark.parametrize("tiered", [False, True])
def test_replanner_over_sharded_store_matches_jax(tiered):
    """The closed loop over a 4-shard store picks the same epochs, the
    same clauses and tiers, for the same reasons, as the JAX package."""
    store, repl, clients, coord = _sharded_replan(False, tiered)
    jstore, jrepl, jclients, jcoord = _sharded_replan(True, tiered)
    assert store.epoch >= 1 and coord.epoch_bumps >= 1
    assert (store.epoch, coord.epoch_bumps) == \
        (jstore.epoch, jcoord.epoch_bumps)
    assert [(h.epoch, h.reason, h.remap.tolist()) for h in repl.history] == \
        [(h.epoch, h.reason, h.remap.tolist()) for h in jrepl.history]
    for e in store.plans:
        assert _objs(store.plans[e].clauses, False) == \
            _objs(jstore.plans[e].clauses, True)
        assert store.families[e].tier_sizes == jstore.families[e].tier_sizes
    assert all(s.plan.epoch == store.epoch for s in store.shards)
    assert [(c.plan.epoch, c.tier) for c in clients] == \
        [(c.plan.epoch, c.tier) for c in jclients]
    assert store.group_records == jstore.group_records
    for e in store.plans:
        assert np.array_equal(store.observed_selectivities(e),
                              jstore.observed_selectivities(e))
    sig, jsig = repl.drift_signal(), jrepl.drift_signal()
    assert (sig.coverage, sig.sel_drift, sig.n_observed, sig.n_window) == \
        (jsig.coverage, jsig.sel_drift, jsig.n_observed, jsig.n_window)
