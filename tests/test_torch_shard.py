"""The port's sharded store plane (``repro_torch.core.shard``).

The first part is ``tests/test_shard.py`` of the JAX package, run on the
port: the three-level skipping cascade, the scatter-gather merge, router
determinism, format-6 checkpoints with format-5 and 2/3/4 migrations,
offline resharding, and the control plane (replanner, ingest
coordinator, recipe batcher) over a sharded store.  The second part
holds the port against the JAX package on the same numpy-seeded records:
router assignments, partition summaries, epochs, per-group accounting
and every ``ScanResult`` field, at hash and range routing over 1, 2 and
4 shards, through resharding, online migration and snapshots.  All
values compared are integers or clause lists, so the tolerance is 0.
"""
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.predicates import Query, clause, key_value
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, ScanResult,
    StaleEpochError, evolve_family,
)
from repro_torch.core.shard import (
    ShardedCiaoStore, ShardedScanner, ShardRouter, ShardSummary,
    choose_routing_key, merge_scan_results, reshard,
)
from repro_torch.core.workload import Workload, estimate_selectivities
from repro_torch.data.datasets import generate_records, predicate_pool

CHUNK = 256
N_RECORDS = 2048


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


def _build(store, recs, fam0, fam1, *, jit=False):
    """Mixed-epoch / mixed-tier ingest: replan at the halfway point."""
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


def _workload(fam0, fam1, ranked, objs):
    qs = [Query((c,)) for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]]
    qs += [Query((fam0.plan.clauses[0], ranked[13]))]   # pushed + residual
    qs += [Query((c,)) for c in ranked[14:17]]          # residual-only
    # routing-key point lookups (partition-prunable under range routing)
    for v in (3, 55, 97):
        qs.append(Query((clause(key_value("linear_score", v)),)))
    qs.append(Query((clause(key_value("linear_score", 250)),)))   # no match
    qs.append(Query((clause(key_value("phone_country", "ZZ")),)))
    return qs


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def test_router_deterministic_and_balanced(ycsb):
    recs, objs, _ = ycsb
    r = ShardRouter(n_shards=8, key="customer_id", mode="hash")
    sid = r.route(objs, recs)
    assert np.array_equal(sid, r.route(objs, recs))   # deterministic
    counts = np.bincount(sid, minlength=8)
    assert counts.min() > 0.5 * len(recs) / 8         # roughly balanced
    # raw-bytes fallback (no key) is deterministic too
    r2 = ShardRouter(n_shards=4)
    assert np.array_equal(r2.route(objs, recs), r2.route(objs, recs))


def test_router_range_quantiles_balance_skew(ycsb):
    recs, objs, _ = ycsb
    # skew the routing key hard: quantile boundaries must still balance rows
    rng = np.random.default_rng(0)
    skew = [dict(o, linear_score=int(99 * rng.random() ** 3)) for o in objs]
    r = ShardRouter.from_samples(8, "linear_score", skew[:500])
    sid = r.route(skew, recs)
    counts = np.bincount(sid, minlength=8)
    # heavy duplicate mass can only concentrate on ONE shard (an equal
    # value never splits); the rest stay within a constant of the mean
    assert (counts > 0).sum() >= 6
    assert counts.max() < 0.35 * len(recs)
    # range routing sends equal values to one shard
    v_to_sid = {}
    for o, s in zip(skew, sid):
        v_to_sid.setdefault(o["linear_score"], set()).add(int(s))
    assert all(len(s) == 1 for s in v_to_sid.values())


def test_router_serialization_roundtrip(ycsb):
    recs, objs, _ = ycsb
    for r in (ShardRouter(n_shards=4),
              ShardRouter(n_shards=8, key="phone_country", mode="hash"),
              ShardRouter.from_samples(4, "linear_score", objs[:200])):
        r2 = ShardRouter.from_obj(r.to_obj())
        assert np.array_equal(r.route(objs[:64], recs[:64]),
                              r2.route(objs[:64], recs[:64]))


def test_router_validation():
    with pytest.raises(ValueError):
        ShardRouter(n_shards=0)
    with pytest.raises(ValueError):
        ShardRouter(n_shards=2, mode="modulo")
    with pytest.raises(ValueError):
        ShardRouter(n_shards=2, mode="range")          # needs a key
    with pytest.raises(ValueError):
        ShardRouter(n_shards=3, key="x", mode="range", boundaries=(2.0,))
    with pytest.raises(ValueError):
        ShardRouter(n_shards=3, key="x", mode="range", boundaries=(2.0, 1.0))


def test_choose_routing_key(ycsb):
    _, _, ranked = ycsb
    fam0, _ = _families(ranked)
    key = choose_routing_key(fam0)
    assert key in {t.key for c in fam0.plan.clauses for t in c.terms}
    # workload weighting can move the choice: weight one clause heavily
    heavy = fam0.plan.clauses[-1]
    wl = Workload(name="w", queries=[Query((heavy,), freq=100.0)])
    assert choose_routing_key(fam0, wl) == heavy.terms[0].key
    assert choose_routing_key(PushdownPlan(clauses=[])) is None


# ---------------------------------------------------------------------------
# the differential sweep (acceptance)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["hash", "range"])
def test_sharded_counts_bit_identical_to_unsharded(ycsb, mode):
    """Mixed-epoch / mixed-tier workload: counts at 1, 4 and 8 shards are
    bit-identical to the unsharded oracle AND to matches_exact."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    plain = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    stores = []
    for n in (1, 4, 8):
        if mode == "range" and n > 1:
            router = ShardRouter.from_samples(n, "linear_score", objs[:400])
        elif n > 1:
            router = ShardRouter(n_shards=n, key="linear_score", mode="hash")
        else:
            router = None
        stores.append(_build(
            ShardedCiaoStore(fam0, router=router, n_shards=n,
                             segment_capacity=512),
            recs, fam0, fam1))
    oracle_scanner = DataSkippingScanner(plain, log_queries=False)
    scanners = [ShardedScanner(s, log_queries=False) for s in stores]
    any_pruned = 0
    try:
        for q in _workload(fam0, fam1, ranked, objs):
            oracle = sum(1 for o in objs if q.matches_exact(o))
            a = oracle_scanner.scan(q)
            assert a.count == oracle
            for sc in scanners:
                r = sc.scan(q)
                assert r.count == oracle, (q.describe(), r.count, oracle)
                assert r.used_skipping == a.used_skipping, q.describe()
                assert list(r.groups) == sorted(r.groups)
                any_pruned += r.shards_pruned
    finally:
        for sc in scanners:
            sc.close()
    if mode == "range":
        assert any_pruned > 0   # partition metadata demonstrably pruned
    # aggregated feedback state is exact across shard counts
    for s in stores:
        assert s.stats.n_records == plain.stats.n_records
        assert s.stats.n_loaded == plain.stats.n_loaded
        for e in (0, 1):
            assert s.epoch_records(e) == plain.epoch_records(e)
            assert np.array_equal(s.clause_records(e),
                                  plain.clause_records(e))
            assert np.array_equal(s.observed_selectivities(e),
                                  plain.observed_selectivities(e))


def test_partition_prune_skips_shards_soundly(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter.from_samples(8, "linear_score", objs[:400])
    store = _build(ShardedCiaoStore(fam0, router=router, segment_capacity=512),
                   recs, fam0, fam1, jit=True)
    with ShardedScanner(store, log_queries=False) as sc:
        q = Query((clause(key_value("linear_score", 55)),))
        r = sc.scan(q)
        assert r.count == sum(1 for o in objs if q.matches_exact(o))
        assert r.shards_pruned >= 6          # only the owning shard scans
        assert r.shards_scanned <= 2
        # a pruned shard's rows land in the merged result as skipped
        assert r.rows_scanned + r.rows_skipped >= store.stats.n_records
        # no-match probe: every shard refuted, zero work dispatched
        r = sc.scan(Query((clause(key_value("linear_score", -5)),)))
        assert (r.count, r.shards_scanned) == (0, 0)
        assert r.shards_pruned == 8


def test_sharded_raw_coverage_and_jit_promotion(ycsb):
    """Residual-only queries JIT-promote raw remainders per shard, exactly
    once, and the promoted rows keep their coverage metadata."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(
        ShardedCiaoStore(fam0,
                         router=ShardRouter(n_shards=4, key="linear_score"),
                         segment_capacity=512),
        recs, fam0, fam1)
    assert len(store.raw) > 0
    with ShardedScanner(store, log_queries=False) as sc:
        q = Query((ranked[14],))             # residual: no coverage anywhere
        r1 = sc.scan(q)
        assert r1.raw_parsed > 0             # promotion happened
        assert r1.count == sum(1 for o in objs if q.matches_exact(o))
        r2 = sc.scan(q)
        assert r2.raw_parsed == 0            # ...exactly once
        assert r2.count == r1.count
    # promoted segments keep (epoch, n_covered, tier)
    assert {(s.epoch, s.tier) for s in store.jit_blocks} <= \
        {(e, t) for (e, t) in store.group_records}


def test_sharded_ingest_validation_touches_no_state(ycsb):
    recs, _, ranked = ycsb
    fam0, _ = _families(ranked)
    store = ShardedCiaoStore(fam0,
                             router=ShardRouter(n_shards=4,
                                                key="linear_score"))
    eng = NumpyEngine()
    chunk = encode_chunk(recs[:CHUNK])
    bv = eng.eval_fused(chunk, fam0.plan.clauses)
    with pytest.raises(StaleEpochError):
        store.ingest_chunk(chunk, bv, epoch=3)
    with pytest.raises(ValueError):
        store.ingest_chunk(chunk, bv, tier=7)
    with pytest.raises(ValueError):          # coverage claim vs bitvectors
        store.ingest_chunk(chunk, bv, tier=0)
    assert store.stats.n_records == 0
    assert all(s.stats.n_records == 0 for s in store.shards)


# ---------------------------------------------------------------------------
# deterministic scatter-gather merge
# ---------------------------------------------------------------------------

def _tier_result(groups, count):
    r = ScanResult(count=count, rows_scanned=count, rows_skipped=0,
                   raw_parsed=0, time_s=0.001, used_skipping=True)
    for k in groups:
        g = r.group(*k)
        g.count += count
        g.rows_scanned += count
    return r


def test_merge_is_order_independent_and_sorted():
    parts = [
        _tier_result([(1, 2), (0, 0)], 3),
        _tier_result([(0, 1)], 5),
        _tier_result([(1, 0), (0, 0)], 7),
        _tier_result([(2, 1)], 1),
    ]
    merged = merge_scan_results(parts)
    assert list(merged.groups) == sorted(merged.groups)
    assert merged.count == 16
    for _ in range(5):
        shuffled = parts[:]
        random.Random(0xC1A0).shuffle(shuffled)
        m2 = merge_scan_results(shuffled)
        assert list(m2.groups) == list(merged.groups)   # ordering contract
        assert m2.count == merged.count
        assert {k: vars(v) for k, v in m2.groups.items()} == \
            {k: vars(v) for k, v in merged.groups.items()}


def test_unsharded_scanner_groups_sorted(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    store = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    r = DataSkippingScanner(store, log_queries=False).scan(
        Query((fam0.plan.clauses[0],)))
    assert len(r.groups) > 1
    assert list(r.groups) == sorted(r.groups)


# ---------------------------------------------------------------------------
# NaN poisoning (satellite): partition + zone metadata stay sound
# ---------------------------------------------------------------------------

def _nan_records():
    rows = [{"score": 10.0, "tag": "a"}, {"score": float("nan"), "tag": "b"},
            {"score": 50.0, "tag": "c"}, {"score": float("nan"), "tag": "d"},
            {"score": 90.0, "tag": "e"}] * 40
    return [json.dumps(r).encode() for r in rows], rows


def test_partition_summary_nan_marks_nonprunable():
    recs, rows = _nan_records()
    s = ShardSummary()
    s.update(rows)
    assert s.term_possible(key_value("score", 50))
    assert s.term_possible(key_value("score", float("nan")))
    # the EXACT repr set may still refute an absent value (sound: a NaN
    # row cannot equal 10000 in any representation)...
    assert not s.term_possible(key_value("score", 10_000))
    # set-backed refutation works on the clean column too
    assert not s.term_possible(key_value("tag", "zz"))
    assert not s.term_possible(key_value("missing", 1))
    # ...but once the value set saturates, only min/max could refute —
    # and the NaN marks it non-prunable, so the lookup must stay possible
    sat = ShardSummary(value_cap=3)
    sat.update(rows)
    assert sat.term_possible(key_value("score", 10_000))
    # control: the same saturated summary WITHOUT NaN refutes via min/max
    clean = ShardSummary(value_cap=3)
    clean.update([r for r in rows if r["score"] == r["score"]])
    assert not clean.term_possible(key_value("score", 10_000))
    assert clean.term_possible(key_value("score", 50))


def test_nan_column_never_wrongly_skips_sharded_or_not():
    recs, rows = _nan_records()
    plan = PushdownPlan(clauses=[clause(key_value("tag", "a"))])
    eng = NumpyEngine()
    plain = CiaoStore(plan, segment_capacity=64)
    sharded = ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key="tag"), segment_capacity=64)
    for store in (plain, sharded):
        for lo in range(0, len(recs), 50):
            chunk = encode_chunk(recs[lo: lo + 50])
            store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
        store.jit_load_raw()
    queries = [Query((clause(key_value("score", v)),))
               for v in (10, 10.0, 50, 90, 77, 10_000, float("nan"))]
    s_plain = DataSkippingScanner(plain, log_queries=False)
    with ShardedScanner(sharded, log_queries=False) as s_sh:
        for q in queries:
            oracle = sum(1 for o in rows if q.matches_exact(o))
            assert s_plain.scan(q).count == oracle
            assert s_sh.scan(q).count == oracle
    # the zone map carries the poison flag on the affected column only —
    # NaN rows match no pushed clause, so they live in the JIT segments
    nan_segs = [s for s in plain.blocks + plain.jit_blocks
                if not s.key_cols["score"].num_prunable]
    assert nan_segs
    assert all(s.key_cols["tag"].num_prunable
               for s in plain.blocks + plain.jit_blocks)


def test_used_skipping_parity_across_epochs(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    plain = _build(CiaoStore(fam0, segment_capacity=512), recs, fam0, fam1)
    store = _build(
        ShardedCiaoStore(fam0,
                         router=ShardRouter(n_shards=4, key="linear_score"),
                         segment_capacity=512),
        recs, fam0, fam1)
    # this clause was pushed by the epoch-0 plan but dropped by the
    # epoch-1 replan: used_skipping must come from pushdown resolved per
    # SEGMENT epoch (ORed through the merge), not from a current-epoch
    # recomputation (regression: the executor clobbered the merged flag)
    q_old = Query((fam0.plan.clauses[5],))
    assert fam0.plan.clauses[5] not in fam1.plan.clauses
    mono = DataSkippingScanner(plain, log_queries=False).scan(q_old)
    with ShardedScanner(store, log_queries=False) as sc:
        r = sc.scan(q_old)
    assert mono.used_skipping
    assert r.used_skipping == mono.used_skipping
    assert r.count == mono.count


def test_range_router_huge_int_values_fall_back_to_hash():
    r = ShardRouter(n_shards=4, key="v", mode="range",
                    boundaries=(10.0, 20.0, 30.0))
    # > float64 max: float(v) raises OverflowError (regression: killed
    # the whole ingest_chunk); routes by the hash rule instead
    big = 10 ** 400
    rec = json.dumps({"v": big}).encode()
    sid = r.shard_of({"v": big}, rec)
    assert 0 <= sid < 4
    assert sid == r.shard_of({"v": big}, rec)
    # f64-INEXACT ints also hash-route: the partition summaries never
    # admit them to the numeric bounds, so range clustering is moot
    assert 0 <= r.shard_of({"v": 2 ** 63 + 1}, b"x") < 4
    # ordinary numerics still range-route by boundary
    assert r.shard_of({"v": 5.0}, b"x") == 0
    assert r.shard_of({"v": 15}, b"x") == 1
    assert r.shard_of({"v": 35}, b"x") == 3


# ---------------------------------------------------------------------------
# saturated summaries vs cross-representation strings (regression)
# ---------------------------------------------------------------------------

def _crossrepr_records():
    """200 distinct numeric scores (saturates a capped repr set) plus
    string ``"10"`` rows that cross-repr match the numeric probe 10 —
    which lies OUTSIDE the numeric min/max of [100, 299]."""
    rows = [{"score": 100 + i, "tag": "n"} for i in range(200)]
    rows += [{"score": "10", "tag": "s"}] * 8
    random.Random(5).shuffle(rows)
    return [json.dumps(r).encode() for r in rows], rows


def test_saturated_summary_keeps_cross_repr_strings_possible():
    _, rows = _crossrepr_records()
    sat = ShardSummary(value_cap=16)
    sat.update(rows)
    assert sat._keys["score"].reprs is None
    assert sat._keys["score"].strs is not None
    # the numeric bounds only summarize numeric rows: an out-of-range
    # probe must not refute the string "10" that cross-repr matches it
    assert sat.term_possible(key_value("score", 10))
    # ...while a probe matching no string still refutes via the str set —
    # including the float spelling (json_scalar(10.0) = "10.0" != "10")
    assert not sat.term_possible(key_value("score", 10.0))
    assert not sat.term_possible(key_value("score", 11))
    # both sets saturated: nothing may refute an out-of-range probe
    tiny = ShardSummary(value_cap=2)
    tiny.update([{"k": 1}, {"k": 2}, {"k": 3},
                 {"k": "a"}, {"k": "b"}, {"k": "c"}])
    assert tiny.term_possible(key_value("k", 99))


def test_saturated_shard_summary_never_wrongly_prunes():
    recs, rows = _crossrepr_records()
    plan = PushdownPlan(clauses=[clause(key_value("tag", "n"))])
    eng = NumpyEngine()
    plain = CiaoStore(plan, segment_capacity=64)
    sharded = ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key="score"),
        segment_capacity=64, summary_value_cap=16)
    for store in (plain, sharded):
        for lo in range(0, len(recs), 50):
            chunk = encode_chunk(recs[lo: lo + 50])
            store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    # the regression's trigger really is armed: repr summaries saturated
    assert any(ks.reprs is None
               for s in sharded.summaries for ks in s._keys.values())
    queries = [Query((clause(key_value("score", v)),))
               for v in (10, 10.0, "10", 150, 11, 9999)]
    # the regression case: int probe 10 cross-repr matches the "10" rows
    assert sum(1 for o in rows if queries[0].matches_exact(o)) == 8
    s_plain = DataSkippingScanner(plain, log_queries=False)
    with ShardedScanner(sharded, log_queries=False) as s_sh:
        for q in queries:
            oracle = sum(1 for o in rows if q.matches_exact(o))
            assert s_plain.scan(q).count == oracle
            assert s_sh.scan(q).count == oracle
        # pruning still fires on a truly absent value (not over-conservative)
        assert s_sh.scan(Query((clause(key_value("score", 9999)),))
                         ).shards_pruned > 0


def test_pruned_shard_skip_accounting_matches_scanned_population():
    recs, _ = _crossrepr_records()
    plan = PushdownPlan(clauses=[clause(key_value("tag", "n"))])
    eng = NumpyEngine()
    sharded = ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key="score"),
        segment_capacity=64, summary_value_cap=16)
    for lo in range(0, len(recs), 50):
        chunk = encode_chunk(recs[lo: lo + 50])
        sharded.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    with ShardedScanner(sharded, log_queries=False) as s_sh:
        r = s_sh.scan(Query((clause(key_value("score", 9999)),)))
    assert r.count == 0
    assert r.shards_pruned == sharded.n_shards
    # pruned shards report skips over the SAME population a scanned shard
    # does — loaded + JIT segment rows; never-promoted raw residents stay
    # out of the accounting on both paths
    seg_rows = sum(seg.n_rows for s in sharded.shards
                   for seg in (*s.blocks, *s.jit_blocks))
    raw_rows = sum(rr.n for s in sharded.shards for rr in s.raw)
    assert raw_rows > 0
    assert r.rows_skipped == seg_rows
    assert r.rows_scanned == 0
    assert sum(g.rows_skipped for g in r.groups.values()) == seg_rows


# ---------------------------------------------------------------------------
# checkpoints: format 5 + 2/3/4 migrations + offline reshard
# ---------------------------------------------------------------------------

def _scan_counts(store, queries):
    if isinstance(store, ShardedCiaoStore):
        with ShardedScanner(store, log_queries=False) as sc:
            return [sc.scan(q).count for q in queries]
    sc = DataSkippingScanner(store, log_queries=False)
    return [sc.scan(q).count for q in queries]


def test_format5_roundtrip(tmp_path, ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter.from_samples(4, "linear_score", objs[:400])
    store = _build(ShardedCiaoStore(fam0, router=router, segment_capacity=512),
                   recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked, objs)
    before = _scan_counts(store, queries)
    path = str(tmp_path / "ckpt5")
    store.save(path)
    # the manifest must be STRICT RFC-8259 JSON: empty numeric bounds
    # serialize as null, never as json.dump's Infinity/-Infinity tokens
    # (regression: string-only keys broke every non-Python consumer)
    manifest_text = (tmp_path / "ckpt5" / "manifest.json").read_text()
    json.loads(manifest_text, parse_constant=lambda tok: pytest.fail(
        f"non-standard JSON token {tok!r} in manifest"))
    loaded = ShardedCiaoStore.load(path)
    assert loaded.n_shards == 4
    assert loaded.router.to_obj() == router.to_obj()
    assert _scan_counts(loaded, queries) == before
    # partition summaries survive: pruning still fires after restore
    with ShardedScanner(loaded, log_queries=False) as sc:
        r = sc.scan(Query((clause(key_value("linear_score", 55)),)))
        assert r.shards_pruned >= 2
    # feedback state survives per shard
    assert np.array_equal(loaded.observed_selectivities(),
                          store.observed_selectivities())
    assert loaded.stats.n_records == store.stats.n_records


def _legacy_rewrite(src_path, dst_path, fmt):
    """Rewrite a format-4 npz checkpoint into the legacy format 2 or 3."""
    z = dict(np.load(src_path))
    meta = json.loads(bytes(z["meta"].tobytes()).decode())
    assert meta["format"] == 4
    meta["format"] = fmt
    for prefix in ("seg", "jit"):
        i = 0
        while f"{prefix}_blob_{i}" in z:
            blob, off = z.pop(f"{prefix}_blob_{i}"), z.pop(f"{prefix}_off_{i}")
            b = blob.tobytes()
            rows = [json.loads(b[off[k]: off[k + 1]])
                    for k in range(len(off) - 1)]
            name = "rows" if prefix == "seg" else "jit_rows"
            z[f"{name}_{i}"] = np.frombuffer(
                json.dumps(rows).encode(), np.uint8)
            i += 1
    if fmt == 2:
        # pre-tier checkpoints had no families / coverage columns /
        # per-clause denominators / group attribution / query log
        for key in ("families", "epoch_clause_records", "group_records",
                    "group_loaded", "query_log"):
            meta.pop(key, None)
        for key in ("block_ncov", "block_tiers", "raw_ncov", "raw_tiers",
                    "jit_ncov", "jit_tiers"):
            z.pop(key, None)
    z["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(dst_path, **z)


@pytest.mark.parametrize("fmt", [2, 3, 4])
def test_migrate_legacy_checkpoint_to_sharded(tmp_path, ycsb, fmt):
    """Formats 2-4 load into a 1-shard store; counts and coverage claims
    survive, and an offline reshard restores partition pruning."""
    recs, objs, ranked = ycsb
    plan = PushdownPlan(clauses=ranked[:4])
    store = CiaoStore(plan, segment_capacity=512)
    eng = NumpyEngine()
    for lo in range(0, 1024, CHUNK):
        chunk = encode_chunk(recs[lo: lo + CHUNK])
        store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    f4 = str(tmp_path / "f4.npz")
    store.save(f4)
    if fmt == 4:
        legacy = f4
    else:
        legacy = str(tmp_path / f"f{fmt}.npz")
        _legacy_rewrite(f4, legacy, fmt)

    queries = [Query((c,)) for c in ranked[:4]] + \
        [Query((clause(key_value("linear_score", v)),)) for v in (3, 55)]
    want = _scan_counts(store, queries)

    migrated = ShardedCiaoStore.load(legacy)
    assert migrated.n_shards == 1
    assert not migrated.summaries[0].exhaustive   # pruning disabled...
    assert _scan_counts(migrated, queries) == want
    # ...until the offline reshard rebuilds exhaustive summaries
    re8 = reshard(migrated,
                  ShardRouter.from_samples(8, "linear_score", objs[:400]))
    assert all(s.exhaustive for s in re8.summaries)
    assert _scan_counts(re8, queries) == want
    with ShardedScanner(re8, log_queries=False) as sc:
        assert sc.scan(queries[-1]).shards_pruned >= 6
    # aggregate feedback totals survive the migration chain exactly
    assert re8.stats.n_records == store.stats.n_records
    assert re8.epoch_records(0) == store.epoch_records(0)
    assert np.array_equal(re8.clause_records(0), store.clause_records(0))
    # save/load the resharded store as format 5 and re-check counts
    p5 = str(tmp_path / "resharded")
    re8.save(p5)
    assert _scan_counts(ShardedCiaoStore.load(p5), queries) == want
    # coverage claims survive: ingest under the current plan still works
    chunk = encode_chunk(recs[1024: 1024 + CHUNK])
    re8.ingest_chunk(chunk, eng.eval_fused(chunk, re8.plan.clauses))
    assert re8.stats.n_records == store.stats.n_records + CHUNK


def test_reshard_mixed_epoch_tier_store(tmp_path, ycsb):
    """Reshard preserves counts across epochs, tiers, raw remainders and
    JIT segments; format-5 roundtrip of the result is stable."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    src = _build(
        ShardedCiaoStore(fam0,
                         router=ShardRouter(n_shards=2, key="phone_country"),
                         segment_capacity=512),
        recs, fam0, fam1)
    queries = _workload(fam0, fam1, ranked, objs)
    # promote SOME remainders, leave the rest raw: this clause is pushed
    # only in epoch 1 at local row 4, so every raw group except epoch 1's
    # top-tier coverage misses it and gets JIT-promoted
    with ShardedScanner(src, log_queries=False) as sc:
        sc.scan(Query((fam1.plan.clauses[4],)))
    assert len(src.raw) > 0 and len(src.jit_blocks) > 0
    want = _scan_counts(src, queries)
    out = reshard(src, ShardRouter.from_samples(4, "linear_score",
                                                objs[:400]))
    assert _scan_counts(out, queries) == want
    assert np.array_equal(out.observed_selectivities(1),
                          src.observed_selectivities(1))
    # loaded rows are preserved exactly once across target shards
    assert sum(s.n_rows for s in out.blocks) == \
        sum(s.n_rows for s in src.blocks)
    assert sum(r.n for s in out.shards for r in s.raw) == \
        sum(r.n for s in src.shards for r in s.raw)
    # per-shard accounting is placement-derived, not dumped on shard 0:
    # the counters the scan executor reads per shard must be exact
    for sh in out.shards:
        resident = sum(s.n_rows for s in list(sh.blocks) + sh.jit_segments)
        resident += sum(r.n for r in sh.raw)
        assert sh.stats.n_records == resident
        assert sum(sh.group_records.values()) == resident
        assert sum(sh._epoch_records.values()) == resident
    assert out.stats.n_records == src.stats.n_records
    # pruned-shard attribution after reshard never exceeds resident rows
    with ShardedScanner(out, log_queries=False) as sc:
        r = sc.scan(Query((clause(key_value("linear_score", -7)),)))
        assert r.count == 0 and r.shards_pruned == out.n_shards
        assert r.rows_skipped == out.stats.n_records


# ---------------------------------------------------------------------------
# control plane over a sharded substrate
# ---------------------------------------------------------------------------

def test_replanner_over_sharded_store(ycsb):
    from repro_torch.core.replan import Replanner, ReplanPolicy

    recs, objs, ranked = ycsb
    plan = PushdownPlan(clauses=ranked[:4])
    store = ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key="linear_score"),
        segment_capacity=512)
    wl = Workload(name="w", queries=[Query((c,)) for c in ranked[4:10]])
    rp = Replanner(store, recs[:300], budget_us=50.0, base_workload=wl,
                   policy=ReplanPolicy(check_every_records=256,
                                       min_observe_records=256,
                                       min_window_queries=4))
    eng = NumpyEngine()
    for lo in range(0, 1024, CHUNK):
        chunk = encode_chunk(recs[lo: lo + CHUNK])
        store.ingest_chunk(chunk, eng.eval_fused(chunk, store.plan.clauses))
    with ShardedScanner(store) as sc:       # log a drifted workload
        for q in wl.queries * 4:
            sc.scan(q)
    new_plan = rp.step(force=True)
    assert new_plan is not None and store.epoch == 1
    assert all(s.plan.epoch == 1 for s in store.shards)
    # ingest continues under the new epoch, fanned out to every shard
    chunk = encode_chunk(recs[1024: 1024 + CHUNK])
    store.ingest_chunk(chunk, eng.eval_fused(chunk, store.plan.clauses),
                       epoch=1)
    assert store.epoch_records(1) == CHUNK


def test_pipeline_coordinator_and_batcher_over_sharded_store(ycsb):
    from repro_torch.data.pipeline import ClientShard, IngestCoordinator, RecipeBatcher
    from repro_torch.data.tokenizer import ByteTokenizer

    _, _, ranked = ycsb
    plan = PushdownPlan(clauses=ranked[:4])

    def run(store):
        clients = [
            ClientShard(dataset="ycsb", shard_id=i, engine=NumpyEngine(),
                        plan=plan, chunk_records=128,
                        speed=[4.0, 1.0, 0.5][i])
            for i in range(3)
        ]
        coord = IngestCoordinator(clients, store)
        coord.run(chunks_per_client=3)
        return store

    plain = run(CiaoStore(plan, segment_capacity=512))
    sharded = run(ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key="linear_score"),
        segment_capacity=512))
    assert sharded.stats.n_records == plain.stats.n_records
    assert sharded.stats.n_loaded == plain.stats.n_loaded
    recipe = Query((plan.clauses[0],))
    tok = ByteTokenizer(vocab_size=512)
    got_plain = sorted(RecipeBatcher(plain, tok, seq_len=64, batch_size=2)
                       .matching_records(recipe))
    got_shard = sorted(RecipeBatcher(sharded, tok, seq_len=64, batch_size=2)
                       .matching_records(recipe))
    assert got_plain == got_shard


# ---------------------------------------------------------------------------
# tree_reduce (the JAX package's tests/test_dist.py tree_reduce tests)
# ---------------------------------------------------------------------------

def test_tree_reduce_deterministic_association():
    """The merge tree is fixed by POSITION: ((x0·x1)·(x2·x3)) with an odd
    tail carried up, as in the JAX package."""
    from repro.dist.collectives import tree_reduce as j_tree_reduce
    from repro_torch.dist.collectives import tree_reduce

    paren = lambda a, b: f"({a}{b})"  # noqa: E731
    assert tree_reduce(["a"], paren) == "a"
    assert tree_reduce(list("ab"), paren) == "(ab)"
    assert tree_reduce(list("abcd"), paren) == "((ab)(cd))"
    assert tree_reduce(list("abcde"), paren) == "(((ab)(cd))e)"
    assert tree_reduce(list("abcdefg"), paren) == "(((ab)(cd))((ef)g))"
    assert tree_reduce(list(range(100)), lambda a, b: a + b) == 4950
    for n in range(1, 40):
        xs = [chr(65 + i % 26) for i in range(n)]
        assert tree_reduce(xs, paren) == j_tree_reduce(xs, paren)
    with pytest.raises(ValueError):
        tree_reduce([], paren)


def test_tree_reduce_float_sums_reproducible():
    from repro.dist.collectives import tree_reduce as j_tree_reduce
    from repro_torch.dist.collectives import tree_reduce

    rng = np.random.default_rng(3)
    xs = list(rng.normal(size=33) * 10.0 ** rng.integers(-8, 8, size=33))
    add = lambda a, b: a + b  # noqa: E731
    assert tree_reduce(xs, add) == tree_reduce(list(xs), add)
    assert tree_reduce(xs, add) == j_tree_reduce(xs, add)


# ---------------------------------------------------------------------------
# the port against the JAX package, on twin stores
# ---------------------------------------------------------------------------

from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro_torch.core.predicates import clause_to_obj  # noqa: E402


def _full(r) -> tuple:
    """Every accounting field of a ScanResult, groups included."""
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.shards_scanned,
            r.shards_pruned, r.used_skipping,
            tuple((k, (g.count, g.rows_scanned, g.rows_skipped,
                       g.raw_parsed, g.segments_pruned))
                  for k, g in r.groups.items()))


def _jc(c):
    return j_pred.clause_from_obj(clause_to_obj(c))


def _jq(q):
    return j_pred.Query(tuple(_jc(c) for c in q.clauses), freq=q.freq)


def _j_family(fam):
    plan = j_server.PushdownPlan.from_obj(json.loads(json.dumps(
        fam.plan.to_obj())))
    return j_server.PlanFamily.from_obj(plan, json.loads(json.dumps(
        fam.to_obj())))


def _j_router(router):
    return None if router is None else j_shard.ShardRouter.from_obj(
        json.loads(json.dumps(router.to_obj())))


def _build_jax(recs, fam0, fam1, router, n, *, jit=False):
    """``_build`` in the JAX package, with its own engine."""
    store = j_shard.ShardedCiaoStore(_j_family(fam0), router=_j_router(router),
                                     n_shards=n, segment_capacity=512)
    eng = j_client.NumpyEngine()

    def ingest(lo, hi, epoch):
        fam = store.family
        for i, start in enumerate(range(lo, hi, CHUNK)):
            tier = i % fam.n_tiers
            chunk = j_client.encode_chunk(recs[start: start + CHUNK])
            bv = eng.eval_fused_prefix(chunk, fam.plan.clauses,
                                       fam.tier_sizes[tier])
            store.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)

    half = (len(recs) // 2) // CHUNK * CHUNK
    ingest(0, half, epoch=0)
    store.advance_epoch(_j_family(fam1))
    ingest(half, len(recs), epoch=1)
    if jit:
        store.jit_load_raw()
    return store


def _build_port(recs, fam0, fam1, router, n, *, jit=False):
    return _build(ShardedCiaoStore(fam0, router=router, n_shards=n,
                                   segment_capacity=512),
                  recs, fam0, fam1, jit=jit)


def _build_twins(recs, fam0, fam1, router, n, *, jit=False):
    """The same mixed-epoch / mixed-tier ingest into a port store and a
    JAX store; each package evaluates the chunks with its own engine."""
    return (_build_port(recs, fam0, fam1, router, n, jit=jit),
            _build_jax(recs, fam0, fam1, router, n, jit=jit))


def _router_for(mode, n, objs):
    if n == 1:
        return None
    if mode == "range":
        return ShardRouter.from_samples(n, "linear_score", objs[:400])
    return ShardRouter(n_shards=n, key="linear_score", mode="hash")


def _same_state(ours, theirs):
    """Epochs, plans, per-group and per-shard accounting, summaries."""
    assert ours.n_shards == theirs.n_shards
    assert ours.epoch == theirs.epoch
    assert {e: [clause_to_obj(c) for c in p.clauses]
            for e, p in ours.plans.items()} == \
        {e: [j_pred.clause_to_obj(c) for c in p.clauses]
         for e, p in theirs.plans.items()}
    assert {e: f.tier_sizes for e, f in ours.families.items()} == \
        {e: f.tier_sizes for e, f in theirs.families.items()}
    assert ours.group_records == theirs.group_records
    assert ours.group_loaded == theirs.group_loaded
    for e in ours.plans:
        assert ours.epoch_records(e) == theirs.epoch_records(e)
        assert np.array_equal(ours.clause_records(e),
                              theirs.clause_records(e))
        assert np.array_equal(ours.observed_selectivities(e),
                              theirs.observed_selectivities(e))
    for a, b in zip(ours.shards, theirs.shards):
        assert (a.stats.n_records, a.stats.n_loaded, a.stats.n_jit_loaded) \
            == (b.stats.n_records, b.stats.n_loaded, b.stats.n_jit_loaded)
        assert [s.n_rows for s in a.blocks] == [s.n_rows for s in b.blocks]
        assert [s.n_rows for s in a.jit_blocks] == \
            [s.n_rows for s in b.jit_blocks]
        assert [(r.n, r.epoch, r.tier) for r in a.raw] == \
            [(r.n, r.epoch, r.tier) for r in b.raw]
    norm = lambda o: json.loads(json.dumps(o))  # noqa: E731
    assert [norm(s.to_obj()) for s in ours.summaries] == \
        [norm(s.to_obj()) for s in theirs.summaries]


def test_router_assignments_and_routing_key_match_jax(ycsb):
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    routers = [ShardRouter(n_shards=4),
               ShardRouter(n_shards=8, key="customer_id", mode="hash"),
               ShardRouter(n_shards=4, key="phone_country", mode="hash"),
               ShardRouter.from_samples(4, "linear_score", objs[:400]),
               ShardRouter.from_samples(8, "linear_score", objs[:800])]
    for r in routers:
        jr = _j_router(r)
        assert jr.to_obj() == r.to_obj()
        assert np.array_equal(r.route(objs, recs), jr.route(objs, recs))
    j_ranges = j_shard.ShardRouter.from_samples(4, "linear_score", objs[:400])
    assert j_ranges.to_obj() == routers[3].to_obj()
    for fam in (fam0, fam1):
        assert choose_routing_key(fam) == \
            j_shard.choose_routing_key(_j_family(fam))
    heavy = fam0.plan.clauses[-1]
    wl = Workload(name="w", queries=[Query((heavy,), freq=100.0)])
    from repro.core.workload import Workload as JWorkload
    jwl = JWorkload(name="w", queries=[_jq(Query((heavy,), freq=100.0))])
    assert choose_routing_key(fam0, wl) == \
        j_shard.choose_routing_key(_j_family(fam0), jwl)


@pytest.mark.parametrize("mode,n", [("hash", 1), ("hash", 2), ("hash", 4),
                                    ("range", 2), ("range", 4)])
def test_sharded_scans_match_jax(ycsb, mode, n):
    """Mixed-epoch, mixed-tier stores: the port's ShardedScanner equals
    the JAX package's in every ScanResult field, query by query (the
    first pass promotes raw remainders, the second reads them)."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    ours, theirs = _build_twins(recs, fam0, fam1,
                                _router_for(mode, n, objs), n)
    _same_state(ours, theirs)
    queries = _workload(fam0, fam1, ranked, objs)
    pruned = 0
    with ShardedScanner(ours, log_queries=False) as a, \
            j_shard.ShardedScanner(theirs, log_queries=False) as b:
        for _ in range(2):
            for q in queries:
                r = a.scan(q)
                assert _full(r) == _full(b.scan(_jq(q))), q.describe()
                pruned += r.shards_pruned
    if mode == "range":
        assert pruned > 0
    _same_state(ours, theirs)


def test_merge_scan_results_matches_jax():
    parts = [
        _tier_result([(1, 2), (0, 0)], 3),
        _tier_result([(0, 1)], 5),
        _tier_result([(1, 0), (0, 0)], 7),
        _tier_result([(2, 1)], 1),
        _tier_result([(0, 1), (2, 1)], 4),
    ]

    def j_part(r):
        out = j_server.ScanResult(
            count=r.count, rows_scanned=r.rows_scanned,
            rows_skipped=r.rows_skipped, raw_parsed=r.raw_parsed,
            time_s=r.time_s, used_skipping=r.used_skipping)
        for k, g in r.groups.items():
            jg = out.group(*k)
            jg.count, jg.rows_scanned = g.count, g.rows_scanned
        return out

    for k in range(1, len(parts) + 1):
        assert _full(merge_scan_results(parts[:k])) == _full(
            j_shard.merge_scan_results([j_part(p) for p in parts[:k]]))


def test_reshard_and_online_migration_match_jax(ycsb):
    """Offline reshard onto a range router, then an online migration
    back to hash routing, in both packages: same placement, same
    accounting for every query."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    ours, theirs = _build_twins(
        recs, fam0, fam1,
        ShardRouter(n_shards=2, key="phone_country"), 2)
    q_promote = Query((fam1.plan.clauses[4],))
    with ShardedScanner(ours, log_queries=False) as a, \
            j_shard.ShardedScanner(theirs, log_queries=False) as b:
        assert _full(a.scan(q_promote)) == _full(b.scan(_jq(q_promote)))
    rng_router = ShardRouter.from_samples(4, "linear_score", objs[:400])
    ours = reshard(ours, rng_router)
    theirs = j_shard.reshard(theirs, _j_router(rng_router))
    _same_state(ours, theirs)
    queries = _workload(fam0, fam1, ranked, objs)
    with ShardedScanner(ours, log_queries=False) as a, \
            j_shard.ShardedScanner(theirs, log_queries=False) as b:
        for q in queries:
            assert _full(a.scan(q)) == _full(b.scan(_jq(q))), q.describe()
    hashed = ShardRouter(n_shards=4, key="customer_id", mode="hash")
    ma = ours.begin_migration(hashed, batch_rows=300)
    mb = theirs.begin_migration(_j_router(hashed), batch_rows=300)
    steps = 0
    while not ma.done:
        assert ma.step() == mb.step()
        assert ma.items_left == mb.items_left
        steps += 1
    assert mb.done and steps > 1
    ma.finish()
    mb.finish()
    _same_state(ours, theirs)
    with ShardedScanner(ours, log_queries=False) as a, \
            j_shard.ShardedScanner(theirs, log_queries=False) as b:
        for q in queries:
            r = a.scan(q)
            assert r.count == sum(1 for o in objs if q.matches_exact(o))
            assert _full(r) == _full(b.scan(_jq(q))), q.describe()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_snapshot_scans_like_store_and_stays_fixed(ycsb, package):
    """A ShardedStoreSnapshot answers like its store, and a later ingest
    into the store leaves the snapshot's answers unchanged."""
    recs, objs, ranked = ycsb
    fam0, fam1 = _families(ranked)
    router = ShardRouter.from_samples(4, "linear_score", objs[:400])
    queries = _workload(fam0, fam1, ranked, objs)
    half = recs[:1536]
    if package == "jax":
        build, scanner, eng = _build_jax, j_shard.ShardedScanner, \
            j_client.NumpyEngine()
        queries = [_jq(q) for q in queries]
        enc = j_client.encode_chunk
    else:
        build, scanner, eng = _build_port, ShardedScanner, NumpyEngine()
        enc = encode_chunk
    store, twin = (build(half, fam0, fam1, router, 4) for _ in range(2))
    fam = store.family
    snap = store.snapshot()
    with scanner(snap, log_queries=False) as a, \
            scanner(twin, log_queries=False) as b:
        # two passes: the first promotes raw rows query by query, so a
        # pruned shard's skipped rows grow until the second
        for _ in range(2):
            before = [a.scan(q) for q in queries]
            assert [_full(r) for r in before] == \
                [_full(b.scan(q)) for q in queries]
    for lo in range(1536, len(recs), CHUNK):
        chunk = enc(recs[lo: lo + CHUNK])
        store.ingest_chunk(chunk, eng.eval_fused_prefix(
            chunk, fam.plan.clauses, fam.tier_sizes[1]), epoch=1, tier=1)
    assert store.stats.n_records == len(recs)
    with scanner(snap, log_queries=False) as a, \
            scanner(store, log_queries=False) as live:
        after = [a.scan(q) for q in queries]
        assert [_full(r) for r in after] == [_full(r) for r in before]
        grown = [live.scan(q).count for q in queries]
    assert grown == [sum(1 for o in objs if q.matches_exact(o))
                     for q in _workload(fam0, fam1, ranked, objs)]
    snap.close()


def test_bloom_batches_and_number_parse_match_jax():
    """The port's batched n-gram bloom (``add_many``, used by the partition
    summaries and the segment zone maps) sets the JAX package's bits, and
    its ``json_number`` shortcut parses what the JAX package parses."""
    from repro.core.predicates import json_number as j_json_number
    from repro.core.skip_index import NGramBloom as JBloom
    from repro_torch.core.predicates import json_number
    from repro_torch.core.skip_index import NGramBloom

    rng = random.Random(11)
    alphabet = "ab.@- 0123456789" + "é€\U0001f600"
    for _ in range(200):
        strings = ["".join(rng.choice(alphabet)
                           for _ in range(rng.randrange(0, 14)))
                   for _ in range(rng.randrange(0, 24))]
        ours, one_by_one, theirs = NGramBloom(), NGramBloom(), JBloom()
        ours.add_many(strings)
        for s in strings:
            one_by_one.add(s)
            theirs.add(s)
        assert ours.to_hex() == one_by_one.to_hex() == theirs.to_hex()
    probes = ["", " ", "12", " 12 ", "\t-3.5e2\n", "-", "007", "1_0", "+3",
              "NaN", "Infinity", "-Infinity", "Nope", "I", "true", "null",
              '"1"', "1e400", "10" * 30, "x1", "é1"]
    for s in probes:
        a, b = json_number(s), j_json_number(s)
        assert type(a) is type(b) and (a == b or (a != a and b != b)), s
