"""The port's columnar scan engine (``repro_torch.core.columnar``):
lowering exactness, zone-map soundness, and the differential sweep vs the
``matches_exact`` / FullScanBaseline oracle (DESIGN.md §13).

The first part runs the JAX package's ``tests/test_columnar.py`` on the
port; its XLA AND-reduce test becomes the port's hook on kernel C's plain
version.  The second part holds the port against the JAX package on the
same inputs: segments, bitvectors and every scan's accounting across
mixed epochs, tiers and segment capacities; lowered masks and zone-map
verdicts on the adversarial values.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import client as j_client  # noqa: E402
from repro.core import columnar as j_columnar  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro.kernels.residual import bv_and_many_xla  # noqa: E402
from repro_torch.core import bitvector  # noqa: E402
from repro_torch.core.client import NumpyEngine, encode_chunk  # noqa: E402
from repro_torch.core.columnar import (  # noqa: E402
    ColumnarSegment, build_key_columns, eval_lowered, query_mask,
)
from repro_torch.core.predicates import (  # noqa: E402
    Query, clause, clause_to_obj, exact, json_scalar, key_value, lowerable,
    presence, substring,
)
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, FullScanBaseline, PlanFamily,
    PushdownPlan, evolve_family,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import generate_records, predicate_pool  # noqa: E402

def _segment(objs, n_covered=0, bits=None, epoch=0, tier=0):
    recs = [json.dumps(o, separators=(",", ":")).encode() for o in objs]
    if bits is None:
        bits = np.zeros((n_covered, len(objs)), bool)
    return ColumnarSegment(
        records=recs, bitvectors=bitvector.pack(bits),
        epoch=epoch, n_covered=n_covered, tier=tier)


# ---------------------------------------------------------------------------
# predicate lowering: exact matches_exact semantics over columns
# ---------------------------------------------------------------------------

# adversarial value mix: cross-representation pairs (10 vs "10" vs 10.0),
# bool-vs-int traps (True vs 1), None, nested values, numeric strings
_TRICKY_OBJS = [
    {"a": 10, "b": "x"},
    {"a": "10", "b": "xy"},
    {"a": 10.0, "c": True},
    {"a": True, "c": 1},
    {"a": False, "c": 0},
    {"a": None, "b": "none"},
    {"a": "true", "c": "None"},
    {"b": "contains 10 inside", "c": 2.5},
    {"a": [1, 2], "b": {"nested": 1}},
    {"a": "", "b": "x", "c": -3},
    {"c": 24e-1},
    {"a": 2.4, "c": "2.4"},
]

_TRICKY_PREDS = [
    key_value("a", 10), key_value("a", 10.0), key_value("a", "10"),
    key_value("a", True), key_value("c", 1), key_value("c", True),
    key_value("c", 0), key_value("c", False), key_value("a", None),
    key_value("c", 2.4), key_value("c", "2.4"), key_value("c", 24e-1),
    key_value("missing", 1),
    exact("a", "10"), exact("a", "true"), exact("a", ""), exact("b", "x"),
    substring("b", "10"), substring("b", "x"), substring("a", "1"),
    presence("a"), presence("c"), presence("missing"),
]


@pytest.mark.parametrize("pred", _TRICKY_PREDS,
                         ids=[p.describe() for p in _TRICKY_PREDS])
def test_lowered_predicates_match_exact_oracle(pred):
    cols = build_key_columns(_TRICKY_OBJS)
    assert lowerable(pred)
    col = cols.get(pred.key)
    if col is None:
        got = np.zeros(len(_TRICKY_OBJS), bool)
    else:
        got = eval_lowered(col, pred)
    want = np.array([pred.matches_exact(o) for o in _TRICKY_OBJS])
    assert np.array_equal(got, want), (pred.describe(), got, want)


def test_lowered_random_sweep_matches_exact_oracle():
    rng = np.random.default_rng(11)
    keys = ["k0", "k1", "k2", "k3"]
    vals = [0, 1, 7, 10, -3, 2.5, 10.0, "10", "a", "ab", "true", "None",
            True, False, None]
    objs = []
    for _ in range(300):
        o = {}
        for k in keys:
            if rng.random() < 0.75:
                o[k] = vals[int(rng.integers(len(vals)))]
        objs.append(o)
    cols = build_key_columns(objs)
    preds = []
    for k in keys + ["absent"]:
        for v in vals:
            preds.append(key_value(k, v))
            if isinstance(v, str):
                preds.append(exact(k, v))
                preds.append(substring(k, v))
        preds.append(presence(k))
    for p in preds:
        col = cols.get(p.key)
        got = (np.zeros(len(objs), bool) if col is None
               else eval_lowered(col, p))
        want = np.array([p.matches_exact(o) for o in objs])
        assert np.array_equal(got, want), p.describe()


def test_non_lowerable_terms_fall_back_to_exact():
    # EXACT with a non-string operand is outside the lowering (and CAN
    # match: kind EXACT compares v == value directly); the clause must
    # still evaluate exactly through the per-row raw-bytes fallback
    weird = exact("a", 10)
    assert not lowerable(weird)
    seg = _segment(_TRICKY_OBJS)
    q = Query((clause(weird, key_value("b", "xy")),))
    mask = query_mask(seg, q)
    want = np.array([q.matches_exact(o) for o in _TRICKY_OBJS])
    assert np.array_equal(mask, want)
    assert mask.any()  # the fallback actually fired on a matching row


def test_huge_int_no_float64_aliasing():
    big = (1 << 53) + 1
    objs = [{"a": big}, {"a": float(1 << 53)}, {"a": 1 << 53},
            {"a": str(big)}]
    cols = build_key_columns(objs)
    for v in (big, 1 << 53, float(1 << 53), str(big)):
        p = key_value("a", v)
        got = eval_lowered(cols["a"], p)
        want = np.array([p.matches_exact(o) for o in objs])
        assert np.array_equal(got, want), (v, got, want)


# ---------------------------------------------------------------------------
# zone maps
# ---------------------------------------------------------------------------

def test_zone_map_refutations_are_sound():
    rng = np.random.default_rng(3)
    objs = [{"n": int(rng.integers(50, 80)), "s": f"w{i % 7}"}
            for i in range(64)] + [{"n": 60, "s": "w0"}]
    seg = _segment(objs)
    refuted = [
        clause(key_value("n", 10)),        # below num_min
        clause(key_value("n", 99)),        # above num_max
        clause(exact("s", "w9")),          # not in the dictionary
        clause(substring("s", "zz")),      # no dict entry contains it
        clause(presence("missing")),       # key absent everywhere
    ]
    for c in refuted:
        assert not seg.clause_possible(c), c.describe()
        # soundness: the refutation must imply ZERO exact matches
        assert not any(Query((c,)).matches_exact(o) for o in objs)
    possible = [
        clause(key_value("n", 60)), clause(exact("s", "w0")),
        clause(substring("s", "w")), clause(presence("n")),
        clause(key_value("n", 10), key_value("n", 60)),  # OR: one disjunct
    ]
    for c in possible:
        assert seg.clause_possible(c), c.describe()


def test_zone_map_nan_marks_column_nonprunable():
    """NaN poisoning regression (DESIGN.md §14): a NaN among a key's
    numeric values marks the zone map non-prunable, and no segment is
    ever wrongly skipped — every numeric lookup's count stays exact."""
    objs = [{"n": 10.0, "s": "a"}, {"n": float("nan"), "s": "b"},
            {"n": 90.0, "s": "c"}, {"n": float("nan"), "s": "d"}] * 8
    seg = _segment(objs)
    assert not seg.key_cols["n"].num_prunable   # detected at build time
    assert seg.key_cols["s"].num_prunable       # only the NaN column
    # min/max over the non-NaN values stays clean (NaN never enters num)
    assert (seg.key_cols["n"].num_min, seg.key_cols["n"].num_max) == \
        (10.0, 90.0)
    # no wrongful skip: every lookup with >= 1 exact match stays possible,
    # and query_mask reproduces matches_exact bit for bit — NaN included
    for v in (10, 10.0, 90, float("nan")):
        c = clause(key_value("n", v))
        assert seg.clause_possible(c)
        mask = query_mask(seg, Query((c,)))
        want = np.array([Query((c,)).matches_exact(o) for o in objs])
        assert np.array_equal(mask, want), v
    # values absent in EVERY representation may still be refuted by the
    # exact repr set (sound: a NaN row equals nothing but NaN)
    assert not seg.clause_possible(clause(key_value("n", 55)))
    assert sum(1 for o in objs
               if Query((clause(key_value("n", 55)),)).matches_exact(o)) == 0


def test_scan_counts_exact_with_pruned_and_all_pruned_segments():
    recs = generate_records("ycsb", 900, seed=21)
    pool = predicate_pool("ycsb")
    plan = PushdownPlan(clauses=pool[:2])
    store = CiaoStore(plan, segment_capacity=256)   # many small segments
    eng = NumpyEngine()
    for lo in range(0, 900, 300):
        chunk = encode_chunk(recs[lo:lo + 300])
        store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    base = FullScanBaseline()
    for lo in range(0, 900, 300):
        base.ingest_chunk(encode_chunk(recs[lo:lo + 300]))
    scanner = DataSkippingScanner(store, log_queries=False)
    # every-segment-pruned edge: value outside every zone map
    q = Query((clause(key_value("linear_score", 250)),))
    r = scanner.scan(q)
    assert r.count == base.scan(q).count == 0
    assert r.segments_pruned == len(store.blocks) + len(store.jit_blocks)
    # point lookup: most segments pruned via the repr dictionary, counts
    # still exact
    target = json.loads(recs[5])["customer_id"]
    q = Query((clause(key_value("customer_id", target)),))
    r = scanner.scan(q)
    assert r.count == base.scan(q).count >= 1
    assert r.segments_pruned >= 1
    # empty store edge
    empty = CiaoStore(PushdownPlan(clauses=pool[:2]))
    r = DataSkippingScanner(empty, log_queries=False).scan(q)
    assert r.count == 0 and r.rows_scanned == 0


# ---------------------------------------------------------------------------
# THE differential sweep: mixed epochs x tiers x coverage prefixes
# ---------------------------------------------------------------------------

def _mixed_store(segment_capacity=512):
    recs = generate_records("ycsb", 1800, seed=9)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.25))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:6]),
                      tier_sizes=(0, 2, 6))
    store = CiaoStore(fam0, segment_capacity=segment_capacity)
    eng = NumpyEngine()
    for i, lo in enumerate(range(0, 900, 300)):
        tier = i % 3
        chunk = encode_chunk(recs[lo:lo + 300])
        bv = eng.eval_fused_prefix(chunk, fam0.plan.clauses,
                                   fam0.tier_sizes[tier])
        store.ingest_chunk(chunk, bv, tier=tier)
    fam1 = evolve_family(fam0, ranked[2:8], (1, 3, 6))
    store.advance_epoch(fam1)
    for i, lo in enumerate(range(900, 1800, 300)):
        tier = (i + 1) % 3
        chunk = encode_chunk(recs[lo:lo + 300])
        bv = eng.eval_fused_prefix(chunk, fam1.plan.clauses,
                                   fam1.tier_sizes[tier])
        store.ingest_chunk(chunk, bv, epoch=1, tier=tier)
    base = FullScanBaseline()
    for lo in range(0, 1800, 300):
        base.ingest_chunk(encode_chunk(recs[lo:lo + 300]))
    return store, base, ranked, recs


def test_differential_columnar_vs_full_scan_oracle():
    store, base, ranked, recs = _mixed_store()
    scanner = DataSkippingScanner(store, log_queries=False)
    queries = (
        [Query((c,)) for c in ranked[:10]] +
        [Query((a, b)) for a, b in zip(ranked[:4], ranked[6:10])] +
        [Query((ranked[0], ranked[1], ranked[12]))] +
        [Query((clause(key_value("linear_score", 250)),)),
         Query((clause(exact("phone_country", "ZZ")),)),
         Query((clause(presence("email")),)),
         Query((clause(substring("url_site", "www.")),))]
    )
    for q in queries:
        r = scanner.scan(q)
        assert r.count == base.scan(q).count, q.describe()
        # aggregate accounting stays consistent under pruning
        assert r.rows_scanned + r.rows_skipped == sum(
            s.n_rows for s in list(store.blocks) + list(store.jit_blocks))
    # second pass: memoized clause masks / AND masks must not drift
    for q in queries:
        assert scanner.scan(q).count == base.scan(q).count, q.describe()


def test_differential_sweep_across_segment_capacities():
    for cap in (128, 1024, 8192):
        store, base, ranked, recs = _mixed_store(segment_capacity=cap)
        scanner = DataSkippingScanner(store, log_queries=False)
        for q in [Query((c,)) for c in ranked[:6]] + \
                 [Query((ranked[0], ranked[7]))]:
            assert scanner.scan(q).count == base.scan(q).count, \
                (cap, q.describe())


def test_recipe_batcher_streams_source_bytes():
    """Matching records come back as the ORIGINAL ingested bytes — no
    json.dumps round-trip — and exactly the oracle's match set."""
    from repro_torch.data.pipeline import RecipeBatcher
    from repro_torch.data.tokenizer import ByteTokenizer

    store, base, ranked, recs = _mixed_store()
    recipe = Query((ranked[1],))
    b = RecipeBatcher(store, ByteTokenizer(vocab_size=512),
                      seq_len=16, batch_size=2)
    got = list(b.matching_records(recipe))
    want = [r for r in recs if recipe.matches_exact(json.loads(r))]
    assert sorted(got) == sorted(want)


def test_segment_compaction_bounds_and_order():
    store, base, ranked, recs = _mixed_store(segment_capacity=512)
    segs = store.blocks
    # loaded rows survive compaction exactly once
    n_loaded = sum(s.n_rows for s in segs)
    assert n_loaded == store.stats.n_loaded
    # sealed segments respect the capacity bound (cap + one chunk slack)
    for s in store.segments:
        assert s.n_rows <= 512 + 300
    # every segment is homogeneous in its coverage group
    for s in segs:
        assert s.bitvectors.shape[0] == s.n_covered
        assert s.bitvectors.shape[1] == bitvector.num_words(s.n_rows)


def test_save_load_format4_roundtrip(tmp_path):
    store, base, ranked, recs = _mixed_store()
    DataSkippingScanner(store).scan(Query((ranked[9],)))  # force JIT
    path = str(tmp_path / "store.npz")
    store.save(path)
    loaded = CiaoStore.load(path)
    # compaction behavior survives the restore (not the 8192 default)
    assert loaded.segment_capacity == store.segment_capacity == 512
    assert [s.n_covered for s in loaded.blocks] == \
        [s.n_covered for s in store.blocks]
    assert [s.records() for s in loaded.blocks] == \
        [s.records() for s in store.blocks]
    s1 = DataSkippingScanner(store, log_queries=False)
    s2 = DataSkippingScanner(loaded, log_queries=False)
    for q in (Query((ranked[0],)), Query((ranked[2], ranked[7]))):
        a, b2 = s1.scan(q), s2.scan(q)
        assert (a.count, a.rows_scanned, a.rows_skipped,
                a.segments_pruned) == \
            (b2.count, b2.rows_scanned, b2.rows_skipped, b2.segments_pruned)


def test_load_migrates_format3_checkpoint(tmp_path):
    """A format-3 checkpoint (parsed row dicts per block) restores into
    columnar segments with identical scan results."""
    recs = generate_records("ycsb", 200, seed=4)
    pool = predicate_pool("ycsb")
    plan = PushdownPlan(clauses=pool[:2])
    store = CiaoStore(plan)
    eng = NumpyEngine()
    chunk = encode_chunk(recs)
    store.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    path = str(tmp_path / "f3.npz")
    store.save(path)

    # rewrite the checkpoint into the legacy format-3 shape: rows_<i>
    # JSON instead of seg_blob/seg_off
    z = dict(np.load(path))
    meta = json.loads(bytes(z["meta"].tobytes()).decode())
    assert meta["format"] == 4
    meta["format"] = 3
    z["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    for bi in range(int(z["n_blocks"])):
        blob, off = z.pop(f"seg_blob_{bi}"), z.pop(f"seg_off_{bi}")
        b = blob.tobytes()
        rows = [json.loads(b[off[i]:off[i + 1]])
                for i in range(len(off) - 1)]
        z[f"rows_{bi}"] = np.frombuffer(
            json.dumps(rows).encode(), np.uint8)
    legacy = str(tmp_path / "legacy.npz")
    np.savez_compressed(legacy, **z)

    loaded = CiaoStore.load(legacy)
    q = Query((plan.clauses[0],))
    a = DataSkippingScanner(store, log_queries=False).scan(q)
    b = DataSkippingScanner(loaded, log_queries=False).scan(q)
    assert (a.count, a.rows_scanned) == (b.count, b.rows_scanned)


def test_scan_counts_independent_of_query_order_across_value_types():
    # Regression: segment clause caches (and the pushed-clause lookup)
    # key on clause equality, and Python's 10 == 10.0 aliased the int and
    # float probes — the first query's cached mask answered the second,
    # so counts depended on query ORDER.  The probes differ exactly on
    # string rows: json_scalar(10) = "10" matches the row "10",
    # json_scalar(10.0) = "10.0" does not.
    objs = [{"score": 100 + i} for i in range(20)] + [{"score": "10"}] * 4
    recs = [json.dumps(o).encode() for o in objs]
    q_int = Query((clause(key_value("score", 10)),))
    q_float = Query((clause(key_value("score", 10.0)),))
    oracles = {q: sum(1 for o in objs if q.matches_exact(o))
               for q in (q_int, q_float)}
    assert oracles[q_int] == 4 and oracles[q_float] == 0
    for order in ((q_int, q_float), (q_float, q_int)):
        store = CiaoStore(PushdownPlan(clauses=[]), segment_capacity=64)
        chunk = encode_chunk(recs)
        store.ingest_chunk(chunk, np.zeros((0, chunk.n_records), bool))
        s = DataSkippingScanner(store, log_queries=False)
        for q in order:
            assert s.scan(q).count == oracles[q]


def test_and_reduce_hook_matches_numpy():
    """The JAX test's XLA AND-reduce, on the port: ``residual``'s hooks on
    kernel C's plain version (``backend="torch"``), and the JAX hook."""
    from repro_torch.kernels.residual import bv_and_many_cuda, popcount_cuda

    and_plain = functools.partial(bv_and_many_cuda, backend="torch")
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(5, 7), dtype=np.uint64
                         ).astype(np.uint32)
    assert np.array_equal(and_plain(words), bitvector.bv_and_many(words))
    assert np.array_equal(and_plain(words), bv_and_many_xla(words))
    assert popcount_cuda(words, backend="torch") == \
        int(bitvector.popcount_rows(words).sum())
    # end to end: a scanner routed through the AND-reduce hook agrees
    store, base, ranked, recs = _mixed_store()
    s_np = DataSkippingScanner(store, log_queries=False)
    s_hook = DataSkippingScanner(store, log_queries=False,
                                 and_reduce=and_plain)
    for q in [Query((c,)) for c in ranked[:4]]:
        assert s_np.scan(q).count == s_hook.scan(q).count == \
            base.scan(q).count


# ---- held against the JAX package on the same inputs

def _j_mixed_store(segment_capacity=512):
    recs = j_datasets.generate_records("ycsb", 1800, seed=9)
    pool = j_datasets.predicate_pool("ycsb")
    sel = j_workload.estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.25))
    fam0 = j_server.PlanFamily(plan=j_server.PushdownPlan(clauses=ranked[:6]),
                               tier_sizes=(0, 2, 6))
    store = j_server.CiaoStore(fam0, segment_capacity=segment_capacity)
    eng = j_client.NumpyEngine()
    for i, lo in enumerate(range(0, 900, 300)):
        tier = i % 3
        chunk = j_client.encode_chunk(recs[lo:lo + 300])
        bv = eng.eval_fused_prefix(chunk, fam0.plan.clauses,
                                   fam0.tier_sizes[tier])
        store.ingest_chunk(chunk, bv, tier=tier)
    fam1 = j_server.evolve_family(fam0, ranked[2:8], (1, 3, 6))
    store.advance_epoch(fam1)
    for i, lo in enumerate(range(900, 1800, 300)):
        tier = (i + 1) % 3
        chunk = j_client.encode_chunk(recs[lo:lo + 300])
        bv = eng.eval_fused_prefix(chunk, fam1.plan.clauses,
                                   fam1.tier_sizes[tier])
        store.ingest_chunk(chunk, bv, epoch=1, tier=tier)
    return store, ranked


def _to_jax(q):
    return j_pred.Query(tuple(
        j_pred.clause_from_obj(json.loads(json.dumps(clause_to_obj(c))))
        for c in q.clauses))


def _segs(store):
    return [(s.n_rows, s.n_covered, s.epoch, s.tier, s.records(),
             s.bitvectors.tolist())
            for s in list(store.blocks) + list(store.jit_blocks)]


@pytest.mark.parametrize("cap", [128, 512, 8192])
def test_mixed_store_matches_jax(cap):
    """Same segments (rows, coverage, epoch, tier, bytes, bitvectors) and
    every ScanResult field, before and after the raw rows' promotion."""
    store, base, ranked, recs = _mixed_store(segment_capacity=cap)
    jstore, jranked = _j_mixed_store(segment_capacity=cap)
    assert [clause_to_obj(c) for c in ranked] == \
        [j_pred.clause_to_obj(c) for c in jranked]
    assert _segs(store) == _segs(jstore)
    queries = ([Query((c,)) for c in ranked[:10]]
               + [Query((a, b)) for a, b in zip(ranked[:4], ranked[6:10])]
               + [Query((clause(key_value("linear_score", 250)),)),
                  Query((clause(presence("email")),))])
    a = DataSkippingScanner(store, log_queries=False)
    b = j_server.DataSkippingScanner(jstore, log_queries=False)
    for q in queries:
        r, jr = a.scan(q), b.scan(_to_jax(q))
        assert (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
                r.segments_pruned, r.used_skipping) == \
            (jr.count, jr.rows_scanned, jr.rows_skipped, jr.raw_parsed,
             jr.segments_pruned, jr.used_skipping), q.describe()
    assert _segs(store) == _segs(jstore)


def test_lowering_and_zone_maps_match_jax():
    cols = build_key_columns(_TRICKY_OBJS)
    jcols = j_columnar.build_key_columns(_TRICKY_OBJS)
    assert sorted(cols) == sorted(jcols)
    seg = _segment(_TRICKY_OBJS)
    recs = [json.dumps(o, separators=(",", ":")).encode()
            for o in _TRICKY_OBJS]
    jseg = j_columnar.ColumnarSegment(
        records=recs, bitvectors=bitvector.pack(np.zeros((0, len(recs)),
                                                         bool)),
        epoch=0, n_covered=0, tier=0)
    for p in _TRICKY_PREDS:
        jp = j_pred.clause_from_obj(json.loads(json.dumps(
            clause_to_obj(clause(p))))).terms[0]
        if p.key in cols:
            assert np.array_equal(eval_lowered(cols[p.key], p),
                                  j_columnar.eval_lowered(jcols[p.key], jp))
        assert seg.clause_possible(clause(p)) == \
            jseg.clause_possible(j_pred.clause(jp)), p.describe()
        assert json_scalar(p.value) == j_pred.json_scalar(jp.value)
