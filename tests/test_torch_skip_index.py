"""The port's skipping-index registry (``repro_torch.core.skip_index``,
DESIGN.md §19): RANGE / IN / n-gram pruning.

The first part runs the JAX package's ``tests/test_skip_index.py`` on the
port, shard summaries folded the port's way (``_KeySummary.add(v, cap,
strings)``, then ``NGramBloom.add_many``).  The second part holds the
port against the JAX package on the same values: bloom bits, summaries
and their probes, and every sweep predicate's mask.
"""
import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import columnar as j_columnar  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import shard as j_shard  # noqa: E402
from repro.core import skip_index as j_skip  # noqa: E402
from repro_torch.core import bitvector  # noqa: E402
from repro_torch.core.batch_scan import ResultCache, ScanBatcher  # noqa: E402
from repro_torch.core.client import NumpyEngine, encode_chunk  # noqa: E402
from repro_torch.core.columnar import (  # noqa: E402
    ColumnarSegment, _term_possible, query_mask,
)
from repro_torch.core.predicates import (  # noqa: E402
    Query, between, clause, clause_to_obj, exact, in_list, key_value, rng,
    substring,
)
from repro_torch.core.server import CiaoStore, PlanFamily, PushdownPlan  # noqa: E402
from repro_torch.core.shard import _KeySummary  # noqa: E402
from repro_torch.core.skip_index import (  # noqa: E402
    REGISTRY, KeyStats, NGramBloom, conservative_bounds, range_fold_value,
)


def _fold(ks, values, cap):
    """``_KeySummary.add`` of each value, the port's way: strings gathered
    and added to the n-gram bloom in one batch (``NGramBloom.add_many``)."""
    strings = []
    for v in values:
        ks.add(v, cap, strings)
    if strings:
        ks.ngram.add_many(strings)

def _segment(objs, n_covered=0):
    recs = [json.dumps(o, separators=(",", ":")).encode() for o in objs]
    bits = np.zeros((n_covered, len(objs)), bool)
    return ColumnarSegment(records=recs, bitvectors=bitvector.pack(bits),
                           epoch=0, n_covered=n_covered, tier=0)


# ---------------------------------------------------------------------------
# n-gram bloom: no false negatives, serialization, refutation power
# ---------------------------------------------------------------------------

_BLOOM_STRS = ["session 41 tok03 event", "café au lait", "日本語テスト",
               "naïve", "", "ab", "x" * 200]


def test_ngram_bloom_never_false_negative():
    b = NGramBloom()
    for s in _BLOOM_STRS:
        b.add(s)
    for s in _BLOOM_STRS:
        # every substring of an added string must stay possible —
        # including multibyte unicode slices (UTF-8 substring closure)
        for i in range(len(s)):
            for j in range(i + 1, min(i + 8, len(s)) + 1):
                assert b.might_contain(s[i:j]), (s, s[i:j])
    # needles shorter than one full 3-gram are always possible
    assert b.might_contain("") and b.might_contain("zz")
    # a rare absent trigram refutes (deterministic hashes, sparse bloom)
    assert not b.might_contain("zzqxv")
    assert not b.might_contain("語本日")          # reversed: absent grams


def test_ngram_bloom_hex_roundtrip_and_union():
    a, b = NGramBloom(), NGramBloom()
    a.add("alpha"), b.add("bravo")
    restored = NGramBloom.from_hex(a.to_hex())
    assert np.array_equal(restored.bits, a.bits)
    a.union(b)
    assert a.might_contain("alpha") and a.might_contain("bravo")


# ---------------------------------------------------------------------------
# range index probe: bounds intersection, conservative defaults
# ---------------------------------------------------------------------------

def _num_stats(lo, hi, prunable=True):
    return KeyStats(any_notnull=True, rnum_min=lo, rnum_max=hi,
                    rnum_prunable=prunable)


def test_range_probe_interval_logic():
    s = _num_stats(10.0, 20.0)
    assert REGISTRY.term_possible(between("k", 15, 30), s)
    assert REGISTRY.term_possible(between("k", 20, 25), s)   # touches max
    assert not REGISTRY.term_possible(between("k", 21, 25), s)
    assert not REGISTRY.term_possible(rng("k", hi=9.5), s)
    assert REGISTRY.term_possible(rng("k", lo=20.0), s)
    # exclusive query bounds still probe the closed summary interval
    # (conservative: the summary cannot distinguish open endpoints)
    assert REGISTRY.term_possible(rng("k", lo=20.0, lo_incl=False), s)
    # unprunable (format-5 restore) never refutes
    assert REGISTRY.term_possible(between("k", 999, 1000),
                                  _num_stats(10.0, 20.0, prunable=False))
    # empty fold (no range-matchable values seen) refutes every range
    assert not REGISTRY.term_possible(
        between("k", 0, 1e9),
        KeyStats(any_notnull=True, rnum_prunable=True))


def test_conservative_bounds_and_fold_universe():
    lo, hi = conservative_bounds(2**53 + 1)       # not f64-exact: widened
    assert lo < 2**53 + 1 < hi
    assert conservative_bounds(10) == (10.0, 10.0)
    assert range_fold_value(True) is None         # bools never match RANGE
    assert range_fold_value(None) is None
    assert range_fold_value("10") == 10.0         # cross-representation
    assert range_fold_value("007") is None        # not a JSON number
    assert range_fold_value(float("nan")) is None  # NaN matches no range


# ---------------------------------------------------------------------------
# format-5 -> format-6 migration: stripped fields degrade, never refute
# ---------------------------------------------------------------------------

def test_format5_summary_restores_conservative():
    ks = _KeySummary()
    _fold(ks, (10, 250, "tok03 event", "30"), 4096)
    obj = ks.to_obj()
    for k in ("rmin", "rmax", "rmin_inf", "rmax_inf", "rnum_prunable",
              "ngram"):
        assert k in obj                            # format-6 writes them
        obj.pop(k)
    old = _KeySummary.from_obj(obj)                # format-5 block
    assert old.rnum_prunable is False and old.ngram is None
    # migrated range bounds never refute (no fold state to trust) —
    # membership pruning via the legacy value set stays, and is sound
    for t in (between("k", 10**6, 10**6 + 1), rng("k", hi=-1e9),
              between("k", 25, 35)):
        assert REGISTRY.term_possible(t, old.stats())
    assert REGISTRY.term_possible(in_list("k", [10]), old.stats())
    # whereas the full format-6 restore keeps its pruning power
    new = _KeySummary.from_obj(ks.to_obj())
    assert new.stats().rnum_prunable is True
    assert not REGISTRY.term_possible(between("k", 10**6, 10**6 + 1),
                                      new.stats())
    assert not REGISTRY.term_possible(substring("k", "zzqxv"), new.stats())
    assert REGISTRY.term_possible(substring("k", "tok03"), new.stats())
    assert REGISTRY.term_possible(between("k", 25, 35), new.stats())


# ---------------------------------------------------------------------------
# cache / pushdown key discipline (type-strict, no cross-kind aliasing)
# ---------------------------------------------------------------------------

def test_new_kinds_type_strict_keys():
    assert in_list("k", [10]) != in_list("k", [10.0])
    assert hash(in_list("k", [10])) != hash(in_list("k", [10.0]))
    assert in_list("k", [1]) != in_list("k", [True])
    assert between("k", 10, 20) != between("k", 10.0, 20)
    assert between("k", 10, 20) != rng("k", 10, 20, lo_incl=False)
    # no cross-kind aliasing between kinds sharing a value shape
    assert in_list("k", [10, 20]) != Query  # sanity: different types
    assert key_value("k", 10) != in_list("k", [10])
    assert clause(between("k", 10, 20)) != clause(in_list("k", [10, 20]))


def test_pushed_in_covers_range_and_in_exactly():
    c_rng = clause(between("k", 10, 20))
    c_in = clause(in_list("k", [1, 2]))
    plan = PushdownPlan(clauses=[c_rng, c_in])
    assert plan.pushed_in(Query((c_rng,))) == [0]
    # ids come back in query clause order
    assert plan.pushed_in(Query((c_in, c_rng))) == [1, 0]
    # float-aliased bounds / elements are DIFFERENT predicates: no cover
    assert plan.pushed_in(Query((clause(between("k", 10.0, 20)),))) == []
    assert plan.pushed_in(Query((clause(in_list("k", [1.0, 2])),))) == []
    assert plan.pushed_in(
        Query((clause(rng("k", 10, 20, hi_incl=False)),))) == []


def _mini_store(objs):
    recs = [json.dumps(o, separators=(",", ":")).encode() for o in objs]
    fam = PlanFamily(plan=PushdownPlan(clauses=[clause(key_value("s", 1)),
                                                clause(key_value("s", 2))]),
                     tier_sizes=(1, 2))
    store = CiaoStore(fam, segment_capacity=8)
    eng = NumpyEngine()
    chunk = encode_chunk(recs)
    bv = eng.eval_fused_prefix(chunk, fam.plan.clauses, 2)
    store.ingest_chunk(chunk, bv, epoch=0, tier=1)
    return store


_ALIAS_OBJS = [{"k": 10, "s": 1}, {"k": 10, "s": 2}, {"k": "10", "s": 1},
               {"k": 10.0, "s": 3}, {"k": 10.5, "s": 1}, {"k": 2, "s": 2},
               {"k": "10.0", "s": 1}, {"k": True, "s": 2}]

_ALIAS_QUERIES = [
    Query((clause(in_list("k", [10])),)),
    Query((clause(in_list("k", [10.0])),)),
    Query((clause(between("k", 10, 10)),)),
    Query((clause(rng("k", 10, 11, hi_incl=False)),)),
    Query((clause(key_value("k", 10)),)),
    Query((clause(in_list("k", [True, 2])),)),
]


@pytest.mark.parametrize("reverse", [False, True])
def test_result_cache_no_aliasing_across_new_kinds(reverse):
    """Cold+warm cached counts == oracle for every query, both scan
    orders: IN/RANGE/KEY_VALUE twins over aliasing value reprs must hit
    only their own cache entries."""
    store = _mini_store(_ALIAS_OBJS)
    queries = list(reversed(_ALIAS_QUERIES)) if reverse else _ALIAS_QUERIES
    cache = ResultCache()
    bat = ScanBatcher(store, cache=cache, log_queries=False)
    cold = bat.scan_batch(queries)
    assert cache.misses >= len(queries) and cache.hits == 0
    warm = bat.scan_batch(queries)
    assert cache.hits >= len(queries)
    for q, rc, rw in zip(queries, cold, warm):
        oracle = sum(1 for o in _ALIAS_OBJS if q.matches_exact(o))
        assert rc.count == oracle == rw.count, q.describe()


# ---------------------------------------------------------------------------
# differential sweep: lowering exactness + pruning soundness on
# adversarial values (hypothesis shim when the real package is absent)
# ---------------------------------------------------------------------------

_ADVERSARIAL_VALUES = [
    0, -0.0, 0.0, 1, -1.5, 0.1, 10, 10.0, 2**53, 2**53 + 1, -(2**53) - 1,
    1e308, True, False, None, "", "10", "10.0", "007", "1e3", "a",
    "café", "日本語テスト", "session tok03 event", "naïve café",
]

_SWEEP_PREDS = [
    between("k", 0, 10), between("k", 2**53, 2**53 + 1),
    between("k", -1, -0.0), rng("k", lo=-0.5, lo_incl=False),
    rng("k", hi=0.0), rng("k", 9.5, 10.5), rng("k", 0, 0),
    rng("k", lo=1e307), rng("k", 999, 1001),
    in_list("k", [10]), in_list("k", [10.0, "10"]), in_list("k", [True]),
    in_list("k", [None, ""]), in_list("k", [2**53 + 1, -0.0]),
    substring("k", "é"), substring("k", "本語"), substring("k", "10"),
    substring("k", "fé c"), substring("k", "tok03"),
    exact("k", "café"), exact("k", ""), key_value("k", 10),
]


@settings(max_examples=120, deadline=None)
@given(st.lists(st.sampled_from(_ADVERSARIAL_VALUES), min_size=1,
                max_size=10),
       st.integers(min_value=0, max_value=len(_SWEEP_PREDS) - 1))
def test_sweep_lowering_and_pruning_vs_exact_oracle(values, pi):
    pred = _SWEEP_PREDS[pi]
    objs = [{"k": v} for v in values]
    seg = _segment(objs)
    q = Query((clause(pred),))
    oracle = [bool(q.matches_exact(o)) for o in objs]
    mask = query_mask(seg, q)
    if mask is None:                   # zone-pruned: must be sound
        assert not any(oracle), (values, pred.describe())
    else:
        assert list(map(bool, mask)) == oracle, (values, pred.describe())
    # segment zone probe soundness (column-level)
    col = seg.key_col("k")
    if col is not None and not _term_possible(col, pred):
        assert not any(oracle), (values, pred.describe())
    # shard summary probe soundness — small cap forces the saturated
    # membership path while range bounds + bloom stay active
    ks = _KeySummary()
    _fold(ks, values, 4)
    if not REGISTRY.term_possible(pred, ks.stats()):
        assert not any(oracle), (values, pred.describe())


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(_ADVERSARIAL_VALUES), min_size=1,
                max_size=8),
       st.lists(st.sampled_from(_ADVERSARIAL_VALUES), min_size=1,
                max_size=3))
def test_sweep_in_list_equals_or_of_key_values(values, elements):
    """IN is exactly the OR of per-element KEY_VALUE semantics at every
    level that evaluates rows."""
    elements = [e for e in elements if not isinstance(e, (list, dict))]
    if not elements:
        elements = [0]
    pred = in_list("k", elements)
    objs = [{"k": v} for v in values]
    kvs = [key_value("k", e) for e in elements]
    for o in objs:
        assert pred.matches_exact(o) == any(t.matches_exact(o)
                                            for t in kvs), (o, elements)
    seg = _segment(objs)
    mask = query_mask(seg, Query((clause(pred),)))
    want = [any(t.matches_exact(o) for t in kvs) for o in objs]
    if mask is None:
        assert not any(want)
    else:
        assert list(map(bool, mask)) == want


# ---- held against the JAX package on the same inputs

def _j_pred(p):
    return j_pred.clause_from_obj(json.loads(json.dumps(
        clause_to_obj(clause(p))))).terms[0]


def test_ngram_bloom_bits_match_jax():
    """``add_many`` (the port's batch) sets the JAX bloom's bits exactly,
    and both refute the same needles."""
    ours, theirs = NGramBloom(), j_skip.NGramBloom()
    ours.add_many(_BLOOM_STRS)
    for s in _BLOOM_STRS:
        theirs.add(s)
    assert np.array_equal(ours.bits, theirs.bits)
    assert ours.to_hex() == theirs.to_hex()
    for needle in ("zzqxv", "語本日", "tok03", "café", "ab", "x" * 5):
        assert ours.might_contain(needle) == theirs.might_contain(needle)


@pytest.mark.parametrize("cap", [4, 4096])
def test_key_summary_matches_jax(cap):
    """The port's summary, folded the port's way, serialises and probes
    as the JAX package's on the adversarial values."""
    ours, theirs = _KeySummary(), j_shard._KeySummary()
    _fold(ours, _ADVERSARIAL_VALUES, cap)
    for v in _ADVERSARIAL_VALUES:
        theirs.add(v, cap)
    assert json.dumps(ours.to_obj(), sort_keys=True) == \
        json.dumps(theirs.to_obj(), sort_keys=True)
    for p in _SWEEP_PREDS:
        assert REGISTRY.term_possible(p, ours.stats()) == \
            j_skip.REGISTRY.term_possible(_j_pred(p), theirs.stats()), \
            p.describe()


@pytest.mark.parametrize("pred", _SWEEP_PREDS,
                         ids=[p.describe() for p in _SWEEP_PREDS])
def test_sweep_masks_match_jax(pred):
    """Every sweep predicate over every adversarial value: the port's
    mask (or zone refutation) is the JAX package's."""
    objs = [{"k": v} for v in _ADVERSARIAL_VALUES]
    recs = [json.dumps(o, separators=(",", ":")).encode() for o in objs]
    empty = bitvector.pack(np.zeros((0, len(objs)), bool))
    seg = ColumnarSegment(records=recs, bitvectors=empty, epoch=0,
                          n_covered=0, tier=0)
    jseg = j_columnar.ColumnarSegment(records=recs, bitvectors=empty,
                                      epoch=0, n_covered=0, tier=0)
    got = query_mask(seg, Query((clause(pred),)))
    want = j_columnar.query_mask(jseg, j_pred.Query((j_pred.clause(
        _j_pred(pred)),)))
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got, want)
