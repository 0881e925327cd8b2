"""The fused single-pass pushdown on the port (``tests/test_fused.py``),
held against the JAX package.

The reference's engine-equivalence contract (DESIGN.md §4): every engine
must produce bit-identical packed bitvectors, load masks and popcounts,
and never a false negative against exact semantics.  Here the port's
engines (``PythonEngine``, ``NumpyEngine`` and ``KernelEngine("torch")``,
kernel A's plain version on the CPU) run each reference test's chunk and
plan, built from the same seeded numbers, and every output must equal
the JAX package's ``KernelEngine`` on ``"xla"`` and ``"pallas_interpret"``
exactly, and its Python oracle.

The reference's ``test_single_kernel_launch_per_chunk`` and
``test_hot_swap_same_bucket_epoch_no_retrace`` count ``pallas_call``
stagings under ``jit``; the port has no trace.  Their counterparts count
what the port does per chunk: one call of kernel A's plain version (one
launch of kernel A on the card, held by ``chip_smoke.py``'s kernel A
phase through ``fused.launches``) and one compiled plan per clause list,
reused on re-evaluation.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.kernels.engine import KernelEngine as JKernelEngine  # noqa: E402
from repro_torch.core import bitvector  # noqa: E402
from repro_torch.core.client import (  # noqa: E402
    NumpyEngine, PythonEngine, encode_chunk,
)
from repro_torch.core.predicates import (  # noqa: E402
    Clause, SimplePredicate, clause, clause_to_obj, exact, key_value,
    presence, substring,
)
from repro_torch.kernels.engine import KernelEngine, compile_plan  # noqa: E402

#: the JAX package's engines each port output is held against
JAX_BACKENDS = ("xla", "pallas_interpret")

_KEYS = ["name", "age", "tags", "city", "note"]
_WORDS = ["bob", "ann", "x", "par,is", "ab}c", "tok", "zz", "a b"]


def _random_record(rng) -> dict:
    obj = {}
    for k in _KEYS:
        if rng.random() < 0.4:
            continue
        r = rng.random()
        if r < 0.35:
            obj[k] = int(rng.integers(0, 30))
        elif r < 0.7:
            n = int(rng.integers(1, 4))
            obj[k] = " ".join(_WORDS[int(i)]
                              for i in rng.integers(0, len(_WORDS), n))
        elif r < 0.85:
            obj[k] = bool(rng.integers(0, 2))
        else:
            obj[k] = None
    return obj


def _random_term(rng) -> SimplePredicate:
    k = _KEYS[int(rng.integers(0, len(_KEYS)))]
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return exact(k, _WORDS[int(rng.integers(0, len(_WORDS)))])
    if kind == 1:
        return substring(k, _WORDS[int(rng.integers(0, len(_WORDS)))])
    if kind == 2:
        return presence(k)
    r = rng.random()
    if r < 0.4:
        return key_value(k, int(rng.integers(0, 30)))
    if r < 0.6:
        return key_value(k, bool(rng.integers(0, 2)))
    # delimiter-containing values exercise the unbounded degradation
    return key_value(k, _WORDS[int(rng.integers(0, len(_WORDS)))])


def _random_clauses(rng, n: int) -> list[Clause]:
    out = []
    for _ in range(n):
        terms = tuple(_random_term(rng)
                      for _ in range(int(rng.integers(1, 4))))
        out.append(Clause(terms))
    return out


def _jc(c):
    return j_pred.clause_from_obj(clause_to_obj(c))


def _jax_fused(recs, clauses, backend, **kw):
    """The JAX package's fused outputs for the same records and clauses."""
    return JKernelEngine(backend=backend, **kw).eval_fused(
        j_client.encode_chunk(recs), [_jc(c) for c in clauses])


def _same_fused(got, want, name="") -> None:
    assert np.array_equal(got.words, want.words), name
    assert np.array_equal(got.or_words, want.or_words), name
    assert np.array_equal(got.counts, want.counts), name


def _records(rng, n):
    objs = [_random_record(rng) for _ in range(n)]
    return objs, [json.dumps(o, separators=(",", ":")).encode() for o in objs]


@pytest.mark.parametrize("seed", range(6))
def test_differential_all_engines_bit_identical(seed):
    """Random chunks x random clause sets: all engines, same packed bits,
    the JAX package's on both its backends."""
    rng = np.random.default_rng(1000 + seed)
    objs, recs = _records(rng, 24)
    chunk = encode_chunk(recs)
    clauses = _random_clauses(rng, int(rng.integers(2, 7)))

    expected_fused = PythonEngine().eval_fused(chunk, clauses)
    for b in JAX_BACKENDS:
        _same_fused(expected_fused, _jax_fused(recs, clauses, b), b)
    for eng in (NumpyEngine(), KernelEngine(backend="torch")):
        fused = eng.eval_fused(chunk, clauses)
        _same_fused(fused, expected_fused, eng.name)
        assert fused.n_records == chunk.n_records
        # packed path must agree with the fused words exactly
        assert np.array_equal(eng.eval_packed(chunk, clauses), fused.words)

    # THE invariant (paper §IV-B): exact match on the parsed record
    # implies the client bit is set — false positives allowed, false
    # negatives never.
    bits = bitvector.unpack(expected_fused.words, chunk.n_records)
    for ci, cl in enumerate(clauses):
        for ri, obj in enumerate(objs):
            if cl.matches_exact(obj):
                assert bits[ci, ri], (cl.describe(), obj)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_multi_block_accumulation(backend):
    """Several record tiles per chunk: pack, load-mask OR and popcount
    accumulate correctly across blocks (and the word slice drops the
    padding tile), equal to the JAX package's at the same tile."""
    rng = np.random.default_rng(5)
    _, recs = _records(rng, 150)
    chunk = encode_chunk(recs)
    clauses = _random_clauses(rng, 5)
    expected = PythonEngine().eval_fused(chunk, clauses)
    fused = KernelEngine(backend="torch", r_blk=64).eval_fused(chunk, clauses)
    _same_fused(fused, expected)
    _same_fused(fused, _jax_fused(recs, clauses, backend, r_blk=64))


def test_empty_patterns_engines_agree():
    """Empty substring / empty key-value value: match-all / key-presence
    semantics, bit-identical across ALL engines of both packages."""
    recs = [b'{"note":"hi","age":3}', b'{"age":4}']
    chunk = encode_chunk(recs)
    cls = [clause(substring("note", "")), clause(key_value("note", ""))]
    expected = PythonEngine().eval(chunk, cls)
    assert expected[0].all()          # empty substring matches everything
    assert expected[1].tolist() == [True, False]  # '"note"' presence
    for eng in (NumpyEngine(), KernelEngine(backend="torch")):
        assert np.array_equal(eng.eval(chunk, cls), expected), eng.name
    jchunk = j_client.encode_chunk(recs)
    for b in JAX_BACKENDS:
        assert np.array_equal(JKernelEngine(backend=b).eval(
            jchunk, [_jc(c) for c in cls]), expected), b


def test_ops_clause_bitvectors_empty_plan():
    """The public ``kernels.clause_bitvectors`` handles degenerate inputs
    with the JAX package's shapes."""
    from repro.kernels import clause_bitvectors as j_cb
    from repro.kernels.plan import compile_plan as j_cp
    from repro_torch.kernels import clause_bitvectors
    from repro_torch.kernels.plan import compile_plan as cp

    data = encode_chunk([b'{"a":1}']).data
    empty = np.zeros((0, 128), np.uint8)
    got = [clause_bitvectors(data, cp([]), backend="torch"),
           clause_bitvectors(empty, cp([clause(presence("a"))]),
                             backend="torch")]
    words, or_words, counts = got[0]
    assert words.shape == (0, 1) and counts.shape == (0,)
    assert not or_words.any()
    words, or_words, counts = got[1]
    assert words.shape == (1, 0) and or_words.shape == (0,)
    assert counts.tolist() == [0]
    for b in JAX_BACKENDS:
        want = [j_cb(data, j_cp([]), backend=b),
                j_cb(empty, j_cp([j_pred.clause(j_pred.presence("a"))]),
                     backend=b)]
        for g, w in zip(got, want):
            for a, c in zip(g, w):
                assert a.shape == np.asarray(c).shape
                assert np.array_equal(a, np.asarray(c))


def test_ingest_mismatch_leaves_stats_untouched():
    """A rejected ingest must not corrupt n_records / selectivities; the
    JAX package's store rejects the same ingests and keeps the same
    state."""
    from repro.core import server as j_server
    from repro_torch.core.server import CiaoStore, PushdownPlan

    clauses = [clause(presence("age"))]
    stale = [clause(presence("age")), clause(presence("x"))]
    good_recs = [b'{"age":1}', b'{"age":2}']
    short_recs = [b'{"age":%d}' % i for i in range(40)]
    eng = KernelEngine(backend="torch")
    jeng = JKernelEngine(backend="xla")
    for pkg in ("port", "jax"):
        if pkg == "port":
            store = CiaoStore(PushdownPlan(clauses=clauses))
            e, enc, cl, st = eng, encode_chunk, clauses, stale
        else:
            store = j_server.CiaoStore(j_server.PushdownPlan(
                clauses=[_jc(c) for c in clauses]))
            e, enc = jeng, j_client.encode_chunk
            cl, st = [_jc(c) for c in clauses], [_jc(c) for c in stale]
        good = enc(good_recs)
        store.ingest_chunk(good, e.eval_fused(good, cl))
        before = (store.stats.n_records, store.clause_counts.copy())
        with pytest.raises(ValueError):
            store.ingest_chunk(enc([b'{"x":0}']), e.eval_fused(good, cl))
        # clause-dimension mismatch (stale client plan), both ingest forms
        with pytest.raises(ValueError):
            store.ingest_chunk(good, e.eval_fused(good, st))
        with pytest.raises(ValueError):
            store.ingest_chunk(good, e.eval_packed(good, st))
        # raw-array word width covering a different record count
        with pytest.raises(ValueError):
            store.ingest_chunk(enc(short_recs), e.eval_packed(good, cl))
        assert store.stats.n_records == before[0] == 2
        assert np.array_equal(store.clause_counts, before[1])
        assert before[1].tolist() == [2]


def test_wide_record_stride_no_false_negative():
    """Strides past the int16 sentinel must not wrap the position scan
    (the JAX oracle's regression): a key-value match near the end of a
    record wider than 0x7FFF bytes is found, as by the JAX package."""
    tail = b'"name":"bob","age":7}'
    rec = b'{"pad":"' + b"x" * 33000 + b'",' + tail
    recs = [rec, b'{"age":8}']
    chunk = encode_chunk(recs)
    assert chunk.stride > 0x7FFF
    clauses = [clause(key_value("age", 7))]
    expected = PythonEngine().eval(chunk, clauses)
    assert expected[0, 0]  # the match near the record end must be found
    out = KernelEngine(backend="torch").eval(chunk, clauses)
    assert np.array_equal(out, expected)
    jchunk = j_client.encode_chunk(recs)
    for b in JAX_BACKENDS:
        assert np.array_equal(JKernelEngine(backend=b).eval(
            jchunk, [_jc(c) for c in clauses]), expected), b


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_fused_edge_cases(backend):
    eng = KernelEngine(backend="torch")
    jeng = JKernelEngine(backend=backend)
    recs = [b'{"a":1}', b'{"b":2}']
    chunk, jchunk = encode_chunk(recs), j_client.encode_chunk(recs)
    # empty plan — every protocol method, including unpack-based eval
    fused = eng.eval_fused(chunk, [])
    assert fused.words.shape == (0, 1)
    assert fused.or_words.shape == (1,)
    assert not fused.or_words.any()
    _same_fused(fused, jeng.eval_fused(jchunk, []))
    assert eng.eval(chunk, []).shape == (0, 2) == jeng.eval(jchunk, []).shape
    assert eng.eval_packed(chunk, []).shape == (0, 1) == \
        jeng.eval_packed(jchunk, []).shape
    # empty chunk
    cl = [clause(presence("a"))]
    fused = eng.eval_fused(encode_chunk([]), cl)
    assert fused.words.shape == (1, 0)
    assert fused.counts.tolist() == [0]
    _same_fused(fused, jeng.eval_fused(j_client.encode_chunk([]),
                                       [_jc(c) for c in cl]))


def test_compile_plan_dedups_shared_disjuncts():
    """A disjunct shared by several clauses occupies ONE predicate slot;
    the compiled plan's tables are the JAX package's."""
    from repro.kernels.plan import compile_plan as j_cp

    shared = substring("note", "tok")
    cls = [clause(shared, presence("age")), clause(shared),
           clause(shared, key_value("age", 7))]
    plan = compile_plan(cls)
    assert plan.n_preds == 3  # shared, presence, key_value — not 5
    assert plan.membership.shape == (3, 3)
    assert plan.membership.sum() == 5
    assert plan.kinds.sum() == 1  # exactly one key-value predicate
    jplan = j_cp([_jc(c) for c in cls])
    for f in ("membership", "kinds"):
        assert np.array_equal(getattr(plan, f), np.asarray(getattr(jplan, f)))
    assert plan.n_preds == jplan.n_preds and plan.n_simple == jplan.n_simple


def test_numpy_engine_dedups_evaluation(monkeypatch):
    """NumpyEngine evaluates a shared disjunct once per chunk, not per
    clause, as the JAX package's does."""
    from repro_torch.core import client as client_mod

    shared = substring("note", "tok")
    cls = [clause(shared), clause(shared, presence("age")), clause(shared)]
    recs = [b'{"note":"a tok b","age":3}', b'{"note":"x"}']
    chunk = encode_chunk(recs)
    counts = {}
    for name, mod, engine, ch, cl in (
            ("port", client_mod, NumpyEngine, chunk, cls),
            ("jax", j_client, j_client.NumpyEngine,
             j_client.encode_chunk(recs), [_jc(c) for c in cls])):
        calls = []
        real = mod.eval_simple

        def counting(data, pred, _real=real, _calls=calls, **kw):
            _calls.append(pred)
            return _real(data, pred, **kw)

        monkeypatch.setattr(mod, "eval_simple", counting)
        out = engine().eval(ch, cl)
        counts[name] = len(calls)
        assert np.array_equal(out, PythonEngine().eval(chunk, cls)), name
    assert counts == {"port": 2, "jax": 2}  # shared + presence, 3 clauses


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_single_plain_call_per_chunk(backend, monkeypatch):
    """Counterpart of ``test_single_kernel_launch_per_chunk``: the whole
    plan, simple AND key-value mixed, is ONE call of kernel A's plain
    version per chunk (one launch on the card); re-evaluation compiles
    no new plan and makes one more call; the words are the JAX
    package's."""
    from repro_torch.kernels import engine as engine_mod
    from repro_torch.kernels import ops as ops_mod

    calls, compiled = [], []
    real_ref, real_compile = ops_mod.ref.clause_bitvectors_ref, \
        engine_mod.compile_plan

    def counting_ref(*a, **kw):
        calls.append(1)
        return real_ref(*a, **kw)

    def counting_compile(*a, **kw):
        compiled.append(1)
        return real_compile(*a, **kw)

    monkeypatch.setattr(ops_mod.ref, "clause_bitvectors_ref", counting_ref)
    monkeypatch.setattr(engine_mod, "compile_plan", counting_compile)
    rng = np.random.default_rng(7)
    _, recs = _records(rng, 41)
    chunk = encode_chunk(recs)
    # mixed plan: simple patterns + several distinct key-value pairs
    clauses = [
        clause(exact("name", "bob"), key_value("age", 7)),
        clause(key_value("age", 11)),
        clause(substring("note", "zz"), key_value("city", 3)),
        clause(presence("tags")),
    ]
    eng = KernelEngine(backend="torch")
    out1 = eng.eval_fused(chunk, clauses)
    assert (len(calls), len(compiled)) == (1, 1)
    out2 = eng.eval_fused(chunk, clauses)
    assert (len(calls), len(compiled)) == (2, 1), "re-evaluation recompiled"
    _same_fused(out1, out2)
    _same_fused(out1, PythonEngine().eval_fused(chunk, clauses))
    _same_fused(out1, _jax_fused(recs, clauses, backend))


@pytest.mark.parametrize("seed", range(3))
def test_differential_post_replan_plan_bit_identical(seed):
    """Engine equivalence must hold PER EPOCH: after a replan evolves the
    plan (dropped + surviving + fresh clauses, new local row order), every
    engine still produces the JAX package's bitvectors for the new
    epoch's clause list, and the plans' remaps are equal."""
    from repro.core import server as j_server
    from repro_torch.core.server import PushdownPlan, evolve_plan

    rng = np.random.default_rng(4000 + seed)
    _, recs = _records(rng, 24)
    chunk = encode_chunk(recs)
    clauses0 = _random_clauses(rng, 5)
    plan0 = PushdownPlan(clauses=clauses0)
    # replan: drop two, keep three (shuffled rows), push two fresh clauses
    survivors = [clauses0[4], clauses0[1], clauses0[2]]
    fresh = _random_clauses(rng, 2)
    plan1 = evolve_plan(plan0, survivors + fresh)
    assert plan1.remap_from(plan0).tolist()[:3] == [4, 1, 2]
    jplan0 = j_server.PushdownPlan(clauses=[_jc(c) for c in clauses0])
    jplan1 = j_server.evolve_plan(jplan0, [_jc(c) for c in survivors + fresh])
    assert np.array_equal(plan1.remap_from(plan0), jplan1.remap_from(jplan0))

    expected = PythonEngine().eval_fused(chunk, plan1.clauses)
    for eng in (NumpyEngine(), KernelEngine(backend="torch")):
        _same_fused(eng.eval_fused(chunk, plan1.clauses), expected, eng.name)
    for b in JAX_BACKENDS:
        _same_fused(expected, JKernelEngine(backend=b).eval_fused(
            j_client.encode_chunk(recs), jplan1.clauses), b)


def test_epoch_swap_compiles_one_plan_per_epoch(monkeypatch):
    """Counterpart of ``test_hot_swap_same_bucket_epoch_no_retrace``: a
    replan into the same shape bucket compiles the new epoch's plan once
    (nothing is traced or rebuilt), each epoch's evaluation is one plain
    call, and both epochs' words are the JAX package's."""
    from repro_torch.core.server import PushdownPlan, evolve_plan
    from repro_torch.kernels import engine as engine_mod
    from repro_torch.kernels import ops as ops_mod

    calls, compiled = [], []
    real_ref, real_compile = ops_mod.ref.clause_bitvectors_ref, \
        engine_mod.compile_plan
    monkeypatch.setattr(ops_mod.ref, "clause_bitvectors_ref",
                        lambda *a, **kw: calls.append(1) or real_ref(*a, **kw))
    monkeypatch.setattr(engine_mod, "compile_plan", lambda *a, **kw:
                        compiled.append(1) or real_compile(*a, **kw))
    rng = np.random.default_rng(11)
    _, recs = _records(rng, 37)
    chunk = encode_chunk(recs)
    plan0 = PushdownPlan(clauses=[
        clause(key_value("age", 7)), clause(presence("tags")),
    ])
    # same predicate count, same key, value in the same 8-byte width
    # bucket -> identical compiled shapes, different constants
    plan1 = evolve_plan(plan0, [
        clause(key_value("age", 23)), clause(presence("city")),
    ])
    p0, p1 = compile_plan(plan0.clauses), compile_plan(plan1.clauses)
    assert p0.membership.shape == p1.membership.shape
    compiled.clear()
    eng = KernelEngine(backend="torch")
    out0 = eng.eval_fused(chunk, plan0.clauses)
    out1 = eng.eval_fused(chunk, plan1.clauses)
    assert (len(calls), len(compiled)) == (2, 2)
    eng.eval_fused(chunk, plan0.clauses)
    assert (len(calls), len(compiled)) == (3, 2), "an epoch recompiled"
    for out, plan in ((out0, plan0), (out1, plan1)):
        _same_fused(out, PythonEngine().eval_fused(chunk, plan.clauses))
        _same_fused(out, _jax_fused(recs, plan.clauses, "pallas_interpret"))


def test_server_ingest_consumes_fused_outputs():
    """CiaoStore accepts ChunkBitvectors directly (no host OR re-reduce);
    the loaded rows and per-clause counts are the JAX package's store's
    on the same chunk."""
    from repro.core import server as j_server
    from repro_torch.core.server import CiaoStore, PushdownPlan

    rng = np.random.default_rng(3)
    _, recs = _records(rng, 60)
    chunk = encode_chunk(recs)
    clauses = _random_clauses(rng, 4)
    plan = PushdownPlan(clauses=clauses)
    eng = KernelEngine(backend="torch")

    s1 = CiaoStore(plan)
    s1.ingest_chunk(chunk, eng.eval_fused(chunk, plan.clauses))
    s2 = CiaoStore(plan)
    s2.ingest_chunk(chunk, eng.eval_packed(chunk, plan.clauses))
    assert s1.stats.n_loaded == s2.stats.n_loaded
    assert sum(b.n_rows for b in s1.blocks) == sum(b.n_rows for b in s2.blocks)
    for b1, b2 in zip(s1.blocks, s2.blocks):
        assert b1.rows == b2.rows
        assert np.array_equal(b1.bitvectors, b2.bitvectors)
    # per-clause popcounts feed the store's observed selectivities,
    # identically for the fused and the raw-array ingest path
    exact_counts = PythonEngine().eval(chunk, clauses).sum(axis=1)
    assert np.array_equal(s1.clause_counts, exact_counts)
    assert np.array_equal(s2.clause_counts, exact_counts)
    assert np.allclose(
        s1.observed_selectivities(), exact_counts / chunk.n_records)
    jplan = j_server.PushdownPlan(clauses=[_jc(c) for c in clauses])
    js = j_server.CiaoStore(jplan)
    jchunk = j_client.encode_chunk(recs)
    js.ingest_chunk(jchunk, JKernelEngine(backend="xla").eval_fused(
        jchunk, jplan.clauses))
    assert js.stats.n_loaded == s1.stats.n_loaded
    assert [b.rows for b in js.blocks] == [b.rows for b in s1.blocks]
    assert np.array_equal(js.clause_counts, s1.clause_counts)
    # n_records mismatch is rejected
    other = encode_chunk(recs[:10])
    with pytest.raises(ValueError):
        s1.ingest_chunk(other, eng.eval_fused(chunk, plan.clauses))
