"""The port's predicate semantics (``repro_torch.core.predicates``) held
against the JAX package's (``tests/test_predicates.py``).

Every pattern string, raw match and exact match of the reference tests is
taken in both packages and must be equal, and so must every predicate's
identity (equality and hashing of the same values); the no-false-negative
sweep draws its records and predicates once and builds them in both.
"""
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro.core import predicates as J  # noqa: E402
from repro_torch.core import predicates as T  # noqa: E402

PKGS = (T, J)


def test_pattern_strings_match_paper_table1():
    for m in PKGS:
        assert m.exact("name", "Bob").patterns() == (b'"Bob"',)
        assert m.substring("text", "delicious").patterns() == (b"delicious",)
        assert m.presence("email").patterns() == (b'"email"',)
        assert m.key_value("age", 10).patterns() == (b'"age"', b"10")


def test_exact_match_raw():
    rec = b'{"name":"Bob","age":22}'
    rec2 = b'{"nickname":"Bob","name":"Al"}'
    for m in PKGS:
        assert m.exact("name", "Bob").matches_raw(rec)
        assert not m.exact("name", "Alice").matches_raw(rec)
        # false positive by design: value appears under another key
        assert m.exact("name", "Bob").matches_raw(rec2)


def test_key_value_segment_semantics():
    rec = b'{"age":10,"score":22}'
    for m in PKGS:
        assert m.key_value("age", 10).matches_raw(rec)
        assert not m.key_value("age", 22).matches_raw(rec)  # beyond the comma
        assert m.key_value("score", 22).matches_raw(rec)
        # last pair closed by }
        assert m.key_value("score", 2).matches_raw(rec)  # substring: FP ok


def test_predicate_equality_is_type_strict():
    # Python's 10 == 10.0 == True-style cross-type equality must NOT leak
    # into predicate identity (the reference's regression: a cached
    # ``score = 10`` mask answered a later ``score = 10.0`` scan)
    for m in PKGS:
        kv = m.key_value
        assert kv("a", 10) == kv("a", 10)
        assert kv("a", 10) != kv("a", 10.0)
        assert kv("a", 1) != kv("a", True)
        assert kv("a", 0) != kv("a", False)
        assert hash(kv("a", 10)) != hash(kv("a", 10.0))
        assert hash(kv("a", 1)) != hash(kv("a", True))
        assert m.clause(kv("a", 10)) != m.clause(kv("a", 10.0))
        # row semantics really do differ across the alias
        assert kv("a", 10).matches_exact({"a": "10"})
        assert not kv("a", 10.0).matches_exact({"a": "10"})
        assert kv("a", True).matches_exact({"a": True})
        assert not kv("a", 1).matches_exact({"a": True})
    # the same identity in both: a port clause read back by the JAX package
    for v in (10, 10.0, 1, True, 0, False):
        obj = T.clause_to_obj(T.clause(T.key_value("a", v)))
        assert J.clause_from_obj(obj) == J.clause(J.key_value("a", v))


def test_key_value_multiple_key_occurrences():
    # key string also appears inside a text field before the real pair
    rec = b'{"text":"age is a number","age":7}'
    for m in PKGS:
        assert m.key_value("age", 7).matches_raw(rec)


def test_clause_disjunction():
    for m in PKGS:
        c = m.clause(m.exact("name", "Bob"), m.exact("name", "John"))
        assert c.matches_raw(b'{"name":"John"}')
        assert c.matches_raw(b'{"name":"Bob"}')
        assert not c.matches_raw(b'{"name":"Alice"}')


def test_exact_semantics_on_parsed():
    for m in PKGS:
        q = m.query(m.clause(m.key_value("age", 10)),
                    m.clause(m.presence("email")))
        assert q.matches_exact({"age": 10, "email": "x@y.z"})
        assert not q.matches_exact({"age": 10})
        assert not q.matches_exact({"age": 11, "email": "x@y.z"})


_KEYS = ["alpha", "beta", "gamma", "text", "num"]


@st.composite
def json_record(draw):
    obj = {}
    for k in draw(st.lists(st.sampled_from(_KEYS), unique=True, min_size=1)):
        kind = draw(st.integers(0, 2))
        if kind == 0:
            obj[k] = draw(st.integers(0, 99))
        elif kind == 1:
            obj[k] = draw(st.text(alphabet="abcdef ", min_size=0, max_size=12))
        else:
            obj[k] = draw(st.booleans())
    return obj


@st.composite
def simple_predicate(draw):
    """(kind, key, value): built in either package by :func:`_build`."""
    k = draw(st.sampled_from(_KEYS))
    kind = draw(st.integers(0, 3))
    if kind == 0:
        return ("exact", k, draw(st.text(alphabet="abcdef", min_size=1,
                                         max_size=6)))
    if kind == 1:
        return ("substring", k, draw(st.text(alphabet="abcdef ", min_size=1,
                                             max_size=6)))
    if kind == 2:
        return ("presence", k)
    return ("key_value", k, draw(st.integers(0, 99)))


def _build(m, spec):
    return getattr(m, spec[0])(*spec[1:])


@given(st.lists(json_record(), min_size=1, max_size=20),
       st.lists(simple_predicate(), min_size=1, max_size=8))
@settings(max_examples=200, deadline=None)
def test_no_false_negatives(objs, specs):
    """THE invariant (paper §IV-B): exact-match => raw pattern-match; and
    both matches the JAX package's on every record and predicate."""
    for obj in objs:
        rec = json.dumps(obj, separators=(",", ":")).encode()
        for spec in specs:
            p, jp = _build(T, spec), _build(J, spec)
            assert p.patterns() == jp.patterns()
            assert p.matches_exact(obj) == jp.matches_exact(obj)
            assert p.matches_raw(rec) == jp.matches_raw(rec)
            if p.matches_exact(obj):
                assert p.matches_raw(rec), (obj, p.describe())
