"""Predicate AST and pattern-string compilation (paper §IV).

CIAO supports four predicate kinds, each compiled to one or two *pattern
strings* that a client can evaluate by raw substring search over JSON bytes
(no parsing).  Client evaluation may produce false positives (a query
re-verifies on parsed values at scan time) but NEVER false negatives — this
is the invariant the whole system rests on, and the one our property tests
enforce.

Terminology follows the paper:
  * ``SimplePredicate`` — one string-matchable SQL predicate (Table I).
  * ``Clause`` — a disjunction of simple predicates; the *atomic unit* of
    pushdown (paper §V-A: each conjunctive clause is pushed whole or not at
    all, because pushing one disjunct of an IN-list cannot filter tuples).
  * ``Query`` — a conjunction of clauses.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from typing import Any, Iterable, Sequence


class Kind(enum.Enum):
    EXACT = "exact"             # name = "Bob"          -> pattern '"Bob"'
    SUBSTRING = "substring"     # text LIKE "%x%"       -> pattern 'x'
    KEY_PRESENCE = "presence"   # email != NULL         -> pattern '"email"'
    KEY_VALUE = "key_value"     # age = 10              -> patterns '"age"', '10'
    RANGE = "range"             # 10 <= age < 20        -> pattern '"age"'
    IN = "in"                   # age IN (1, 2, 3)      -> pattern '"age"'


def _enc(s: str) -> bytes:
    return s.encode("utf-8")


def _strict_key(v: Any):
    """Hashable key carrying the value AND its type, recursively.

    ``10 == 10.0 == True`` under Python equality, and for composite
    values ``(10,) == (10.0,)`` — so RANGE bound tuples and IN element
    tuples must be keyed per-element as ``(type, value)`` pairs or two
    semantically different predicates would share cache slots
    (``ResultCache``, ``PushdownPlan.pushed_in``, clause-mask memos).
    """
    if isinstance(v, tuple):
        return ("t",) + tuple(_strict_key(e) for e in v)
    return (type(v), v)


@dataclass(frozen=True, eq=False)
class SimplePredicate:
    """One string-matchable predicate over a JSON record."""

    kind: Kind
    key: str
    value: Any = None  # str | int | float | bool | None

    # Equality is TYPE-STRICT on the value: Python's cross-type numeric
    # equality (10 == 10.0 == True) would alias predicates whose exact
    # semantics differ — ``json_scalar(10)`` is "10" but
    # ``json_scalar(10.0)`` is "10.0", so ``score = 10`` matches a string
    # row "10" while ``score = 10.0`` does not.  Clause caches and the
    # pushed-clause lookup (``PushdownPlan.pushed_in``) key on predicate
    # equality, so aliasing would let an earlier query's cached mask or
    # bitvector answer a later, semantically different one.  Strictness
    # recurses into tuple values (RANGE bounds, IN elements) via
    # ``_strict_key``: ``IN (10,)`` and ``IN (10.0,)`` differ the same
    # way the scalars do.
    def __eq__(self, other: object):
        if not isinstance(other, SimplePredicate):
            return NotImplemented
        return (self.kind is other.kind and self.key == other.key
                and _strict_key(self.value) == _strict_key(other.value))

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.kind, self.key, _strict_key(self.value)))
            object.__setattr__(self, "_hash", h)
        return h

    # ---- pattern compilation (paper Table I) -------------------------------
    def patterns(self) -> tuple[bytes, ...]:
        # Memoized per instance (predicates are frozen): the client hot
        # path calls this per (record, term) and byte-encoding the same
        # strings every call dominated `matches_raw` on short records.
        pats = self.__dict__.get("_patterns")
        if pats is None:
            pats = self._compile_patterns()
            object.__setattr__(self, "_patterns", pats)
        return pats

    def _compile_patterns(self) -> tuple[bytes, ...]:
        if self.kind is Kind.EXACT:
            # Exact string match: operand string including JSON quotes.
            return (_enc(f'"{self.value}"'),)
        if self.kind is Kind.SUBSTRING:
            return (_enc(str(self.value)),)
        if self.kind is Kind.KEY_PRESENCE:
            return (_enc(f'"{self.key}"'),)
        if self.kind is Kind.KEY_VALUE:
            return (_enc(f'"{self.key}"'), _enc(_json_scalar(self.value)))
        if self.kind in (Kind.RANGE, Kind.IN):
            # A value pattern cannot express a range or a disjunction of
            # encodings, so the client degrades to key presence — more
            # false positives, never a false negative (the invariant all
            # four engines share); the server's exact residual catches
            # the rest.
            return (_enc(f'"{self.key}"'),)
        raise AssertionError(self.kind)

    # ---- client-side semantics (string search, false-positive tolerant) ----
    def matches_raw(self, record: bytes) -> bool:
        """Paper-faithful ``string::find`` evaluation on raw JSON bytes."""
        pats = self.patterns()
        if self.kind is Kind.KEY_VALUE:
            key_pat, val_pat = pats
            # Search every occurrence of the key; for each, look for the
            # value between the end of the key and the next delimiter
            # (',' or '}').  Checking every occurrence (not just the first)
            # is required to keep the no-false-negative invariant when the
            # key string also appears inside a text field.
            # Values that themselves contain a delimiter could be cut short
            # by the segment search and yield a false negative; for those we
            # degrade to "value appears anywhere after the key" (more false
            # positives, never a false negative).
            unbounded = b"," in val_pat or b"}" in val_pat
            start = record.find(key_pat)
            while start != -1:
                seg_start = start + len(key_pat)
                if unbounded:
                    seg_end = len(record)
                else:
                    c = record.find(b",", seg_start)
                    b = record.find(b"}", seg_start)
                    cands = [x for x in (c, b) if x != -1]
                    seg_end = min(cands) if cands else len(record)
                if record.find(val_pat, seg_start, seg_end) != -1:
                    return True
                start = record.find(key_pat, start + 1)
            return False
        return pats[0] in record

    # ---- exact semantics on a parsed record (server-side verification) -----
    def matches_exact(self, obj: dict) -> bool:
        if self.kind is Kind.KEY_PRESENCE:
            return self.key in obj and obj[self.key] is not None
        if self.key not in obj:
            return False
        v = obj[self.key]
        if self.kind is Kind.RANGE:
            return range_contains(self.value, v)
        if self.kind is Kind.IN:
            # OR of per-element KEY_VALUE semantics (type-strict, §IV-B
            # cross-representation equality per element).
            return any(_kv_matches(v, e) for e in self.value)
        # bool/number equality across representations is unsupported (paper
        # §IV-B excludes e.g. 2.4 vs 24e-1 for the same reason: the raw
        # pattern cannot match, so allowing it would be a false negative).
        if isinstance(v, bool) != isinstance(self.value, bool):
            return False
        if self.kind is Kind.EXACT:
            return v == self.value
        if self.kind is Kind.SUBSTRING:
            return isinstance(v, str) and str(self.value) in v
        if self.kind is Kind.KEY_VALUE:
            return v == self.value or _json_scalar(self.value) == _json_scalar(v)
        raise AssertionError(self.kind)

    def pattern_length(self) -> int:
        return sum(len(p) for p in self.patterns())

    def describe(self) -> str:
        if self.kind is Kind.EXACT:
            return f'{self.key} = "{self.value}"'
        if self.kind is Kind.SUBSTRING:
            return f'{self.key} LIKE "%{self.value}%"'
        if self.kind is Kind.KEY_PRESENCE:
            return f"{self.key} != NULL"
        if self.kind is Kind.RANGE:
            lo, hi, lo_i, hi_i = self.value
            parts = []
            if lo is not None:
                parts.append(f"{self.key} >{'=' if lo_i else ''} "
                             f"{_json_scalar(lo)}")
            if hi is not None:
                parts.append(f"{self.key} <{'=' if hi_i else ''} "
                             f"{_json_scalar(hi)}")
            return " AND ".join(parts)
        if self.kind is Kind.IN:
            vals = ", ".join(_json_scalar(e) for e in self.value)
            return f"{self.key} IN ({vals})"
        return f"{self.key} = {_json_scalar(self.value)}"


def _kv_matches(v: Any, pv: Any) -> bool:
    """One KEY_VALUE disjunct of an IN list: exact §IV-B equality of a
    row value ``v`` against a probe element ``pv``."""
    if isinstance(v, bool) != isinstance(pv, bool):
        return False
    return v == pv or _json_scalar(pv) == _json_scalar(v)


def range_contains(bounds: tuple, v: Any) -> bool:
    """Exact RANGE semantics: does row value ``v`` fall in ``bounds``?

    ``bounds`` is ``(lo, hi, lo_incl, hi_incl)`` with ``None`` for an
    open side.  Numeric rows (bool excluded) compare directly — Python
    comparisons between huge ints and float bounds are exact, and NaN
    fails every comparison so it never matches.  String rows match iff
    they parse as a JSON number in range (the cross-representation rule:
    ``"10"`` satisfies ``score BETWEEN 5 AND 15`` just as KEY_VALUE's
    ``score = 10`` matches the string row ``"10"``).  Everything else
    (bool, None, objects) never matches.
    """
    lo, hi, lo_i, hi_i = bounds
    if isinstance(v, bool) or v is None:
        return False
    if isinstance(v, (int, float)):
        x = v
    elif isinstance(v, str):
        x = json_number(v)
        if x is None:
            return False
    else:
        return False
    if lo is not None and not (x > lo or (lo_i and x == lo)):
        return False
    if hi is not None and not (x < hi or (hi_i and x == hi)):
        return False
    return True


_JSON_NUMBER_CACHE: dict[str, Any] = {}
_JSON_NUMBER_CACHE_CAP = 4096


def json_number(s: str) -> "int | float | None":
    """Parse ``s`` as a JSON number; ``None`` if it is not one.

    This is THE rule deciding which strings participate in numeric RANGE
    semantics — shared by ``matches_exact``, the vectorized lowering, and
    both summary levels so they can never disagree.  ``json.loads`` keeps
    int parses arbitrary-precision (huge ints stay exact) and rejects
    non-JSON spellings like ``"007"`` or ``"1_0"``; Python's reader also
    accepts the ``NaN``/``Infinity`` extended tokens, which is fine — NaN
    fails every range and infinities compare correctly.  Memoized with a
    fresh-dict eviction (concurrent scan threads may hold the old dict).
    """
    global _JSON_NUMBER_CACHE
    if s in _JSON_NUMBER_CACHE:
        return _JSON_NUMBER_CACHE[s]
    try:
        v = json.loads(s)
    except Exception:
        v = None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        v = None
    if len(_JSON_NUMBER_CACHE) >= _JSON_NUMBER_CACHE_CAP:
        _JSON_NUMBER_CACHE = {}
    _JSON_NUMBER_CACHE[s] = v
    return v


def _json_scalar(v: Any) -> str:
    """Render a scalar the way our JSON writer renders it (for pattern gen)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    return str(v)


# public alias: the columnar scan engine dictionary-encodes json_scalar(v)
# per key (the "repr column"), which is what keeps KEY_VALUE's
# cross-representation equality exact without per-row parsing
json_scalar = _json_scalar


def lowerable(p: SimplePredicate) -> bool:
    """True iff ``p`` can be lowered to vectorized columnar evaluation.

    The lowering (``repro_torch.core.columnar.eval_lowered``) reproduces
    ``matches_exact`` bit for bit over struct-of-arrays columns, but only
    for the value shapes it models: scalar JSON values.  Anything else
    (non-string EXACT operands, exotic KEY_VALUE value objects) falls
    back to the per-row exact oracle — never evaluated wrong, just not
    vectorized.
    """
    if p.kind in (Kind.KEY_PRESENCE, Kind.SUBSTRING):
        return True
    if p.kind is Kind.EXACT:
        return isinstance(p.value, str)
    if p.kind is Kind.KEY_VALUE:
        return p.value is None or isinstance(p.value, (str, int, float, bool))
    if p.kind is Kind.RANGE:
        return True
    if p.kind is Kind.IN:
        return all(e is None or isinstance(e, (str, int, float, bool))
                   for e in p.value)
    return False


def clause_lowerable(c: Clause) -> bool:
    """True iff every disjunct of ``c`` lowers to columnar evaluation."""
    return all(lowerable(t) for t in c.terms)


@dataclass(frozen=True)
class Clause:
    """A disjunction of simple predicates — the atomic pushdown unit."""

    terms: tuple[SimplePredicate, ...]

    def __post_init__(self) -> None:
        if not self.terms:
            raise ValueError("empty clause")

    # Client semantics: valid iff ANY disjunct pattern-matches.
    def matches_raw(self, record: bytes) -> bool:
        return any(t.matches_raw(record) for t in self.terms)

    def matches_exact(self, obj: dict) -> bool:
        return any(t.matches_exact(obj) for t in self.terms)

    def patterns(self) -> tuple[tuple[bytes, ...], ...]:
        return tuple(t.patterns() for t in self.terms)

    def pattern_length(self) -> int:
        return sum(t.pattern_length() for t in self.terms)

    def describe(self) -> str:
        if len(self.terms) == 1:
            return self.terms[0].describe()
        return "(" + " OR ".join(t.describe() for t in self.terms) + ")"

    # Clauses are dict keys throughout the optimizer.
    def __hash__(self) -> int:  # pragma: no cover - trivial
        return hash(self.terms)


@dataclass(frozen=True)
class Query:
    """A conjunction of clauses with a workload frequency weight."""

    clauses: tuple[Clause, ...]
    freq: float = 1.0

    def matches_exact(self, obj: dict) -> bool:
        return all(c.matches_exact(obj) for c in self.clauses)

    def describe(self) -> str:
        return " AND ".join(c.describe() for c in self.clauses)


# ---------------------------------------------------------------------------
# convenience constructors
# ---------------------------------------------------------------------------

def exact(key: str, value: str) -> SimplePredicate:
    return SimplePredicate(Kind.EXACT, key, value)


def substring(key: str, value: str) -> SimplePredicate:
    return SimplePredicate(Kind.SUBSTRING, key, value)


def presence(key: str) -> SimplePredicate:
    return SimplePredicate(Kind.KEY_PRESENCE, key)


def key_value(key: str, value: Any) -> SimplePredicate:
    return SimplePredicate(Kind.KEY_VALUE, key, value)


def rng(key: str, lo: "int | float | None" = None,
        hi: "int | float | None" = None, *,
        lo_incl: bool = True, hi_incl: bool = True) -> SimplePredicate:
    """RANGE predicate: ``lo <(=) key <(=) hi`` (``None`` = open side)."""
    for b in (lo, hi):
        if b is None:
            continue
        if isinstance(b, bool) or not isinstance(b, (int, float)):
            raise TypeError(f"range bound must be numeric or None: {b!r}")
        if b != b:
            raise ValueError("NaN range bound")
    if lo is None and hi is None:
        raise ValueError("range needs at least one bound")
    return SimplePredicate(Kind.RANGE, key,
                           (lo, hi, bool(lo_incl), bool(hi_incl)))


def between(key: str, lo: "int | float", hi: "int | float"
            ) -> SimplePredicate:
    """SQL BETWEEN: both bounds inclusive."""
    return rng(key, lo, hi)


def in_list(key: str, values: Iterable[Any]) -> SimplePredicate:
    """IN-list predicate: OR of per-element KEY_VALUE equality."""
    vals = tuple(values)
    if not vals:
        raise ValueError("empty IN list")
    return SimplePredicate(Kind.IN, key, vals)


def clause(*terms: SimplePredicate) -> Clause:
    return Clause(tuple(terms))


def query(*clauses_: Clause | SimplePredicate, freq: float = 1.0) -> Query:
    cs = tuple(c if isinstance(c, Clause) else Clause((c,)) for c in clauses_)
    return Query(cs, freq=freq)


# ---------------------------------------------------------------------------
# JSON-safe (de)serialization — plan persistence (server checkpoints)
# ---------------------------------------------------------------------------

def predicate_to_obj(p: SimplePredicate) -> dict:
    v = p.value
    if isinstance(v, tuple):
        v = list(v)   # RANGE bounds / IN elements: JSON arrays
    return {"kind": p.kind.value, "key": p.key, "value": v}


def predicate_from_obj(d: dict) -> SimplePredicate:
    k = Kind(d["kind"])
    v = d.get("value")
    if k in (Kind.RANGE, Kind.IN) and isinstance(v, list):
        v = tuple(v)
    return SimplePredicate(k, d["key"], v)


def clause_to_obj(c: Clause) -> list[dict]:
    return [predicate_to_obj(t) for t in c.terms]


def clause_from_obj(terms: Sequence[dict]) -> Clause:
    return Clause(tuple(predicate_from_obj(t) for t in terms))


def all_patterns(clauses_: Iterable[Clause]) -> list[bytes]:
    """Flat, deduplicated pattern list for a set of clauses (kernel input)."""
    seen: dict[bytes, None] = {}
    for c in clauses_:
        for term_pats in c.patterns():
            for p in term_pats:
                seen.setdefault(p, None)
    return list(seen)
