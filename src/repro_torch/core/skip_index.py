"""Pluggable skipping-index registry (DESIGN.md §19).

Both pruning levels of the cascade — per-segment zone maps
(``repro_torch.core.columnar``) and per-shard partition summaries
(``repro_torch.core.shard.ShardSummary``) — used to share ONE hardcoded
refutation rule, ``term_possible_over``.  This module generalizes it to a
registry of *skipping indexes*, each declaring:

  * ``handles(pred)``   — which predicate kinds it can refute;
  * ``probe(pred, stats)`` — the conservative refutation itself (``False``
    only when PROVABLY no summarized row matches);
  * ``selectivity(pred)`` — a workload-free prior consumed by the CELF
    selection path (``tiered_celf`` via ``estimate_selectivities``) and
    the Replanner when no sample records are available;
  * ``build_cost_per_row`` — relative maintenance cost, surfaced in docs
    and stats so physical-design tooling can weigh index choices;
  * ``summary_to_obj``/``summary_from_obj`` — its slice of the checkpoint
    summary encoding (format-6 manifests; format-5 files simply lack the
    new fields and deserialize to "cannot refute" defaults).

The composition rule is conjunctive: a predicate is *possible* iff EVERY
index that handles it says possible (each probe is independently sound,
so their intersection is too); a predicate no index handles is always
possible.  Registered indexes:

``membership``
    The original rule — key presence, exact string/repr value-set
    membership (saturating past ``SUMMARY_VALUE_CAP`` at shard level),
    numeric min/max with NaN poisoning, and the PR-5 saturated-repr
    cross-representation guard.  Handles EXACT / SUBSTRING /
    KEY_PRESENCE / KEY_VALUE / IN (an IN list is possible iff ANY element
    is).

``range``
    RANGE predicates against dedicated *range bounds* ``rnum_min`` /
    ``rnum_max`` folded over every value the RANGE semantics can match:
    numeric rows (bool excluded) and strings parsing as JSON numbers via
    ``json_number`` — the exact same value universe ``range_contains``
    accepts, so the cross-representation trap cannot recur.  NaN never
    matches a range, so (unlike the membership zone map) NaN rows do not
    poison these bounds; non-float64-exact values fold with one-ulp
    widening (``conservative_bounds``), keeping refutation sound for
    huge ints.  Inclusivity is ignored (bounds treated closed): at worst
    one fewer refutation, never an unsound one.

``ngram``
    A tiny bloom filter over the byte-level 3-grams of every string
    value.  If ``needle in row_string`` then every 3-gram of the
    needle's UTF-8 encoding appears in the row string's encoding (UTF-8
    substring closure), so a SUBSTRING — or string-valued EXACT — probe
    whose grams are not all present can refute without evaluation.
    Unlike the value sets the bloom never saturates, which is what makes
    shard-level SUBSTRING pruning work past ``SUMMARY_VALUE_CAP``.
    Needles shorter than 3 bytes have no grams and are never refuted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .predicates import (
    Clause, Kind, SimplePredicate, json_number, json_scalar,
)

NGRAM_N = 3
_BLOOM_WORDS = 16          # 16 x uint64 = 1024 bits
_BLOOM_BITS = _BLOOM_WORDS * 64


def _gram_buckets(g: bytes) -> tuple[int, int]:
    """Two deterministic bucket indices for one 3-byte gram."""
    x = int.from_bytes(g, "big")
    h1 = (x * 2654435761) & 0xFFFFFFFF
    h2 = (x * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF
    return h1 % _BLOOM_BITS, h2 % _BLOOM_BITS


class NGramBloom:
    """1024-bit bloom filter over byte-level 3-grams of string values.

    Monotone-permissive like every other summary field (bits only get
    set), so the shard-level concurrency argument carries over; reads of
    a torn update can only fail to refute.
    """

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray | None = None):
        self.bits = (np.zeros(_BLOOM_WORDS, np.uint64)
                     if bits is None else np.asarray(bits, np.uint64))

    def add(self, s: str) -> None:
        b = s.encode("utf-8")
        bits = self.bits
        for i in range(len(b) - NGRAM_N + 1):
            for idx in _gram_buckets(b[i:i + NGRAM_N]):
                bits[idx >> 6] |= np.uint64(1 << (idx & 63))

    def add_many(self, strings) -> None:
        """:meth:`add` of every string in ``strings``, all their grams at
        once in numpy (a gram never spans two strings)."""
        bufs = [s.encode("utf-8") for s in strings]
        if not bufs:
            return
        lens = np.fromiter(map(len, bufs), np.int64, len(bufs))
        n_grams = np.maximum(lens - (NGRAM_N - 1), 0)
        total = int(n_grams.sum())
        if not total:
            return
        data = np.frombuffer(b"".join(bufs), np.uint8).astype(np.uint64)
        first = np.cumsum(lens) - lens             # each string's offset
        before = np.cumsum(n_grams) - n_grams      # grams of earlier ones
        pos = np.repeat(first - before, n_grams) + np.arange(total)
        x = (data[pos] << 16) | (data[pos + 1] << 8) | data[pos + 2]
        hit = np.zeros(_BLOOM_BITS, bool)
        hit[((x * 2654435761) & 0xFFFFFFFF) % _BLOOM_BITS] = True
        hit[((x * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF) % _BLOOM_BITS] = True
        self.bits |= np.packbits(hit, bitorder="little").view("<u8")

    def might_contain(self, needle: str) -> bool:
        """False only when NO summarized string can contain ``needle``."""
        b = needle.encode("utf-8")
        if len(b) < NGRAM_N:
            return True   # no grams to probe: cannot refute
        bits = self.bits
        for i in range(len(b) - NGRAM_N + 1):
            for idx in _gram_buckets(b[i:i + NGRAM_N]):
                if not (bits[idx >> 6] >> np.uint64(idx & 63)) & np.uint64(1):
                    return False
        return True

    def union(self, other: "NGramBloom") -> None:
        self.bits |= other.bits

    def to_hex(self) -> str:
        return self.bits.tobytes().hex()

    @classmethod
    def from_hex(cls, h: str) -> "NGramBloom":
        return cls(np.frombuffer(bytes.fromhex(h), np.uint64).copy())


def conservative_bounds(x) -> tuple[float, float]:
    """Float64 interval guaranteed to contain the exact numeric ``x``.

    Exact-representable values collapse to a point; anything float64
    would round (huge ints, >53-bit ints) widens one ulp each way, and
    values beyond float64 range clamp to the infinity on their side —
    so folding these bounds into a zone map can never exclude ``x``.
    """
    try:
        f = float(x)
    except (OverflowError, ValueError):
        return (np.inf, np.inf) if x > 0 else (-np.inf, -np.inf)
    if f == x:
        return (f, f)
    return (float(np.nextafter(f, -np.inf)), float(np.nextafter(f, np.inf)))


def range_fold_value(v) -> "int | float | None":
    """The numeric a row value contributes to the RANGE bounds, or None.

    Mirrors :func:`repro_torch.core.predicates.range_contains` exactly: bool
    and None never match any range (no contribution), numerics
    contribute themselves (NaN skipped — it matches no range), strings
    contribute their ``json_number`` parse when they have one.
    """
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float)):
        return None if v != v else v
    if isinstance(v, str):
        x = json_number(v)
        return None if x is None or x != x else x
    return None


@dataclass
class KeyStats:
    """Everything the registry may probe about one key's summarized rows.

    Built from either a segment :class:`~repro_torch.core.columnar.KeyColumn`
    (exact dictionaries) or a shard ``_KeySummary`` (saturating sets).
    ``strs``/``reprs`` are membership containers (dict or set) or ``None``
    when saturated; ``rnum_prunable=False`` / ``ngram=None`` mean the
    corresponding index has no data and must answer "possible" — the
    format-5 migration default.
    """

    any_notnull: bool = False
    num_min: float = np.inf
    num_max: float = -np.inf
    num_prunable: bool = True
    strs: Any = None
    reprs: Any = None
    rnum_min: float = np.inf
    rnum_max: float = -np.inf
    rnum_prunable: bool = False
    ngram: NGramBloom | None = None


# ---------------------------------------------------------------------------
# the indexes
# ---------------------------------------------------------------------------

class SkipIndex:
    """One pluggable skipping index: probe + cost/selectivity + codec."""

    name = "index"
    build_cost_per_row = 0.0   # relative per-row maintenance cost units

    def handles(self, pred: SimplePredicate) -> bool:
        raise NotImplementedError

    def probe(self, pred: SimplePredicate, stats: KeyStats) -> bool:
        """False ONLY when provably no summarized row matches ``pred``."""
        raise NotImplementedError

    def selectivity(self, pred: SimplePredicate) -> float:
        """Workload-free prior fraction of rows matching ``pred``."""
        return 1.0

    def summary_to_obj(self, stats: KeyStats) -> dict:
        return {}

    def summary_from_obj(self, obj: dict, stats: KeyStats) -> None:
        pass


class MembershipIndex(SkipIndex):
    """Value-set membership + numeric min/max (the original zone map)."""

    name = "membership"
    build_cost_per_row = 1.0   # dictionary insert + min/max fold

    _KINDS = (Kind.EXACT, Kind.SUBSTRING, Kind.KEY_PRESENCE,
              Kind.KEY_VALUE, Kind.IN)

    def handles(self, pred: SimplePredicate) -> bool:
        return pred.kind in self._KINDS

    def probe(self, pred: SimplePredicate, stats: KeyStats) -> bool:
        if pred.kind is Kind.KEY_PRESENCE:
            return stats.any_notnull
        v = pred.value
        if pred.kind is Kind.EXACT:
            if not isinstance(v, str):
                return True  # non-lowerable value: never prune
            return True if stats.strs is None else v in stats.strs
        if pred.kind is Kind.SUBSTRING:
            if isinstance(v, bool):
                return False
            if stats.strs is None:
                return True
            sub = str(v)
            return any(sub in s for s in stats.strs)
        if pred.kind is Kind.IN:
            # disjunction: possible iff ANY element is
            return any(self._kv_possible(e, stats) for e in v)
        return self._kv_possible(v, stats)

    @staticmethod
    def _kv_possible(v, stats: KeyStats) -> bool:
        from .columnar import _f64_exact, _num_reprs
        if not (v is None or isinstance(v, (str, int, float, bool))):
            return True
        if stats.reprs is not None and json_scalar(v) in stats.reprs:
            return True
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and _f64_exact(v):
            fv = float(v)
            # min/max gate first (cheapest), then the exact
            # numeric-equality membership test.  A NaN observed at build
            # time marks the bounds non-prunable: comparisons would be
            # silently False, so skip straight to the membership test
            if stats.num_prunable \
                    and not stats.num_min <= fv <= stats.num_max:
                # out-of-range refutes only the NUMERIC rows: min/max
                # never saw string values, yet a string row can
                # cross-repr match the probe (row {"score": "10"} vs
                # score == 10, §IV-B).  With an exact repr set that
                # string side is already refuted; saturated, fall back
                # to the string value set — and if that saturated too,
                # nothing may refute
                if stats.reprs is not None:
                    return False
                if stats.strs is None:
                    return True
                return json_scalar(v) in stats.strs
            if stats.reprs is None:
                return True
            return any(r in stats.reprs for r in _num_reprs(fv))
        return stats.reprs is None

    def selectivity(self, pred: SimplePredicate) -> float:
        if pred.kind is Kind.KEY_PRESENCE:
            return 0.5
        if pred.kind is Kind.EXACT:
            return 0.01
        if pred.kind is Kind.SUBSTRING:
            return 0.1
        if pred.kind is Kind.IN:
            return min(0.9, 0.02 * len(pred.value))
        return 0.02   # KEY_VALUE point lookup

    def summary_to_obj(self, stats: KeyStats) -> dict:
        # the legacy (format <= 5) summary block, byte-compatible with
        # what pre-registry checkpoints wrote
        empty = stats.num_min > stats.num_max
        return {
            "min": None if empty else stats.num_min,
            "max": None if empty else stats.num_max,
            "num_prunable": stats.num_prunable,
            "any_notnull": stats.any_notnull,
            "reprs": None if stats.reprs is None else sorted(stats.reprs),
            "strs": None if stats.strs is None else sorted(stats.strs),
        }

    def summary_from_obj(self, obj: dict, stats: KeyStats) -> None:
        stats.num_min = np.inf if obj["min"] is None else float(obj["min"])
        stats.num_max = -np.inf if obj["max"] is None else float(obj["max"])
        stats.num_prunable = bool(obj["num_prunable"])
        stats.any_notnull = bool(obj["any_notnull"])
        stats.reprs = None if obj["reprs"] is None else set(obj["reprs"])
        stats.strs = None if obj["strs"] is None else set(obj["strs"])


class RangeIndex(SkipIndex):
    """RANGE refutation via dedicated range bounds (never saturates)."""

    name = "range"
    build_cost_per_row = 0.5   # one json_number parse + min/max fold

    def handles(self, pred: SimplePredicate) -> bool:
        return pred.kind is Kind.RANGE

    def probe(self, pred: SimplePredicate, stats: KeyStats) -> bool:
        if not stats.rnum_prunable:
            return True
        if stats.rnum_min > stats.rnum_max:
            return False   # no range-matchable value anywhere in the key
        lo, hi, _lo_i, _hi_i = pred.value
        # bounds treated closed (inclusivity ignored): conservative
        if lo is not None and stats.rnum_max < lo:
            return False
        if hi is not None and stats.rnum_min > hi:
            return False
        return True

    def selectivity(self, pred: SimplePredicate) -> float:
        lo, hi, _, _ = pred.value
        return 0.1 if (lo is not None and hi is not None) else 0.25

    def summary_to_obj(self, stats: KeyStats) -> dict:
        empty = stats.rnum_min > stats.rnum_max
        return {
            "rmin": None if empty or not np.isfinite(stats.rnum_min)
            else stats.rnum_min,
            "rmax": None if empty or not np.isfinite(stats.rnum_max)
            else stats.rnum_max,
            # infinities can't ride in RFC 8259 JSON, so encode the
            # "bound present but infinite" case (an Infinity-string row)
            # as explicit flags
            "rmin_inf": bool(not empty and stats.rnum_min == -np.inf),
            "rmax_inf": bool(not empty and stats.rnum_max == np.inf),
            "rnum_prunable": bool(stats.rnum_prunable),
        }

    def summary_from_obj(self, obj: dict, stats: KeyStats) -> None:
        if "rnum_prunable" not in obj:
            # format-5 file: no range bounds were recorded — stay
            # non-prunable (conservative) until a reshard rebuilds them
            stats.rnum_prunable = False
            return
        stats.rnum_prunable = bool(obj["rnum_prunable"])
        if obj["rmin"] is not None:
            stats.rnum_min = float(obj["rmin"])
        elif obj.get("rmin_inf"):
            stats.rnum_min = -np.inf
        if obj["rmax"] is not None:
            stats.rnum_max = float(obj["rmax"])
        elif obj.get("rmax_inf"):
            stats.rnum_max = np.inf


class NGramIndex(SkipIndex):
    """Bloom-filter n-gram refutation for substring/exact string probes."""

    name = "ngram"
    build_cost_per_row = 2.0   # per-gram hashing over string values

    def handles(self, pred: SimplePredicate) -> bool:
        return pred.kind in (Kind.SUBSTRING, Kind.EXACT)

    def probe(self, pred: SimplePredicate, stats: KeyStats) -> bool:
        if stats.ngram is None:
            return True
        v = pred.value
        if pred.kind is Kind.EXACT and not isinstance(v, str):
            return True
        if isinstance(v, bool):
            return True   # membership already refutes bool SUBSTRING
        # EXACT: equality implies containment, so the same gram probe is
        # sound; SUBSTRING: directly the containment probe
        return stats.ngram.might_contain(str(v))

    def selectivity(self, pred: SimplePredicate) -> float:
        if pred.kind is Kind.EXACT:
            return 0.01
        # longer needles are rarer: decay with gram count, floored
        n_bytes = len(str(pred.value).encode("utf-8"))
        return max(0.005, 0.3 / max(1, n_bytes - NGRAM_N + 2))

    def summary_to_obj(self, stats: KeyStats) -> dict:
        return {"ngram": None if stats.ngram is None
                else stats.ngram.to_hex()}

    def summary_from_obj(self, obj: dict, stats: KeyStats) -> None:
        h = obj.get("ngram")
        stats.ngram = None if h is None else NGramBloom.from_hex(h)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SkipIndexRegistry:
    """Conjunctive composition of independently-sound skipping indexes."""

    indexes: tuple[SkipIndex, ...]

    def term_possible(self, pred: SimplePredicate, stats: KeyStats) -> bool:
        """False iff SOME index proves no summarized row matches."""
        for ix in self.indexes:
            if ix.handles(pred) and not ix.probe(pred, stats):
                return False
        return True

    def term_selectivity(self, pred: SimplePredicate) -> float:
        """Most-selective prior among the indexes that handle ``pred``."""
        out = 1.0
        for ix in self.indexes:
            if ix.handles(pred):
                out = min(out, max(0.0, ix.selectivity(pred)))
        return out

    def clause_selectivity_prior(self, clause: Clause) -> float:
        """Disjunction combine: 1 - prod(1 - s_term)."""
        miss = 1.0
        for t in clause.terms:
            miss *= 1.0 - min(1.0, self.term_selectivity(t))
        return 1.0 - miss

    def build_cost_per_row(self) -> float:
        return sum(ix.build_cost_per_row for ix in self.indexes)

    def summary_to_obj(self, stats: KeyStats) -> dict:
        out: dict = {}
        for ix in self.indexes:
            out.update(ix.summary_to_obj(stats))
        return out

    def summary_from_obj(self, obj: dict, stats: KeyStats | None = None
                         ) -> KeyStats:
        stats = stats or KeyStats()
        for ix in self.indexes:
            ix.summary_from_obj(obj, stats)
        return stats


REGISTRY = SkipIndexRegistry((MembershipIndex(), RangeIndex(), NGramIndex()))
