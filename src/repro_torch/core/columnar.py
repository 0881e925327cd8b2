"""Columnar scan engine: struct-of-arrays segments + zone-map skipping.

The server-side query path used to be row-at-a-time Python: every block
kept ``rows: list[dict]`` and the scanner called ``q.matches_exact(row)``
per surviving row.  This module replaces that layout with *segments*
(DESIGN.md §13):

  * loaded rows are decomposed at ingest into per-key struct-of-arrays
    columns — numeric values as float64 + validity masks, string values
    dictionary-encoded (int32 codes into a per-segment dictionary), and a
    *scalar-repr* dictionary column holding ``json_scalar(v)`` for every
    present value (the paper's §IV-B cross-representation equality,
    e.g. ``age = 10`` matching the string ``"10"``, stays exact);
  * small per-chunk row groups are compacted into large fixed-capacity
    segments (one :class:`SegmentBuilder` per ``(epoch, n_covered, tier)``
    coverage group), amortizing per-block Python overhead;
  * each segment carries *zone maps* — per-key numeric min/max and the
    string/repr dictionary sets — a second level of data skipping for
    residual clauses the client never evaluated (following the
    extensible-data-skipping / raw-data-query-processing line in
    PAPERS.md);
  * predicates are *lowered* to vectorized numpy evaluation over whole
    columns with EXACT ``matches_exact`` semantics (``predicates.
    lowerable`` gates the cases the lowering covers; anything else falls
    back to a per-row oracle check on the raw bytes, so counts are
    bit-identical by construction).

Segments keep the loaded records' raw JSON bytes (one blob + offsets), so
recipe batching streams source bytes without a ``json.dumps`` round-trip
and the per-row fallback parses lazily.  ``matches_exact`` survives only
as the differential oracle (and the fallback for non-lowerable terms).
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from . import bitvector
from .predicates import (
    Clause, Kind, Query, SimplePredicate, json_number, json_scalar,
    lowerable, range_contains,
)
from .skip_index import (
    REGISTRY, KeyStats, NGramBloom, conservative_bounds,
)

def _f64_exact(v) -> bool:
    """True iff ``float(v) == v`` holds exactly (no float64 aliasing)."""
    try:
        return float(v) == v
    except (OverflowError, ValueError):
        return False


# ---------------------------------------------------------------------------
# per-key column bundle
# ---------------------------------------------------------------------------

@dataclass
class KeyColumn:
    """Struct-of-arrays decomposition of one JSON key over a segment.

    Every mask/array is aligned to the segment's row order.  ``repr_*``
    dictionary-encodes ``json_scalar(v)`` for EVERY present value (strings
    included), which is what keeps ``KEY_VALUE`` cross-representation
    equality exact without per-row parsing.  The zone map lives in
    ``num_min``/``num_max`` (numeric values only) plus the dictionary
    index sets themselves.
    """

    present: np.ndarray      # bool[n] — key exists in the row object
    notnull: np.ndarray      # bool[n] — present and value is not None
    is_bool: np.ndarray      # bool[n]
    num_valid: np.ndarray    # bool[n] — int/float (not bool), f64-exact
    num: np.ndarray          # float64[n] — value where num_valid
    str_codes: np.ndarray    # int32[n] — dictionary code, -1 = not a string
    str_dict: list[str]
    str_index: dict[str, int]
    repr_codes: np.ndarray   # int32[n] — json_scalar dictionary, -1 = absent
    repr_dict: list[str]
    repr_index: dict[str, int]
    num_min: float = np.inf   # zone map over num_valid rows
    num_max: float = -np.inf
    any_notnull: bool = False
    # False when a NaN was observed among the key's float values at build
    # time: NaN never enters ``num`` (``_f64_exact`` rejects it, NaN != NaN)
    # so min/max stay finite, but the flag marks the numeric zone map
    # non-prunable — every min/max refutation must gate on it, because a
    # comparison against a poisoned bound would be silently False and skip
    # a segment that still holds matches
    num_prunable: bool = True
    # RANGE-index bounds (DESIGN.md §19): min/max over every value the
    # RANGE semantics can match — numerics (huge ints ulp-widened) AND
    # strings parsing as JSON numbers — so they never hit the §IV-B
    # cross-representation trap the num_* bounds have.  NaN matches no
    # range, so it is simply excluded (no poisoning flag needed: segment
    # bounds are always exact-or-widened, hence always prunable).
    rnum_min: float = np.inf
    rnum_max: float = -np.inf
    # byte-level 3-gram bloom over the string dictionary (None when the
    # segment holds no strings for this key)
    ngram: "NGramBloom | None" = None


class _KeyAcc:
    """Accumulates one key's values; :meth:`finish` emits a KeyColumn."""

    __slots__ = ("present", "notnull", "is_bool", "num_valid", "num",
                 "str_codes", "str_index", "repr_codes", "repr_index",
                 "has_nan")

    def __init__(self, n: int):
        self.present = np.zeros(n, bool)
        self.notnull = np.zeros(n, bool)
        self.is_bool = np.zeros(n, bool)
        self.num_valid = np.zeros(n, bool)
        self.num = np.zeros(n, np.float64)
        self.str_codes = np.full(n, -1, np.int32)
        self.str_index: dict[str, int] = {}
        self.repr_codes = np.full(n, -1, np.int32)
        self.repr_index: dict[str, int] = {}
        self.has_nan = False

    def add(self, i: int, v) -> None:
        self.present[i] = True
        if v is not None:
            self.notnull[i] = True
        if isinstance(v, bool):
            self.is_bool[i] = True
        elif isinstance(v, float) and v != v:
            # NaN: excluded from the numeric column (NaN == NaN is False so
            # _f64_exact rejects it) — detect it EXPLICITLY and poison-mark
            # the zone map instead of relying on that rejection staying true
            self.has_nan = True
        elif isinstance(v, (int, float)) and _f64_exact(v):
            self.num_valid[i] = True
            self.num[i] = float(v)
        elif isinstance(v, str):
            code = self.str_index.setdefault(v, len(self.str_index))
            self.str_codes[i] = code
        r = json_scalar(v)
        self.repr_codes[i] = self.repr_index.setdefault(r, len(self.repr_index))

    def finish(self) -> KeyColumn:
        nums = self.num[self.num_valid]
        # RANGE bounds fold over the DISTINCT reprs, not the rows: every
        # present value's repr round-trips through json_number to exactly
        # the numeric its row contributes (ints arbitrary-precision,
        # floats bit-exact, numeric strings ARE their repr), and the
        # dictionary dedups the parses.  Bool reprs ("true"/"false"),
        # non-numeric strings and "NaN" contribute nothing.
        rmin, rmax = np.inf, -np.inf
        for r in self.repr_index:
            x = json_number(r)
            if x is None or x != x:
                continue
            lo, hi = conservative_bounds(x)
            if lo < rmin:
                rmin = lo
            if hi > rmax:
                rmax = hi
        ngram = None
        if self.str_index:
            ngram = NGramBloom()
            for s in self.str_index:
                ngram.add(s)
        return KeyColumn(
            present=self.present, notnull=self.notnull,
            is_bool=self.is_bool, num_valid=self.num_valid, num=self.num,
            str_codes=self.str_codes,
            str_dict=list(self.str_index), str_index=self.str_index,
            repr_codes=self.repr_codes,
            repr_dict=list(self.repr_index), repr_index=self.repr_index,
            num_min=float(nums.min()) if nums.size else np.inf,
            num_max=float(nums.max()) if nums.size else -np.inf,
            any_notnull=bool(self.notnull.any()),
            num_prunable=not self.has_nan,
            rnum_min=rmin, rnum_max=rmax, ngram=ngram,
        )


def build_key_columns(objs: Sequence[dict],
                      keys: "set[str] | frozenset[str] | None" = None
                      ) -> dict[str, KeyColumn]:
    """Decompose parsed row objects into per-key struct-of-arrays columns.

    ``keys`` restricts the build to a subset (the per-key layout policy's
    eager set, DESIGN.md §18); ``None`` builds every key present.
    """
    accs: dict[str, _KeyAcc] = {}
    n = len(objs)
    for i, obj in enumerate(objs):
        for k, v in obj.items():
            if keys is not None and k not in keys:
                continue
            acc = accs.get(k)
            if acc is None:
                acc = accs[k] = _KeyAcc(n)
            acc.add(i, v)
    return {k: acc.finish() for k, acc in accs.items()}


# ---------------------------------------------------------------------------
# vectorized predicate lowering (exact matches_exact semantics)
# ---------------------------------------------------------------------------

def eval_lowered(col: KeyColumn, pred: SimplePredicate) -> np.ndarray:
    """bool[n]: exact ``pred.matches_exact`` over one column.

    Callers must gate on :func:`repro_torch.core.predicates.lowerable`; the
    per-kind derivations below mirror ``SimplePredicate.matches_exact``
    line by line (bool-vs-non-bool mismatch, cross-representation
    equality via the repr dictionary, float64-exactness guards).
    """
    v = pred.value
    if pred.kind is Kind.KEY_PRESENCE:
        return col.notnull.copy()
    if pred.kind is Kind.EXACT:
        # value is a string (lowerable gate): only string rows can equal it
        code = col.str_index.get(v, -2)
        return col.str_codes == code
    if pred.kind is Kind.SUBSTRING:
        if isinstance(v, bool):
            # matches_exact's bool-mismatch check plus isinstance(v, str)
            # can never both hold: provably empty
            return np.zeros(col.present.shape, bool)
        sub = str(v)
        lut = np.zeros(len(col.str_dict) + 1, bool)
        for s, code in col.str_index.items():
            lut[code + 1] = sub in s
        return lut[col.str_codes + 1]
    if pred.kind is Kind.RANGE:
        # pure repr-LUT: a row's repr round-trips through json_number to
        # exactly the value ``range_contains`` would test (ints
        # arbitrary-precision, floats bit-exact, numeric strings ARE
        # their repr; "true"/"false"/"None"/non-numeric parse to None →
        # False, "NaN" → nan fails every comparison) — bit-identical to
        # matches_exact by case analysis on the row's JSON type
        lut = np.zeros(len(col.repr_dict) + 1, bool)
        for r, code in col.repr_index.items():
            x = json_number(r)
            lut[code + 1] = x is not None and range_contains(v, x)
        return lut[col.repr_codes + 1]
    if pred.kind is Kind.IN:
        # OR of per-element KEY_VALUE lowerings (matches_exact's IN is
        # the same OR of per-element KEY_VALUE semantics)
        m = np.zeros(col.present.shape, bool)
        for e in v:
            m |= eval_lowered(
                col, SimplePredicate(Kind.KEY_VALUE, pred.key, e))
        return m
    # KEY_VALUE: (v == value) OR (json_scalar(value) == json_scalar(v)),
    # masked by the bool-compatibility check
    compat = col.is_bool if isinstance(v, bool) else \
        (col.present & ~col.is_bool)
    rcode = col.repr_index.get(json_scalar(v), -2)
    m = col.repr_codes == rcode
    if v is None:
        m = m | (col.present & ~col.notnull)
    elif not isinstance(v, (bool, str)):
        # numeric direct equality (10 == 10.0 across int/float); skipped
        # when float64 would alias the query value itself
        if _f64_exact(v):
            m = m | (col.num_valid & (col.num == float(v)))
    # strings and bools are fully covered by the repr dictionary: a str
    # row's repr IS the string, a bool's repr is "true"/"false"
    return m & compat


_NUM_REPRS_CACHE: dict[float, frozenset] = {}
_NUM_REPRS_CACHE_CAP = 4096


def _num_reprs(fv: float) -> frozenset[str]:
    """Every ``json_scalar`` a num_valid row numerically equal to ``fv``
    can carry.

    An int row *v* with ``float(v) == fv`` round-trips exactly (that is
    the ``num_valid`` admission rule), so ``v == int(fv)`` and its repr
    is ``str(int(fv))``; a float row equal to ``fv`` is the same float64
    and shares ``json.dumps(fv)`` — except the signed zeros, which are
    float-equal with distinct dumps (0.0 and -0.0 hash alike and share
    one cache slot, whose set contains both dumps).  Memoized: zone-map
    checks call this once per (segment, clause) and the json round-trips
    dominate the probe cost on fresh point lookups.
    """
    global _NUM_REPRS_CACHE
    hit = _NUM_REPRS_CACHE.get(fv)
    if hit is not None:
        return hit
    cands = {json.dumps(fv)}
    if fv == 0.0:
        cands |= {"0", "0.0", "-0.0"}
    elif float(fv).is_integer():
        cands.add(str(int(fv)))
    out = frozenset(cands)
    if len(_NUM_REPRS_CACHE) >= _NUM_REPRS_CACHE_CAP:
        # fresh dict, never .clear(): concurrent readers (serve-plane
        # scan threads) may be probing the old one
        _NUM_REPRS_CACHE = {}
    _NUM_REPRS_CACHE[fv] = out
    return out


def term_possible_over(
    pred: SimplePredicate, *, any_notnull: bool,
    num_min: float, num_max: float, num_prunable: bool,
    strs, reprs,
) -> bool:
    """Compat wrapper: membership-only probe of the skipping registry.

    The single hardcoded refutation rule this function used to BE now
    lives in ``repro_torch.core.skip_index.MembershipIndex``; callers holding
    only the legacy summary fields (no range bounds, no n-gram bloom)
    get exactly the old behavior — the newer indexes see their
    "no data" defaults (``rnum_prunable=False``, ``ngram=None``) and
    never refute.  Must be conservative: False only when provably no
    match.  ``strs``/``reprs`` are value-membership containers (dict or
    set), or ``None`` when the caller's value set SATURATED.  The caller
    handles the missing-key case (which refutes every kind).
    """
    return REGISTRY.term_possible(pred, KeyStats(
        any_notnull=any_notnull, num_min=num_min, num_max=num_max,
        num_prunable=num_prunable, strs=strs, reprs=reprs,
    ))


def column_stats(col: KeyColumn) -> KeyStats:
    """Registry probe view of one segment column (exact dictionaries,
    always-prunable range bounds)."""
    return KeyStats(
        any_notnull=col.any_notnull,
        num_min=col.num_min, num_max=col.num_max,
        num_prunable=col.num_prunable,
        strs=col.str_index, reprs=col.repr_index,
        rnum_min=col.rnum_min, rnum_max=col.rnum_max,
        rnum_prunable=True, ngram=col.ngram,
    )


def _term_possible(col: KeyColumn | None, pred: SimplePredicate) -> bool:
    """Zone-map check: can ``pred`` match ANY row of this segment?

    Every predicate kind requires the key to be present, so a missing
    column refutes every kind — including non-lowerable values.  Segment
    dictionaries are exact (never saturated), so membership refutation is
    always available here, and the segment-level range bounds and n-gram
    bloom are always populated (built at column-finish time).
    """
    if col is None:
        return False
    return REGISTRY.term_possible(pred, column_stats(col))


# ---------------------------------------------------------------------------
# the segment
# ---------------------------------------------------------------------------

_CLAUSE_CACHE_CAP = 128
_AND_CACHE_CAP = 64


class ColumnarSegment:
    """One compacted group of loaded rows in struct-of-arrays layout.

    Carries the same coverage metadata a loaded block used to (``epoch``
    names the plan the bitvector rows index, ``n_covered`` the coverage
    prefix, ``tier`` the producing family tier — DESIGN.md §12), plus:

      * ``bitvectors`` — packed ``uint32[n_covered, W]`` client clause
        bitvectors over the segment's rows (W = ceil(n_rows/32));
      * ``key_cols``   — per-key :class:`KeyColumn` bundles (zone maps
        included);
      * the raw JSON bytes of every row (blob + offsets), for zero-copy
        recipe streaming and the per-row exact fallback.

    Query-path results are memoized per segment: ANDed pushed-bitvector
    masks per pushed-row tuple, lowered clause masks and zone-map verdicts
    per clause (the "(query, epoch, coverage)" cache — a query resolves to
    exactly those keys).
    """

    def __init__(self, *, records: Sequence[bytes],
                 bitvectors: np.ndarray, epoch: int, n_covered: int,
                 tier: int, objs: Sequence[dict] | None = None,
                 eager_keys: "frozenset[str] | None" = None):
        self.n_rows = len(records)
        self.epoch = int(epoch)
        self.n_covered = int(n_covered)
        self.tier = int(tier)
        self.bitvectors = np.asarray(bitvectors, np.uint32)
        lens = np.fromiter((len(r) for r in records), np.int64,
                           count=len(records))
        self.raw_offsets = np.zeros(len(records) + 1, np.int64)
        np.cumsum(lens, out=self.raw_offsets[1:])
        self.raw_blob = np.frombuffer(b"".join(records), np.uint8)
        if objs is None:
            objs = [json.loads(r) for r in records]
        if eager_keys is None:
            self.key_cols = build_key_columns(objs)
            self.lazy_keys: frozenset[str] = frozenset()
        else:
            # Per-key layout policy (DESIGN.md §18): only the eager set is
            # columnarized up front; the rest stay raw until first touched.
            present: set[str] = set()
            for obj in objs:
                present.update(obj)
            self.key_cols = build_key_columns(objs, keys=present & eager_keys)
            self.lazy_keys = frozenset(present - eager_keys)
        self._lazy_lock = threading.Lock()
        self._clause_masks: dict[Clause, tuple] = {}
        self._possible: dict[Clause, bool] = {}
        self._and_masks: dict[tuple[int, ...], np.ndarray] = {}

    def key_col(self, key: str) -> KeyColumn | None:
        """Per-key column, materializing a lazy key on first touch.

        A key absent from ``key_cols`` AND ``lazy_keys`` is genuinely
        absent from every row (sound to refute).  A lazy key decodes the
        raw rows once under ``_lazy_lock`` (a racing reader either wins
        the lock and builds, or blocks and finds the column installed —
        never a lost update), installs into a FRESH dict (peers holding
        the old dict just retry via this method), and shrinks the lazy
        set last so a concurrent ``lazy_keys`` probe stays conservative.
        """
        col = self.key_cols.get(key)
        if col is not None or key not in self.lazy_keys:
            return col
        with self._lazy_lock:
            col = self.key_cols.get(key)
            if col is not None:
                return col
            built = build_key_columns(self.rows, keys={key}).get(key)
            cols = dict(self.key_cols)
            if built is not None:
                cols[key] = built
            self.key_cols = cols
            self.lazy_keys = self.lazy_keys - {key}
            return built

    # -- raw bytes -----------------------------------------------------------
    def record(self, i: int) -> bytes:
        o = self.raw_offsets
        return self.raw_blob[o[i]:o[i + 1]].tobytes()

    def records(self) -> list[bytes]:
        return [self.record(i) for i in range(self.n_rows)]

    @property
    def rows(self) -> list[dict]:
        """Parsed row objects (decoded fresh — differential/test use only)."""
        return [json.loads(self.record(i)) for i in range(self.n_rows)]

    def plane_nbytes(self, k_cap: int) -> int:
        """Device bytes this segment occupies in a resident plane with
        ``k_cap`` key rows (DESIGN.md §15): four uint8 masks + two int32
        code columns per key row, plus the int32 slot id and uint32
        clause word per row."""
        return self.n_rows * (k_cap * (4 * 1 + 2 * 4) + 8)

    # -- pushed-bitvector candidates ----------------------------------------
    def pushed_mask(self, pushed: Sequence[int],
                    and_reduce: Callable | None = None) -> np.ndarray:
        """bool[n]: AND of the pushed clauses' bitvector rows (memoized).

        The memo caches here and in :meth:`clause_possible` /
        :meth:`clause_mask` are safe under concurrent readers (segments
        are shared between the live store and its snapshots, DESIGN.md
        §17): entries are pure functions of immutable segment state, so
        a racing recompute stores an identical value, and eviction swaps
        in a fresh dict rather than clearing the one a peer may hold.
        """
        key = tuple(pushed)
        m = self._and_masks.get(key)
        if m is None:
            reduce = and_reduce or bitvector.bv_and_many
            words = reduce(self.bitvectors[list(key)])
            m = bitvector.unpack(words, self.n_rows)
            if len(self._and_masks) >= _AND_CACHE_CAP:
                self._and_masks = {}
            self._and_masks[key] = m
        return m

    # -- zone maps -----------------------------------------------------------
    def clause_possible(self, c: Clause) -> bool:
        """False iff the zone map proves no row can match clause ``c``."""
        p = self._possible.get(c)
        if p is None:
            p = any(_term_possible(self.key_col(t.key), t)
                    for t in c.terms)
            if len(self._possible) >= _CLAUSE_CACHE_CAP:
                self._possible = {}
            self._possible[c] = p
        return p

    # -- vectorized clause evaluation ---------------------------------------
    def clause_mask(self, c: Clause
                    ) -> tuple[np.ndarray, tuple[SimplePredicate, ...]]:
        """(bool[n] exact OR over lowerable terms, non-lowerable leftovers).

        The mask is memoized and must not be mutated by callers; leftover
        terms need the per-row fallback (``matches_exact`` on the parsed
        raw bytes) for rows the mask leaves False.
        """
        hit = self._clause_masks.get(c)
        if hit is None:
            mask = np.zeros(self.n_rows, bool)
            leftover = []
            for t in c.terms:
                if not lowerable(t):
                    leftover.append(t)
                    continue
                col = self.key_col(t.key)
                if col is not None:
                    mask |= eval_lowered(col, t)
            hit = (mask, tuple(leftover))
            if len(self._clause_masks) >= _CLAUSE_CACHE_CAP:
                self._clause_masks = {}
            self._clause_masks[c] = hit
        return hit


def query_mask(seg: ColumnarSegment, q: Query,
               pushed: Sequence[int] = (),
               and_reduce: Callable | None = None) -> np.ndarray | None:
    """Exact per-row match mask for ``q`` over one segment.

    Returns ``None`` when the zone map prunes the whole segment (some
    query clause provably matches no row), else ``bool[n_rows]`` with
    EXACTLY the rows ``q.matches_exact`` accepts:

      1. zone-map prune on every clause (cheap set/range checks);
      2. AND the pushed clauses' client bitvectors (sound candidate set —
         clients never produce false negatives);
      3. vectorized exact evaluation of every clause over whole columns,
         with a per-row raw-bytes fallback for non-lowerable terms.

    The returned mask may alias a memoized per-clause mask (the common
    single-residual-clause case skips a whole-segment ones-AND round
    trip); callers must treat it as read-only.
    """
    for c in q.clauses:
        if not seg.clause_possible(c):
            return None
    # candidate mask, built lazily: None means "every row" so the common
    # single-clause unpushed probe never allocates or ANDs a ones-mask
    m = seg.pushed_mask(pushed, and_reduce) if pushed else None
    for c in q.clauses:
        cm, leftover = seg.clause_mask(c)
        if leftover:
            need = ~cm if m is None else m & ~cm
            if need.any():
                cm = cm.copy()
                for i in np.nonzero(need)[0]:
                    obj = json.loads(seg.record(i))
                    if any(t.matches_exact(obj) for t in leftover):
                        cm[i] = True
        m = cm if m is None else m & cm
        if not m.any():
            break
    if m is None:  # zero-clause query: every row matches
        m = np.ones(seg.n_rows, bool)
    return m


# ---------------------------------------------------------------------------
# builders: per-coverage-group compaction at ingest
# ---------------------------------------------------------------------------

@dataclass
class SegmentBuilder:
    """Accumulates loaded chunks of ONE ``(epoch, n_covered, tier)`` group.

    Ingest appends parsed chunk rows; when the builder crosses
    ``capacity`` rows it seals into a :class:`ColumnarSegment` (so sealed
    segments hold ``[capacity, capacity + chunk)`` rows — large enough to
    amortize per-segment Python overhead).  ``view()`` materializes the
    open tail as a segment for the query path, cached until the next
    append, so scans between ingests pay the column build once.
    """

    epoch: int
    n_covered: int
    tier: int
    capacity: int = 8192
    touch_seq: int = 0
    eager_keys: "frozenset[str] | None" = None

    def __post_init__(self) -> None:
        self._records: list[bytes] = []
        self._objs: list[dict] = []
        self._bits: list[np.ndarray] = []   # bool[n_covered, k] per chunk
        self._view: ColumnarSegment | None = None

    @property
    def n_rows(self) -> int:
        return len(self._records)

    def add(self, records: Sequence[bytes], objs: Sequence[dict],
            bits: np.ndarray) -> list[ColumnarSegment]:
        """Append one chunk's loaded rows; returns newly sealed segments."""
        if bits.shape != (self.n_covered, len(records)):
            raise ValueError(
                f"bits shape {bits.shape} != ({self.n_covered}, "
                f"{len(records)})")
        self._view = None
        self._records.extend(records)
        self._objs.extend(objs)
        self._bits.append(np.asarray(bits, bool))
        if len(self._records) >= self.capacity:
            return [self.seal()]
        return []

    def _build(self) -> ColumnarSegment:
        n = len(self._records)
        if self._bits:
            bits = np.concatenate(self._bits, axis=1)
        else:
            bits = np.zeros((self.n_covered, n), bool)
        return ColumnarSegment(
            records=self._records, objs=self._objs,
            bitvectors=bitvector.pack(bits) if n else
            np.zeros((self.n_covered, 0), np.uint32),
            epoch=self.epoch, n_covered=self.n_covered, tier=self.tier,
            eager_keys=self.eager_keys,
        )

    def view(self) -> ColumnarSegment:
        """Query-path view of the open tail (cached until the next add)."""
        if self._view is None:
            self._view = self._build()
        return self._view

    def seal(self) -> ColumnarSegment:
        """Finalize and reset the builder."""
        seg = self._build()
        self._records, self._objs, self._bits = [], [], []
        self._view = None
        return seg


def build_segments(records: Sequence[bytes], bits: np.ndarray, *,
                   epoch: int, n_covered: int, tier: int,
                   capacity: int = 8192,
                   objs: Sequence[dict] | None = None
                   ) -> list[ColumnarSegment]:
    """Chop one row batch into capacity-bounded segments (JIT promotion,
    checkpoint restore)."""
    out = []
    n = len(records)
    for lo in range(0, max(n, 1), capacity):
        hi = min(lo + capacity, n)
        if hi <= lo:
            break
        out.append(ColumnarSegment(
            records=records[lo:hi],
            objs=None if objs is None else objs[lo:hi],
            bitvectors=bitvector.pack(bits[:, lo:hi]) if bits.size else
            np.zeros((bits.shape[0], bitvector.num_words(hi - lo)),
                     np.uint32),
            epoch=epoch, n_covered=n_covered, tier=tier,
        ))
    return out


def segment_from_packed(records: Sequence[bytes], words: np.ndarray, *,
                        epoch: int, n_covered: int, tier: int,
                        objs: Sequence[dict] | None = None
                        ) -> ColumnarSegment:
    """Rebuild one segment from checkpointed raw bytes + packed words."""
    return ColumnarSegment(
        records=records, bitvectors=np.asarray(words, np.uint32),
        epoch=epoch, n_covered=n_covered, tier=tier, objs=objs,
    )


def decode_rows(data: np.ndarray, lengths: np.ndarray,
                idx: np.ndarray | None = None,
                objs: Sequence[dict] | None = None
                ) -> tuple[list[bytes], list[dict]]:
    """Batch-decode dense chunk rows: ONE fancy-indexed copy, then slices.

    Replaces the per-row ``chunk.record(i)`` bytes copies on the ingest
    parse path: the selected sub-array is materialized once
    (``tobytes``), record bytes are cheap slices of that buffer, and the
    parsed objects feed the columnar builder directly.  ``objs`` supplies
    already-parsed row objects aligned to the FULL ``data`` (the sharded
    ingest path parses every row once for routing) so the selected rows
    skip the second ``json.loads``.
    """
    if idx is not None:
        data = data[idx]
        lengths = lengths[idx]
        if objs is not None:
            objs = [objs[int(i)] for i in idx]
    n, stride = data.shape
    buf = np.ascontiguousarray(data).tobytes()
    records = [buf[k * stride: k * stride + int(lengths[k])]
               for k in range(n)]
    if objs is None:
        objs = [json.loads(r) for r in records]
    return records, list(objs)
