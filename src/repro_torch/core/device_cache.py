"""Device-resident segment cache: the host half of DESIGN.md §15.

Mirrors a :class:`~repro_torch.core.server.CiaoStore`'s hot columnar segments
as one concatenated device plane (see ``kernels.scan_fused`` for the
array layout) so steady-state scans never move segment data across the
host->device boundary again:

  * **incremental admission** — ``sync`` uploads only segments not yet
    resident (sealed and JIT-promoted; open builder tails mutate per
    ingest and stay host-scanned).  An admission batch is ONE copy per
    plane array into preallocated power-of-two capacity on ``device``:
    the port updates the resident tensors IN PLACE (``copy_`` into a
    slice), where the JAX package rebuilt each array functionally.
    Capacity growth allocates new tensors and copies the old rows over
    on the device;
  * **eviction** — a byte budget with LRU-by-last-scan ordering; evicted
    segments fall back to the host scan path and may be re-admitted by a
    later ``sync`` (uploads are counted, so tests can pin the
    steady-state transfer count at zero);
  * **instrumentation** — ``uploads`` / ``upload_bytes`` count every
    host->device transfer of segment *column* payload; ``syncs``,
    ``admitted`` and ``sync_s`` count the ``sync`` calls, the segments
    they admitted and the host seconds spent in them.  Per-scan
    parameter tables (dictionary code lookups, substring LUTs, pushed
    masks) are O(terms x slots) and intentionally not counted as
    segment traffic — they are the query, not the data.

What stays host-side, by design: float64 numeric columns (the repr-code
equivalence in ``kernels.scan_fused`` makes them redundant for exact
evaluation), zone-map refutation (needs f64 bounds,
NaN poison flags and dictionary membership sets — the verdict ships as
the kernel's ``active`` mask), raw remainders (unparsed by definition),
and open builder tails (mutable).  Segments are immutable once sealed,
so epoch bumps never invalidate resident slots — a replan only changes
the *pushed masks* resolved per scan via ``store.pushed_by_epoch``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bitvector
from repro_torch.core.columnar import ColumnarSegment, _f64_exact, _num_reprs
from repro_torch.core.predicates import Kind, SimplePredicate, json_scalar
from repro_torch.kernels.scan_fused import (
    KIND_KV, MAX_COVERED, _KIND_CODE,
    DevicePlaneArrays, ScanBatch, ScanParams, bucket_pow2,
)

_N_FLOOR = 4096      # row-capacity floor (pow2)

#: (fill, dtype) of each plane array: rows of absent keys / free capacity
_FILLS = {
    "pres": (0, torch.uint8), "notn": (0, torch.uint8),
    "isb": (0, torch.uint8), "numv": (0, torch.uint8),
    "scod": (-1, torch.int32), "rcod": (-1, torch.int32),
    "sid": (-1, torch.int32), "cw": (0, torch.uint32),
}


@dataclass
class CacheSlot:
    """Host metadata for one resident segment."""

    seg: ColumnarSegment
    index: int          # position in the slot order == device slot id
    offset: int         # first row in the concatenated plane
    n_rows: int
    nbytes: int
    is_jit: bool        # promoted raw remainder (no pushed bitvectors)
    last_used: int


class DeviceSegmentCache:
    """Per-store device mirror of sealed + JIT-promoted segments."""

    def __init__(self, *, byte_budget: int = 256 << 20, device="cuda"):
        self.byte_budget = int(byte_budget)
        self.device = torch.device(device)
        self._slots: dict[int, CacheSlot] = {}     # id(seg) -> slot
        self._order: list[CacheSlot] = []          # slot id order
        self._key_rows: dict[str, int] = {}        # key -> plane row (>= 1)
        self._plane: DevicePlaneArrays | None = None
        self._n_used = 0
        self._tick = 0
        self.uploads = 0          # host->device segment-column transfers
        self.upload_bytes = 0
        self.syncs = 0            # sync() calls
        self.admitted = 0         # segments admitted by them
        self.sync_s = 0.0         # host seconds in sync()
        self.evictions = 0
        # per-(segment, term) parameter memo: code tables & substring LUTs
        self._term_cache: dict[tuple[int, SimplePredicate], tuple] = {}

    # -- introspection ------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return len(self._order)

    @property
    def slots(self) -> list[CacheSlot]:
        return self._order

    @property
    def bytes_used(self) -> int:
        return sum(s.nbytes for s in self._order)

    @property
    def plane(self) -> DevicePlaneArrays | None:
        return self._plane

    def slot_for(self, seg: ColumnarSegment) -> CacheSlot | None:
        return self._slots.get(id(seg))

    # -- admission ----------------------------------------------------------

    @staticmethod
    def _eligible(seg: ColumnarSegment) -> bool:
        # one uint32 clause word per row caps mirrored pushed coverage;
        # segments with un-materialized lazy keys stay host-side — a
        # missing device column reads as all-absent and would REFUTE
        # rows a lazy key actually matches (DESIGN.md §18)
        return (seg.n_rows > 0 and seg.bitvectors.shape[0] <= MAX_COVERED
                and not getattr(seg, "lazy_keys", None))

    def sync(self, store) -> int:
        """Mirror the store's queryable surface; enforce the byte budget.

        Admits every eligible segment of ``store.blocks`` (sealed AND
        open-builder tail views — the views are cached until their next
        append, so their identity is stable between ingests) plus the
        JIT-promoted remainders, and drops slots whose segment is no
        longer part of the surface (a tail view invalidated by an
        append, a truncated restore).  Returns the number of segments
        admitted.  Steady state (no ingest, no promotion since the last
        call) admits nothing, drops nothing, and performs zero
        transfers; ingest-heavy phases re-admit the changed tails —
        that churn is counted by ``uploads``, not hidden.
        """
        t0 = time.perf_counter()
        live: dict[int, tuple[ColumnarSegment, bool]] = {}
        for seg in store.blocks:
            live[id(seg)] = (seg, False)
        for seg in store.jit_blocks:
            live[id(seg)] = (seg, True)
        if any(i not in live for i in self._slots):
            self._rebuild([(s.seg, s.is_jit) for s in self._order
                           if id(s.seg) in live])
        fresh = [(seg, is_jit) for i, (seg, is_jit) in live.items()
                 if i not in self._slots and self._eligible(seg)]
        if fresh:
            self._admit(fresh)
        self._enforce_budget()
        self.syncs += 1
        self.admitted += len(fresh)
        self.sync_s += time.perf_counter() - t0
        return len(fresh)

    def _admit(self, pairs: Sequence[tuple[ColumnarSegment, bool]]) -> None:
        for seg, _ in pairs:
            for key in seg.key_cols:
                if key not in self._key_rows:
                    self._key_rows[key] = len(self._key_rows) + 1
        k_cap = bucket_pow2(len(self._key_rows) + 1, 2)
        n_new = sum(seg.n_rows for seg, _ in pairs)
        n_cap = bucket_pow2(self._n_used + n_new, _N_FLOOR)
        self._ensure_capacity(k_cap, n_cap)
        p = self._plane
        assert p is not None
        k_cap, n_cap = p.pres.shape

        pres = np.zeros((k_cap, n_new), np.uint8)
        notn = np.zeros((k_cap, n_new), np.uint8)
        isb = np.zeros((k_cap, n_new), np.uint8)
        numv = np.zeros((k_cap, n_new), np.uint8)
        scod = np.full((k_cap, n_new), -1, np.int32)
        rcod = np.full((k_cap, n_new), -1, np.int32)
        sid = np.zeros((n_new,), np.int32)
        cw = np.zeros((n_new,), np.uint32)
        at = 0
        for seg, is_jit in pairs:
            n = seg.n_rows
            for key, col in seg.key_cols.items():
                r = self._key_rows[key]
                pres[r, at:at + n] = col.present
                notn[r, at:at + n] = col.notnull
                isb[r, at:at + n] = col.is_bool
                numv[r, at:at + n] = col.num_valid
                scod[r, at:at + n] = col.str_codes
                rcod[r, at:at + n] = col.repr_codes
            slot = CacheSlot(
                seg=seg, index=len(self._order),
                offset=self._n_used + at, n_rows=n,
                nbytes=seg.plane_nbytes(k_cap),
                is_jit=is_jit, last_used=self._tick,
            )
            sid[at:at + n] = slot.index
            rows = seg.bitvectors.shape[0]
            if rows:
                bits = bitvector.unpack(seg.bitvectors, n)
                shifts = np.arange(rows, dtype=np.uint32)[:, None]
                cw[at:at + n] = np.bitwise_or.reduce(
                    np.left_shift(bits.astype(np.uint32), shifts), axis=0)
            self._slots[id(seg)] = slot
            self._order.append(slot)
            at += n

        off = self._n_used
        for name, block in zip(DevicePlaneArrays._fields,
                               (pres, notn, isb, numv, scod, rcod, sid, cw)):
            self._upload(getattr(p, name)[..., off:off + n_new], block)
        self._n_used += n_new

    def _upload(self, dst: torch.Tensor, block: np.ndarray) -> None:
        """Copy one host block into its resident slice (counted)."""
        self.uploads += 1
        self.upload_bytes += block.nbytes
        dst.copy_(torch.from_numpy(block))

    def _ensure_capacity(self, k_cap: int, n_cap: int) -> None:
        p = self._plane
        if p is not None:
            ok, on = p.pres.shape
            if k_cap <= ok and n_cap <= on:
                return
            k_cap, n_cap = max(k_cap, ok), max(n_cap, on)
        arrays = {}
        for name, (fill, dtype) in _FILLS.items():
            shape = (n_cap,) if name in ("sid", "cw") else (k_cap, n_cap)
            if dtype == torch.uint32:   # fill 0, made as int32 zeros
                new = torch.zeros(shape, dtype=torch.int32,
                                  device=self.device).view(torch.uint32)
            else:
                new = torch.full(shape, fill, dtype=dtype,
                                 device=self.device)
            if p is not None:
                old = getattr(p, name)
                new[tuple(slice(0, d) for d in old.shape)].copy_(old)
            arrays[name] = new
        self._plane = DevicePlaneArrays(**arrays)

    # -- eviction -----------------------------------------------------------

    def touch(self, slot_indices: Sequence[int]) -> None:
        """Mark slots as used by the current scan (LRU ordering)."""
        self._tick += 1
        for i in slot_indices:
            self._order[i].last_used = self._tick

    def _enforce_budget(self) -> None:
        used = self.bytes_used
        if used <= self.byte_budget or not self._order:
            return
        victims = sorted(self._order, key=lambda s: (s.last_used, s.index))
        evict: set[int] = set()
        for s in victims:
            if used <= self.byte_budget:
                break
            used -= s.nbytes
            evict.add(s.index)
            self.evictions += 1
        self._rebuild([(s.seg, s.is_jit) for s in self._order
                       if s.index not in evict])

    def _rebuild(self, retained: list[tuple[ColumnarSegment, bool]]) -> None:
        """Compact the plane down to ``retained`` (eviction / slot GC).

        Re-uploads the retained segments from their host-resident
        columns; the transfers are counted — shrinking the plane is not
        steady state."""
        ticks = {id(s.seg): s.last_used for s in self._order}
        self._slots.clear()
        self._order.clear()
        self._key_rows.clear()
        self._plane = None
        self._n_used = 0
        if retained:
            self._admit(retained)
            for s in self._order:
                s.last_used = ticks.get(id(s.seg), s.last_used)

    # -- per-scan parameter assembly ---------------------------------------

    def key_row(self, key: str) -> int:
        return self._key_rows.get(key, 0)   # row 0 = reserved all-absent

    def _term_entry(self, t: SimplePredicate, seg: ColumnarSegment) -> tuple:
        """(code_a, num_codes[3], lut | None) for one (term, segment).

        Memoized — these depend only on the segment's immutable
        dictionaries and the term's value, so the steady-state scan path
        does no dictionary work at all.
        """
        ck = (id(seg), t)
        hit = self._term_cache.get(ck)
        if hit is not None:
            return hit
        col = seg.key_cols.get(t.key)
        code_a, nc, lut = -2, (-2, -2, -2), None
        v = t.value
        if col is not None:
            if t.kind is Kind.EXACT:
                code_a = col.str_index.get(v, -2)
            elif t.kind is Kind.SUBSTRING:
                if not isinstance(v, bool):   # bool: provably empty
                    sub = str(v)
                    lut = np.zeros((len(col.str_dict) + 1,), np.uint8)
                    for s, code in col.str_index.items():
                        lut[code + 1] = sub in s
            elif t.kind is Kind.KEY_VALUE:
                code_a = col.repr_index.get(json_scalar(v), -2)
                if (v is not None and not isinstance(v, (bool, str))
                        and _f64_exact(v)):
                    codes = [col.repr_index[r]
                             for r in _num_reprs(float(v))
                             if r in col.repr_index]
                    codes = (codes + [-2, -2, -2])[:3]
                    nc = tuple(codes)
        entry = (code_a, nc, lut)
        if len(self._term_cache) > 8192:
            self._term_cache.clear()
        self._term_cache[ck] = entry
        return entry

    def build_params(self, batch: ScanBatch, *, pushed_bits: np.ndarray,
                     active: np.ndarray) -> ScanParams:
        """Bucket-padded parameter tables for one launch.

        ``pushed_bits uint32[Q, S]`` / ``active uint8[Q, S]`` arrive from
        the scanner's host-side pushdown + zone-prune resolution over the
        REAL (query, slot) grid; padding queries/slots are inert (active
        0, pushed 0).
        """
        S = self.n_slots
        T, C, Q = batch.n_terms, batch.n_clauses, batch.n_queries
        Tb, Cb, Qb = bucket_pow2(T), bucket_pow2(C), bucket_pow2(Q)
        S1 = bucket_pow2(S + 1)
        key_ids = np.zeros((Tb,), np.int32)
        kinds = np.full((Tb,), -1, np.int32)
        code_a = np.full((Tb, S1), -2, np.int32)
        num_codes = np.full((Tb, 3, S1), -2, np.int32)
        lut_off = np.full((Tb, S1), -1, np.int32)
        is_null = np.zeros((Tb,), np.uint8)
        is_boolv = np.zeros((Tb,), np.uint8)
        luts: list[np.ndarray] = [np.zeros((1,), np.uint8)]
        lut_len = 1
        for ti, t in enumerate(batch.terms):
            key_ids[ti] = self.key_row(t.key)
            # kinds without a device code (RANGE/IN) stay -1: inert rows,
            # referenced only by clauses of non-query_ok queries whose
            # device counts are discarded (host fallback)
            kinds[ti] = _KIND_CODE.get(t.kind, -1)
            if kinds[ti] == KIND_KV:
                is_null[ti] = t.value is None
                is_boolv[ti] = isinstance(t.value, bool)
            for si, slot in enumerate(self._order):
                ca, nc, lut = self._term_entry(t, slot.seg)
                code_a[ti, si] = ca
                num_codes[ti, :, si] = nc
                if lut is not None:
                    lut_off[ti, si] = lut_len
                    luts.append(lut)
                    lut_len += lut.shape[0]
        lut_flat = np.concatenate(luts)
        Lb = bucket_pow2(lut_len, 8)
        if Lb != lut_len:
            lut_flat = np.concatenate(
                [lut_flat, np.zeros((Lb - lut_len,), np.uint8)])
        membership = np.zeros((Cb, Tb), np.uint8)
        membership[:C, :T] = batch.membership
        query_clause = np.zeros((Qb, Cb), np.uint8)
        query_clause[:Q, :C] = batch.query_clause
        ptab = np.zeros((Qb, S1), np.uint32)
        ptab[:Q, :S] = pushed_bits
        act = np.zeros((Qb, S1), np.uint8)
        act[:Q, :S] = active
        return ScanParams(
            key_ids=key_ids, kinds=kinds, code_a=code_a,
            num_codes=num_codes, lut_off=lut_off, lut_flat=lut_flat,
            is_null=is_null, is_boolv=is_boolv, membership=membership,
            query_clause=query_clause, pushed_tbl=ptab, active=act,
        )
