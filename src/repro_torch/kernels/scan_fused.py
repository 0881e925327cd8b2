"""Fused multi-query scan over the device-resident segment plane.

The device half of DESIGN.md §15, ported from ``repro.kernels.scan_fused``.
The host half (:class:`repro_torch.core.device_cache.DeviceSegmentCache`)
keeps every hot segment's columnar state resident as torch tensors on the
device:

  * per-key row masks     — present / notnull / is_bool / num_valid,
    stacked ``uint8[K, N]`` over the concatenated rows of all cached
    segments (``K`` = union of keys, row 0 reserved all-absent);
  * dictionary codes      — ``str_codes`` / ``repr_codes`` ``int32[K, N]``
    (-1 = not-a-string / absent, matching ``core.columnar.KeyColumn``);
  * ``seg_ids int32[N]``  — row -> cache slot (-1 = capacity padding);
  * ``clause_word``       — the segment's packed pushed bitvectors,
    TRANSPOSED to one ``uint32`` per row (bit *p* = clause row *p* of
    that segment's coverage; cache admission requires n_covered <= 32).

A batch of queries compiles once (:func:`compile_scan_batch`) into
per-scan parameter tables resolved on the host from the segment
dictionaries (codes, substring LUTs, pushed-bit masks, zone-prune
verdicts): O(terms x slots), never O(rows).  One launch then evaluates
the whole batch (several, grouped by query, only when its tables exceed a
block's shared memory): zone-prune mask -> pushed bitvector AND -> lowered
residual on dictionary codes -> per-(query, slot) popcount, bit-identical
to ``core.columnar.query_mask`` because every ``eval_lowered`` branch has
an exact integer form (see the JAX package's module for the derivation).

Three implementations of one function, all returning ``counts[Q, S1]`` /
``cands[Q, S1]`` (matches, pushed-candidate rows) per cache slot:

  * :func:`scan_core_cuda` — wrapper of the hand-written CUDA kernel
    ``csrc/scan.cu`` (on a CPU tensor it runs :func:`scan_core`);
  * :func:`scan_core` — the plain PyTorch version of that kernel;
  * :func:`scan_core_numpy` — the numpy reference, verbatim from the JAX
    package.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.predicates import (
    Clause, Kind, Query, SimplePredicate, lowerable,
)

from . import cuda_build
from .fused import MAX_SMEM
from .plan import compile_query_batch

KIND_PRESENCE = 0
KIND_EXACT = 1
KIND_SUBSTRING = 2
KIND_KV = 3
_KIND_CODE = {
    Kind.KEY_PRESENCE: KIND_PRESENCE,
    Kind.EXACT: KIND_EXACT,
    Kind.SUBSTRING: KIND_SUBSTRING,
    Kind.KEY_VALUE: KIND_KV,
}

#: cache slots carry pushed coverage as one uint32 word per row
MAX_COVERED = 32


def device_lowerable(t: SimplePredicate) -> bool:
    """True iff ``t`` evaluates on the device dictionary-code plane.

    Stricter than host ``lowerable``: RANGE and IN lower to vectorized
    numpy (repr-LUT / per-element OR) but have no ``_KIND_CODE`` row —
    their repr LUTs would be per-(term, slot) rebuilt parameters of
    unbounded width.  Queries containing them fall back whole to the
    host scanner (the standard non-eligible path), keeping counts
    bit-identical.
    """
    return lowerable(t) and t.kind in _KIND_CODE


# ---------------------------------------------------------------------------
# batch compilation: queries -> deduped clause/term tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScanBatch:
    """Clause/term-deduped encoding of a query batch (host-side)."""

    queries: tuple[Query, ...]
    clauses: tuple[Clause, ...]          # unique clauses across the batch
    terms: tuple[SimplePredicate, ...]   # unique terms across those clauses
    membership: np.ndarray               # uint8[C, T] clause -> term
    query_clause: np.ndarray             # uint8[Q, C] query -> clause
    query_ok: tuple[bool, ...]           # per-query device eligibility

    @property
    def n_queries(self) -> int:
        return len(self.queries)

    @property
    def n_clauses(self) -> int:
        return len(self.clauses)

    @property
    def n_terms(self) -> int:
        return len(self.terms)


def compile_scan_batch(queries: Sequence[Query]) -> ScanBatch:
    """Dedup clauses and terms across a query batch.

    Thin wrapper over :func:`repro_torch.kernels.plan.compile_query_batch` —
    ONE implementation of the query -> clause -> term type-strict dedup
    serves both multi-query planes (the host ``ScanBatcher`` and this
    device compiler); see its docstring for why the dedup keys on
    predicate equality rather than ``dedup_terms``' pattern bytes.
    ``query_ok`` is the per-query device-eligibility flag: every term
    must lower onto the dictionary-code plane (:func:`device_lowerable`
    — host-lowerable RANGE/IN terms still disqualify a query here).
    """
    qb = compile_query_batch(queries)
    ok = tuple(
        all(device_lowerable(t) for c in q.clauses for t in c.terms)
        for q in qb.queries
    )
    return ScanBatch(
        queries=qb.queries, clauses=qb.clauses, terms=qb.terms,
        membership=qb.membership, query_clause=qb.query_clause,
        query_ok=ok,
    )


class ScanParams(NamedTuple):
    """Per-scan parameter tables (host numpy, bucket-padded).

    Shapes: T/C/Q/S1 are power-of-two buckets of (terms, clauses,
    queries, slots + 1); the extra slot S1-1 is the dummy that
    capacity-padding rows (seg_id -1) resolve to, with ``active`` zeroed
    so they can never contribute.
    """

    key_ids: np.ndarray      # int32[T]   term -> plane key row (0 = absent)
    kinds: np.ndarray        # int32[T]   KIND_* (-1 = padding, inert)
    code_a: np.ndarray       # int32[T, S1]  EXACT str code / KV repr code
    num_codes: np.ndarray    # int32[T, 3, S1] KV numeric repr codes
    lut_off: np.ndarray      # int32[T, S1]  substring LUT base (-1 = empty)
    lut_flat: np.ndarray     # uint8[L]      concatenated substring LUTs
    is_null: np.ndarray      # uint8[T]   KV value is None
    is_boolv: np.ndarray     # uint8[T]   KV value is a bool
    membership: np.ndarray   # uint8[C, T]
    query_clause: np.ndarray  # uint8[Q, C]
    pushed_tbl: np.ndarray   # uint32[Q, S1] pushed clause bits (0 = all-pass)
    active: np.ndarray       # uint8[Q, S1]  zone-prune verdict (0 = pruned)


def _pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Power-of-two shape bucket."""
    return _pow2(n, floor)


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel
# ---------------------------------------------------------------------------

class DevicePlaneArrays(NamedTuple):
    """The device-resident plane a launch consumes (torch tensors)."""

    pres: torch.Tensor    # uint8[K, N]
    notn: torch.Tensor    # uint8[K, N]
    isb: torch.Tensor     # uint8[K, N]
    numv: torch.Tensor    # uint8[K, N]
    scod: torch.Tensor    # int32[K, N]
    rcod: torch.Tensor    # int32[K, N]
    sid: torch.Tensor     # int32[N] (-1 = padding)
    cw: torch.Tensor      # uint32[N]


def _params_on(params: ScanParams, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in params._asdict().items()}


def scan_core(plane: DevicePlaneArrays, params: ScanParams
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused scan, on the plane's device.

    Same arithmetic as :func:`scan_core_numpy`; uint32 words are compared
    through int32 views (``&`` and ``==`` see the same bits).
    """
    dev = plane.sid.device
    p = _params_on(params, dev)
    S1 = params.pushed_tbl.shape[1]
    L = params.lut_flat.shape[0]
    sid = torch.where(plane.sid < 0, S1 - 1, plane.sid).long()
    key_ids = p["key_ids"].long()
    tp = plane.pres[key_ids] > 0              # (T, N)
    tn = plane.notn[key_ids] > 0
    tb = plane.isb[key_ids] > 0
    tv = plane.numv[key_ids] > 0
    ts = plane.scod[key_ids]
    tr = plane.rcod[key_ids]
    ca = p["code_a"][:, sid]
    off = p["lut_off"][:, sid]
    m_exact = ts == ca
    idx = torch.clamp(off + 1 + ts, 0, L - 1).long()
    m_sub = (p["lut_flat"][idx] > 0) & (off >= 0)
    nc = p["num_codes"][:, :, sid]
    m_num = tv & (nc == tr[:, None, :]).any(dim=1)
    m_null = (p["is_null"][:, None] > 0) & tp & ~tn
    compat = torch.where(p["is_boolv"][:, None] > 0, tb, tp & ~tb)
    m_kv = ((tr == ca) | m_num | m_null) & compat
    k = p["kinds"][:, None]
    term = torch.where(
        k == KIND_PRESENCE, tn,
        torch.where(k == KIND_EXACT, m_exact,
                    torch.where(k == KIND_SUBSTRING, m_sub,
                                (k == KIND_KV) & m_kv)))
    mem = p["membership"].bool()
    cm = torch.stack([term[mem[c]].any(dim=0) for c in range(mem.shape[0])]) \
        if mem.shape[0] else term.new_zeros((0, term.shape[1]))
    qc = p["query_clause"].bool()
    qm = torch.stack([cm[qc[q]].all(dim=0) for q in range(qc.shape[0])])
    ptab = p["pushed_tbl"].view(torch.int32)[:, sid]
    cw = plane.cw.view(torch.int32)
    pm = (cw[None, :] & ptab) == ptab
    act = p["active"][:, sid] > 0
    hit = qm & pm & act
    pa = pm & act
    Q = params.pushed_tbl.shape[0]
    counts = torch.zeros((Q, S1), dtype=torch.int32, device=dev)
    cands = torch.zeros((Q, S1), dtype=torch.int32, device=dev)
    counts.index_add_(1, sid, hit.to(torch.int32))
    cands.index_add_(1, sid, pa.to(torch.int32))
    return counts, cands


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

#: launches of the CUDA kernel in this process (the main-path proof)
launches = 0
#: blocks per SM of the launch (each takes a contiguous run of tiles)
_BLOCKS_PER_SM = 4
#: warps per block of a launch (each takes one tile of 32 rows at a time)
KERNEL_WARPS = 8
#: the per-block [2][Q][S1] counters stay in shared memory up to this size;
#: above it the kernel adds into the global counts directly
LOCAL_ACC_BYTES = 64 << 10

#: plane fields a key group reads (``csrc/scan.cu``)
FIELD_PRES, FIELD_NOTN, FIELD_ISB, FIELD_NUMV, FIELD_SCOD, FIELD_RCOD = (
    1, 2, 4, 8, 16, 32)
_KIND_FIELDS = np.array([
    FIELD_NOTN,                                               # presence
    FIELD_SCOD,                                               # exact
    FIELD_SCOD,                                               # substring
    FIELD_PRES | FIELD_NOTN | FIELD_ISB | FIELD_NUMV | FIELD_RCOD,  # kv
], np.uint32)

#: header words of :func:`scan_table` (``csrc/scan.cu``)
(TABLE_N_LIVE, TABLE_N_GROUPS, TABLE_N_CLAUSES, TABLE_N_QUERIES,
 TABLE_OFF_TERM, TABLE_OFF_GROUP, TABLE_OFF_CBEG, TABLE_OFF_CTERM,
 TABLE_OFF_QBEG, TABLE_OFF_QCLAUSE, TABLE_PUSHED_MASK,
 TABLE_SKIP_PADDING) = range(12)
_TABLE_HEADER = 12

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    return cuda_build.load("scan", {
        "ciao_scan": (
            [_I] + [_P] * 8 + [_LL] + [_P] * 4 + [_I] + [_P] * 2 + [_I, _P]
            + [_I] * 6 + [_P] * 3, _I),
    })


def _check_plane(plane: DevicePlaneArrays) -> None:
    K, N = plane.pres.shape
    want = {"pres": (torch.uint8, (K, N)), "notn": (torch.uint8, (K, N)),
            "isb": (torch.uint8, (K, N)), "numv": (torch.uint8, (K, N)),
            "scod": (torch.int32, (K, N)), "rcod": (torch.int32, (K, N)),
            "sid": (torch.int32, (N,)), "cw": (torch.uint32, (N,))}
    for name, (dtype, shape) in want.items():
        cuda_build.check_tensor(getattr(plane, name), f"plane.{name}", dtype,
                                shape, plane.sid.device)


def scan_table(params: ScanParams) -> np.ndarray:
    """The batch's structure as the kernel reads it: one ``uint32`` table.

    Header (``TABLE_*``), then sections starting on 16-byte boundaries:

      * term records, one per live term (kinds 0-3; bucket padding and
        kinds without a device code are inert and left out), sorted by
        plane key, then kind: bits 0-15 the term's row of the (term, slot)
        tables, 16-18 its kind, 19 value is null, 20 value is a bool;
      * key groups of 8 words, ``(key, fields, first, exact, substring,
        key_value, end, 0)``: the key's records are ``[first, end)``, its
        presence terms start at ``first``, then each named kind's run, so
        a row's plane cells of one key are read once for all its terms
        and each kind runs its own loop;
      * the clause -> term list (CSR over term record positions) for the
        clauses the queries read, and the query -> clause list for the
        queries up to the last one with an active slot (later ones add
        nothing);
      * the OR of every pushed word (the bits the kernel transposes), and
        whether no query is active on the padding slot S1-1 (then tiles of
        padding rows alone are skipped).
    """
    kinds = params.kinds.astype(np.int64)
    live = np.flatnonzero((kinds >= KIND_PRESENCE) & (kinds <= KIND_KV))
    # (key, kind) as one sortable number: kinds take the low 2 bits
    key_kind = params.key_ids[live].astype(np.int64) << 2 | kinds[live]
    sort = np.argsort(key_kind, kind="stable")
    order, key_kind = live[sort], key_kind[sort]
    n_live = order.size
    recs = (order | (key_kind & 3) << 16
            | (params.is_null[order] > 0).astype(np.int64) << 19
            | (params.is_boolv[order] > 0).astype(np.int64) << 20)
    keys = key_kind >> 2
    groups = np.zeros((0, 8), np.int64)
    if n_live:
        first = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        end = np.r_[first[1:], n_live]
        fields = np.bitwise_or.reduceat(_KIND_FIELDS[key_kind & 3], first)
        # where each kind's run starts inside its key group
        runs = np.searchsorted(key_kind, keys[first][:, None] << 2 | np.array(
            [KIND_EXACT, KIND_SUBSTRING, KIND_KV]))
        groups = np.column_stack(
            [keys[first], fields.astype(np.int64), first, runs, end,
             np.zeros(len(first), np.int64)])

    queries = np.flatnonzero((params.active > 0).any(axis=1))
    Q = int(queries[-1]) + 1 if queries.size else 0
    qc = params.query_clause[:Q] > 0
    used = np.flatnonzero(qc.any(axis=0))
    C = int(used[-1]) + 1 if used.size else 0
    # membership's columns in term record order: its nonzeros are the
    # clause -> term list, each clause's terms in record order
    c_rows, c_terms = np.divmod(
        np.flatnonzero(params.membership[:C][:, order] > 0), max(n_live, 1))
    cbeg = np.searchsorted(c_rows, np.arange(C + 1))
    q_rows, q_clauses = np.divmod(np.flatnonzero(qc[:, :C]), max(C, 1))
    qbeg = np.searchsorted(q_rows, np.arange(Q + 1))
    pmask = int(np.bitwise_or.reduce(params.pushed_tbl[:Q].reshape(-1))) \
        if Q else 0

    sections = [recs, groups.reshape(-1), cbeg, c_terms, qbeg, q_clauses]
    offsets, at = [], _TABLE_HEADER
    for sec in sections:
        offsets.append(at)
        at += -(-sec.size // 4) * 4
    table = np.zeros((at,), np.uint32)
    skip = int(not (params.active[:, -1] > 0).any())
    table[:_TABLE_HEADER] = [n_live, len(groups), C, Q, *offsets, pmask, skip]
    for off, sec in zip(offsets, sections):
        table[off:off + sec.size] = sec
    return table


class ScanLayout(NamedTuple):
    """One launch's shared memory, as the kernel carves it."""

    smem: int           # bytes per block
    warp_words: int     # words of each warp's slice
    local_acc: bool     # [2][Q][S1] counters in shared memory


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def scan_layout(table: np.ndarray, S1: int) -> ScanLayout:
    """Shared memory of a launch over ``table`` (:func:`scan_table`): the
    table, the block's counters when they fit ``LOCAL_ACC_BYTES``, and per
    warp one slot's parameters (4 words a term, 2 a query), then the term,
    clause and pushed-bit words of a tile."""
    n_live, C, Q = (int(table[i]) for i in (
        TABLE_N_LIVE, TABLE_N_CLAUSES, TABLE_N_QUERIES))
    warp_words = _up4(4 * n_live + 2 * (Q + Q % 2) + n_live + C + 32)
    acc = 4 * _up4(2 * Q * S1)
    local = acc <= LOCAL_ACC_BYTES
    smem = table.nbytes + (acc if local else 0) \
        + KERNEL_WARPS * warp_words * 4
    return ScanLayout(smem=smem, warp_words=warp_words, local_acc=local)


def sub_params(params: ScanParams, queries: np.ndarray) -> ScanParams:
    """The tables of ``queries`` alone: their clauses and those clauses'
    terms, every slot; the same counts for those rows as the whole batch."""
    qc = params.query_clause[queries]
    clauses = np.flatnonzero((qc > 0).any(axis=0))
    terms = np.flatnonzero((params.membership[clauses] > 0).any(axis=0))
    return ScanParams(
        key_ids=params.key_ids[terms], kinds=params.kinds[terms],
        code_a=params.code_a[terms], num_codes=params.num_codes[terms],
        lut_off=params.lut_off[terms], lut_flat=params.lut_flat,
        is_null=params.is_null[terms], is_boolv=params.is_boolv[terms],
        membership=params.membership[np.ix_(clauses, terms)],
        query_clause=qc[:, clauses], pushed_tbl=params.pushed_tbl[queries],
        active=params.active[queries])


def query_groups(params: ScanParams, table: np.ndarray | None = None
                 ) -> list[tuple[np.ndarray, ScanParams, np.ndarray]]:
    """``(queries, their tables, their scan_table)`` per launch.

    The whole batch when its launch fits ``MAX_SMEM`` bytes of shared
    memory; else contiguous query groups, halved until each fits.  The
    groups cover every query once.  Raises if one query alone does not fit.
    ``table`` is the batch's :func:`scan_table`, built here when not given.
    """
    Q, S1 = params.pushed_tbl.shape
    table = scan_table(params) if table is None else table
    if scan_layout(table, S1).smem <= MAX_SMEM:
        return [(np.arange(Q), params, table)]
    k = 2
    while True:
        groups = []
        for idx in np.array_split(np.arange(Q), min(k, Q)):
            sub = sub_params(params, idx)
            t = scan_table(sub)
            if scan_layout(t, S1).smem > MAX_SMEM:
                if idx.size == 1:
                    raise ValueError(
                        f"query {int(idx[0])} alone needs "
                        f"{scan_layout(t, S1).smem} B of shared memory per "
                        f"block (limit {MAX_SMEM})")
                break
            groups.append((idx, sub, t))
        else:
            return groups
        k *= 2


class StagedParams(NamedTuple):
    """One launch's parameter tables in a single device buffer."""

    buf: torch.Tensor               # uint8, every table 16-byte aligned
    offsets: dict                   # table name -> byte offset in ``buf``
    dims: tuple                     # (Q, S1, lut length)
    layout: ScanLayout
    table_vec: int                  # 16-byte units of the scan table


#: the tables the kernel reads, in buffer order
_STAGED = ("code_a", "num_codes", "lut_off", "lut_flat", "pushed_tbl",
           "active", "table")


def pack_params(params: ScanParams, table: np.ndarray | None = None
                ) -> tuple[np.ndarray, dict]:
    """All tables the kernel reads in one uint8 buffer, 16-byte aligned.

    Returns ``(buffer, offsets)``; ``table`` is :func:`scan_table`, built
    here when not given.
    """
    tables = params._asdict()
    tables["table"] = scan_table(params) if table is None else table
    offsets, at = {}, 0
    for name in _STAGED:
        offsets[name] = at
        at += -(-tables[name].nbytes // 16) * 16
    host = np.zeros((at,), np.uint8)
    for name in _STAGED:
        raw = np.ascontiguousarray(tables[name]).reshape(-1).view(np.uint8)
        host[offsets[name]:offsets[name] + raw.size] = raw
    return host, offsets


def stage_params(params: ScanParams, device,
                 table: np.ndarray | None = None) -> StagedParams:
    """Pack one launch's tables into one buffer: ONE host->device copy.

    Raises if the launch needs more shared memory than a block may use
    (:func:`query_groups` splits such a batch first).
    """
    table = scan_table(params) if table is None else table
    Q, S1 = params.pushed_tbl.shape
    layout = scan_layout(table, S1)
    if layout.smem > MAX_SMEM:
        raise ValueError(f"scan launch needs {layout.smem} B of shared "
                         f"memory per block (limit {MAX_SMEM})")
    host, offsets = pack_params(params, table)
    return StagedParams(buf=torch.from_numpy(host).to(device),
                        offsets=offsets,
                        dims=(Q, S1, params.lut_flat.shape[0]),
                        layout=layout, table_vec=table.size // 4)


def launch_scan(plane: DevicePlaneArrays, staged: StagedParams
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/scan.cu`` over staged tables (no host copy)."""
    global launches
    dev = plane.sid.device
    if dev.type != "cuda" or staged.buf.device != dev:
        raise ValueError(f"plane and tables must be on one CUDA device, "
                         f"not {dev} and {staged.buf.device}")
    _check_plane(plane)
    Q, S1, L = staged.dims
    out = torch.zeros((2, Q, S1), dtype=torch.int32, device=dev)
    base = staged.buf.data_ptr()
    ptr = {name: base + off for name, off in staged.offsets.items()}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = staged.layout
    lib = _lib()
    err = lib.ciao_scan(
        dev.index, *(t.data_ptr() for t in plane), plane.sid.shape[0],
        ptr["code_a"], ptr["num_codes"], ptr["lut_off"], ptr["lut_flat"], L,
        ptr["pushed_tbl"], ptr["active"], S1, ptr["table"], staged.table_vec,
        lay.warp_words, int(lay.local_acc), lay.smem, KERNEL_WARPS,
        n_sm * _BLOCKS_PER_SM,
        out[0].data_ptr(), out[1].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "scan")
    with cuda_build.counter_lock:
        launches += 1
    return out[0], out[1]


def _by_query_groups(run, params: ScanParams, device,
                     table: np.ndarray | None) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """``run(params, table)`` once per :func:`query_groups` group, the
    rows gathered into one ``(counts, cands)`` pair."""
    groups = query_groups(params, table)
    if len(groups) == 1:
        return run(params, groups[0][2])
    Q, S1 = params.pushed_tbl.shape
    out = torch.zeros((2, Q, S1), dtype=torch.int32, device=device)
    for idx, sub, table in groups:
        if not table[TABLE_N_QUERIES]:
            continue                # no active slot: its rows stay 0
        counts, cands = run(sub, table)
        rows = torch.from_numpy(idx).to(device)
        out[0, rows] = counts
        out[1, rows] = cands
    return out[0], out[1]


def scan_core_cuda(plane: DevicePlaneArrays, params: ScanParams,
                   table: np.ndarray | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts, cands)`` int32[Q, S1] from ``csrc/scan.cu``.

    One launch per :func:`query_groups` group: one for a batch whose
    tables fit a block's shared memory (200 uniform queries over the ycsb
    pool take about 100 KB), several, by query, otherwise.  ``table`` is
    the batch's :func:`scan_table` when the caller built it already.  On a
    plane held on the CPU each group runs the plain version
    (:func:`scan_core`) instead.
    """
    dev = plane.sid.device
    if dev.type == "cpu":
        return _by_query_groups(lambda p, _t: scan_core(plane, p), params,
                                dev, table)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _by_query_groups(
        lambda p, t: launch_scan(plane, stage_params(p, dev, t)), params,
        dev, table)


# ---------------------------------------------------------------------------
# numpy reference and dispatch
# ---------------------------------------------------------------------------

def scan_core_numpy(pres, notn, isb, numv, scod, rcod, sid, cw,
                    params: ScanParams) -> tuple[np.ndarray, np.ndarray]:
    """Numpy-vectorized reference of the fused scan, bit-identical.

    Plane arrays arrive as HOST numpy (the baseline's "resident"
    mirror).  Serves two roles: the differential oracle the kernel
    backends are tested against, and the ``numpy`` side of
    ``benchmarks.bench_device`` — the same multi-query plane scan,
    vectorized the way a numpy engine would write it (one temporary per
    stage), so the gated speedup isolates what the fused single launch
    buys on identical work.
    """
    S1 = params.pushed_tbl.shape[1]
    L = params.lut_flat.shape[0]
    sid = np.where(sid < 0, S1 - 1, sid)
    key_ids = params.key_ids
    tp = pres[key_ids] > 0                    # (T, N)
    tn = notn[key_ids] > 0
    tb = isb[key_ids] > 0
    tv = numv[key_ids] > 0
    ts = scod[key_ids]
    tr = rcod[key_ids]
    ca = params.code_a[:, sid]
    off = params.lut_off[:, sid]
    m_exact = ts == ca
    idx = np.clip(off + 1 + ts, 0, L - 1)
    m_sub = (params.lut_flat[idx] > 0) & (off >= 0)
    nc = params.num_codes[:, :, sid]
    m_num = tv & (nc == tr[:, None, :]).any(axis=1)
    m_null = (params.is_null[:, None] > 0) & tp & ~tn
    compat = np.where(params.is_boolv[:, None] > 0, tb, tp & ~tb)
    m_kv = ((tr == ca) | m_num | m_null) & compat
    k = params.kinds[:, None]
    term = np.select(
        [k == KIND_PRESENCE, k == KIND_EXACT, k == KIND_SUBSTRING,
         k == KIND_KV],
        [tn, m_exact, m_sub, m_kv], False)
    cm = (params.membership.astype(np.int32) @ term.astype(np.int32)) > 0
    viol = params.query_clause.astype(np.int32) @ (1 - cm.astype(np.int32))
    qm = viol == 0                            # (Q, N)
    ptab = params.pushed_tbl[:, sid]
    pm = (cw[None, :] & ptab) == ptab
    act = params.active[:, sid] > 0
    hit = qm & pm & act
    pa = pm & act
    Q = params.pushed_tbl.shape[0]
    counts = np.zeros((Q, S1), np.int32)
    cands = np.zeros((Q, S1), np.int32)
    for q in range(Q):
        counts[q] = np.bincount(sid, weights=hit[q], minlength=S1)[:S1]
        cands[q] = np.bincount(sid, weights=pa[q], minlength=S1)[:S1]
    return counts, cands


def scan_counts(plane: DevicePlaneArrays, params: ScanParams, *,
                backend: str = "cuda", table: np.ndarray | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """The fused scan over the plane; ``(counts, cands)`` as int32[Q, S1].

    ``backend``: ``"cuda"`` (the hand-written kernel; the plane must be on
    a card), ``"torch"`` (the plain version on the plane's device) or
    ``"numpy"`` (the host reference — converts the plane per call).  The
    first two run one launch per :func:`query_groups` group (one unless
    the batch's tables exceed ``MAX_SMEM``), over ``table`` when given.
    """
    if backend == "numpy":
        return scan_core_numpy(
            *(a.cpu().numpy() for a in plane), params)
    if backend == "cuda":
        if plane.sid.device.type != "cuda":
            raise ValueError("backend 'cuda' needs the plane on a CUDA "
                             f"device, not {plane.sid.device}")
        counts, cands = scan_core_cuda(plane, params, table)
    elif backend == "torch":
        counts, cands = _by_query_groups(
            lambda p, _t: scan_core(plane, p), params, plane.sid.device,
            table)
    else:
        raise ValueError(f"unknown device scan backend {backend!r}")
    return counts.cpu().numpy(), cands.cpu().numpy()
