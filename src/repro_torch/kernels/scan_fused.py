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
the whole batch: zone-prune mask -> pushed bitvector AND -> lowered
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

from repro_torch.core import bitvector
from repro_torch.core.predicates import (
    Clause, Kind, Query, SimplePredicate, lowerable,
)

from . import cuda_build
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
    cm = torch.stack([term[mem[c]].any(dim=0) for c in range(mem.shape[0])])
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
#: resident blocks per SM of the grid-stride launch
_BLOCKS_PER_SM = 8

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("scan")
    if not getattr(lib, "_typed", False):
        lib.ciao_scan.argtypes = (
            [_I] + [_P] * 8 + [_LL] + [_P] * 6 + [_I] + [_P] * 6 + [_I] * 5
            + [_P, _P, _P])
        lib.ciao_scan.restype = _I
        lib.ciao_scan_max_words.restype = _I
        lib.ciao_scan_smem_bytes.argtypes = [_I, _I, _I]
        lib.ciao_scan_smem_bytes.restype = _I
        lib._typed = True
    return lib


def _check_plane(plane: DevicePlaneArrays) -> None:
    K, N = plane.pres.shape
    want = {"pres": (torch.uint8, (K, N)), "notn": (torch.uint8, (K, N)),
            "isb": (torch.uint8, (K, N)), "numv": (torch.uint8, (K, N)),
            "scod": (torch.int32, (K, N)), "rcod": (torch.int32, (K, N)),
            "sid": (torch.int32, (N,)), "cw": (torch.uint32, (N,))}
    for name, (dtype, shape) in want.items():
        cuda_build.check_tensor(getattr(plane, name), f"plane.{name}", dtype,
                                shape, plane.sid.device)


class StagedParams(NamedTuple):
    """One launch's parameter tables in a single device buffer."""

    buf: torch.Tensor               # uint8, every table 16-byte aligned
    offsets: dict                   # table name -> byte offset in ``buf``
    dims: tuple                     # (T, C, Q, S1, lut length)


#: the tables the kernel reads, in buffer order; membership and
#: query_clause travel as little-endian bit masks over their rows
_STAGED = ("key_ids", "kinds", "code_a", "num_codes", "lut_off", "lut_flat",
           "is_null", "is_boolv", "membership", "query_clause", "pushed_tbl",
           "active")


def pack_params(params: ScanParams) -> tuple[np.ndarray, dict]:
    """All tables the kernel reads in one uint8 buffer, 16-byte aligned.

    Returns ``(buffer, offsets)``; membership and query_clause are packed
    into little-endian uint32 bit masks over their rows first.
    """
    tables = params._replace(
        membership=bitvector.pack(params.membership > 0),
        query_clause=bitvector.pack(params.query_clause > 0))._asdict()
    offsets, at = {}, 0
    for name in _STAGED:
        offsets[name] = at
        at += -(-tables[name].nbytes // 16) * 16
    host = np.zeros((at,), np.uint8)
    for name in _STAGED:
        raw = np.ascontiguousarray(tables[name]).reshape(-1).view(np.uint8)
        host[offsets[name]:offsets[name] + raw.size] = raw
    return host, offsets


def stage_params(params: ScanParams, device) -> StagedParams:
    """Pack one launch's tables into one buffer: ONE host->device copy."""
    T = params.kinds.shape[0]
    C, Q = params.membership.shape[0], params.query_clause.shape[0]
    S1 = params.pushed_tbl.shape[1]
    lib = _lib()
    limit = 32 * lib.ciao_scan_max_words()
    if T > limit or C > limit:
        raise ValueError(f"scan batch has {T} term and {C} clause slots; "
                         f"the kernel holds at most {limit} of each")
    smem = lib.ciao_scan_smem_bytes(T, C, Q)
    if smem > 232_448:
        raise ValueError(f"scan batch of {Q} queries needs {smem} B of "
                         "shared memory per block (limit 232448)")
    host, offsets = pack_params(params)
    return StagedParams(buf=torch.from_numpy(host).to(device),
                        offsets=offsets,
                        dims=(T, C, Q, S1, params.lut_flat.shape[0]))


def launch_scan(plane: DevicePlaneArrays, staged: StagedParams
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/scan.cu`` over staged tables (no host copy)."""
    global launches
    dev = plane.sid.device
    if dev.type != "cuda" or staged.buf.device != dev:
        raise ValueError(f"plane and tables must be on one CUDA device, "
                         f"not {dev} and {staged.buf.device}")
    _check_plane(plane)
    T, C, Q, S1, L = staged.dims
    out = torch.zeros((2, Q, S1), dtype=torch.int32, device=dev)
    base = staged.buf.data_ptr()
    ptr = {name: base + off for name, off in staged.offsets.items()}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _lib()
    err = lib.ciao_scan(
        dev.index, *(t.data_ptr() for t in plane), plane.sid.shape[0],
        ptr["key_ids"], ptr["kinds"], ptr["code_a"], ptr["num_codes"],
        ptr["lut_off"], ptr["lut_flat"], L, ptr["is_null"], ptr["is_boolv"],
        ptr["membership"], ptr["query_clause"], ptr["pushed_tbl"],
        ptr["active"], T, C, Q, S1, n_sm * _BLOCKS_PER_SM,
        out[0].data_ptr(), out[1].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "scan")
    launches += 1
    return out[0], out[1]


def scan_core_cuda(plane: DevicePlaneArrays, params: ScanParams
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts, cands)`` int32[Q, S1] from one launch of ``csrc/scan.cu``.

    On a plane held on the CPU this runs the plain version
    (:func:`scan_core`) instead.  Raises on term/clause buckets wider than
    the kernel's register and shared-memory tables.
    """
    dev = plane.sid.device
    if dev.type == "cpu":
        return scan_core(plane, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return launch_scan(plane, stage_params(params, dev))


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
                backend: str = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """One fused launch over the plane; ``(counts, cands)`` as int32[Q, S1].

    ``backend``: ``"cuda"`` (the hand-written kernel; the plane must be on
    a card), ``"torch"`` (the plain version on the plane's device) or
    ``"numpy"`` (the host reference — converts the plane per call).
    """
    if backend == "numpy":
        return scan_core_numpy(
            *(a.cpu().numpy() for a in plane), params)
    if backend == "cuda":
        if plane.sid.device.type != "cuda":
            raise ValueError("backend 'cuda' needs the plane on a CUDA "
                             f"device, not {plane.sid.device}")
        counts, cands = scan_core_cuda(plane, params)
    elif backend == "torch":
        counts, cands = scan_core(plane, params)
    else:
        raise ValueError(f"unknown device scan backend {backend!r}")
    return counts.cpu().numpy(), cands.cpu().numpy()
