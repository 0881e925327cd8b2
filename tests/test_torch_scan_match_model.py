"""Kernels B (device scan) and D (pattern-set match) as numpy models, held
to the JAX package and to the port's plain versions, exactly.

The CUDA kernels (``csrc/scan.cu``, ``csrc/substring_match.cu``) cannot
run here.  What they compute is modelled word by word in numpy instead:

* kernel B reads the batch as one table (``scan_fused.scan_table``: live
  terms grouped by plane key with a run per kind, clause -> term and query ->
  clause lists, the OR of the pushed words).  Over tiles of 32 rows it
  forms one ballot word per term, ORs them into clause words, transposes
  the rows' pushed clause words by one ballot per pushed bit, and for each
  slot group of a tile ANDs a query's pushed-bit words and clause words;
  the model does the same from the decoded table, at the main path's
  buckets (T/C/Q 64) and at a 200-query uniform batch (T/C 512, Q 256);
* kernel D stages each record zero-filled past the stride, and flags
  candidate starts 4 at a time: the pattern's first min(m, 4) bytes XORed
  with the record word and its funnel-shifted neighbours, then a zero-byte
  test; only candidates run the full compare.  The model holds that the
  flags never miss a match, over the three pools and D's edges.

The models are held against the TPU kernels run in interpret mode
(``pallas_interpret``), their jnp oracles (``xla``) and the port's plain
versions, with tolerance 0: the results are integers and bits.  The
scanner is held to the JAX ``DeviceScanner`` on a 200-query uniform batch
in one launch, and split by query under a small shared-memory limit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import device_scan as j_device_scan  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import scan_fused as j_scan_fused  # noqa: E402
from repro_torch.core.client import encode_chunk, encode_patterns  # noqa: E402
from repro_torch.core.device_scan import DeviceScanner  # noqa: E402
from repro_torch.core.predicates import Kind  # noqa: E402
from repro_torch.core.workload import generate_workload  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels import ref, scan_fused  # noqa: E402
from test_torch_device_scan import (  # noqa: E402
    _build, _jq, accounting, ycsb,  # noqa: F401  (ycsb: a fixture)
)

def _words(bits: np.ndarray) -> np.ndarray:
    """uint32[..., n / 32]: bit i of word k is element 32k + i (a ballot)."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(
        np.uint32)


def _popc(w) -> int:
    return int(np.bitwise_count(np.uint32(w)))


# ---------------------------------------------------------------------------
# kernel B: the numpy model
# ---------------------------------------------------------------------------

def decode_table(table: np.ndarray) -> dict:
    """The sections of ``scan_fused.scan_table``."""
    t = table.astype(np.int64)
    n_live, n_groups, C, Q = (int(t[i]) for i in (
        scan_fused.TABLE_N_LIVE, scan_fused.TABLE_N_GROUPS,
        scan_fused.TABLE_N_CLAUSES, scan_fused.TABLE_N_QUERIES))
    o_term, o_group, o_cbeg, o_cterm, o_qbeg, o_qcl = (
        int(t[i]) for i in range(scan_fused.TABLE_OFF_TERM,
                                 scan_fused.TABLE_OFF_QCLAUSE + 1))
    for off in (o_term, o_group, o_cbeg, o_cterm, o_qbeg, o_qcl):
        assert off % 4 == 0                 # 16-byte sections
    cbeg = t[o_cbeg:o_cbeg + C + 1]
    qbeg = t[o_qbeg:o_qbeg + Q + 1]
    return {
        "terms": t[o_term:o_term + n_live],
        "groups": t[o_group:o_group + 8 * n_groups].reshape(-1, 8),
        "clauses": [t[o_cterm + cbeg[c]:o_cterm + cbeg[c + 1]]
                    for c in range(C)],
        "queries": [t[o_qcl + qbeg[q]:o_qcl + qbeg[q + 1]] for q in range(Q)],
        "pmask": int(t[scan_fused.TABLE_PUSHED_MASK]),
        "skip_padding": int(t[scan_fused.TABLE_SKIP_PADDING]),
    }


def _term_hits(params, rec: int, cells: dict, s: np.ndarray) -> np.ndarray:
    """bool[rows]: one term record over a key group's cells (term_hit)."""
    t, kind = rec & 0xFFFF, (rec >> 16) & 7
    if kind == scan_fused.KIND_PRESENCE:
        return cells["notn"] > 0
    ca = params.code_a[t, s]
    if kind == scan_fused.KIND_EXACT:
        return cells["scod"] == ca
    if kind == scan_fused.KIND_SUBSTRING:
        lo = params.lut_off[t, s]
        idx = np.clip(lo + 1 + cells["scod"], 0, params.lut_flat.size - 1)
        return (lo >= 0) & (params.lut_flat[idx] > 0)
    assert kind == scan_fused.KIND_KV
    tp, tn = cells["pres"] > 0, cells["notn"] > 0
    tb, tv, tr = cells["isb"] > 0, cells["numv"] > 0, cells["rcod"]
    nc = params.num_codes[t][:, s]                      # (3, rows)
    m_num = tv & (nc == tr[None]).any(axis=0)
    m_null = bool((rec >> 19) & 1) & tp & ~tn
    compat = tb if (rec >> 20) & 1 else (tp & ~tb)
    return ((tr == ca) | m_num | m_null) & compat


_FIELDS = (("pres", scan_fused.FIELD_PRES), ("notn", scan_fused.FIELD_NOTN),
           ("isb", scan_fused.FIELD_ISB), ("numv", scan_fused.FIELD_NUMV),
           ("scod", scan_fused.FIELD_SCOD), ("rcod", scan_fused.FIELD_RCOD))


def model_scan(plane: dict, params) -> tuple[np.ndarray, np.ndarray]:
    """Kernel B's tile algorithm from its table: ``(counts, cands)``."""
    tab = decode_table(scan_fused.scan_table(params))
    N = plane["sid"].size
    Qb, S1 = params.pushed_tbl.shape
    n_tiles = -(-N // 32)
    rows = n_tiles * 32
    inside = np.arange(rows) < N
    sid = np.full(rows, -1, np.int64)
    sid[:N] = plane["sid"]
    s = np.where(sid < 0, S1 - 1, sid)
    # term words, one per term and tile; each key group's cells read once
    tw = np.zeros((len(tab["terms"]), n_tiles), np.uint32)
    for key, fields, first, *_, end, _ in tab["groups"]:
        cells = {}
        for name, bit in _FIELDS:
            col = np.zeros(rows, np.int64)
            if fields & bit:
                col[:N] = plane[name][key]
            cells[name] = col
        for i in range(first, end):
            tw[i] = _words(_term_hits(params, int(tab["terms"][i]), cells, s)
                           & inside)
    # clause words: OR of their terms' words
    cwd = np.stack([np.bitwise_or.reduce(tw[c], axis=0) if c.size else
                    np.zeros(n_tiles, np.uint32) for c in tab["clauses"]]) \
        if tab["clauses"] else np.zeros((0, n_tiles), np.uint32)
    # the rows' pushed words transposed: one word per pushed bit and tile
    cw = np.zeros(rows, np.uint64)
    cw[:N] = plane["cw"]
    pw = {b: _words(((cw >> np.uint64(b)) & 1).astype(bool) & inside)
          for b in range(32) if (tab["pmask"] >> b) & 1}
    counts = np.zeros((Qb, S1), np.int64)
    cands = np.zeros((Qb, S1), np.int64)
    valid_w = _words(inside)
    for k in range(n_tiles):
        ts = s[32 * k:32 * k + 32]
        valid = int(valid_w[k])
        todo = valid
        while todo:                                     # slot groups
            lead = (todo & -todo).bit_length() - 1
            sg = int(ts[lead])
            group = int(_words(ts == sg)[0]) & valid
            todo &= ~group
            for q, clauses in enumerate(tab["queries"]):
                if not params.active[q, sg]:
                    continue
                pa = group                              # empty AND: all ones
                ptab = int(params.pushed_tbl[q, sg])
                for b in range(32):
                    if (ptab >> b) & 1:
                        pa &= int(pw[b][k])
                hit = pa
                for c in clauses:
                    hit &= int(cwd[c, k])
                cands[q, sg] += _popc(pa)
                counts[q, sg] += _popc(hit)
    return counts.astype(np.int32), cands.astype(np.int32)


def _plane_np(scanner) -> dict:
    names = ("pres", "notn", "isb", "numv", "scod", "rcod", "sid", "cw")
    return {n: a.numpy() for n, a in zip(names, scanner.cache.plane)}


def _batch(kind: str):
    pool = predicate_pool("ycsb")
    if kind == "zipf64":                # the main path's first batch shape
        wl = generate_workload(pool, n_queries=200, distribution="zipf",
                               zipf_a=1.5, rng=np.random.default_rng(0))
        return list(wl.queries)[:64]
    wl = generate_workload(pool, n_queries=200, distribution="uniform",
                           rng=np.random.default_rng(0))
    return list(wl.queries)


@pytest.mark.parametrize("kind,buckets", [("zipf64", (64, 64, 64)),
                                          ("uniform200", (512, 512, 256))])
def test_scan_model_matches_jax(ycsb, kind, buckets):
    store = _build(ycsb, jax=False)
    dev = DeviceScanner(store, backend="torch", device="cpu",
                        log_queries=False)
    params = dev._prepare(_batch(kind)).params
    assert (params.kinds.size, params.membership.shape[0],
            params.query_clause.shape[0]) == buckets
    plane = _plane_np(dev)
    # what the batch exercises: tiles across two segments, padding rows,
    # active queries with and without pushed bits
    sid = plane["sid"].reshape(-1, 32)
    assert any(len(set(t[t >= 0])) > 1 for t in sid)
    assert (plane["sid"] < 0).any()
    act = params.active > 0
    assert ((params.pushed_tbl == 0) & act).any()
    assert ((params.pushed_tbl != 0) & act).any()

    got = model_scan(plane, params)
    host = tuple(plane[n] for n in ("pres", "notn", "isb", "numv", "scod",
                                    "rcod", "sid", "cw"))
    j_params = j_scan_fused.ScanParams(*params)
    j_plane = j_scan_fused.DevicePlaneArrays(*(jnp.asarray(a) for a in host))
    plain = scan_fused.scan_core(dev.cache.plane, params)
    for want in (j_scan_fused.scan_counts(j_plane, j_params,
                                          backend="pallas_interpret"),
                 j_scan_fused.scan_counts(j_plane, j_params, backend="xla"),
                 (plain[0].numpy(), plain[1].numpy())):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert got[1].sum() > 0 and got[0].sum() > 0


def test_scan_table_holds_the_dense_tables(ycsb):
    """Decoded, the table gives back the live terms, membership and
    query_clause it was built from, terms sorted by key and grouped."""
    store = _build(ycsb, jax=False)
    dev = DeviceScanner(store, backend="torch", device="cpu",
                        log_queries=False)
    params = dev._prepare(_batch("uniform200")).params
    tab = decode_table(scan_fused.scan_table(params))
    t_of = tab["terms"] & 0xFFFF
    live = np.flatnonzero(params.kinds >= 0)
    assert sorted(t_of) == list(live)
    assert list((tab["terms"] >> 16) & 7) == list(params.kinds[t_of])
    keys, kinds = params.key_ids[t_of], params.kinds[t_of]
    assert list(zip(keys, kinds)) == sorted(zip(keys, kinds))
    for key, fields, first, exact, sub, kv, end, pad in tab["groups"]:
        assert (keys[first:end] == key).all() and pad == 0
        want = np.bitwise_or.reduce(scan_fused._KIND_FIELDS[kinds[first:end]])
        assert fields == want
        bounds = (first, exact, sub, kv, end)
        for kind in range(4):                   # each kind's run
            assert (kinds[bounds[kind]:bounds[kind + 1]] == kind).all()
    assert np.array_equal(np.concatenate(
        [np.arange(g[2], g[6]) for g in tab["groups"]]),
        np.arange(len(t_of)))
    Q, C = len(tab["queries"]), len(tab["clauses"])
    assert not (params.active[Q:] > 0).any()
    assert not (params.query_clause[:Q, C:] > 0).any()
    for c, terms in enumerate(tab["clauses"]):
        want = set(np.flatnonzero(params.membership[c] > 0)) & set(live)
        assert set(t_of[terms]) == want
    for q, clauses in enumerate(tab["queries"]):
        assert set(clauses) == set(np.flatnonzero(params.query_clause[q] > 0))
    assert tab["pmask"] == int(np.bitwise_or.reduce(
        params.pushed_tbl[:Q].reshape(-1)))
    assert tab["skip_padding"] == int(not (params.active[:, -1] > 0).any())


def test_wide_batch_in_one_launch_matches_jax_device_scanner(ycsb):
    """200 uniform queries (T/C 512, Q 256) in one batch and one launch's
    tables, as the CUDA route runs it, against the JAX DeviceScanner."""
    ours, theirs = _build(ycsb, jax=False), _build(ycsb, jax=True)
    queries = _batch("uniform200")
    dev = DeviceScanner(ours, backend="torch", device="cpu",
                        log_queries=False)
    prep = dev._prepare(queries)
    assert np.array_equal(prep.table, scan_fused.scan_table(prep.params))
    assert len(scan_fused.query_groups(prep.params, prep.table)) == 1
    got = dev.scan_batch(queries)
    want = j_device_scan.DeviceScanner(
        theirs, backend="xla", log_queries=False
    ).scan_batch([_jq(q) for q in queries])
    assert len(got) == 200
    for q, a, b in zip(queries, got, want):
        assert accounting(a) == accounting(b), q.describe()


def test_batch_split_by_query_covers_fits_and_matches(ycsb, monkeypatch):
    """Under a shared-memory limit the 200-query batch does not fit, the
    groups cover every query once and each fits; the ScanResults equal
    the batch's in one launch."""
    store = _build(ycsb, jax=False)
    queries = _batch("uniform200")
    whole = DeviceScanner(store, backend="torch", device="cpu",
                          log_queries=False)
    params = whole._prepare(queries).params
    S1 = params.pushed_tbl.shape[1]
    limit = 24_000
    assert scan_fused.scan_layout(scan_fused.scan_table(params), S1).smem \
        > limit
    want = whole.scan_batch(queries)
    monkeypatch.setattr(scan_fused, "MAX_SMEM", limit)
    groups = scan_fused.query_groups(params)
    assert len(groups) > 1
    covered = np.concatenate([idx for idx, _, _ in groups])
    assert np.array_equal(covered, np.arange(params.pushed_tbl.shape[0]))
    for idx, sub, table in groups:
        assert np.array_equal(table, scan_fused.scan_table(sub))
        assert scan_fused.scan_layout(table, S1).smem <= limit
    split = DeviceScanner(store, backend="torch", device="cpu",
                          log_queries=False)
    runs = []
    plain = scan_fused.scan_core
    monkeypatch.setattr(scan_fused, "scan_core",
                        lambda plane, p: runs.append(p) or plain(plane, p))
    got = split.scan_batch(queries)
    # one run per group with an active query (the bucket padding has none)
    assert len(runs) == sum(int(t[scan_fused.TABLE_N_QUERIES] > 0)
                            for _, _, t in groups) > 1
    for q, a, b in zip(queries, got, want):
        assert accounting(a) == accounting(b), q.describe()
    monkeypatch.setattr(scan_fused, "MAX_SMEM", 1_000)
    with pytest.raises(ValueError):
        scan_fused.query_groups(params)


def test_query_group_without_clauses_matches_jax(ycsb):
    """A group of queries that read no clause (``sub_params`` then gives
    no clause and no term, shapes the JAX package never builds): every
    pushed candidate of an active slot matches, as those queries' rows of
    the whole batch do in the JAX package."""
    store = _build(ycsb, jax=False)
    dev = DeviceScanner(store, backend="torch", device="cpu",
                        log_queries=False)
    params = dev._prepare(_batch("zipf64")).params
    idx = np.flatnonzero((params.active > 0).any(axis=1))[:5]
    qc = params.query_clause.copy()
    qc[idx] = 0
    params = params._replace(query_clause=qc)
    sub = scan_fused.sub_params(params, idx)
    assert sub.membership.shape == (0, 0) and sub.query_clause.shape == (5, 0)
    plane = _plane_np(dev)
    plain = scan_fused.scan_core(dev.cache.plane, sub)
    host = tuple(plane[n] for n in ("pres", "notn", "isb", "numv", "scod",
                                    "rcod", "sid", "cw"))
    j_plane = j_scan_fused.DevicePlaneArrays(*(jnp.asarray(a) for a in host))
    for backend in ("pallas_interpret", "xla"):
        want = j_scan_fused.scan_counts(
            j_plane, j_scan_fused.ScanParams(*params), backend=backend)
        want = tuple(np.asarray(w)[idx] for w in want)
        for counts, cands in (model_scan(plane, sub),
                              scan_fused.scan_core_numpy(*host, sub),
                              (plain[0].numpy(), plain[1].numpy())):
            assert np.array_equal(counts, want[0])
            assert np.array_equal(cands, want[1])
    assert np.array_equal(want[0], want[1]) and want[0].sum() > 0


# ---------------------------------------------------------------------------
# kernel D: the numpy model
# ---------------------------------------------------------------------------

def _window_bytes(data: np.ndarray, pat: np.ndarray) -> np.ndarray:
    """bool[R, L]: the window at x equals ``pat``, bytes past L zero."""
    R, L = data.shape
    buf = np.zeros((R, L + len(pat)), np.uint8)
    buf[:, :L] = data
    hit = np.ones((R, L), bool)
    for i, b in enumerate(pat):
        hit &= buf[:, i:i + L] == b
    return hit


def model_match(data: np.ndarray, patterns: np.ndarray,
                plens: np.ndarray) -> tuple[np.ndarray, int]:
    """Kernel D's candidate search: ``(uint8[P, R], candidates tested)``.

    Records are staged as the kernel stages them (zeros from L to the next
    128-position block and 16 bytes on); each 4-aligned word ``at`` and the
    next give the candidate flags of positions at .. at + 3; a pattern hits
    where a flagged start below L passes the full compare.  Asserts that
    the flags cover every true start (the filter loses no match).
    """
    R, L = data.shape
    P, M = patterns.shape
    Lp = -(-L // 128) * 128 + 16
    staged = np.zeros((R, Lp), np.uint8)
    staged[:, :L] = data
    words = staged.view("<u4").astype(np.uint32)       # (R, Lp / 4)
    n_at = -(-L // 128) * 32                           # lanes x blocks
    lo, hi = words[:, :n_at], words[:, 1:n_at + 1]
    pw = np.zeros((P, -(-M // 4) * 4), np.uint8)
    pw[:, :M] = patterns
    out = np.zeros((P, R), np.uint8)
    tested = 0
    for p in range(P):
        m = min(max(int(plens[p]), 1), M)
        x = np.zeros_like(lo)
        for k in range(min(m, 4)):
            rep = np.uint32(int(pw[p, k]) * 0x01010101)
            sh = (lo >> np.uint32(8 * k)) | (hi << np.uint32(32 - 8 * k)) \
                if k else lo
            x |= sh ^ rep
        flag = (x - np.uint32(0x01010101)) & ~x & np.uint32(0x80808080)
        cand = np.stack([(flag >> np.uint32(8 * k + 7)) & 1
                         for k in range(4)], axis=-1).reshape(R, -1) > 0
        cand = cand[:, :L]                              # starts below L
        true = _window_bytes(data, pw[p, :m])
        assert not (true & ~cand).any(), f"pattern {p}: a match was not flagged"
        tested += int(cand.sum())
        out[p] = (cand & true).any(axis=1)
    return out, tested


def _jax_match(data, pats, plens, backend):
    return j_ops.match_any(data, pats, plens[:, None], backend=backend,
                           r_blk=-(-data.shape[0] // 8) * 8).astype(np.uint8)


def _pool_patterns(dataset: str) -> list[bytes]:
    return list(dict.fromkeys(
        t.patterns()[0] for c in predicate_pool(dataset) for t in c.terms
        if t.kind is not Kind.KEY_VALUE))


def _hold(data, pats, plens, interpret_rows=None):
    """The model against the plain version, xla and (on ``interpret_rows``
    patterns, all when None) the TPU kernel in interpret mode."""
    got, tested = model_match(data, pats, plens)
    plain = ref.multi_match_any_ref(torch.from_numpy(data),
                                    torch.from_numpy(pats),
                                    torch.from_numpy(plens)).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _jax_match(data, pats, plens, "xla"))
    sel = slice(None) if interpret_rows is None else interpret_rows
    assert np.array_equal(got[sel], _jax_match(
        data, pats[sel], plens[sel], "pallas_interpret"))
    return got, tested


@pytest.mark.parametrize("dataset", ["ycsb", "yelp", "winlog"])
def test_match_model_pools_match_jax(dataset):
    """Every simple pattern of the pool over 45 records (R not a multiple
    of 32); the TPU kernel interpreted on a spread of 12 of them."""
    recs = generate_records(dataset, 45, seed=11)
    data = encode_chunk(recs).data
    patterns = _pool_patterns(dataset)
    pats, plens = encode_patterns(patterns)
    got, tested = _hold(data, pats, plens,
                        np.linspace(0, len(patterns) - 1, 12).astype(int))
    assert got.any() and not got.all()
    # the filter's point: far fewer full compares than start positions
    assert tested < 0.25 * len(patterns) * data.size


@pytest.mark.parametrize("L", [100, 257, 384])
def test_match_model_edges_match_jax(L):
    """Strides 100, 257 and 384; an empty pattern; a pattern longer than
    M (compared on its first M bytes); windows at and past the stride end;
    needles across the 4-byte words and 128-position blocks; 37 records."""
    rng = np.random.default_rng(L)
    data = rng.integers(1, 255, (37, L), dtype=np.uint8)
    data[0, :] = ord("B")                       # fills the stride
    data[1, L - 3:] = 0                         # a zero byte: empty matches
    needle = np.frombuffer(b"needle!", np.uint8)
    starts = [min(at, L - 1) for at in (0, 1, 2, 3, 29, 31, 124, 125, 126,
                                        127, 128, L - 7, L - 6, L - 4, L - 1)]
    for r, at in enumerate(starts, start=2):
        data[r, at:at + len(needle)] = needle[:L - at]
    data[20, L - 2:] = ord("Z")                 # "ZZ" ends at the stride end
    M = 8
    pats = np.zeros((8, M), np.uint8)
    plens = np.zeros((8,), np.int32)
    rows = [b"", b"needle!", b"needle!\x00", b"needle!xy", b"ZZ",
            b"ZZ\x00", b"B" * 8, b"e"]
    for i, p in enumerate(rows):
        pats[i, :min(len(p), M)] = np.frombuffer(p[:M], np.uint8)
        plens[i] = len(p)
    plens[3] = 12          # longer than M: compared on its first 8 bytes
    got, _ = _hold(data, pats, plens)
    assert got[0, 1] and not got[0, 0]          # empty: the zero byte
    whole = np.array([at + len(needle) <= L for at in starts])
    assert np.array_equal(got[1, 2:17] > 0, whole)  # cut by the stride: no
    assert got[2, 13]                           # runs past L: zeros there
    assert got[4, 20] and got[5, 20]            # "ZZ" and "ZZ\0" at the end
    assert got[6, 0]
