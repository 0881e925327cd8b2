"""Kernels A (pushdown) and E (key-value match) as numpy models, held to
the JAX package and to the port's plain versions, bit for bit.

The CUDA kernels (``csrc/pushdown.cu``, ``csrc/key_value.cu``) cannot run
here.  What they compute is modelled word by word in numpy instead:

* kernel A reads its plan as one packed table
  (``repro_torch.kernels.plan.kernel_table``: patterns as 32-bit words,
  a CSR clause list per predicate, key-value predicates grouped by key).
  The table is decoded and held against the dense plan it was built from,
  for the three pools, tier views and the edge plans;
* the key-value rule: over 32-position words, K = key ends, M = positions
  that are not ``,``/``}``, reach = the carries of ``M + (K & M)`` with
  one carry bit handed from word to word, and a hit wherever a value
  window starts on a reach position (the first value start after a key
  end comes before the first delimiter).

The models are held against the TPU kernels run in interpret mode
(``pallas_interpret``), their jnp oracles (``xla``) and the port's plain
versions (``repro_torch.kernels.ref``), exactly: they are bits.  The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``, on the same kinds of edge records.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import substring_match as j_sm  # noqa: E402
from repro.kernels.plan import compile_plan as j_compile_plan  # noqa: E402
from repro.kernels.plan import tier_view as j_tier_view  # noqa: E402
from repro.core.predicates import clause_from_obj as j_clause  # noqa: E402
from repro_torch.core import bitvector  # noqa: E402
from repro_torch.core.client import encode_chunk  # noqa: E402
from repro_torch.core.planner import build_plan_family  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    Kind, clause, clause_to_obj, exact, key_value, presence, substring,
)
from repro_torch.core.workload import generate_workload  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels import ops, plan as kplan, ref  # noqa: E402
from repro_torch.kernels.plan import compile_plan, tier_view  # noqa: E402

DATASETS = ("ycsb", "yelp", "winlog")
DELIMS = (ord(","), ord("}"))


# ---------------------------------------------------------------------------
# the numpy model
# ---------------------------------------------------------------------------

def _windows(data: np.ndarray, pat: bytes | np.ndarray) -> np.ndarray:
    """bool[R, 32 * ceil(L / 32)]: the window at x equals ``pat``, bytes
    past L read as zero, no window at or past L."""
    R, L = data.shape
    n = -(-L // 32) * 32
    pat = np.frombuffer(bytes(pat), np.uint8)
    buf = np.zeros((R, n + len(pat)), np.uint8)
    buf[:, :L] = data
    hit = np.ones((R, n), bool)
    for t, b in enumerate(pat):
        hit &= buf[:, t:t + n] == b
    hit[:, L:] = False
    return hit


def _to_words(bits: np.ndarray) -> np.ndarray:
    """uint32[R, n / 32]: bit i of word k is position 32k + i."""
    R, n = bits.shape
    b = bits.reshape(R, n // 32, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)


def _from_words(words: np.ndarray) -> np.ndarray:
    R, nw = words.shape
    return ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool).reshape(R, nw * 32)


def reach_words(K: np.ndarray, M: np.ndarray) -> np.ndarray:
    """reach[x] = M[x] & (K[x] | reach[x - 1]), word by word: the carries of
    M + (K & M), with the carry out of each word carried into the next."""
    out = np.zeros_like(K)
    carry = np.zeros(K.shape[0], np.uint64)
    for k in range(K.shape[1]):
        m = M[:, k].astype(np.uint64)
        s = (K[:, k] & M[:, k]).astype(np.uint64)
        reach = ((m + s + carry) ^ m ^ s) >> np.uint64(1)
        out[:, k] = reach.astype(np.uint32)
        carry = reach >> np.uint64(31)
    return out


def model_reach(data: np.ndarray, key: bytes, shift: int,
                unbounded: bool) -> np.ndarray:
    """bool[R, n]: the reach positions of ``key`` (its end = start +
    ``shift``), through positions that are not delimiters."""
    R, L = data.shape
    starts = _windows(data, key)
    n = starts.shape[1]
    ends = np.zeros_like(starts)
    if shift < n:
        ends[:, shift:] = starts[:, :n - shift]
    inside = np.arange(n) < L
    ends &= inside
    open_ = np.broadcast_to(inside, (R, n)).copy()
    if not unbounded:
        padded = np.zeros((R, n), np.uint8)
        padded[:, :L] = data
        open_ &= ~np.isin(padded, DELIMS)
    return _from_words(reach_words(_to_words(ends), _to_words(open_)))


def model_key_value(data, key: bytes, val: bytes, unbounded: bool):
    """Kernel E's rule: a value window starts on a reach position."""
    reach = model_reach(data, key, len(key), unbounded)
    return (reach & _windows(data, val)).any(axis=1)


def decode_table(table: np.ndarray) -> dict:
    """The packed table back into Python: simple predicates, key groups."""
    H = kplan
    off_pred, off_group = int(table[H.TABLE_PRED]), int(table[H.TABLE_GROUP])
    off_csr, off_pat = int(table[H.TABLE_CSR]), int(table[H.TABLE_PAT])
    preds = table[off_pred:off_group].reshape(-1, 4)
    groups = table[off_group:off_csr].reshape(-1, 8)
    pat = table[off_pat:].view(np.uint8)

    def pattern(word, m):
        return pat[4 * int(word):4 * int(word) + int(m)].tobytes()

    def row(p):
        w, m, beg, end = (int(v) for v in preds[p])
        return pattern(w, m), tuple(int(c) for c in table[off_csr + beg:
                                                          off_csr + end])
    n_simple = int(table[H.TABLE_N_SIMPLE])
    assert len(groups) == int(table[H.TABLE_N_GROUPS])
    out = {"simple": [row(p) for p in range(n_simple)], "groups": []}
    for kw, kc, shift, unb, first, end, _, _ in groups:
        out["groups"].append((pattern(kw, kc), int(shift), bool(unb),
                              [row(p) for p in range(first, end)]))
    assert sum(len(g[3]) for g in out["groups"]) + n_simple == len(preds)
    return out


def model_pushdown(data: np.ndarray, table: np.ndarray, C: int,
                   n_valid: int):
    """Kernel A on its packed table: (words, or_words, counts)."""
    R = data.shape[0]
    bits = np.zeros((C, R), bool)
    valid = np.arange(R) < n_valid
    dec = decode_table(table)
    for pat, ids in dec["simple"]:
        hit = _windows(data, pat).any(axis=1) if pat else np.ones(R, bool)
        bits[list(ids)] |= hit & valid
    for key, shift, unb, values in dec["groups"]:
        reach = model_reach(data, key, shift, unb)
        for val, ids in values:
            bits[list(ids)] |= (reach & _windows(data, val)).any(axis=1) & valid
    words = bitvector.pack(bits)
    return words, np.bitwise_or.reduce(words, axis=0), \
        bits.sum(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _ref_pushdown(data: np.ndarray, plan, n_valid: int):
    u = ops.plan_tensors(plan, ops.UNIQUE_FIELDS, "cpu")
    out = ref.clause_bitvectors_ref(
        torch.from_numpy(data), u["ukeys"], u["uklens"], u["uvals"],
        u["uvlens"], u["uunb"], u["key_ids"], u["val_ids"], u["membership"],
        n_valid, n_simple=plan.n_simple)
    return tuple(t.numpy() for t in out)


def _assert_same(got, want, what):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), what


def _jax_plan(clauses):
    return j_compile_plan(tuple(j_clause(clause_to_obj(c)) for c in clauses))


def _family(dataset, recs):
    wl = generate_workload(predicate_pool(dataset), n_queries=200,
                           distribution="zipf", zipf_a=1.5,
                           rng=np.random.default_rng(0))
    return build_plan_family(wl, recs[:200],
                             tier_budgets_us=[0.25, 1.0, 4.0]).family


def straddling_rows(L: int, key: bytes, val: bytes) -> np.ndarray:
    """uint8[R, L] over an ``x`` filler: ``key`` and ``val`` placed across
    positions 31/32, 127/128 and L - 1 (a 32-position word, a lane's
    4-byte word and the stride end): the value exactly at the key end, a
    delimiter exactly at the key end, the value two bytes on, two key hits
    of which only the second reaches its value, and a value ending at L."""
    mk, mv = len(key), len(val)
    rows = []

    def row(*parts):
        r = bytearray(b"x" * (L + 64))
        for pos, b in parts:
            r[pos:pos + len(b)] = b
        rows.append(bytes(r[:L]))

    for edge in (32, 128, L - 1):
        for s in range(max(0, edge - mk - mv - 3), min(L, edge + 2)):
            e = s + mk
            row((s, key), (e, val))
            row((s, key), (e, b","), (e + 1, val))
            row((s, key), (e, b"}" + val))
            row((s, key), (e + 2, val))
            row((s, key + b"0," + key + val))
            row((max(0, s - mk - 3), key + b"9,"), (s, key), (e, val))
    row((L - mv - mk, key + val))
    row((L - mv - mk - 1, key + b" " + val))
    return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, L).copy()


# ---------------------------------------------------------------------------
# the packed table against the dense plan
# ---------------------------------------------------------------------------

def _expected_rows(plan) -> tuple[list, dict]:
    """The live predicates of ``plan`` as the table should hold them."""
    mem = plan.membership.astype(bool)
    Mk, Mv = plan.keys.shape[1], plan.vals.shape[1]
    simple, groups = [], {}
    for p in range(plan.n_preds):
        ids = tuple(int(c) for c in np.flatnonzero(mem[:, p]))
        if not ids:
            continue
        klen = int(plan.klens[p])
        if plan.kinds[p] == 0:
            simple.append((plan.keys[p, :min(klen, Mk)].tobytes(), ids))
        else:
            key = plan.keys[p, :max(1, min(klen, Mk))].tobytes()
            val = plan.vals[p, :max(1, min(int(plan.vlens[p]), Mv))].tobytes()
            groups.setdefault((key, klen, bool(plan.unbounded[p])),
                              []).append((val, ids))
    return simple, groups


def _check_table(plan) -> None:
    table = plan.kernel_table
    assert table.dtype == np.uint32 and len(table) % 4 == 0
    for h in (kplan.TABLE_PRED, kplan.TABLE_GROUP, kplan.TABLE_CSR,
              kplan.TABLE_PAT):
        assert table[h] % 4 == 0
    dec = decode_table(table)
    simple, groups = _expected_rows(plan)
    assert dec["simple"] == simple
    assert {(k, s, u): v for k, s, u, v in dec["groups"]} == groups
    # the CSR lists are the dense membership columns of the live predicates
    rows = simple + [r for g in dec["groups"] for r in g[3]]
    live = np.flatnonzero(plan.membership.any(axis=0))
    assert sorted(ids for _, ids in rows) == sorted(
        tuple(np.flatnonzero(plan.membership[:, p]).tolist()) for p in live)


@pytest.mark.parametrize("dataset", DATASETS)
def test_kernel_table_holds_the_dense_plan(dataset):
    """Pools and every tier view of a family: the CSR clause lists, the
    packed pattern words and the key groups against the dense plan;
    neutralised (0xFF) predicates are absent."""
    recs = generate_records(dataset, 200, seed=5)
    pool = compile_plan(tuple(predicate_pool(dataset)))
    _check_table(pool)
    assert len(decode_table(pool.kernel_table)["simple"]) == pool.n_simple
    fam = _family(dataset, recs)
    full = compile_plan(tuple(fam.plan.clauses))
    for n in sorted(set(fam.tier_sizes) | {0, 1, full.n_clauses}):
        view = tier_view(full, n)
        _check_table(view)
        dec = decode_table(view.kernel_table)
        every = [p for p, _ in dec["simple"]] + [
            k for k, _, _, _ in dec["groups"]] + [
            v for g in dec["groups"] for v, _ in g[3]]
        assert all(b"\xff" not in p for p in every)
    # the table is built once per plan, where the engine caches its tensors
    assert pool.kernel_table is pool.kernel_table


def test_kernel_table_edge_lengths():
    """Empty and over-wide lengths follow the plain version: an empty simple
    pattern is length 0 (every row), an empty key-value key compares one
    padding byte and shifts by 0, a length past the width compares the
    width and shifts by the length."""
    plan = compile_plan((clause(substring("note", "")),
                         clause(key_value("age", 5)),
                         clause(key_value("name", "par,is"))))
    assert decode_table(plan.kernel_table)["simple"][0] == (b"", (0,))
    P, Mk = plan.keys.shape
    klens = plan.klens.copy()
    kv = int(np.flatnonzero(plan.kinds)[0])
    klens[kv] = 0
    odd = dataclasses.replace(plan, klens=klens.copy())
    key, shift, _, _ = decode_table(odd.kernel_table)["groups"][0]
    assert (key, shift) == (bytes(plan.keys[kv, :1]), 0)
    klens[kv] = Mk + 5
    odd = dataclasses.replace(plan, klens=klens.copy())
    key, shift, _, _ = decode_table(odd.kernel_table)["groups"][0]
    assert (len(key), shift) == (Mk, Mk + 5)
    klens[kv] = -1
    with pytest.raises(ValueError):
        dataclasses.replace(plan, klens=klens).kernel_table
    _check_table(plan)


# ---------------------------------------------------------------------------
# the models against the JAX package and the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", DATASETS)
def test_pushdown_model_matches_jax(dataset):
    """The model of kernel A on its table: every tier of a family and the
    whole pool, R not a multiple of 32, rows past n_valid."""
    recs = generate_records(dataset, 150, seed=9)
    data = encode_chunk(recs).data
    fam = _family(dataset, recs)
    full = compile_plan(tuple(fam.plan.clauses))
    jfull = _jax_plan(fam.plan.clauses)
    for n in sorted(set(fam.tier_sizes) | {1, full.n_clauses}):
        view = tier_view(full, n)
        got = model_pushdown(data, view.kernel_table, view.n_clauses, 150)
        _assert_same(got, _ref_pushdown(data, view, 150), f"{dataset} {n}")
        want = j_ops.clause_bitvectors(data, j_tier_view(jfull, n),
                                       backend="pallas_interpret")
        _assert_same(got, want, f"{dataset} tier {n} vs pallas_interpret")
    pool = predicate_pool(dataset)
    plan = compile_plan(tuple(pool))
    got = model_pushdown(data, plan.kernel_table, plan.n_clauses, 117)
    _assert_same(got, _ref_pushdown(data, plan, 117), f"{dataset} pool")
    want = j_ops.clause_bitvectors(data, _jax_plan(pool), backend="xla")
    got_all = model_pushdown(data, plan.kernel_table, plan.n_clauses, 150)
    _assert_same(got_all, want, f"{dataset} pool vs xla")


EDGE_CLAUSES = [
    clause(substring("note", "")), clause(key_value("note", "")),
    clause(key_value("name", "par,is")), clause(key_value("k", "a}b")),
    clause(key_value("age", 5)), clause(key_value("age", 1)),
    clause(exact("tail", "bob"), presence("zz")),
    clause(substring("x", "yyyy"), key_value("age", 3)),
    clause(key_value("age", 57)), clause(key_value("age", 12)),
]


@pytest.mark.parametrize("L", [257, 384])
def test_pushdown_model_edges_match_jax(L):
    """Keys and values across positions 31/32, 127/128 and L - 1, at odd
    and 16-byte strides, under plans with empty, unbounded and shared-key
    predicates."""
    data = straddling_rows(L, b'"age"', b"57")
    data = np.concatenate([data, straddling_rows(L, b'"age"', b":5")])
    R = data.shape[0]
    plan = compile_plan(tuple(EDGE_CLAUSES))
    jplan = _jax_plan(EDGE_CLAUSES)
    got = model_pushdown(data, plan.kernel_table, plan.n_clauses, R)
    assert got[2][EDGE_CLAUSES.index(clause(key_value("age", 57)))] > 0
    _assert_same(got, _ref_pushdown(data, plan, R), f"L={L} vs plain")
    _assert_same(got, j_ops.clause_bitvectors(data, jplan, backend="xla"),
                 f"L={L} vs xla")


@pytest.mark.parametrize("dataset", DATASETS)
def test_key_value_model_matches_jax(dataset):
    """The model of kernel E on the dataset's key-value pairs (winlog's
    pool has none: its pairs come from its records' fields) against the
    plain version and the jnp oracle, the first two against the TPU kernel
    in interpret mode."""
    recs = generate_records(dataset, 64, seed=3)
    data = encode_chunk(recs).data
    pairs = list(dict.fromkeys(
        t.patterns() for c in predicate_pool(dataset) for t in c.terms
        if t.kind is Kind.KEY_VALUE))
    if not pairs:
        pairs = [(b'"level"', b'"Info"'), (b'"service"', b'"EventLog"'),
                 (b'"time"', b'2016'), (b'"info"', b"Warning"),
                 (b'"level"', b'Warn')]
    hits = 0
    for i, (k, v) in enumerate(pairs[::max(1, len(pairs) // 12)]):
        unb = b"," in v or b"}" in v
        got = model_key_value(data, k, v, unb)
        hits += int(got.any())
        want = ref.key_value_match_ref(
            torch.from_numpy(data), torch.tensor(list(k), dtype=torch.uint8),
            torch.tensor(list(v), dtype=torch.uint8), unb).numpy()
        assert np.array_equal(got, want.astype(bool)), (k, v)
        for backend in ("xla", "pallas_interpret")[:1 + (i < 2)]:
            assert np.array_equal(got, j_ops.match_key_value(
                data, k, v, backend=backend)), (k, v, backend)
    assert hits > 0


@pytest.mark.parametrize("L", [100, 257, 384])
def test_key_value_model_edges_match_jax(L):
    """Edge rows across 31/32, 127/128 and L - 1 with the key-value kernel's
    own patterns (the key's colon included), bounded and unbounded, against
    the TPU kernel in interpret mode, the jnp oracle and the plain version."""
    data = straddling_rows(L, b'"age":', b"57")
    t = torch.from_numpy(data)
    for k, v in ((b'"age":', b"57"), (b'"age":', b"5"), (b'"age":', b"7,"),
                 (b'"age":', b"x"), (b"x", b"5")):
        unb = b"," in v or b"}" in v
        got = model_key_value(data, k, v, unb)
        want = ref.key_value_match_ref(
            t, torch.tensor(list(k), dtype=torch.uint8),
            torch.tensor(list(v), dtype=torch.uint8), unb).numpy()
        assert np.array_equal(got, want.astype(bool)), (k, v)
        assert np.array_equal(got, j_ops.match_key_value(
            data, k, v, backend="xla")), (k, v)
    kv = (b'"age":', b"57")
    pal = j_sm.key_value_match(
        np.concatenate([data, np.zeros((-len(data) % 256, L), np.uint8)]),
        np.frombuffer(kv[0], np.uint8)[None], np.frombuffer(kv[1], np.uint8)[None],
        mk=len(kv[0]), mv=len(kv[1]), unbounded=False, interpret=True)
    got = model_key_value(data, *kv, False)
    assert got.sum() > 10 and (~got).sum() > 10
    assert np.array_equal(got, np.asarray(pal[0], bool)[:len(data)])


def test_key_value_model_random_triples():
    """Seeded random keys, values and records over a small alphabet with
    the delimiters in it (zero bytes included), bounded and unbounded."""
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ab,}\x00", np.uint8)
    for i in range(40):
        L = int(rng.integers(1, 90))
        data = alphabet[rng.integers(0, 5, (16, L))]
        k = alphabet[rng.integers(0, 5, int(rng.integers(1, 4)))].tobytes()
        v = alphabet[rng.integers(0, 5, int(rng.integers(1, 3)))].tobytes()
        unb = bool(i % 2)
        want = ref.key_value_match_ref(
            torch.from_numpy(data), torch.tensor(list(k), dtype=torch.uint8),
            torch.tensor(list(v), dtype=torch.uint8), unb).numpy()
        assert np.array_equal(model_key_value(data, k, v, unb),
                              want.astype(bool)), (L, k, v, unb)


def test_reach_words_carry_between_words():
    """A key end in one word reaches values words later; a delimiter in
    between stops it; an all-open word passes the carry on."""
    K = np.array([[1 << 31, 0, 0]], np.uint32)
    M = np.array([[0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]], np.uint32)
    assert reach_words(K, M).tolist() == [[1 << 31, 0xFFFFFFFF, 0xFFFFFFFF]]
    M[0, 1] = 0xFFFFFFFF ^ (1 << 5)
    assert reach_words(K, M).tolist() == [[1 << 31, 0x1F, 0]]
    K = np.array([[0b1001, 0, 0]], np.uint32)
    M = np.array([[0xFFFFFFFF ^ 0b100, 0, 0xFFFFFFFF]], np.uint32)
    assert reach_words(K, M).tolist() == [[0xFFFFFFFF ^ 0b100, 0, 0]]
