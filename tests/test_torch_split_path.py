"""The port's split pushdown path against the JAX package's, bit for bit.

Kernels C (``bitvector_reduce``), D (``multi_match_any``) and E
(``key_value_match``), the seed split pipeline that runs them
(``repro_torch.benchmarks.bench_kernels.seed_split_eval``) and the host
scanner's AND-reduce hook (``repro_torch.kernels.residual``).  The port's
plain PyTorch versions (``backend="torch"``, on the CPU) and the JAX
package under ``pallas_interpret`` (the TPU kernels, interpreted) and
``xla`` (their jnp oracles) see the same numpy-seeded inputs; hits, words,
masks, counts and scan accounting must be equal exactly (tolerance 0:
they are bits and integers).  The CUDA kernels are held against the same
plain versions on the card by ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from benchmarks.bench_kernels import _seed_split_eval as j_split  # noqa: E402
from repro.core import bitvector as j_bitvector  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core.client import encode_chunk as j_encode_chunk  # noqa: E402
from repro.core.predicates import clause_from_obj as j_clause  # noqa: E402
from repro.core.predicates import query as j_query  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.residual import bv_and_many_xla  # noqa: E402
from repro_torch.benchmarks import bench_kernels  # noqa: E402
from repro_torch.core import bitvector  # noqa: E402
from repro_torch.core.client import encode_chunk, encode_patterns  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    Kind, Query, clause, clause_to_obj, key_value,
)
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, PushdownPlan,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels import (  # noqa: E402
    bitvector_ops, ops, ref, residual, substring_match,
)
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

JAX_BACKENDS = ("xla", "pallas_interpret")


def _jax_match_any(data, pats, plens, backend):
    return j_ops.match_any(data, pats, plens[:, None], backend=backend)


# ---------------------------------------------------------------------------
# kernel D: multi_match_any
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("n_rec,stride", [(7, 128), (64, 256), (200, 384)])
def test_match_any_shape_sweep_matches_jax(backend, n_rec, stride):
    """The sweep of ``tests/test_kernels.py``: planted needles in random
    printable bytes, R not a multiple of 32 or of the TPU's record block."""
    rng = np.random.default_rng(n_rec * stride + 32)
    data = rng.integers(32, 127, size=(n_rec, stride), dtype=np.uint8)
    needles = [b"hello", b"x", b"abcdefgh"]
    for i in range(0, n_rec, 3):
        nd = needles[i % len(needles)]
        pos = int(rng.integers(0, stride - len(nd)))
        data[i, pos:pos + len(nd)] = np.frombuffer(nd, np.uint8)
    pats, plens = encode_patterns(needles + [b"notthere"])
    got = ops.match_any(data, pats, plens, backend="torch")
    assert got.dtype == bool and got.shape == (4, n_rec)
    assert np.array_equal(got, _jax_match_any(data, pats, plens, backend))
    want = [[nd in row.tobytes() for row in data]
            for nd in needles + [b"notthere"]]
    assert np.array_equal(got, np.array(want))


def test_match_any_empty_pattern_compares_the_padding_byte():
    """An empty pattern matches a record shorter than the stride (it holds
    a zero byte) and not one that fills the stride: kernel D is not the
    fused pass, where an empty simple pattern matches every row."""
    data = np.zeros((4, 128), np.uint8)
    data[0, :5] = ord("A")          # short record
    data[1, :] = ord("B")           # fills the stride
    data[2, :127] = ord("C")        # one byte short
    data[3, 120:] = ord("A")        # pattern at the stride end
    pats, plens = encode_patterns([b"", b"A", b"BB", b"AAAAAAAA", b"AAAAAAAAA"])
    got = ops.match_any(data, pats, plens, backend="torch")
    assert got[0].tolist() == [True, False, True, True]
    assert got[3].tolist() == [False, False, False, True]
    assert not got[4].any()         # would run past the stride
    for backend in JAX_BACKENDS:
        assert np.array_equal(got, _jax_match_any(data, pats, plens, backend))


def test_match_any_wrapper_runs_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(1)
    data = torch.from_numpy(rng.integers(1, 255, (45, 128), dtype=np.uint8))
    pats, plens = encode_patterns([bytes(data[3, 10:14].tolist()), b"\x01"])
    before = substring_match.match_launches
    got = substring_match.multi_match_any(
        data, torch.from_numpy(pats), torch.from_numpy(plens))
    assert substring_match.match_launches == before
    assert got.dtype == torch.uint8 and got[0, 3] == 1
    assert torch.equal(got, ref.multi_match_any_ref(
        data, torch.from_numpy(pats), torch.from_numpy(plens)))
    with pytest.raises(ValueError):
        substring_match.multi_match_any(data, torch.zeros((1, 0), dtype=torch.uint8),
                                        torch.zeros((1,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# kernel E: key_value_match
# ---------------------------------------------------------------------------

def _kv_pairs(dataset):
    return list(dict.fromkeys(
        t.patterns() for c in predicate_pool(dataset) for t in c.terms
        if t.kind is Kind.KEY_VALUE))


@pytest.mark.parametrize("dataset", ["ycsb", "yelp"])
def test_match_key_value_pool_matches_jax(dataset):
    """Key-value pairs of the dataset's predicate pool (the winlog pool has
    none) on a real chunk: every 20th pair against the jnp oracle, the
    first against the interpreted TPU kernel too."""
    recs = generate_records(dataset, 96, seed=3)
    data = encode_chunk(recs).data
    pairs = _kv_pairs(dataset)
    assert len(pairs) > 100 and not _kv_pairs("winlog")
    n_hit = 0
    for i, (k, v) in enumerate(pairs[::20]):
        got = ops.match_key_value(data, k, v, backend="torch")
        n_hit += int(got.any())
        for backend in JAX_BACKENDS[:1 + (i == 0)]:
            assert np.array_equal(got, j_ops.match_key_value(
                data, k, v, backend=backend)), (k, v, backend)
    assert n_hit > 0


KV_RECORDS = [
    b'{"name":"par,is","age":7}', b'{"k":"a}b","z":1}',
    b'{"age":4}', b'{"age":12,"tail":"bob"}',
    b'{"x":"' + b"y" * 112 + b'","age":5}',          # fills the stride, 128
    b'{"x":"' + b"y" * 113 + b'","age":5',           # value at the stride end
    b'{"age":', b'{"a":1,"age":"3}"}', b'{"age":,3}', b'{"age":}4',
]
KV_PAIRS = [
    (b'"name":', b'"par,is"'), (b'"name":', b'"par'),  # unbounded, bounded
    (b'"k":', b'"a}b"'), (b'"k":', b'b"'),
    (b'"age":', b'5'), (b'"age":', b'4'), (b'"age":', b'3'),
    (b'"age":', b'3}'), (b'"age":', b'12'), (b'"tail":', b'"bob"'),
]


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_match_key_value_edges_match_jax(backend):
    """Unbounded values (',' / '}' inside), delimiters right after the key,
    a value that ends exactly at the stride, records cut by the stride."""
    data = encode_chunk(KV_RECORDS).data
    assert data.shape == (10, 128)
    # the interpreter compiles one kernel per (key, value) length pair
    for k, v in KV_PAIRS if backend == "xla" else KV_PAIRS[::2]:
        got = ops.match_key_value(data, k, v, backend="torch")
        want = j_ops.match_key_value(data, k, v, backend=backend)
        assert np.array_equal(got, want), (k, v)
    last = ops.match_key_value(data, b'"age":', b"5", backend="torch")
    assert last[4] and last[5]


def test_empty_key_value_refused_on_both_sides():
    data = encode_chunk(KV_RECORDS).data
    for backend in JAX_BACKENDS:
        with pytest.raises(IndexError):
            j_ops.match_key_value(data, b'"age":', b"", backend=backend)
    for k, v in ((b'"age":', b""), (b"", b"5")):
        with pytest.raises(ValueError):
            ops.match_key_value(data, k, v, backend="torch")
    t = torch.from_numpy(data)
    with pytest.raises(ValueError):
        substring_match.key_value_match(t, torch.tensor([1], dtype=torch.uint8),
                                        torch.zeros(0, dtype=torch.uint8), False)
    with pytest.raises(ValueError):
        ref.key_value_match_ref(t, torch.tensor([1], dtype=torch.uint8),
                                torch.zeros(0, dtype=torch.uint8), True)


# ---------------------------------------------------------------------------
# kernel C: bitvector_reduce
# ---------------------------------------------------------------------------

def _words(rng, p, w):
    return rng.integers(0, 2**32, size=(p, w), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("p,w", [(1, 1), (3, 64), (8, 130), (2, 257)])
def test_reduce_bitvectors_matches_jax(p, w):
    bv = _words(np.random.default_rng(p * w), p, w)
    got = ops.reduce_bitvectors(bv, backend="torch")
    assert got[0].dtype == np.uint32 and got[0].shape == (w,)
    for backend in JAX_BACKENDS:
        want = j_ops.reduce_bitvectors(bv, backend=backend)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert got[2] == int(bitvector.popcount(np.bitwise_and.reduce(bv, axis=0)))


@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF])
def test_reduce_bitvectors_uniform_rows(fill):
    bv = np.full((5, 37), fill, np.uint32)
    got = ops.reduce_bitvectors(bv, backend="torch")
    want = j_ops.reduce_bitvectors(bv, backend="pallas_interpret")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] == (37 * 32 if fill else 0)


def test_reduce_bitvectors_refuses_no_rows_and_counts_no_cpu_launch():
    with pytest.raises(ValueError):
        ops.reduce_bitvectors(np.zeros((0, 4), np.uint32), backend="torch")
    t = torch.from_numpy(_words(np.random.default_rng(2), 3, 9))
    with pytest.raises(ValueError):
        bitvector_ops.bitvector_reduce(t[:0])
    before = bitvector_ops.launches
    a, o, c = bitvector_ops.bitvector_reduce(t)
    assert bitvector_ops.launches == before
    assert c.dtype == torch.int32 and c.dim() == 0
    assert torch.equal(a.view(torch.int32),
                       bitvector.torch_and_many(t).view(torch.int32))


def test_residual_hooks_match_numpy():
    words = _words(np.random.default_rng(0), 5, 7)
    assert np.array_equal(
        residual.bv_and_many_cuda(words, backend="torch"),
        bitvector.bv_and_many(words))
    assert residual.popcount_cuda(words, backend="torch") == \
        int(bitvector.popcount_rows(words).sum())


# ---------------------------------------------------------------------------
# the split path: seed_split_eval, and the hooked host scanner
# ---------------------------------------------------------------------------

def _jax(clauses):
    return [j_clause(clause_to_obj(c)) for c in clauses]


@pytest.mark.parametrize("dataset", ["ycsb", "yelp"])
def test_seed_split_eval_matches_jax_and_fused(dataset):
    """The bench's 12-clause mixed plan on a 256-record chunk: split equals
    the port's fused engine, and the JAX split pipeline under both
    backends."""
    recs = generate_records(dataset, 256, seed=43)
    clauses = bench_kernels.mixed_plan(dataset, 12, np.random.default_rng(0))
    chunk = encode_chunk(recs)
    words, or_words = bench_kernels.seed_split_eval(chunk, clauses, "torch")
    assert words.shape == (12, 8) and words.any()
    fused = KernelEngine("torch").eval_fused(chunk, clauses)
    assert np.array_equal(words, fused.words)
    assert np.array_equal(or_words, fused.or_words)
    assert np.array_equal(bitvector.popcount_rows(words), fused.counts)
    jcl, jchunk = _jax(clauses), j_encode_chunk(recs)
    for backend in JAX_BACKENDS[:1 + (dataset == "ycsb")]:
        jw, jo = j_split(jchunk, jcl, backend)
        assert np.array_equal(words, jw) and np.array_equal(or_words, jo)


def accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.used_skipping,
            tuple(sorted(
                (k, (g.count, g.rows_scanned, g.rows_skipped, g.raw_parsed,
                     g.segments_pruned))
                for k, g in r.groups.items())))


def test_hooked_scanner_matches_jax():
    """Split-ingested stores in both packages, scanned through the device
    AND-reduce hook (port: kernel C's plain version; JAX: XLA)."""
    recs = generate_records("ycsb", 1024, seed=7)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    plan = ranked[:6]
    ours = CiaoStore(PushdownPlan(clauses=plan), segment_capacity=256)
    theirs = j_server.CiaoStore(j_server.PushdownPlan(clauses=_jax(plan)),
                                segment_capacity=256)
    for lo in range(0, 1024, 128):
        batch = recs[lo:lo + 128]
        chunk = encode_chunk(batch)
        words, or_words = bench_kernels.seed_split_eval(chunk, plan, "torch")
        counts = bitvector.popcount_rows(words).astype(np.int32)
        ours.ingest_chunk(chunk, bitvector.ChunkBitvectors(
            words=words, or_words=or_words, counts=counts, n_records=128))
        theirs.ingest_chunk(j_encode_chunk(batch), j_bitvector.ChunkBitvectors(
            words=words, or_words=or_words, counts=counts, n_records=128))
    calls = []

    def hook(words):
        calls.append(words.shape)
        return residual.bv_and_many_cuda(words, backend="torch")

    mine = DataSkippingScanner(ours, log_queries=False, and_reduce=hook)
    host = j_server.DataSkippingScanner(theirs, log_queries=False,
                                        and_reduce=bv_and_many_xla)
    queries = [Query((c,)) for c in plan[:4]] + [Query((plan[0], plan[1]))]
    queries += [Query((plan[2], ranked[9]))]
    queries += [Query((clause(key_value("linear_score", 29)),))]
    for q in queries:
        got = mine.scan(q)
        want = host.scan(j_query(*_jax(q.clauses)))
        assert accounting(got) == accounting(want), q.describe()
    assert calls and all(p >= 1 for p, _ in calls)


def test_bench_main_on_the_plain_backend(tmp_path, monkeypatch):
    """The bench's engine table and fused-vs-split section at a tiny size;
    ``main`` returns its result and writes nothing."""
    monkeypatch.chdir(tmp_path)
    out = bench_kernels.main(n_records=48, n_clauses=4, repeats=1,
                             backends=("torch",))
    assert [r["engine"] for r in out["engines"]] == [
        "python-bytes-find", "numpy-vectorized", "torch-plain"]
    (fvs,) = out["fused_vs_split"]
    assert fvs["device"] == "cpu" and fvs["launches_split"] >= 2
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the rules: no card, no kernel
# ---------------------------------------------------------------------------

def test_cuda_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = encode_chunk(KV_RECORDS).data
    pats, plens = encode_patterns([b"age"])
    words = np.ones((2, 4), np.uint32)
    calls = [
        functools.partial(ops.match_any, data, pats, plens),
        functools.partial(ops.match_key_value, data, b'"age":', b"5"),
        functools.partial(ops.reduce_bitvectors, words),
        functools.partial(residual.bv_and_many_cuda, words),
        functools.partial(residual.popcount_cuda, words),
        functools.partial(bench_kernels.seed_split_eval, encode_chunk(KV_RECORDS),
                          [clause(key_value("age", 5))], "cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError):
        ops.reduce_bitvectors(words, device="cpu")
