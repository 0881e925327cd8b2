"""The port's pushdown pass against the JAX package's, bit for bit.

The port's ``KernelEngine("torch")`` (the plain PyTorch version of the CUDA
pushdown kernel, on the CPU) and the JAX ``KernelEngine`` under
``pallas_interpret`` (the TPU kernel, interpreted) and ``xla`` (its jnp
oracle) evaluate the same chunks and plans.  Packed words, the load mask
and per-clause counts must be equal exactly: they are integers and bits.
The CUDA kernel itself is held against the same plain version on the card
by ``chip_smoke.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core.client import encode_chunk as j_encode_chunk  # noqa: E402
from repro.core.predicates import clause_from_obj as j_clause  # noqa: E402
from repro.kernels.engine import KernelEngine as JKernelEngine  # noqa: E402
from repro_torch.core.bitvector import torch_unpack  # noqa: E402
from repro_torch.core.client import (  # noqa: E402
    NumpyEngine, PythonEngine, encode_chunk, get_engine,
)
from repro_torch.core.planner import build_plan_family  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    clause, clause_to_obj, exact, key_value, presence, substring,
)
from repro_torch.core.workload import generate_workload  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels import fused, ops, ref  # noqa: E402
from repro_torch.kernels.engine import KernelEngine  # noqa: E402
from repro_torch.kernels.plan import compile_plan, tier_view  # noqa: E402

DATASETS = ("ycsb", "yelp", "winlog")


@pytest.fixture(scope="module")
def jax_engines():
    return {b: JKernelEngine(backend=b) for b in ("xla", "pallas_interpret")}


def _jax(clauses):
    return [j_clause(clause_to_obj(c)) for c in clauses]


def _assert_same(got, want, what=""):
    assert np.array_equal(got.words, want.words), what
    assert np.array_equal(got.or_words, want.or_words), what
    assert np.array_equal(got.counts, want.counts), what
    assert got.words.dtype == np.uint32 and got.counts.dtype == np.int32


def _family(dataset, recs):
    wl = generate_workload(predicate_pool(dataset), n_queries=200,
                           distribution="zipf", zipf_a=1.5,
                           rng=np.random.default_rng(0))
    return build_plan_family(wl, recs[:200],
                             tier_budgets_us=[0.25, 1.0, 4.0]).family


@pytest.mark.parametrize("dataset", DATASETS)
def test_family_tiers_match_jax(dataset, jax_engines):
    """Every tier of a plan family, via eval_fused_prefix (tier views with
    neutralised 0xFF rows), on a chunk whose R is not a multiple of 32."""
    recs = generate_records(dataset, 300, seed=5)
    fam = _family(dataset, recs)
    chunk, jchunk = encode_chunk(recs), j_encode_chunk(recs)
    eng = KernelEngine("torch")
    jcl = _jax(fam.plan.clauses)
    for n in sorted(set(fam.tier_sizes) | {1, fam.plan.n}):
        got = eng.eval_fused_prefix(chunk, fam.plan.clauses, n)
        for name, je in jax_engines.items():
            _assert_same(got, je.eval_fused_prefix(jchunk, jcl, n),
                         f"{dataset} tier {n} vs {name}")


@pytest.mark.parametrize("dataset", DATASETS)
def test_whole_pool_matches_jax_oracle(dataset, jax_engines):
    """Every predicate of the dataset's pool in one plan (hundreds of
    clauses, all kinds) against the jnp oracle and the numpy engine."""
    recs = generate_records(dataset, 200, seed=9)
    pool = predicate_pool(dataset)
    got = KernelEngine("torch").eval_fused(encode_chunk(recs), pool)
    want = jax_engines["xla"].eval_fused(j_encode_chunk(recs), _jax(pool))
    _assert_same(got, want, dataset)
    _assert_same(got, NumpyEngine().eval_fused(encode_chunk(recs), pool))


EDGE_RECORDS = [
    b'{"note":"hi","age":3}', b'{"age":4}',
    b'{"name":"par,is","age":7}', b'{"k":"a}b","z":1}',
    b'{"x":"' + b"y" * 112 + b'","age":5}',      # reaches the stride end
    b'{"age":12,"tail":"bob"}', b'{"a":1}{"a":1}',
    b'{"tail":"bo', b'{"name":"par', b'{"age":',  # values cut by the end
]
EDGE_CLAUSES = [
    clause(substring("note", "")),               # empty: match-all
    clause(key_value("note", "")),               # empty value: presence
    clause(key_value("name", "par,is")),         # unbounded (',')
    clause(key_value("k", "a}b")),               # unbounded ('}')
    clause(key_value("age", 5)), clause(key_value("age", 1)),
    clause(exact("tail", "bob"), presence("zz")),
    clause(substring("x", "yyyy"), key_value("age", 3)),
    clause(key_value("age", 12), exact("name", "par")),
]


@pytest.mark.parametrize("n_records", [1, 10, 33, 40])
def test_edge_cases_match_jax(n_records, jax_engines):
    recs = (EDGE_RECORDS * 4)[:n_records]
    chunk = encode_chunk(recs)
    assert chunk.stride == 128
    want_py = PythonEngine().eval_fused(chunk, EDGE_CLAUSES)
    eng = KernelEngine("torch")
    jcl = _jax(EDGE_CLAUSES)
    for n in range(len(EDGE_CLAUSES) + 1):
        got = eng.eval_fused_prefix(chunk, EDGE_CLAUSES, n)
        for name, je in jax_engines.items():
            _assert_same(got, je.eval_fused_prefix(
                j_encode_chunk(recs), jcl, n), f"prefix {n} vs {name}")
    _assert_same(eng.eval_fused(chunk, EDGE_CLAUSES), want_py)


def test_multi_block_rows_and_degenerate_inputs():
    """Several 64-row blocks with a ragged tail; empty plans and chunks."""
    recs = generate_records("ycsb", 150, seed=2)
    pool = predicate_pool("ycsb")[::25]
    chunk = encode_chunk(recs)
    got = KernelEngine("torch", r_blk=64).eval_fused(chunk, pool)
    _assert_same(got, NumpyEngine().eval_fused(chunk, pool))
    eng = KernelEngine("torch")
    fusedv = eng.eval_fused(chunk, [])
    assert fusedv.words.shape == (0, 5) and not fusedv.or_words.any()
    empty = eng.eval_fused(encode_chunk([]), [clause(presence("a"))])
    assert empty.words.shape == (1, 0) and empty.counts.tolist() == [0]
    with pytest.raises(ValueError):
        eng.eval_fused_prefix(chunk, pool, len(pool) + 1)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    """On a CPU tensor the kernel wrapper runs the plain version (and
    counts no launch); rows past ``n_valid`` stay zero."""
    recs = generate_records("winlog", 70, seed=4)
    plan = compile_plan(tuple(predicate_pool("winlog")[:40]))
    view = tier_view(plan, 20)
    data = torch.from_numpy(encode_chunk(recs).data)
    tables = ops.plan_tensors(view, ops.KERNEL_FIELDS + ops.UNIQUE_FIELDS, "cpu")
    before = fused.launches
    words, or_words, counts = fused.clause_bitvectors_fused(
        data, tables, 50, n_simple=view.n_simple)
    assert fused.launches == before
    u = ops.plan_tensors(view, ops.UNIQUE_FIELDS, "cpu")
    want = ref.clause_bitvectors_ref(
        data, u["ukeys"], u["uklens"], u["uvals"], u["uvlens"], u["uunb"],
        u["key_ids"], u["val_ids"], u["membership"], 50,
        n_simple=view.n_simple)
    for a, b in zip((words, or_words, counts), want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a,
                           b.view(torch.int32) if b.dtype == torch.uint32
                           else b)
    assert not torch_unpack(words, 70)[:, 50:].any()
    assert counts.sum() > 0


def test_get_engine_names():
    assert get_engine("torch").backend == "torch"
    assert isinstance(get_engine("numpy"), NumpyEngine)
    for name in ("xla", "pallas", "pallas_interpret", "bogus"):
        with pytest.raises(ValueError):
            get_engine(name)


def test_engine_matches_record_semantics():
    """No false negatives against exact evaluation on the parsed record."""
    recs = generate_records("yelp", 120, seed=8)
    pool = predicate_pool("yelp")[::7]
    bits = KernelEngine("torch").eval(encode_chunk(recs), pool)
    for ri, r in enumerate(recs):
        obj = json.loads(r)
        for ci, c in enumerate(pool):
            if c.matches_exact(obj):
                assert bits[ci, ri], (c.describe(), r)
