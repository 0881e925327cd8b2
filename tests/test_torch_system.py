"""The paper's system end to end on the port, at small scale.

The first part runs the JAX package's ``tests/test_system.py`` on the
port, every client chunk through the kernel engine's plain version
(kernel A's): the pipeline's answers equal a full scan across budgets
and workloads, the loading ratio tracks the pushed set's union
selectivity, a larger budget never selects a worse objective, and CIAO
feeds a train step (on the CPU, attention through the plain version).
The second part holds each pipeline against the JAX package's on the
same records: the same plan, loading ratio and counts; and the recipe
batch and its train step's loss (within 1e-3 in the config's bf16, the
bound of ``tests/test_torch_train.py``) against the JAX package's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import client as j_client  # noqa: E402
from repro.core import planner as j_planner  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro_torch.core.client import encode_chunk  # noqa: E402
from repro_torch.core.planner import build_plan  # noqa: E402
from repro_torch.core.predicates import clause_to_obj  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, FullScanBaseline,
)
from repro_torch.core.workload import generate_workload  # noqa: E402
from repro_torch.data.datasets import generate_records, predicate_pool  # noqa: E402
from repro_torch.kernels.engine import KernelEngine  # noqa: E402


def _pipeline(dataset, budget, n=2000, n_queries=40, kind="zipf", seed=0):
    records = generate_records(dataset, n, seed=seed)
    pool = predicate_pool(dataset)
    rng = np.random.default_rng(seed)
    wl = generate_workload(
        pool, n_queries=n_queries,
        distribution="zipf" if kind == "zipf" else "uniform",
        zipf_a=1.5, rng=rng,
    )
    rep = build_plan(wl, records[:400], budget_us=budget)
    eng = KernelEngine("torch")
    store = CiaoStore(rep.plan)
    base = FullScanBaseline()
    for i in range(0, n, 500):
        chunk = encode_chunk(records[i: i + 500])
        bv = (eng.eval_packed(chunk, rep.plan.clauses) if rep.plan.n
              else np.zeros((0, 0), np.uint32))
        store.ingest_chunk(chunk, bv)
        base.ingest_chunk(chunk)
    return wl, rep, store, base, records


@pytest.mark.parametrize("dataset", ("yelp", "winlog", "ycsb"))
@pytest.mark.parametrize("budget", (0.0, 0.5, 1.5))
def test_all_query_answers_exact(dataset, budget):
    wl, rep, store, base, _ = _pipeline(dataset, budget)
    scanner = DataSkippingScanner(store)
    for q in wl.queries[:25]:
        assert scanner.scan(q).count == base.scan(q).count, q.describe()


def test_loading_ratio_tracks_union_selectivity():
    wl, rep, store, base, records = _pipeline("ycsb", 1.5)
    if rep.plan.n == 0:
        pytest.skip("budget pushed nothing")
    union = sum(
        1 for r in records
        if any(c.matches_raw(r) for c in rep.plan.clauses)
    ) / len(records)
    assert abs(store.stats.loading_ratio - union) < 1e-9


def test_budget_monotone_objective():
    records = generate_records("ycsb", 1200, seed=3)
    pool = predicate_pool("ycsb")
    wl = generate_workload(pool, n_queries=40, distribution="zipf",
                           zipf_a=1.5, rng=np.random.default_rng(3))
    objs = []
    for b in (0.25, 0.5, 1.0, 2.0, 4.0):
        rep = build_plan(wl, records[:400], budget_us=b)
        objs.append(rep.selection.objective)
    assert all(a <= b_ + 1e-9 for a, b_ in zip(objs, objs[1:])), objs


def _train_step_on_recipe(tokens, mask):
    """One port train step of the reduced qwen3-1.7b on a recipe batch,
    from the JAX package's parameters; returns its metrics."""
    import jax

    from repro.models.layers import split
    from repro.models.model import build_model as j_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    values, _ = split(j_build_model(cfg).init(jax.random.PRNGKey(0)))
    params = params_from_reference(jax.tree.map(np.asarray, values), cfg,
                                   "cpu")
    oc = OptConfig()
    state = opt_mod.init(params, oc)
    _, _, metrics = make_train_step(model, oc)(params, state, {
        "tokens": torch.from_numpy(tokens),
        "loss_mask": torch.from_numpy(mask)})
    return values, metrics


def test_ciao_feeds_training_end_to_end():
    """CIAO store → recipe batches → one train step, loss finite."""
    from repro_torch.core.predicates import Query
    from repro_torch.data.pipeline import RecipeBatcher
    from repro_torch.data.tokenizer import ByteTokenizer

    wl, rep, store, base, _ = _pipeline("ycsb", 1.5)
    recipe = Query((rep.plan.clauses[0],)) if rep.plan.n else Query(tuple())
    tok = ByteTokenizer(vocab_size=512)
    batcher = RecipeBatcher(store, tok, seq_len=64, batch_size=2)
    tokens, mask = next(iter(batcher.batches(recipe)))
    _, metrics = _train_step_on_recipe(tokens, mask)
    assert np.isfinite(float(metrics["loss"]))


# ---- held against the JAX package on the same inputs

def _j_pipeline(dataset, budget, n=2000, n_queries=40, seed=0):
    records = j_datasets.generate_records(dataset, n, seed=seed)
    wl = j_workload.generate_workload(
        j_datasets.predicate_pool(dataset), n_queries=n_queries,
        distribution="zipf", zipf_a=1.5, rng=np.random.default_rng(seed))
    rep = j_planner.build_plan(wl, records[:400], budget_us=budget)
    eng = j_client.NumpyEngine()
    store = j_server.CiaoStore(rep.plan)
    for i in range(0, n, 500):
        chunk = j_client.encode_chunk(records[i: i + 500])
        bv = (eng.eval_packed(chunk, rep.plan.clauses) if rep.plan.n
              else np.zeros((0, 0), np.uint32))
        store.ingest_chunk(chunk, bv)
    return wl, rep, store


@pytest.mark.parametrize("dataset", ("yelp", "winlog", "ycsb"))
@pytest.mark.parametrize("budget", (0.5, 1.5))
def test_pipeline_matches_jax(dataset, budget):
    wl, rep, store, base, _ = _pipeline(dataset, budget)
    jwl, jrep, jstore = _j_pipeline(dataset, budget)
    assert [clause_to_obj(c) for c in rep.plan.clauses] == \
        [j_pred.clause_to_obj(c) for c in jrep.plan.clauses]
    assert rep.selection.objective == jrep.selection.objective
    assert store.stats.loading_ratio == jstore.stats.loading_ratio
    a, b = DataSkippingScanner(store), j_server.DataSkippingScanner(jstore)
    for q, jq in zip(wl.queries[:25], jwl.queries[:25]):
        assert json.dumps([clause_to_obj(c) for c in q.clauses]) == \
            json.dumps([j_pred.clause_to_obj(c) for c in jq.clauses])
        r, jr = a.scan(q), b.scan(jq)
        assert (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed) == \
            (jr.count, jr.rows_scanned, jr.rows_skipped, jr.raw_parsed)


def test_ciao_training_matches_jax():
    """The recipe batch and its train step's loss equal the JAX
    package's (same records, same parameters)."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.data.pipeline import RecipeBatcher as JRecipeBatcher
    from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
    from repro.models.model import build_model as j_build_model
    from repro.train import optimizer as j_opt
    from repro.train.train_step import make_train_step as j_make_train_step
    from repro_torch.core.predicates import Query
    from repro_torch.data.pipeline import RecipeBatcher
    from repro_torch.data.tokenizer import ByteTokenizer

    wl, rep, store, base, _ = _pipeline("ycsb", 1.5)
    jwl, jrep, jstore = _j_pipeline("ycsb", 1.5)
    recipe = Query((rep.plan.clauses[0],))
    jrecipe = j_pred.Query((jrep.plan.clauses[0],))
    tokens, mask = next(iter(RecipeBatcher(
        store, ByteTokenizer(vocab_size=512), seq_len=64,
        batch_size=2).batches(recipe)))
    jtokens, jmask = next(iter(JRecipeBatcher(
        jstore, JByteTokenizer(vocab_size=512), seq_len=64,
        batch_size=2).batches(jrecipe)))
    assert np.array_equal(tokens, jtokens) and np.array_equal(mask, jmask)
    values, metrics = _train_step_on_recipe(tokens, mask)
    jmodel = j_build_model(j_get_config("qwen3-1.7b").reduced())
    oc = j_opt.OptConfig()
    _, _, jmetrics = jax.jit(j_make_train_step(jmodel, oc))(
        values, j_opt.init(values, oc),
        {"tokens": jtokens, "loss_mask": jmask})
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-3
