"""The port's paper benchmarks, Figs 3-12, Table IV and selection
(``repro_torch.benchmarks.{common, bench_end_to_end, bench_micro,
bench_cost_model, bench_selection}``) against the JAX package's
``benchmarks/`` on the same seeds.

Every field that no clock sets is held equal: the pushed clauses, the
loading ratio and the per-query counts of all 36 cells of the paper's
grid (kernel A's and B's plain versions on the CPU, every chunk's
bitvectors also held to the numpy engine's, every count to
``FullScanBaseline`` in host and device mode), and the micro benches'
plans, ratios, coverage and skew.  No speed is gated here.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from benchmarks import bench_cost_model as j_cost  # noqa: E402
from benchmarks import bench_micro as j_micro  # noqa: E402
from benchmarks import bench_selection as j_selection  # noqa: E402
from benchmarks import common as j_common  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro_torch.benchmarks import bench_cost_model, bench_end_to_end  # noqa: E402
from repro_torch.benchmarks import bench_micro, bench_selection  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.core.client import NumpyEngine  # noqa: E402
from repro_torch.core.predicates import clause_to_obj  # noqa: E402
from repro_torch.data.datasets import generate_records  # noqa: E402
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

N_RECORDS = 2000
N_EXEC = 6
CELLS = [(d, w, b) for d in bench_end_to_end.DATASETS
         for w in bench_end_to_end.WORKLOADS for b in bench_end_to_end.BUDGETS]


def _objs(clauses):
    return [json.loads(json.dumps(clause_to_obj(c))) for c in clauses]


@pytest.fixture(scope="module")
def records():
    return {d: generate_records(d, N_RECORDS, seed=17)
            for d in bench_end_to_end.DATASETS}


@pytest.fixture(scope="module", autouse=True)
def _pure_work_once():
    """Memoized for this module: both planners' ``estimate_selectivities``
    (the four budgets of a (dataset, workload) pair plan from the same
    pool and sample) and the JAX ``run_end_to_end``'s record generation
    (every cell of a dataset makes the same records).  Both are pure
    functions of their arguments, and they are most of a small cell's
    time."""
    from repro.core import planner as j_planner
    from repro_torch.core import planner

    def memo(fn, key, out):
        seen = {}

        def call(*args, **kw):
            k = key(*args, **kw)
            if k not in seen:
                seen[k] = fn(*args, **kw)
            return out(seen[k])
        return call

    with pytest.MonkeyPatch.context() as mp:
        for mod in (planner, j_planner):
            mp.setattr(mod, "estimate_selectivities", memo(
                mod.estimate_selectivities,
                lambda pool, sample: (tuple(pool), tuple(sample)), dict))
        mp.setattr(j_common, "generate_records", memo(
            j_common.generate_records,
            lambda dataset, n, seed: (dataset, n, seed), list))
        yield


@pytest.mark.parametrize("dataset,kind,budget", CELLS)
def test_end_to_end_cell_matches_jax(records, dataset, kind, budget):
    """One grid cell: the same plan size, loading ratio and counts as the
    JAX package's ``run_end_to_end``; counts equal ``FullScanBaseline``'s
    in host and device mode (``run_end_to_end`` raises otherwise)."""
    wl = common.make_workload(dataset, kind)
    ours = common.run_end_to_end(
        dataset, wl, budget, n_records=N_RECORDS, n_queries_exec=N_EXEC,
        engine=KernelEngine("torch"), records=records[dataset],
        scan_backend="torch", hold_to=NumpyEngine())
    theirs = j_common.run_end_to_end(
        dataset, j_common.make_workload(dataset, kind), budget,
        n_records=N_RECORDS, n_queries_exec=N_EXEC)
    assert (ours.n_pushed, ours.loading_ratio) == \
        (theirs.n_pushed, theirs.loading_ratio)
    assert ours.counts == ours.device_counts == ours.baseline_counts
    assert len(ours.counts) == N_EXEC
    assert ours.held_chunks == (N_RECORDS // 1000 if ours.n_pushed else 0)
    assert ours.n_records == N_RECORDS
    assert ours.device_first_s > 0 and ours.device_steady_s > 0


@pytest.mark.parametrize("kind", ["A", "B", "C"])
def test_workloads_and_records_equal_jax(kind):
    for dataset in bench_end_to_end.DATASETS:
        ours = common.make_workload(dataset, kind)
        theirs = j_common.make_workload(dataset, kind)
        assert ours.name == theirs.name == kind
        assert [_objs(q.clauses) for q in ours.queries] == \
            [[json.loads(json.dumps(j_pred.clause_to_obj(c)))
              for c in q.clauses] for q in theirs.queries]
    assert generate_records("yelp", 50, seed=17) == \
        j_datasets.generate_records("yelp", 50, seed=17)


def test_run_end_to_end_raises_on_a_wrong_engine(records):
    """An engine whose bitvectors differ from the reference engine's, or
    a store whose counts differ from the baseline's, fails the cell."""

    class Flipped(NumpyEngine):
        def eval_packed(self, chunk, clauses):
            words = super().eval_packed(chunk, clauses).copy()
            words[0, 0] ^= 1
            return words

    wl = common.make_workload("ycsb", "A")
    with pytest.raises(AssertionError, match="differ"):
        common.run_end_to_end("ycsb", wl, 1.0, n_records=N_RECORDS,
                              n_queries_exec=4, engine=Flipped(),
                              records=records["ycsb"], scan_backend="torch",
                              hold_to=NumpyEngine())
    with pytest.raises(ValueError, match="records given"):
        common.run_end_to_end("ycsb", wl, 1.0, n_records=100,
                              records=records["ycsb"], engine=NumpyEngine(),
                              scan_backend="torch")


def test_zero_budget_cell_has_no_prefilter(records):
    wl = common.make_workload("winlog", "C")
    r = common.run_end_to_end("winlog", wl, 0.0, n_records=N_RECORDS,
                              n_queries_exec=4, engine=NumpyEngine(),
                              records=records["winlog"],
                              scan_backend="torch")
    assert (r.n_pushed, r.prefilter_s, r.loading_ratio) == (0, 0.0, 1.0)
    assert r.held_chunks == 0
    assert r.counts == r.device_counts == r.baseline_counts


def test_bench_end_to_end_main_writes_the_grid(tmp_path):
    out_path = tmp_path / "e2e.json"
    out = bench_end_to_end.main([
        "--device", "cpu", "--records", "1000", "--queries", "4",
        "--datasets", "ycsb,winlog", "--workloads", "A",
        "--budgets", "0.5,1.0", "--out", str(out_path)])
    on_disk = json.loads(out_path.read_text())
    assert on_disk["card"] == "cpu" and on_disk["device"] == "cpu"
    assert len(on_disk["rows"]) == 4
    assert [(r["dataset"], r["budget_us"]) for r in on_disk["rows"]] == \
        [("ycsb", 0.5), ("ycsb", 1.0), ("winlog", 0.5), ("winlog", 1.0)]
    for r in on_disk["rows"]:
        assert len(r["counts"]) == 4
        for k in bench_end_to_end.SPEEDUPS:
            assert r[k] > 0
    for k, b in out["best"].items():
        assert b["x"] == max(r[k] for r in out["rows"])
    assert out["paper"] == {"loading_speedup": 21.0, "query_speedup": 23.0,
                            "e2e_speedup": 19.0}
    # the numpy client engine: the same plans and counts
    np_out = bench_end_to_end.run(1000, 4, datasets=["ycsb"],
                                  workloads=["A"], budgets=[1.0],
                                  engine="numpy", device="cpu")
    assert [(r["n_pushed"], r["loading_ratio"], r["counts"])
            for r in np_out] == \
        [(r["n_pushed"], r["loading_ratio"], r["counts"])
         for r in out["rows"] if r["dataset"] == "ycsb"
         and r["budget_us"] == 1.0]


def test_micro_benches_match_jax():
    """Figs 6-12 at a small size: every field no clock sets."""
    eng = KernelEngine("torch")
    ours = bench_micro.query_fraction(eng, n_records=400, budgets=(1.0,))
    theirs = j_micro.query_fraction(n_records=400, budgets=(1.0,))
    assert [r["n_pushed"] for r in ours] == [r["n_pushed"] for r in theirs]
    for fn in ("selectivity_sweep", "overlap_sweep", "skewness_sweep"):
        ours = getattr(bench_micro, fn)(eng, n_records=400)
        theirs = getattr(j_micro, fn)(n_records=400)
        keep = ("target_sel", "actual_sel", "loading_ratio",
                "covered_queries", "skewness_factor", "workload")
        assert [{k: r[k] for k in keep if k in r} for r in ours] == \
            [{k: r[k] for k in keep if k in r} for r in theirs], fn
    ours = bench_micro.patterns_memo(n_records=200, repeats=1)
    theirs = j_micro.patterns_memo(n_records=200, repeats=1)
    assert (ours["hits"], ours["n_terms"], ours["memoized"]) == \
        (theirs["hits"], theirs["n_terms"], theirs["memoized"])


def test_cost_model_bench_rows(monkeypatch, tmp_path):
    """Table IV: the same probes as the JAX bench; the kernel engine's row
    in place of the XLA one, an R² and five coefficients per row."""
    assert [p.describe() for p in bench_cost_model._probes()] == \
        [p.describe() for p in j_cost._probes()]
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path)
    rows = bench_cost_model.main(n_records=300, repeats=1, device="cpu")
    assert [r["platform"] for r in rows] == \
        ["python-bytes-find", "numpy-vectorized", "torch-plain"]
    for r in rows:
        assert np.isfinite(r["r_squared"]) and len(r["coeffs"]) == 5
    written = json.loads((tmp_path / "bench_torch_cost_model.json")
                         .read_text())
    assert written["card"] == "cpu" and written["rows"] == rows


def test_selection_bench_matches_jax():
    ours = bench_selection.scaling(sizes=((40, 80), (80, 160)))
    theirs = j_selection.scaling(sizes=((40, 80), (80, 160)))
    keep = ("n_preds", "n_queries", "eager_evals", "celf_evals")
    assert [{k: r[k] for k in keep} for r in ours] == \
        [{k: r[k] for k in keep} for r in theirs]
    assert bench_selection.quality(n_trials=4) == j_selection.quality(
        n_trials=4)
