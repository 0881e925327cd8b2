"""The paper's end-to-end protocol on the port (the JAX package's
``benchmarks/common.py``), with the client's pushdown and the query
batch on the card.

The protocol is the reference's, step for step: ``generate_records(dataset,
n_records, seed=17)``; a plan from ``build_plan`` at the budget with the
default :class:`CostModel` (modelled µs/record of client CPU, so the
port's plans equal the reference's cell for cell); then four clocks:

  * **prefilter** — ``encode_chunk`` and the client engine's
    ``eval_packed`` for every ``chunk_size``-record chunk.  The engine
    defaults to ``KernelEngine("cuda")`` (kernel A); its first call
    builds the kernel and stages the plan table, so one chunk is
    evaluated before the clock starts.  Each chunk's bitvectors are
    copied back to the host inside the clock, as the protocol needs them
    there;
  * **loading** — ``CiaoStore.ingest_chunk`` of every chunk (host);
  * **baseline loading** — ``FullScanBaseline`` parses every record;
  * **query** — the host ``DataSkippingScanner``, query by query (the
    paper's column), then the baseline's row-by-row scan of the same
    queries.

After them, untimed by the paper's clocks, the same queries go through
``DeviceScanner`` (kernel B) in batches of 64: the first pass (it
promotes what the host pass left raw, admits the plane and uploads it)
and the steady pass are timed apart.  Every host and device count is
held equal to ``FullScanBaseline``'s; a difference raises.

Speedups are the paper's: baseline (budget 0) time over CIAO time.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.benchmarks.bench_serve import card  # noqa: F401 (re-export)
from repro_torch.core import bitvector
from repro_torch.core.client import encode_chunk
from repro_torch.core.cost_model import CostModel
from repro_torch.core.device_scan import DeviceScanner
from repro_torch.core.planner import build_plan
from repro_torch.core.server import (
    CiaoStore, DataSkippingScanner, FullScanBaseline, PushdownPlan,
)
from repro_torch.core.workload import Workload, generate_workload
from repro_torch.data.datasets import generate_records, predicate_pool

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"
#: ``--device`` of a bench -> the kernels' backend (``"torch"``: their
#: plain versions)
BACKEND = {"cuda": "cuda", "cpu": "torch"}
#: queries per ``DeviceScanner.scan_batch`` call (the main path's batch)
DEVICE_BATCH = 64
#: the paper's best speedups at 1.0 µs/record (loading, query, end to end)
PAPER = {"loading_speedup": 21.0, "query_speedup": 23.0,
         "e2e_speedup": 19.0}


def write_artifact(name: str, out) -> Path:
    """``out`` as ``artifacts/bench_torch_<name>.json``; returns the path."""
    path = ARTIFACTS / f"bench_torch_{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return path


@dataclass
class EndToEndResult:
    dataset: str
    workload: str
    budget_us: float
    n_pushed: int
    loading_ratio: float
    prefilter_s: float
    loading_s: float
    query_s: float
    baseline_loading_s: float
    baseline_query_s: float
    n_records: int = 0
    n_loaded: int = 0
    #: DeviceScanner over the same queries, first and steady pass
    device_first_s: float = 0.0
    device_steady_s: float = 0.0
    #: per executed query: host, device and FullScanBaseline counts
    counts: list[int] = field(default_factory=list)
    device_counts: list[int] = field(default_factory=list)
    baseline_counts: list[int] = field(default_factory=list)
    #: chunks whose bitvectors were held equal to ``hold_to``'s
    held_chunks: int = 0

    @property
    def loading_speedup(self) -> float:
        return self.baseline_loading_s / max(self.loading_s, 1e-9)

    @property
    def query_speedup(self) -> float:
        return self.baseline_query_s / max(self.query_s, 1e-9)

    @property
    def device_query_speedup(self) -> float:
        """The baseline's query time over the device scanner's steady
        pass."""
        return self.baseline_query_s / max(self.device_steady_s, 1e-9)

    @property
    def end_to_end_speedup(self) -> float:
        """Conservative: client prefilter serialized with server work."""
        base = self.baseline_loading_s + self.baseline_query_s
        ours = self.prefilter_s + self.loading_s + self.query_s
        return base / max(ours, 1e-9)

    @property
    def end_to_end_overlapped_speedup(self) -> float:
        """Deployment model (paper §IV-B's latency-hiding bet): clients
        evaluate predicates while producing records, so the server-side
        critical path is loading + query; client cost is bounded by the
        budget, not on the path."""
        base = self.baseline_loading_s + self.baseline_query_s
        ours = max(self.loading_s + self.query_s, self.prefilter_s)
        return base / max(ours, 1e-9)


def make_workload(dataset: str, kind: str, n_queries: int = 200,
                  seed: int = 0) -> Workload:
    """Paper Table III: A=Zipf(1.5), B=Zipf(2), C=uniform."""
    pool = predicate_pool(dataset)
    rng = np.random.default_rng(seed)
    if kind == "A":
        return generate_workload(pool, n_queries=n_queries, distribution="zipf",
                                 zipf_a=1.5, rng=rng, name="A")
    if kind == "B":
        return generate_workload(pool, n_queries=n_queries, distribution="zipf",
                                 zipf_a=2.0, rng=rng, name="B")
    return generate_workload(pool, n_queries=n_queries, distribution="uniform",
                             rng=rng, name="C")


def run_end_to_end(dataset: str, workload: Workload, budget_us: float,
                   *, n_records: int = 20000, chunk_size: int = 1000,
                   n_queries_exec: int | None = None, engine=None,
                   cost_model: CostModel | None = None,
                   sample: list | None = None, records: list | None = None,
                   scan_backend: str = "cuda",
                   hold_to=None) -> EndToEndResult:
    """One cell of the paper's Figs 3-5 (module docstring).

    ``engine``: the client engine (``KernelEngine("cuda")`` when None).
    ``records``: ``generate_records(dataset, n_records, seed=17)``, made
    here when None (a grid passes one list to every cell of a dataset).
    ``scan_backend``: ``DeviceScanner``'s backend for the device passes
    (``"cuda"``; ``"torch"``: kernel B's plain version).  ``hold_to``: an
    engine whose packed bitvectors every chunk's must equal bit for bit,
    and whose load mask the store's loaded-row count must equal (checked
    outside the clocks)."""
    if engine is None:
        from repro_torch.kernels.engine import KernelEngine
        engine = KernelEngine("cuda")
    if records is None:
        records = generate_records(dataset, n_records, seed=17)
    elif len(records) != n_records:
        raise ValueError(f"{len(records)} records given, n_records is "
                         f"{n_records}")
    sample = sample if sample is not None else records[:500]

    if budget_us > 0:
        report = build_plan(workload, sample, budget_us=budget_us,
                            cost_model=cost_model)
        plan = report.plan
    else:
        plan = PushdownPlan(clauses=[])
    if plan.n:
        # outside the clock: the first call builds the kernel and stages
        # the plan's tables
        engine.eval_packed(encode_chunk(records[:chunk_size]), plan.clauses)

    # client prefiltering (the paper's "prefiltering" bar)
    chunks, bitvecs = [], []
    t0 = time.perf_counter()
    for i in range(0, n_records, chunk_size):
        chunk = encode_chunk(records[i: i + chunk_size])
        bv = engine.eval_packed(chunk, plan.clauses) if plan.n else None
        chunks.append(chunk)
        bitvecs.append(bv)
    prefilter_s = time.perf_counter() - t0

    held, ref_loaded = 0, 0
    if hold_to is not None and plan.n:
        for i, (chunk, bv) in enumerate(zip(chunks, bitvecs)):
            want = hold_to.eval_packed(chunk, plan.clauses)
            if not np.array_equal(np.asarray(bv), want):
                raise AssertionError(
                    f"{dataset}/{workload.name} budget {budget_us}: chunk "
                    f"{i}'s bitvectors differ from the reference engine's")
            mask = np.bitwise_or.reduce(want, axis=0)
            ref_loaded += int(bitvector.popcount(mask))
            held += 1

    # server partial loading (the paper's "Data loading" bar)
    store = CiaoStore(plan)
    t0 = time.perf_counter()
    for chunk, bv in zip(chunks, bitvecs):
        store.ingest_chunk(chunk, bv if bv is not None else np.zeros((0, 0), np.uint32))
    loading_s = time.perf_counter() - t0
    if held and store.stats.n_loaded != ref_loaded:
        raise AssertionError(
            f"{dataset}/{workload.name} budget {budget_us}: "
            f"{store.stats.n_loaded} rows loaded, the reference engine's "
            f"load mask holds {ref_loaded}")

    # baseline: parse + load everything
    base = FullScanBaseline()
    t0 = time.perf_counter()
    for chunk, _ in zip(chunks, bitvecs):
        base.ingest_chunk(chunk)
    baseline_loading_s = time.perf_counter() - t0

    # query execution (the paper's "Query" bar): the whole workload
    queries = workload.queries[: n_queries_exec or len(workload.queries)]
    scanner = DataSkippingScanner(store)
    t0 = time.perf_counter()
    counts = [scanner.scan(q).count for q in queries]
    query_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    baseline_counts = [base.scan(q).count for q in queries]
    baseline_query_s = time.perf_counter() - t0

    dev = DeviceScanner(store, backend=scan_backend, log_queries=False)
    batches = [queries[i:i + DEVICE_BATCH]
               for i in range(0, len(queries), DEVICE_BATCH)]
    t0 = time.perf_counter()
    first = [r.count for b in batches for r in dev.scan_batch(b)]
    device_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    device_counts = [r.count for b in batches for r in dev.scan_batch(b)]
    device_steady_s = time.perf_counter() - t0
    if first != device_counts:
        raise AssertionError(f"{dataset}/{workload.name} budget "
                             f"{budget_us}: device passes disagree")

    for name, got in (("host", counts), ("device", device_counts)):
        if got != baseline_counts:
            bad = [q.describe() for q, a, b in
                   zip(queries, got, baseline_counts) if a != b]
            raise AssertionError(
                f"{dataset}/{workload.name} budget {budget_us}: {name} "
                f"counts differ from FullScanBaseline on {bad[:3]}")

    return EndToEndResult(
        dataset=dataset,
        workload=workload.name,
        budget_us=budget_us,
        n_pushed=plan.n,
        loading_ratio=store.stats.loading_ratio,
        prefilter_s=prefilter_s if plan.n else 0.0,
        loading_s=loading_s,
        query_s=query_s,
        baseline_loading_s=baseline_loading_s,
        baseline_query_s=baseline_query_s,
        n_records=store.stats.n_records,
        n_loaded=store.stats.n_loaded,
        device_first_s=device_first_s,
        device_steady_s=device_steady_s,
        counts=counts,
        device_counts=device_counts,
        baseline_counts=baseline_counts,
        held_chunks=held,
    )
