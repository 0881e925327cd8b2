"""Drifting-workload benchmark on the port: adaptive replanning vs a static
epoch-0 plan (the JAX package's ``benchmarks/bench_replan.py``), with the
fleet's pushdown on kernel A (``KernelEngine("cuda")``; ``--device cpu``:
its plain version).

Scenario (DESIGN.md §11): a fleet of client shards streams chunks while the
query workload is piecewise-stationary — phase 1 draws Zipf(1.5) queries,
then the Zipf parameter AND the hot-clause permutation shift (phase 2).
The static run keeps the epoch-0 plan; the adaptive run wires a
``Replanner`` into the ingest coordinator, which detects the coverage
collapse from the scanner's query log, re-solves the budgeted selection
from observed selectivities + the recalibrated cost model, and broadcasts
the new plan epoch to every shard mid-stream.

Post-drift metrics (the paper's protocol, measured over the tail of the
phase-2 workload):

  * ``scan_s``     — wall-clock of the post-drift query batch;
  * ``eff_ratio``  — effective loading ratio (loaded + JIT-loaded records)
    / ingested records: a static plan degrades to ~1.0 because un-pushed
    queries JIT-promote the whole raw remainder;
  * ``skip_frac``  — fraction of candidate rows skipped via bitvectors.

The cost model is calibrated from timed numpy-engine probes first
(paper §VII-F) so the budget means real µs/record of host CPU; the
calibration stays on the host numpy engine, as in the reference, and is
not refitted to kernel A's launch-bound times (they would make every
clause look free).  The replanner's online recalibration reads the
shards' measured evaluation times, which on the card are kernel A's.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_replan [--device cpu]

Writes ``artifacts/bench_torch_replan.json`` with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks.common import BACKEND, card, write_artifact
from repro_torch.core.client import NumpyEngine
from repro_torch.core.cost_model import CostModel, calibrate_scaled
from repro_torch.core.planner import build_plan
from repro_torch.core.replan import Replanner, ReplanPolicy
from repro_torch.core.server import CiaoStore, DataSkippingScanner, PushdownPlan
from repro_torch.core.workload import DriftPhase, Workload, drifting_workloads
from repro_torch.data.datasets import generate_records, predicate_pool
from repro_torch.data.pipeline import ClientShard, IngestCoordinator


def calibrated_cost_model(sample_records: list[bytes],
                          pool, n_probes: int = 4) -> CostModel:
    """Recalibrate the default model to this hardware + engine.

    The probe plan is sized like the plans the budget will actually buy
    (~``n_probes`` clauses) — see :func:`repro_torch.core.cost_model.
    calibrate_scaled` for why probe size matters.
    """
    return calibrate_scaled(sample_records, pool[:n_probes], NumpyEngine())


def _scenario(
    *, adaptive: bool, dataset: str, budget_us: float,
    cost_model: CostModel, wl_phases: list[Workload],
    sample: list[bytes], chunk_records: int, chunks_per_phase: int,
    n_shards: int, queries_per_chunk: int, n_tail_queries: int, eng,
) -> dict:
    wl1, wl2 = wl_phases
    rep0 = build_plan(wl1, sample, budget_us=budget_us, cost_model=cost_model)
    plan0 = PushdownPlan(clauses=list(rep0.plan.clauses))
    store = CiaoStore(plan0)
    scanner = DataSkippingScanner(store)
    replanner = None
    if adaptive:
        policy = ReplanPolicy(
            check_every_records=2 * chunk_records,
            min_observe_records=chunk_records,
            min_coverage=0.6,
            workload_window=4 * queries_per_chunk,
            min_window_queries=max(2 * queries_per_chunk, 8),
        )
        replanner = Replanner(
            store, sample, budget_us=budget_us, base_workload=wl1,
            cost_model=cost_model, policy=policy, planned_sel=rep0.sel,
        )
    shards = [ClientShard(dataset, i, eng, plan0,
                          chunk_records=chunk_records)
              for i in range(n_shards)]

    qstream = iter(wl1.queries)

    def on_chunk(done: int) -> None:
        for _ in range(queries_per_chunk):
            q = next(qstream, None)
            if q is not None:
                scanner.scan(q)

    coord = IngestCoordinator(shards, store, replanner=replanner,
                              on_chunk=on_chunk)
    coord.run(chunks_per_client=chunks_per_phase)      # phase 1
    qstream = iter(wl2.queries[:-n_tail_queries])      # drift hits here
    coord.run(chunks_per_client=chunks_per_phase)      # phase 2

    # post-drift measurement: the tail of the phase-2 workload
    tail = wl2.queries[-n_tail_queries:]
    t0 = time.perf_counter()
    scanned = skipped = 0
    for q in tail:
        r = scanner.scan(q)
        scanned += r.rows_scanned
        skipped += r.rows_skipped
    scan_s = time.perf_counter() - t0
    stats = store.stats
    return {
        "adaptive": adaptive,
        "epoch": store.epoch,
        "epoch_bumps": coord.epoch_bumps,
        "n_records": stats.n_records,
        "loading_ratio_ingest": round(stats.loading_ratio, 4),
        "eff_loading_ratio": round(
            (stats.n_loaded + stats.n_jit_loaded) / stats.n_records, 4),
        "post_drift_scan_s": round(scan_s, 4),
        "rows_scanned": scanned,
        "skip_frac": round(skipped / max(scanned + skipped, 1), 4),
        "replan_events": [e.describe() for e in
                          (replanner.history if replanner else [])],
        "cost_scale": round(replanner.cost_scale, 3) if replanner else None,
    }


def run(
    dataset: str = "ycsb", *, n_records: int = 16384,
    n_shards: int = 2, queries_per_phase: int = 150,
    n_tail_queries: int = 60, budget_clauses: float = 4.0, seed: int = 1,
    device: str = "cuda",
) -> dict:
    from repro_torch.kernels.engine import KernelEngine

    if n_tail_queries <= 0 or n_tail_queries >= queries_per_phase:
        raise ValueError(
            "n_tail_queries must be in (0, queries_per_phase): the tail is "
            "held out of the ingest-time stream for the post-drift scan")
    pool = predicate_pool(dataset)
    phases = [
        DriftPhase(queries_per_phase, "zipf", 1.5, seed=seed),
        DriftPhase(queries_per_phase, "zipf", 2.0, seed=seed + 6),
    ]
    wl_phases = drifting_workloads(pool, phases)
    sample = generate_records(dataset, 400, seed=17)
    cost_model = calibrated_cost_model(sample, pool)
    # budget = ~budget_clauses x the median clause cost on this hardware
    sel = {c: 0.2 for c in pool}
    costs = sorted(cost_model.clause_cost(c, sel[c]) for c in pool)
    budget_us = budget_clauses * costs[len(costs) // 2]

    chunk_records = 512
    chunks_per_phase = max(n_records // (2 * n_shards * chunk_records), 1)
    queries_per_chunk = max(
        queries_per_phase // (chunks_per_phase * n_shards) // 2, 1)

    common = dict(
        dataset=dataset, budget_us=budget_us, cost_model=cost_model,
        wl_phases=wl_phases, sample=sample, chunk_records=chunk_records,
        chunks_per_phase=chunks_per_phase, n_shards=n_shards,
        queries_per_chunk=queries_per_chunk, n_tail_queries=n_tail_queries,
        eng=KernelEngine(BACKEND[device]),
    )
    static = _scenario(adaptive=False, **common)
    adaptive = _scenario(adaptive=True, **common)
    out = {
        "device": device, "card": card(device),
        "budget_us": round(budget_us, 3),
        "static": static,
        "adaptive": adaptive,
        "post_drift_scan_speedup": round(
            static["post_drift_scan_s"]
            / max(adaptive["post_drift_scan_s"], 1e-9), 2),
        "eff_loading_ratio_delta": round(
            static["eff_loading_ratio"] - adaptive["eff_loading_ratio"], 4),
    }
    print(f"[replan] budget {budget_us:.2f} us/rec | static scan "
          f"{static['post_drift_scan_s']:.3f}s ratio "
          f"{static['eff_loading_ratio']:.2%} | adaptive scan "
          f"{adaptive['post_drift_scan_s']:.3f}s ratio "
          f"{adaptive['eff_loading_ratio']:.2%} (epoch "
          f"{adaptive['epoch']}, x{out['post_drift_scan_speedup']} scan, "
          f"skip {adaptive['skip_frac']:.0%} vs {static['skip_frac']:.0%})")
    for ev in adaptive["replan_events"]:
        print(f"[replan]   {ev}")
    return out


if __name__ == "__main__":
    from repro_torch.benchmarks.bench_schema import validate_replan

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    args = ap.parse_args()
    out = run(device=args.device)
    print(f"wrote {write_artifact('replan', out)}")
    validate_replan(out)
