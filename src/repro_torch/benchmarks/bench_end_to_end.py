"""Paper Figs 3/4/5 on the port: loading / prefilter / query time against
the client budget, 3 datasets x workloads A/B/C (the JAX package's
``benchmarks/bench_end_to_end.py``).

Every cell is :func:`repro_torch.benchmarks.common.run_end_to_end`: the
clients' pushed clauses on kernel A (``KernelEngine("cuda")``), the host
partial load and ``DataSkippingScanner`` queries (the paper's columns),
and the same queries through ``DeviceScanner`` (kernel B) beside them,
first and steady pass apart.  Counts are held to ``FullScanBaseline`` in
every cell.  The paper reports up to 21x loading, 23x query and 19x end
to end at 1.0 µs/record; the best of each is printed beside it.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_end_to_end
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_end_to_end \\
        --records 1048576 --datasets ycsb --workloads A,C --budgets 1.0
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_end_to_end \\
        --device cpu --records 2000 --queries 10      # plain versions

``--engine numpy`` puts the client prefilter on the host numpy engine
(the reference's own engine).  Writes ``artifacts/bench_torch_end_to_end
.json`` (``--out`` to change it) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.benchmarks.common import (
    ARTIFACTS, BACKEND, PAPER, card, make_workload, run_end_to_end,
)
from repro_torch.data.datasets import generate_records

BUDGETS = (0.25, 0.5, 1.0, 2.0)
DATASETS = ("winlog", "yelp", "ycsb")
WORKLOADS = ("A", "B", "C")
SPEEDUPS = ("loading_speedup", "query_speedup", "e2e_speedup",
            "e2e_overlapped_speedup", "device_query_speedup")


def make_engine(engine: str, device: str):
    """The client engine: ``"kernel"`` (kernel A, or its plain version
    with ``device="cpu"``) or ``"numpy"``."""
    if engine == "numpy":
        from repro_torch.core.client import NumpyEngine
        return NumpyEngine()
    from repro_torch.kernels.engine import KernelEngine
    return KernelEngine(BACKEND[device])


def row(r) -> dict:
    """One cell's artifact row (times in seconds, unrounded)."""
    return {
        "dataset": r.dataset, "workload": r.workload,
        "budget_us": r.budget_us, "n_records": r.n_records,
        "n_pushed": r.n_pushed, "loading_ratio": r.loading_ratio,
        "n_loaded": r.n_loaded, "prefilter_s": r.prefilter_s,
        "loading_s": r.loading_s, "query_s": r.query_s,
        "baseline_loading_s": r.baseline_loading_s,
        "baseline_query_s": r.baseline_query_s,
        "device_first_s": r.device_first_s,
        "device_steady_s": r.device_steady_s,
        "loading_speedup": r.loading_speedup,
        "query_speedup": r.query_speedup,
        "e2e_speedup": r.end_to_end_speedup,
        "e2e_overlapped_speedup": r.end_to_end_overlapped_speedup,
        "device_query_speedup": r.device_query_speedup,
        "counts": r.counts,
    }


def run(n_records: int = 20000, n_queries_exec: int = 60, *,
        datasets=DATASETS, workloads=WORKLOADS, budgets=BUDGETS,
        engine: str = "kernel", device: str = "cuda") -> list[dict]:
    """The grid, one :func:`row` per (dataset, workload, budget)."""
    eng = make_engine(engine, device)
    rows = []
    for dataset in datasets:
        records = generate_records(dataset, n_records, seed=17)
        for wname in workloads:
            wl = make_workload(dataset, wname)
            for budget in budgets:
                r = run_end_to_end(
                    dataset, wl, budget, n_records=n_records,
                    n_queries_exec=n_queries_exec, engine=eng,
                    records=records, scan_backend=BACKEND[device])
                rows.append(row(r))
                x = rows[-1]
                print(f"[e2e] {dataset}/{wname} budget={budget}: "
                      f"load x{x['loading_speedup']:.2f} "
                      f"query x{x['query_speedup']:.2f} "
                      f"e2e x{x['e2e_speedup']:.2f} "
                      f"overlap x{x['e2e_overlapped_speedup']:.2f} "
                      f"device query x{x['device_query_speedup']:.2f} "
                      f"(ratio {x['loading_ratio']:.4f}, {x['n_pushed']} "
                      f"pushed)", flush=True)
    return rows


def best(rows: list[dict]) -> dict:
    """Each speedup's best cell: ``{key: {"x", "dataset", "workload",
    "budget_us"}}``."""
    out = {}
    for k in SPEEDUPS:
        top = max(rows, key=lambda r: r[k] if r[k] is not None else -1.0)
        out[k] = {"x": top[k], "dataset": top["dataset"],
                  "workload": top["workload"], "budget_us": top["budget_us"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--engine", choices=("kernel", "numpy"),
                    default="kernel")
    ap.add_argument("--records", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=60,
                    help="queries executed per cell (n_queries_exec)")
    ap.add_argument("--datasets", default=",".join(DATASETS))
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--budgets", default=",".join(map(str, BUDGETS)))
    ap.add_argument("--out", type=Path,
                    default=ARTIFACTS / "bench_torch_end_to_end.json")
    args = ap.parse_args(argv)
    rows = run(args.records, args.queries,
               datasets=args.datasets.split(","),
               workloads=args.workloads.split(","),
               budgets=[float(b) for b in args.budgets.split(",")],
               engine=args.engine, device=args.device)
    out = {"device": args.device, "card": card(args.device),
           "engine": args.engine, "n_records": args.records,
           "n_queries_exec": args.queries, "paper": PAPER,
           "best": best(rows), "rows": rows}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    shown = {k: round(v["x"], 2) for k, v in out["best"].items()}
    print(f"[e2e] best across cells: {shown} (paper: 21x/23x/19x) on "
          f"{out['card']}")
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
