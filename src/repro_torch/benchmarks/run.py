"""The port's benchmark suite, one section per paper table or figure (the
JAX package's ``benchmarks/run.py``).

Each section runs its bench, writes ``artifacts/bench_torch_<name>.json``
(with the card's name and power limit) and holds it to the port's copy
of the reference's gates (``bench_schema``).  A gate that fails is
reported and the suite goes on; the exit code is 1 if any failed.  A
wrong count raises at once.  Nothing is written outside ``artifacts/``.
Then a ``name,us_per_call,derived`` CSV summary, as the reference prints.

    PYTHONPATH=src python -m repro_torch.benchmarks.run            # one card
    PYTHONPATH=src python -m repro_torch.benchmarks.run --quick --device cpu
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only e2e,device

``--device cpu`` runs the kernels' plain versions: its times say nothing
of the card, and its speed gates gate nothing real.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks import bench_schema
from repro_torch.benchmarks.common import write_artifact

# suite name -> what it measures (single source for --only and --list)
SUITES = {
    "e2e": "paper Figs 3-5 end-to-end loading/query/overlap speedups",
    "micro": "paper Figs 6-12 micro-benchmarks + pattern-memo check",
    "cost": "paper Table IV cost-model fit",
    "selection": "CELF predicate selection scaling + quality bound",
    "kernels": "client engine throughput + fused-vs-split launches",
    "replan": "workload-drift replanning vs a static plan",
    "tiers": "tiered fleet allocation vs uniform baselines",
    "scan": "columnar segment scan vs row-at-a-time",
    "shard": "sharded store scaling + partition pruning",
    "device": "device-resident fused scan plane",
    "batch": "multi-query batcher + result cache",
    "serve": "async serving under live ingest",
    "tuner": "online physical-design tuner drift recovery",
    "skip": "skipping-index registry: range/IN/n-gram pruning",
    "roofline": "the dry run's three-term roofline cells (H100 constants)",
}


def _gated(name: str, out: dict, failed: list[str]) -> dict:
    """Write ``out`` as the section's artifact, then hold it to its gates
    (``bench_schema.validate_<name>``); a failed gate joins ``failed``."""
    path = write_artifact(name, out)
    try:
        getattr(bench_schema, f"validate_{name}")(out)
    except bench_schema.SchemaError as e:
        failed.append(f"{name}: {e}")
        print(f"[run] GATE FAILED {name}: {e}")
    print(f"[run] wrote {path}")
    return out


def run(only: set[str] | None, quick: bool, device: str) -> tuple[list, list]:
    """The selected sections; returns the CSV rows and the failed gates."""
    csv: list[tuple[str, float, str]] = []
    failed: list[str] = []

    def want(name: str) -> bool:
        return only is None or name in only

    if want("e2e"):
        from repro_torch.benchmarks import bench_end_to_end

        out = bench_end_to_end.main([
            "--device", device, "--records", "6000" if quick else "20000",
            "--queries", "20" if quick else "60"])
        b = {k: v["x"] for k, v in out["best"].items()}
        at1 = [r for r in out["rows"] if r["budget_us"] == 1.0]
        csv.append((
            "fig3-5_end_to_end",
            1e6 * sum(r["loading_s"] + r["query_s"] for r in at1)
            / max(len(at1), 1) / 1000,
            f"best_load_x{b['loading_speedup']:.2f};"
            f"best_query_x{b['query_speedup']:.2f};"
            f"best_e2e_x{b['e2e_speedup']:.2f};"
            f"best_e2e_overlap_x{b['e2e_overlapped_speedup']:.2f};"
            f"best_device_query_x{b['device_query_speedup']:.2f}"
            ";paper=21x/23x/19x"))

    if want("micro"):
        from repro_torch.benchmarks import bench_micro

        out = bench_micro.main(["--device", device])
        fr = [r["fraction_improved"] for r in out["fig6_query_fraction"]]
        csv.append(("fig6_query_fraction", 0.0,
                    f"improved_{min(fr):.0%}-{max(fr):.0%};paper=37-68%"))
        csv.append(("fig7-12_micro", 0.0,
                    "selectivity+overlap+skewness recorded"))

    if want("cost"):
        from repro_torch.benchmarks import bench_cost_model

        rows = bench_cost_model.main(n_records=1500 if quick else 3000,
                                     device=device)
        r2s = ";".join(f"{r['platform']}=R2_{r['r_squared']}" for r in rows)
        csv.append(("tableIV_cost_model", 0.0, r2s + ";paper=0.666-0.978"))

    if want("selection"):
        from repro_torch.benchmarks import bench_selection

        out = bench_selection.main(device)
        last = out["scaling"][-1]
        csv.append((
            "selection_celf", last["celf_s"] * 1e6 / max(last["n_preds"], 1),
            f"celf_x{last['speedup']}_at_P{last['n_preds']};"
            f"quality_worst_{out['quality']['worst_ratio']}(>=0.316)"))

    if want("kernels"):
        from repro_torch.benchmarks import bench_kernels
        from repro_torch.benchmarks.common import card

        out = bench_kernels.main(
            n_records=1500 if quick else 4000,
            backends=("cuda", "torch") if device == "cuda" else ("torch",))
        out = _gated("kernels", {"device": device, "card": card(device),
                                 **out}, failed)
        for r in out["engines"]:
            csv.append((f"kernel_{r['engine']}", r["us_per_record"],
                        f"{r['records_per_s']:.0f}rec/s;"
                        f"{r['effective_GBps']:.4f}GBps"))
        for r in out["fused_vs_split"]:
            csv.append((
                f"kernel_fused_{r['backend']}", r["fused_us_per_record"],
                f"split_{r['split_us_per_record']:.3f}us;"
                f"x{r['speedup']:.2f};"
                f"launches_{r['launches_split']}->{r['launches_fused']}"))

    if want("replan"):
        from repro_torch.benchmarks import bench_replan

        out = _gated("replan", bench_replan.run(
            n_records=4096 if quick else 16384,
            queries_per_phase=80 if quick else 150,
            n_tail_queries=30 if quick else 60, device=device), failed)
        csv.append((
            "replan_drift", 0.0,
            f"scan_x{out['post_drift_scan_speedup']};"
            f"ratio_{out['adaptive']['eff_loading_ratio']:.2f}vs"
            f"{out['static']['eff_loading_ratio']:.2f};"
            f"epochs_{out['adaptive']['epoch']}"))

    if want("tiers"):
        from repro_torch.benchmarks import bench_tiers

        out = _gated("tiers", bench_tiers.run(
            n_records=4864 if quick else 13312,
            n_queries=200 if quick else 300,
            n_exec_queries=80 if quick else 120, device=device), failed)
        t, lo, hi = out["tiered"], out["uniform_min"], out["uniform_max"]
        csv.append((
            "tiers_fleet", 0.0,
            f"eff_{t['eff_loading_ratio']:.2f}vs"
            f"{lo['eff_loading_ratio']:.2f}/{hi['eff_loading_ratio']:.2f};"
            f"e2e_{t['end_to_end_s']}vs{lo['end_to_end_s']}/"
            f"{hi['end_to_end_s']};retiers_{t['retier_events']}"))

    if want("scan"):
        from repro_torch.benchmarks import bench_scan

        out = _gated("scan", bench_scan.run(
            n_records=6144 if quick else 24576, repeats=2 if quick else 3,
            quick=quick, device=device), failed)
        csv.append((
            "scan_columnar", out["columnar"]["us_per_query"],
            f"row_{out['row_at_a_time']['us_per_query']}us;"
            f"x{out['speedup']};cold_x{out['cold_speedup']};"
            f"pruned_{out['columnar']['segments_pruned']};"
            f"counts_match_{out['counts_match']}"))

    if want("shard"):
        from repro_torch.benchmarks import bench_shard

        out = _gated("shard", bench_shard.run(
            n_records=16384 if quick else 65536, repeats=2 if quick else 3,
            quick=quick, device=device), failed)
        at8 = next(r for r in out["runs"] if r["n_shards"] == 8)
        csv.append((
            "shard_store", at8["us_per_query"],
            f"x{out['speedup_4']}@4;x{out['speedup_8']}@8;"
            f"pruned_{out['selective_pruned_fraction']:.0%};"
            f"counts_match_{out['counts_match']}"))

    if want("device"):
        from repro_torch.benchmarks import bench_device

        out = _gated("device", bench_device.run(
            n_records=6144 if quick else 24576, repeats=2 if quick else 3,
            quick=quick, device=device), failed)
        csv.append((
            "device_scan", out["device_batched"]["us_per_query"],
            f"x{out['speedup']:.2f}_vs_numpy;"
            f"batch8_x{out['batch8_speedup']:.2f};"
            f"uploads_steady_{out['uploads_steady']};"
            f"roofline_frac_{out['roofline_frac']:.6f};"
            f"counts_match_{out['counts_match']}"))

    if want("batch"):
        from repro_torch.benchmarks import bench_batch

        out = _gated("batch", bench_batch.run(
            n_records=6144 if quick else 24576, repeats=2 if quick else 3,
            quick=quick, device=device), failed)
        csv.append((
            "batch_scan", out["batched"]["us_per_query"],
            f"seq_{out['sequential']['us_per_query']}us;x{out['speedup']};"
            f"cache_x{out['cache_speedup']};"
            f"counts_match_{out['counts_match']}"))

    if want("serve"):
        from repro_torch.benchmarks import bench_serve

        out = _gated("serve", bench_serve.run(
            n_records=6144 if quick else 24576,
            segment_capacity=512 if quick else 1024, quick=quick,
            device=device), failed)
        csv.append((
            "serve_live_p99", out["live"]["p99_us"],
            f"x{out['throughput_speedup']:.2f}_vs_serialized;"
            f"p99_ratio_{out['p99_ratio']:.2f};"
            f"counts_match_{out['counts_match']}"))

    if want("tuner"):
        from repro_torch.benchmarks import bench_tuner

        out = _gated("tuner", bench_tuner.run(
            n_records=8192 if quick else 49152,
            segment_capacity=512 if quick else 1024, quick=quick,
            device=device), failed)
        csv.append((
            "tuner_drift", out["after"]["us_per_query"],
            f"recovery_x{out['recovery_speedup']:.2f}_vs_stale;"
            f"p99_ratio_{out['p99_ratio']:.2f};"
            f"rows_moved_{out['migration']['rows_moved']};"
            f"counts_match_{out['counts_match']}"))

    if want("skip"):
        from repro_torch.benchmarks import bench_skip

        out = _gated("skip", bench_skip.run(
            n_records=6144 if quick else 24576, repeats=2 if quick else 3,
            quick=quick, device=device), failed)
        csv.append((
            "skip_registry", out["skip"]["us_per_query"],
            f"noskip_{out['noskip']['us_per_query']}us;x{out['speedup']};"
            f"pruned_{out['pruned_fraction']:.0%};"
            f"migration_ok_{out['migration_ok']};"
            f"counts_match_{out['counts_match']}"))

    if want("roofline"):
        from repro_torch.benchmarks import bench_roofline

        recs = bench_roofline.main()
        if recs:
            ok = [r for r in recs.values() if "roofline" in r]
            csv.append((
                "roofline_cells", 0.0,
                f"{len(ok)}_cells_run;"
                f"{sum(1 for r in recs.values() if 'skipped' in r)}"
                f"_documented_skips"))
    return csv, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", default=None,
                    help="comma list of suites (see --list): "
                         + ",".join(SUITES))
    ap.add_argument("--list", action="store_true",
                    help="list the registered bench suites and exit")
    args = ap.parse_args(argv)
    if args.list:
        for name, what in SUITES.items():
            print(f"{name:10s} {what}")
        return 0
    only = set(args.only.split(",")) if args.only else None
    if only is not None and only - set(SUITES):
        ap.error(f"unknown suite(s): {','.join(sorted(only - set(SUITES)))}"
                 " (see --list)")
    csv, failed = run(only, args.quick, args.device)
    print("\n=== name,us_per_call,derived ===")
    for name, us, derived in csv:
        print(f"{name},{us:.3f},{derived}")
    for f in failed:
        print(f"[run] gate failed: {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
