"""Shape and claim validation of the port's benchmark artifacts: the port's
own copy of the JAX package's ``benchmarks/bench_schema.py``, its gates
and floors unchanged.

Each validator raises :class:`SchemaError` unless its artifact has the
reference's shape and meets the reference's claim gates (counts exact,
speed floors at full size, collapse floors for ``quick`` runs).  They
accept the JAX package's tracked ``BENCH_*.json`` and the port's
``artifacts/bench_torch_*.json`` alike (:func:`validate_file` goes by the
file's name).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_schema FILE [FILE ...]
"""
from __future__ import annotations

import json
import numbers
import sys


class SchemaError(ValueError):
    """A benchmark artifact does not match its declared shape."""


def _require(cond: bool, where: str, msg: str) -> None:
    if not cond:
        raise SchemaError(f"{where}: {msg}")


def _check_fields(row: dict, spec: dict[str, type | tuple], where: str) -> None:
    _require(isinstance(row, dict), where, f"expected object, got {type(row).__name__}")
    for key, typ in spec.items():
        _require(key in row, where, f"missing key {key!r}")
        _require(isinstance(row[key], typ) and not (
            typ is not bool and isinstance(row[key], bool)),
            where, f"{key!r} expected {typ}, got {row[key]!r}")


_ENGINE_ROW = {
    "engine": str,
    # execution provenance: a pallas number measured under the interpreter
    # must never read as a TPU number in the tracked trajectory
    "backend": str,
    "device": str,
    "interpret": bool,
    "records_per_s": numbers.Integral,
    "us_per_record": numbers.Real,
    "effective_GBps": numbers.Real,
}

_FUSED_ROW = {
    "backend": str,
    "n_records": numbers.Integral,
    "n_clauses": numbers.Integral,
    "n_kv_pairs": numbers.Integral,
    "split_us_per_record": numbers.Real,
    "fused_us_per_record": numbers.Real,
    "speedup": numbers.Real,
    "launches_split": numbers.Integral,
    "launches_fused": numbers.Integral,
}


def validate_kernels(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid kernels artifact."""
    _require(isinstance(obj, dict), "kernels", "top level must be an object")
    for section, spec, min_rows in (
        ("engines", _ENGINE_ROW, 2),
        ("fused_vs_split", _FUSED_ROW, 1),
    ):
        _require(section in obj, "kernels", f"missing section {section!r}")
        rows = obj[section]
        _require(isinstance(rows, list), section, "must be a list")
        _require(len(rows) >= min_rows, section,
                 f"expected >= {min_rows} rows, got {len(rows)}")
        for i, row in enumerate(rows):
            _check_fields(row, spec, f"{section}[{i}]")
    for i, row in enumerate(obj["engines"]):
        _require(row["us_per_record"] > 0, f"engines[{i}]",
                 "us_per_record must be positive")
    for i, row in enumerate(obj["fused_vs_split"]):
        _require(row["launches_fused"] == 1, f"fused_vs_split[{i}]",
                 "the fused path is ONE launch by contract")


def validate_replan(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid replan artifact."""
    _require(isinstance(obj, dict), "replan", "top level must be an object")
    for key in ("budget_us", "static", "adaptive",
                "post_drift_scan_speedup", "eff_loading_ratio_delta"):
        _require(key in obj, "replan", f"missing key {key!r}")
    for side in ("static", "adaptive"):
        _check_fields(obj[side], {
            "epoch": numbers.Integral,
            "eff_loading_ratio": numbers.Real,
            "post_drift_scan_s": numbers.Real,
        }, side)
    _require(obj["adaptive"]["epoch"] >= 1, "replan",
             "adaptive run never advanced the plan epoch")


_TIER_SCENARIO_ROW = {
    "mode": str,
    "tier_assignment": list,
    "budget_spent_us": numbers.Real,
    "budget_ok": bool,
    "n_records": numbers.Integral,
    "eff_loading_ratio": numbers.Real,
    "loading_s": numbers.Real,
    "scan_s": numbers.Real,
    "end_to_end_s": numbers.Real,
    "retier_events": numbers.Integral,
}


def validate_tiers(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid tiers artifact.

    Beyond shape, this gates the benchmark's CLAIM: the tier allocator
    must beat BOTH uniform baselines on effective loading ratio and
    end-to-end time, within the global budget, on a nested family.
    """
    _require(isinstance(obj, dict), "tiers", "top level must be an object")
    for key in ("global_budget_us", "fleet", "tiers", "tiered",
                "uniform_min", "uniform_max", "wins"):
        _require(key in obj, "tiers", f"missing key {key!r}")
    _require(isinstance(obj["tiers"], dict), "tiers",
             "'tiers' must be an object")
    sizes = obj["tiers"].get("sizes")
    _require(isinstance(sizes, list) and len(sizes) >= 2, "tiers.sizes",
             "need >= 2 nested tiers")
    _require(all(a <= b for a, b in zip(sizes, sizes[1:])), "tiers.sizes",
             f"tier sizes must be ascending (nested): {sizes}")
    for side in ("tiered", "uniform_min", "uniform_max"):
        _check_fields(obj[side], _TIER_SCENARIO_ROW, side)
        _require(obj[side]["eff_loading_ratio"] > 0, side,
                 "eff_loading_ratio must be positive")
    tiered, umin, umax = (obj["tiered"], obj["uniform_min"],
                          obj["uniform_max"])
    _require(tiered["budget_ok"], "tiered",
             "the allocator exceeded the global budget")
    _require(tiered["retier_events"] >= 1, "tiered",
             "cost-drift re-tiering never fired (the drift demo must "
             "re-solve the allocation)")
    _require(not umax["budget_ok"], "uniform_max",
             "uniform-max fit the budget: the scenario has no trade-off")
    _require(
        tiered["eff_loading_ratio"]
        < min(umin["eff_loading_ratio"], umax["eff_loading_ratio"]),
        "tiers", "tiered allocation must beat both uniform baselines on "
        "effective loading ratio")
    _require(
        tiered["end_to_end_s"]
        < min(umin["end_to_end_s"], umax["end_to_end_s"]),
        "tiers", "tiered allocation must beat both uniform baselines on "
        "end-to-end time")


_SCAN_SIDE = {
    "scan_s": numbers.Real,
    "us_per_query": numbers.Real,
}


def validate_scan(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid scan artifact.

    Beyond shape, this gates the columnar engine's CLAIM: counts must be
    bit-identical to the exact-match oracle across the mixed-epoch /
    mixed-tier workload, zone maps must demonstrably prune, and the
    vectorized path must beat the row-at-a-time path >= 5x at full size
    (>= 1.5x for reduced-size ``--quick``/CI smoke runs, which trade
    segment sizes for wall-clock).
    """
    _require(isinstance(obj, dict), "scan", "top level must be an object")
    for key in ("quick", "n_records", "n_segments", "n_queries",
                "row_at_a_time", "columnar", "speedup", "cold_speedup",
                "counts_match"):
        _require(key in obj, "scan", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "scan", "'quick' must be bool")
    _check_fields(obj["row_at_a_time"], _SCAN_SIDE, "row_at_a_time")
    _check_fields(obj["columnar"], dict(
        _SCAN_SIDE, cold_scan_s=numbers.Real,
        segments_pruned=numbers.Integral), "columnar")
    _require(obj["counts_match"] is True, "scan",
             "columnar counts diverged from the exact-match oracle")
    _require(obj["n_segments"] >= 2, "scan", "need >= 2 segments")
    _require(obj["n_queries"] >= 10, "scan", "need >= 10 workload queries")
    _require(obj["columnar"]["segments_pruned"] >= 1, "scan",
             "zone maps never pruned a segment (the second skipping "
             "level is not demonstrated)")
    floor = 1.5 if obj["quick"] else 5.0
    _require(obj["speedup"] >= floor, "scan",
             f"columnar speedup {obj['speedup']} < required {floor}x")


_SHARD_RUN_ROW = {
    "n_shards": numbers.Integral,
    "scan_s": numbers.Real,
    "us_per_query": numbers.Real,
    "counts_match": bool,
    "selective_pruned_fraction": numbers.Real,
    "max_shard_rows": numbers.Integral,
    "min_shard_rows": numbers.Integral,
}


def validate_shard(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid shard artifact.

    Beyond shape, this gates the shard plane's CLAIM (DESIGN.md §14):
    counts bit-identical to the 1-shard oracle at every shard count,
    >= 30% of per-query shard visits partition-pruned on the selective
    subset at 8 shards, and >= 2x scan speedup at 8 shards.  Reduced-size
    ``--quick`` runs only gate against collapse (>= 0.8x): their tiny
    per-shard segments leave little vectorized work for pruning to skip,
    so the measured ratio sits in wall-clock noise on loaded 2-core CI
    runners — the 2x claim is full-size-only, like the scan gate's 5x.
    """
    _require(isinstance(obj, dict), "shard", "top level must be an object")
    for key in ("quick", "n_records", "routing_card", "n_queries",
                "n_selective", "routing_key", "mode", "runs",
                "counts_match", "speedup_4", "speedup_8",
                "selective_pruned_fraction"):
        _require(key in obj, "shard", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "shard", "'quick' must be bool")
    _require(isinstance(obj["routing_key"], str) and obj["routing_key"],
             "shard", "routing_key must be a non-empty string")
    runs = obj["runs"]
    _require(isinstance(runs, list) and len(runs) >= 3, "runs",
             "need >= 3 shard-count rows")
    for i, row in enumerate(runs):
        _check_fields(row, _SHARD_RUN_ROW, f"runs[{i}]")
        _require(row["scan_s"] > 0, f"runs[{i}]", "scan_s must be positive")
        _require(row["counts_match"] is True, f"runs[{i}]",
                 "counts diverged from the 1-shard oracle")
        _require(row["min_shard_rows"] >= 0
                 and row["max_shard_rows"] >= row["min_shard_rows"],
                 f"runs[{i}]", "shard row bounds inconsistent")
    shard_counts = [row["n_shards"] for row in runs]
    for need in (1, 4, 8):
        _require(need in shard_counts, "runs",
                 f"missing the {need}-shard row")
    _require(obj["counts_match"] is True, "shard",
             "sharded counts diverged from the unsharded oracle")
    _require(0.0 <= obj["selective_pruned_fraction"] <= 1.0, "shard",
             "selective_pruned_fraction out of [0, 1]")
    _require(obj["selective_pruned_fraction"] >= 0.3, "shard",
             "partition metadata pruned < 30% of shard visits on the "
             "selective workload (the third skipping level is not "
             "demonstrated)")
    floor = 0.8 if obj["quick"] else 2.0
    _require(obj["speedup_8"] >= floor, "shard",
             f"8-shard speedup {obj['speedup_8']} < required {floor}x")


_DEVICE_SIDE = {
    "scan_s": numbers.Real,
    "us_per_query": numbers.Real,
    "records_per_s": numbers.Integral,
}


def validate_device(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid device artifact.

    Beyond shape, this gates the device scan plane's CLAIM (DESIGN.md
    §15): counts bit-identical to the quiesced host oracle, ZERO
    steady-state host->device segment uploads, the fused batched path
    >= 2x the numpy-vectorized reference of the SAME plane scan on the
    selective workload (full-size; reduced-size ``--quick`` runs gate
    against collapse at 0.5x; the host skipping scanner is reported as
    ``host_skipping`` context, not gated), a batch of 8 queries >= 3x
    over 8 sequential device scans (>= 0.8x quick), and a roofline
    fraction from the bytes bound — present, positive, and <= 1
    (nothing beats the hardware bound) — with the reference's analytic
    model of the same launch beside it where present
    (``roofline["analytic"]``, not a bound on kernel B, so not gated at
    1).
    """
    _require(isinstance(obj, dict), "device", "top level must be an object")
    for key in ("quick", "backend", "device", "interpret", "n_records",
                "n_segments", "n_queries", "numpy", "host_skipping",
                "device_batched", "device_sequential", "speedup",
                "batch8_speedup", "counts_match", "uploads_steady",
                "roofline", "roofline_frac"):
        _require(key in obj, "device", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "device", "'quick' must be bool")
    _require(isinstance(obj["backend"], str) and obj["backend"],
             "device", "backend must be a non-empty string")
    _require(isinstance(obj["interpret"], bool), "device",
             "'interpret' must be bool")
    for side in ("numpy", "host_skipping", "device_batched",
                 "device_sequential"):
        _check_fields(obj[side], _DEVICE_SIDE, side)
        _require(obj[side]["scan_s"] > 0, side, "scan_s must be positive")
    _require(obj["counts_match"] is True, "device",
             "device counts diverged from the quiesced host oracle")
    _require(obj["uploads_steady"] == 0, "device",
             "steady-state scans re-uploaded segment data "
             f"({obj['uploads_steady']} transfers; the resident plane is "
             "not resident)")
    _require(obj["n_segments"] >= 2, "device", "need >= 2 segments")
    _require(obj["n_queries"] >= 10, "device", "need >= 10 workload queries")
    floor = 0.5 if obj["quick"] else 2.0
    _require(obj["speedup"] >= floor, "device",
             f"device speedup {obj['speedup']} < required {floor}x over "
             "numpy-vectorized")
    b_floor = 0.8 if obj["quick"] else 3.0
    _require(obj["batch8_speedup"] >= b_floor, "device",
             f"batch-of-8 speedup {obj['batch8_speedup']} < required "
             f"{b_floor}x over 8 sequential scans")
    roof = obj["roofline"]
    _require(isinstance(roof, dict), "roofline", "must be an object")
    for key in ("device_flops", "device_bytes", "step_time_s",
                "measured_s", "dominant"):
        _require(key in roof, "roofline", f"missing key {key!r}")
    ana = roof.get("analytic")          # the port's artifacts carry it
    if ana is not None:
        _require(isinstance(ana, dict), "roofline", "'analytic' must be an "
                 "object")
        for key in ("device_flops", "device_bytes", "step_time_s",
                    "dominant", "frac"):
            _require(key in ana, "roofline.analytic", f"missing key {key!r}")
    frac = obj["roofline_frac"]
    _require(isinstance(frac, numbers.Real) and not isinstance(frac, bool),
             "device", "roofline_frac must be a number")
    _require(0.0 < frac <= 1.0, "device",
             f"roofline_frac {frac} outside (0, 1]")


_BATCH_SIDE = {
    "scan_s": numbers.Real,
    "us_per_query": numbers.Real,
}


def validate_batch(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid batch artifact.

    Beyond shape, this gates the multi-query plane's CLAIM (DESIGN.md
    §16): per-query counts AND accounting bit-identical to the
    sequential scanner oracle, batch-of-8 >= 2x over sequential scans at
    full size (>= 0.8x for reduced-size ``--quick`` runs, which gate
    against collapse only — tiny stores leave little parse work for the
    batcher to share), and warm-cache repeats >= 5x over the uncached
    batch (>= 1.5x quick).
    """
    _require(isinstance(obj, dict), "batch", "top level must be an object")
    for key in ("quick", "n_records", "n_segments", "n_queries",
                "n_slices", "audit_key", "sequential", "batched",
                "speedup", "cache", "cache_speedup", "counts_match",
                "accounting_match"):
        _require(key in obj, "batch", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "batch", "'quick' must be bool")
    _require(isinstance(obj["audit_key"], str) and obj["audit_key"],
             "batch", "audit_key must be a non-empty string")
    for side in ("sequential", "batched"):
        _check_fields(obj[side], _BATCH_SIDE, side)
        _require(obj[side]["scan_s"] > 0, side, "scan_s must be positive")
    _check_fields(obj["cache"], {
        "warm_scan_s": numbers.Real,
        "uncached_scan_s": numbers.Real,
        "speedup": numbers.Real,
        "hits": numbers.Integral,
        "misses": numbers.Integral,
        "hit_rate": numbers.Real,
    }, "cache")
    _require(obj["counts_match"] is True, "batch",
             "batched counts diverged from the sequential oracle")
    _require(obj["accounting_match"] is True, "batch",
             "batched accounting diverged from the sequential oracle")
    _require(obj["n_queries"] >= 8, "batch", "need a panel of >= 8 queries")
    _require(obj["n_segments"] >= 2, "batch", "need >= 2 segments")
    _require(obj["cache"]["hits"] >= 1, "batch",
             "the warm pass never hit the result cache")
    floor = 0.8 if obj["quick"] else 2.0
    _require(obj["speedup"] >= floor, "batch",
             f"batch-of-{obj['n_queries']} speedup {obj['speedup']} < "
             f"required {floor}x over sequential scans")
    c_floor = 1.5 if obj["quick"] else 5.0
    _require(obj["cache_speedup"] >= c_floor, "batch",
             f"warm-cache speedup {obj['cache_speedup']} < required "
             f"{c_floor}x over the uncached batch")


def validate_serve(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid serve artifact.

    Beyond shape, this gates the async serving plane's CLAIM (DESIGN.md
    §17): every count answered during live ingest bounded by the
    ``matches_exact`` oracle and the quiesced panel BIT-IDENTICAL to it,
    p99 scan latency under live writes <= 3x the quiesced p99 at the
    same reader concurrency (<= 8x quick — tiny quick stores leave the
    snapshot churn nothing to amortize over), and aggregate scan
    throughput >= 2x the serialized ingest-then-scan loop (>= 0.5x
    quick, a collapse gate only).
    """
    _require(isinstance(obj, dict), "serve", "top level must be an object")
    for key in ("quick", "n_records", "n_chunks", "n_shards",
                "query_threads", "panel_size", "cpu_count", "serialized",
                "live", "quiesced", "throughput_speedup", "p99_ratio",
                "counts_match", "live_counts_bounded"):
        _require(key in obj, "serve", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "serve", "'quick' must be bool")
    _check_fields(obj["serialized"], {
        "ingest_s": numbers.Real,
        "total_s": numbers.Real,
        "queries": numbers.Integral,
        "qps": numbers.Real,
    }, "serialized")
    _check_fields(obj["live"], {
        "total_s": numbers.Real,
        "queries": numbers.Integral,
        "qps": numbers.Real,
        "p50_us": numbers.Real,
        "p99_us": numbers.Real,
        "blocked_s": numbers.Real,
    }, "live")
    _check_fields(obj["quiesced"], {
        "queries": numbers.Integral,
        "p50_us": numbers.Real,
        "p99_us": numbers.Real,
    }, "quiesced")
    for side in ("serialized", "live"):
        _require(obj[side]["total_s"] > 0, side, "total_s must be positive")
        _require(obj[side]["queries"] > 0, side, "queries must be positive")
    _require(obj["query_threads"] >= 8, "serve",
             "the claim is gated at >= 8 query threads")
    _require(obj["counts_match"] is True, "serve",
             "quiesced counts diverged from the matches_exact oracle")
    _require(obj["live_counts_bounded"] is True, "serve",
             "a live count exceeded the final oracle (phantom rows)")
    floor = 0.5 if obj["quick"] else 2.0
    _require(obj["throughput_speedup"] >= floor, "serve",
             f"aggregate scan throughput {obj['throughput_speedup']}x < "
             f"required {floor}x over the serialized ingest-then-scan loop")
    ceil = 8.0 if obj["quick"] else 3.0
    _require(obj["p99_ratio"] <= ceil, "serve",
             f"live p99 is {obj['p99_ratio']}x the quiesced p99 > "
             f"allowed {ceil}x")


def validate_tuner(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid tuner artifact.

    Beyond shape, this gates the online physical-design tuner's CLAIM
    (DESIGN.md §18): counts BIT-IDENTICAL to the ``matches_exact``
    oracle in every phase — before, during the background migration
    (checked continuously by the reader pool), and after; the router
    actually swapped to the drifted key and moved rows in >= 2 bounded
    batches (incremental, not stop-the-world); post-drift scan
    throughput recovered >= 1.5x over the stale layout (>= 0.8x quick —
    tiny quick stores leave pruning little to delete, CI gates against
    collapse only); and reader p99 during the migration <= 3x the
    quiesced p99 at the same concurrency on the same stale layout
    (<= 8x quick), i.e. background moves never stall readers.
    """
    _require(isinstance(obj, dict), "tuner", "top level must be an object")
    for key in ("quick", "n_records", "n_chunks", "n_shards",
                "query_threads", "panel_size", "cpu_count", "key_before",
                "key_after", "router_swapped", "before", "post_drift",
                "during", "quiesced", "after", "migration",
                "telemetry_tuner", "tuner_events", "recovery_speedup",
                "p99_ratio", "shards_pruned_after", "counts_match"):
        _require(key in obj, "tuner", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "tuner", "'quick' must be bool")
    panel = {
        "passes": numbers.Integral,
        "queries": numbers.Integral,
        "us_per_query": numbers.Real,
        "qps": numbers.Real,
        "counts_match": bool,
    }
    for phase in ("before", "post_drift", "after"):
        _check_fields(obj[phase], panel, phase)
        _require(obj[phase]["queries"] > 0, phase, "queries must be positive")
    _check_fields(obj["during"], {
        "migrate_s": numbers.Real,
        "queries": numbers.Integral,
        "p50_us": numbers.Real,
        "p99_us": numbers.Real,
    }, "during")
    _check_fields(obj["quiesced"], {
        "queries": numbers.Integral,
        "p50_us": numbers.Real,
        "p99_us": numbers.Real,
    }, "quiesced")
    _check_fields(obj["migration"], {
        "rows_moved": numbers.Integral,
        "rows_kept": numbers.Integral,
        "segments_moved": numbers.Integral,
        "items_skipped": numbers.Integral,
        "batches": numbers.Integral,
    }, "migration")
    _require(isinstance(obj["tuner_events"], list) and obj["tuner_events"],
             "tuner", "'tuner_events' must be a non-empty list")
    _require(obj["counts_match"] is True, "tuner",
             "a phase's counts diverged from the matches_exact oracle")
    _require(obj["router_swapped"] is True, "tuner",
             f"router never swapped to the drifted key "
             f"(still {obj['key_after']!r})")
    _require(obj["migration"]["rows_moved"] >= 1, "tuner",
             "the migration moved no rows")
    _require(obj["migration"]["batches"] >= 2, "tuner",
             "migration ran in one batch — not incremental")
    _require(obj["shards_pruned_after"] > 0, "tuner",
             "no partition pruning on the new routing key after migration")
    floor = 0.8 if obj["quick"] else 1.5
    _require(obj["recovery_speedup"] >= floor, "tuner",
             f"post-drift recovery {obj['recovery_speedup']}x < required "
             f"{floor}x over the stale layout")
    ceil = 8.0 if obj["quick"] else 3.0
    _require(obj["p99_ratio"] <= ceil, "tuner",
             f"reader p99 during migration is {obj['p99_ratio']}x the "
             f"quiesced p99 > allowed {ceil}x")


_SKIP_SIDE = {
    "scan_s": numbers.Real,
    "us_per_query": numbers.Real,
    "warm_scan_s": numbers.Real,
}


def validate_skip(obj: dict) -> None:
    """Raise :class:`SchemaError` unless ``obj`` is a valid skip artifact.

    Beyond shape, this gates the skipping-index registry's CLAIM
    (DESIGN.md §19): counts BIT-IDENTICAL to the ``matches_exact``
    oracle on the range/IN/substring workload for the skip path, the
    no-skip baseline, AND the reloaded checkpoints (format-6 round trip
    plus a format-5 manifest with the registry fields stripped —
    ``migration_ok``); >= 60% of (query, segment) visits pruned by the
    partition + zone cascade; and >= 5x fresh-evaluation scan speedup
    over the pruning-disabled baseline at full size (>= 1.5x for
    reduced-size ``--quick``/CI smoke runs).
    """
    _require(isinstance(obj, dict), "skip", "top level must be an object")
    for key in ("quick", "n_records", "n_shards", "n_segments",
                "n_queries", "noskip", "skip", "pruned_fraction",
                "speedup", "warm_speedup", "counts_match", "migration_ok"):
        _require(key in obj, "skip", f"missing key {key!r}")
    _require(isinstance(obj["quick"], bool), "skip", "'quick' must be bool")
    _check_fields(obj["noskip"], _SKIP_SIDE, "noskip")
    _check_fields(obj["skip"], dict(
        _SKIP_SIDE, segments_scanned=numbers.Integral,
        segments_zone_pruned=numbers.Integral,
        shard_visits_pruned=numbers.Integral), "skip")
    for side in ("noskip", "skip"):
        _require(obj[side]["scan_s"] > 0, side, "scan_s must be positive")
    _require(obj["counts_match"] is True, "skip",
             "skip-path or no-skip counts diverged from the "
             "matches_exact oracle")
    _require(obj["migration_ok"] is True, "skip",
             "checkpoint round trip failed (format-6 reload or format-5 "
             "migration diverged from the oracle)")
    _require(obj["n_segments"] >= 2, "skip", "need >= 2 segments")
    _require(obj["n_queries"] >= 10, "skip", "need >= 10 workload queries")
    _require(obj["skip"]["segments_zone_pruned"] >= 1, "skip",
             "zone maps never pruned a segment")
    _require(obj["skip"]["shard_visits_pruned"] >= 1, "skip",
             "partition metadata never pruned a shard visit")
    _require(0.0 <= obj["pruned_fraction"] <= 1.0, "skip",
             "pruned_fraction out of [0, 1]")
    _require(obj["pruned_fraction"] >= 0.6, "skip",
             f"pruned_fraction {obj['pruned_fraction']} < required 0.6 "
             "on the selective range/IN/substring workload")
    floor = 1.5 if obj["quick"] else 5.0
    _require(obj["speedup"] >= floor, "skip",
             f"skip speedup {obj['speedup']} < required {floor}x")


_VALIDATORS = {
    "bench_kernels.json": validate_kernels,
    "BENCH_kernels.json": validate_kernels,
    "bench_replan.json": validate_replan,
    "bench_tiers.json": validate_tiers,
    "BENCH_tiers.json": validate_tiers,
    "bench_scan.json": validate_scan,
    "BENCH_scan.json": validate_scan,
    "bench_shard.json": validate_shard,
    "BENCH_shard.json": validate_shard,
    "bench_device.json": validate_device,
    "BENCH_device.json": validate_device,
    "bench_batch.json": validate_batch,
    "BENCH_batch.json": validate_batch,
    "bench_serve.json": validate_serve,
    "BENCH_serve.json": validate_serve,
    "bench_tuner.json": validate_tuner,
    "BENCH_tuner.json": validate_tuner,
    "bench_skip.json": validate_skip,
    "BENCH_skip.json": validate_skip,
}
# the port's artifacts: artifacts/bench_torch_<name>.json
_VALIDATORS.update({
    name.replace("bench_", "bench_torch_", 1): fn
    for name, fn in list(_VALIDATORS.items()) if name.startswith("bench_")})


def validate_file(path: str) -> str:
    """Validate one artifact by filename convention; returns the kind."""
    name = path.rsplit("/", 1)[-1]
    validator = _VALIDATORS.get(name)
    if validator is None:
        raise SchemaError(f"no schema registered for {name!r}")
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise SchemaError(f"{path}: not valid JSON ({e})") from e
    validator(obj)
    return name


def main(argv: list[str]) -> int:
    if not argv:
        print("usage: python -m repro_torch.benchmarks.bench_schema FILE ...",
              file=sys.stderr)
        return 2
    for path in argv:
        try:
            validate_file(path)
        except SchemaError as e:
            print(f"SCHEMA FAIL {path}: {e}", file=sys.stderr)
            return 1
        print(f"schema ok: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
