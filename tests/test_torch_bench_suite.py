"""The port's system benchmarks and their gates
(``repro_torch.benchmarks.{bench_replan, bench_tiers, bench_scan,
bench_device, bench_batch, bench_shard, bench_skip, bench_schema, run}``)
against the JAX package's ``benchmarks/`` on the same seeds.

Each bench runs at a small size on the CPU (kernels A and B on their
plain versions) beside the reference bench, and every field no clock
sets is held equal: counts and accounting, segments and shard visits
pruned, tiers per client, epochs and replan events.  Where a plan comes
from a timed calibration, both sides get the same fixed cost model.  The
port's validators accept the reference's tracked ``BENCH_*.json`` and
reject every mutation ``tests/test_bench_smoke.py`` rejects.  No speed
gate runs on a measured artifact here.
"""
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from benchmarks import bench_batch as j_batch  # noqa: E402
from benchmarks import bench_device as j_device  # noqa: E402
from benchmarks import bench_replan as j_replan  # noqa: E402
from benchmarks import bench_scan as j_scan  # noqa: E402
from benchmarks import bench_schema as j_schema  # noqa: E402
from benchmarks import bench_shard as j_shard  # noqa: E402
from benchmarks import bench_skip as j_skip  # noqa: E402
from benchmarks import bench_tiers as j_tiers  # noqa: E402
from repro.core import cost_model as j_cost_model  # noqa: E402
from repro.core import replan as j_replan_mod  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    bench_batch, bench_device, bench_replan, bench_scan, bench_schema,
    bench_shard, bench_skip, bench_tiers, common, run,
)
from repro_torch.core import cost_model, replan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _pick(d: dict, keys) -> dict:
    return {k: d[k] for k in keys}


def test_replan_bench_matches_jax(monkeypatch):
    """Static vs adaptive under a drift: the same budget, epochs, replan
    events, loading ratios and scan accounting, both sides on the
    analytic cost model with no online recalibration."""
    for mod, cm, rp in ((bench_replan, cost_model, replan),
                        (j_replan, j_cost_model, j_replan_mod)):
        monkeypatch.setattr(mod, "calibrated_cost_model",
                            lambda sample, pool, cm=cm: cm.CostModel())
        monkeypatch.setattr(mod, "ReplanPolicy", functools.partial(
            rp.ReplanPolicy, recalibrate_cost=False))
    kw = dict(n_records=2048, queries_per_phase=60, n_tail_queries=20)
    ours = bench_replan.run(**kw, device="cpu")
    theirs = j_replan.run(**kw)
    assert ours["card"] == "cpu"
    assert (ours["budget_us"], ours["eff_loading_ratio_delta"]) == \
        (theirs["budget_us"], theirs["eff_loading_ratio_delta"])
    keys = ("adaptive", "epoch", "epoch_bumps", "n_records",
            "loading_ratio_ingest", "eff_loading_ratio", "rows_scanned",
            "skip_frac", "replan_events", "cost_scale")
    for side in ("static", "adaptive"):
        assert _pick(ours[side], keys) == _pick(theirs[side], keys), side
    assert ours["adaptive"]["epoch"] >= 1
    bench_schema.validate_replan(ours)


def test_tiers_bench_matches_jax(monkeypatch):
    """The 13-client fleet under the three policies: the same tiers per
    client, spend, ratios, scan accounting, re-tiering and per-(epoch,
    tier) ingest, both sides pricing the tiers with the analytic model."""
    for mod, cm in ((bench_tiers, cost_model), (j_tiers, j_cost_model)):
        monkeypatch.setattr(mod, "calibrate_scaled",
                            lambda *a, cm=cm, **k: cm.CostModel())
        monkeypatch.setattr(
            mod, "_measured_tier_costs",
            lambda family, sample, repeats=3: tuple(
                float(c) for c in np.maximum.accumulate(family.tier_costs)))
    kw = dict(n_records=3328, n_queries=200, n_exec_queries=80)
    ours = bench_tiers.run(**kw, device="cpu")
    theirs = j_tiers.run(**kw)
    for k in ("global_budget_us", "fleet", "tiers", "n_exec_queries",
              "n_floor_uncovered_queries"):
        assert ours[k] == theirs[k], k
    keys = ("mode", "tier_assignment", "budget_spent_us", "budget_ok",
            "n_records", "loading_ratio_ingest", "eff_loading_ratio",
            "rows_scanned", "skip_frac", "matches", "retier_events",
            "retier_demo", "group_records")
    for mode in ("tiered", "uniform_min", "uniform_max"):
        assert _pick(ours[mode], keys) == _pick(theirs[mode], keys), mode
    assert ours["wins"]["eff_loading_ratio"] == \
        theirs["wins"]["eff_loading_ratio"]
    assert len(set(ours["tiered"]["tier_assignment"])) > 1


def test_scan_bench_matches_jax():
    ours = bench_scan.run(n_records=2048, repeats=1, device="cpu")
    theirs = j_scan.run(n_records=2048, repeats=1)
    for k in ("quick", "n_records", "n_loaded", "n_segments", "n_queries",
              "n_epochs", "n_tiers", "counts_match"):
        assert ours[k] == theirs[k], k
    assert ours["columnar"]["segments_pruned"] == \
        theirs["columnar"]["segments_pruned"]
    assert ours["counts_match"] is True


def test_device_bench_matches_jax():
    """Kernel B's plain version over bench_scan's store: the same plane,
    counts and accounting as the JAX bench (on its numpy backend); zero
    steady uploads; a bytes bound under the measured call."""
    ours = bench_device.run(n_records=2048, repeats=1, device="cpu")
    theirs = j_device.run(n_records=2048, repeats=1, backend="numpy")
    for k in ("quick", "n_records", "n_segments", "n_queries", "n_slots",
              "counts_match", "uploads_steady"):
        assert ours[k] == theirs[k], k
    assert ours["counts_match"] is True and ours["uploads_steady"] == 0
    assert (ours["backend"], ours["card"], ours["interpret"]) == \
        ("torch", "cpu", False)
    roof = ours["roofline"]
    assert roof["device_bytes"] > 0 and 0 < ours["roofline_frac"] <= 1
    assert roof["step_time_s"] == roof["device_bytes"] / 3.35e12
    ana = roof["analytic"]
    assert ana["device_flops"] > 0 and ana["device_bytes"] > 0
    assert ana["step_time_s"] == max(ana["compute_s"], ana["memory_s"])
    for k in ("n_terms", "n_clauses", "n_queries", "n_slots"):
        assert roof["shape"][k] > 0


def test_batch_bench_matches_jax():
    ours = bench_batch.run(n_records=2048, repeats=1, device="cpu")
    theirs = j_batch.run(n_records=2048, repeats=1)
    for k in ("quick", "n_records", "n_segments", "n_queries", "n_slices",
              "audit_key", "counts_match", "accounting_match"):
        assert ours[k] == theirs[k], k
    assert _pick(ours["cache"], ("hits", "misses", "hit_rate")) == \
        _pick(theirs["cache"], ("hits", "misses", "hit_rate"))
    assert ours["counts_match"] and ours["accounting_match"]


def test_shard_bench_matches_jax():
    ours = bench_shard.run(n_records=2048, repeats=1, device="cpu")
    theirs = j_shard.run(n_records=2048, repeats=1)
    for k in ("quick", "n_records", "routing_card", "n_queries",
              "n_selective", "routing_key", "mode", "counts_match",
              "selective_pruned_fraction"):
        assert ours[k] == theirs[k], k
    keys = ("n_shards", "counts_match", "selective_pruned_fraction",
            "max_shard_rows", "min_shard_rows")
    assert [_pick(r, keys) for r in ours["runs"]] == \
        [_pick(r, keys) for r in theirs["runs"]]
    assert ours["counts_match"] is True


def test_skip_bench_matches_jax():
    ours = bench_skip.run(n_records=2048, repeats=1, device="cpu")
    theirs = j_skip.run(n_records=2048, repeats=1)
    for k in ("quick", "n_records", "n_shards", "n_segments", "n_queries",
              "pruned_fraction", "counts_match", "migration_ok"):
        assert ours[k] == theirs[k], k
    keys = ("segments_scanned", "segments_zone_pruned",
            "shard_visits_pruned")
    assert _pick(ours["skip"], keys) == _pick(theirs["skip"], keys)
    assert ours["counts_match"] and ours["migration_ok"]


# ---- the validators: the port's copy of the reference's gates

TRACKED = ("BENCH_batch.json", "BENCH_device.json", "BENCH_scan.json",
           "BENCH_shard.json", "BENCH_skip.json", "BENCH_tiers.json",
           "BENCH_kernels.json", "BENCH_serve.json", "BENCH_tuner.json")


@pytest.mark.parametrize("name", TRACKED)
def test_port_validators_accept_the_tracked_artifacts(name, tmp_path):
    path = ROOT / name
    assert bench_schema.validate_file(str(path)) == name
    # and the port's artifact name for the same content
    port_name = name.replace("BENCH_", "bench_torch_")
    (tmp_path / port_name).write_text(path.read_text())
    assert bench_schema.validate_file(str(tmp_path / port_name)) == port_name


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_smoke", ROOT / "tests" / "test_bench_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke_module()
# (validator, well-formed artifact, the reference test's mutations)
_SUITES = (
    ("validate_kernels", _SMOKE._GOOD_KERNELS,
     _SMOKE.test_schema_rejects_malformed_kernels),
    ("validate_tiers", _SMOKE._GOOD_TIERS,
     _SMOKE.test_tiers_schema_rejects_malformed_or_losing),
    ("validate_scan", _SMOKE._GOOD_SCAN,
     _SMOKE.test_scan_schema_rejects_malformed_or_losing),
    ("validate_shard", _SMOKE._GOOD_SHARD,
     _SMOKE.test_shard_schema_rejects_malformed_or_losing),
    ("validate_device", _SMOKE._GOOD_DEVICE,
     _SMOKE.test_device_schema_rejects_malformed_or_losing),
)
MUTATIONS = [(name, good, m) for name, good, test in _SUITES
             for mark in test.pytestmark if mark.name == "parametrize"
             for m in mark.args[1]]


@pytest.mark.parametrize("name,good,mutate", MUTATIONS)
def test_port_validators_reject_what_the_reference_rejects(name, good,
                                                           mutate):
    validator = getattr(bench_schema, name)
    validator(json.loads(json.dumps(good)))
    obj = json.loads(json.dumps(good))
    mutate(obj)
    with pytest.raises(j_schema.SchemaError):
        getattr(j_schema, name)(json.loads(json.dumps(obj)))
    with pytest.raises(bench_schema.SchemaError):
        validator(obj)


def test_port_validators_keep_the_reference_floors():
    """The quick floors and the replan gate, as in test_bench_smoke."""
    quick = json.loads(json.dumps(_SMOKE._GOOD_SHARD))
    quick.update(quick=True, speedup_8=0.9)
    bench_schema.validate_shard(quick)
    quick["speedup_8"] = 0.7
    with pytest.raises(bench_schema.SchemaError):
        bench_schema.validate_shard(quick)
    dev = json.loads(json.dumps(_SMOKE._GOOD_DEVICE))
    dev.update(quick=True, speedup=0.6, batch8_speedup=0.9)
    bench_schema.validate_device(dev)
    replan_ok = {"budget_us": 50.0, "post_drift_scan_speedup": 1.5,
                 "eff_loading_ratio_delta": 0.2,
                 "static": {"epoch": 0, "eff_loading_ratio": 1.0,
                            "post_drift_scan_s": 2.0},
                 "adaptive": {"epoch": 1, "eff_loading_ratio": 0.7,
                              "post_drift_scan_s": 1.3}}
    bench_schema.validate_replan(replan_ok)
    replan_ok["adaptive"]["epoch"] = 0
    with pytest.raises(bench_schema.SchemaError):
        bench_schema.validate_replan(replan_ok)
    for name in ("batch", "skip", "serve", "tuner"):
        obj = json.loads((ROOT / f"BENCH_{name}.json").read_text())
        obj["counts_match"] = False
        with pytest.raises(bench_schema.SchemaError):
            getattr(bench_schema, f"validate_{name}")(obj)


def test_port_validators_refuse_unknown_and_bad_files(tmp_path):
    with pytest.raises(bench_schema.SchemaError):
        bench_schema.validate_file(str(tmp_path / "mystery.json"))
    p = tmp_path / "bench_torch_scan.json"
    p.write_text("{not json")
    with pytest.raises(bench_schema.SchemaError):
        bench_schema.validate_file(str(p))


# ---- the suite's runner (run.py)

def test_run_writes_only_under_artifacts_and_reports_gates(monkeypatch,
                                                           tmp_path,
                                                           capsys):
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path / "artifacts")
    orig = bench_scan.run
    monkeypatch.setattr(bench_scan, "run", lambda **kw: orig(
        **{**kw, "n_records": 2048, "repeats": 1}))
    csv, failed = run.run({"scan"}, quick=True, device="cpu")
    written = json.loads((tmp_path / "artifacts" / "bench_torch_scan.json")
                         .read_text())
    assert written["card"] == "cpu" and written["counts_match"] is True
    assert [r[0] for r in csv] == ["scan_columnar"]
    assert sorted(p.name for p in tmp_path.rglob("*") if p.is_file()) == \
        ["bench_torch_scan.json"]
    # a failed gate is reported and kept, the artifact still written
    bad = dict(written, counts_match=False)
    failed = []
    run._gated("scan", bad, failed)
    assert failed and "counts" in failed[0]
    assert run.main(["--list"]) == 0
    assert "e2e" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run.main(["--only", "bogus"])
