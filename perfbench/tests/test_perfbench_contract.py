"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
leads to the files the harness reads."""
import json
import re

import pytest

from perfbench.harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench.benchmark()


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"][:3] == ["python3", "-m", "perfbench.run"]
    assert B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    names = [e["name"] for e in B[section]]
    assert len(set(names)) == len(names)
    for e in B[section]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "per_layer":
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert e["moves"] in {m["name"] for m in B["end_to_end"]}


def test_every_cell_finds_its_files_and_reports_enough():
    for w in B["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        c = bench.cell(w["name"])
        e2e = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c["per_layer"]
        for m in c["end_to_end"] + c["per_layer"]:
            assert callable(bench.metric_reader(m["name"]))
        for m in c["per_layer"]:
            assert m["moves"] in e2e
        assert c["limits"]["numbers"]


def test_configs_state_their_cuts():
    for conf in B["configs"]:
        assert conf["file"].startswith("perfbench/configs/")
        data = json.loads((bench.ROOT / conf["file"]).read_text())
        assert data["reduced"] == conf["reduced"]
        for k in conf["reduced"]:
            assert NAME.match(k) and k in data
            assert not k.endswith(("_dim", "_rank", "_size", "_tok"))
            assert k not in ("hidden_size", "intermediate_size", "moe_intermediate_size")
