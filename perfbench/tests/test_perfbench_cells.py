"""A whole run of each cell, cut to a tiny size on the CPU: sound, it comes
out correct; with a fault planted under its timed path, or with the
control (the plain reference rounded to fp8) in the program's place, it
does not."""
import json

import pytest
import torch

from perfbench import faults, run as run_mod
from perfbench.harness import bench
from perfbench.tests import tiny

CELLS = ["qwen3-longdoc", "qwen3-train"]
SERVING = "qwen3-longdoc"


def _result(name, r, trace=False, side=""):
    return run_mod.result_line(tiny.cell(name), r, trace, "cpu", 1, side=side)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(name):
    r = tiny.run(name, seed=2**31 + 11)
    out = _result(name, r)
    assert out["correct"] is True, out["check"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {m["name"] for m in bench.cell(name)["end_to_end"]}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


@pytest.mark.parametrize("name,fault", [(SERVING, "altered_token"),
                                        (SERVING, "stale_cache"),
                                        ("qwen3-train", "half_batch"),
                                        ("qwen3-train", "unchanged")])
def test_fault_under_the_timed_path_is_not_correct(name, fault):
    kw = ({"make_fns": faults.SERVE[fault]} if name == SERVING
          else {"make_step": faults.TRAIN[fault]})
    out = _result(name, tiny.run(name, seed=5, **kw))
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place_is_not_correct(name):
    r = tiny.run(name, seed=6, control=True)
    assert _result(name, r)["correct"] is True
    out = _result(name, r, side=".control")
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_per_layer_metrics(name):
    from perfbench.harness import serve, train
    c = tiny.cell(name)
    driver = serve if name == SERVING else train
    import time
    r = driver.run(c, 9, 0.5, True, torch.device("cpu"), time.monotonic_ns())
    out = _result(name, r, trace=True)
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    idle = "idle_pct.serve" if name == SERVING else "idle_pct.train"
    assert 0 <= out["metrics"][idle]["value"] <= 100
    for key in ("device_ops", "idle_gaps"):
        assert 0 < len(out["breakdown"][key]) <= 10


@pytest.mark.perfbench_card
def test_control_fails_at_the_cells_own_size_on_the_card(card):
    import time
    from perfbench.harness import serve
    c = bench.cell(SERVING)
    name = torch.cuda.get_device_name(0)
    r = serve.run(c, 31, 8.0, False, card, time.monotonic_ns(), device_name=name,
                  control=True)
    assert run_mod.result_line(c, r, False, name, 1)["correct"] is True
    out = run_mod.result_line(c, r, False, name, 1, side=".control")
    assert out["correct"] is False, out["check"]
