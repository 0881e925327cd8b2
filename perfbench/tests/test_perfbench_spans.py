"""The program's spans beside the trace: the attribution of device time,
idle gaps and launches to span paths on synthetic traces, and a tiny
traced run of each cell through ``perfbench.spans`` on the CPU, which
gives every metric that reads the program's spans a value."""
import json
import time

import pytest
import torch

from perfbench import run as run_mod, spans as spans_mod
from perfbench.harness import bench, program_trace as pt
from perfbench.tests import tiny

MAIN, AUTOGRAD, PREFETCH = 1, 2, 3


def S(name, t0, t1, parent=-1, thread=MAIN):
    from repro_torch.tracing import Span
    return Span(name, t0, t1, parent, thread)


def test_a_kernel_goes_to_the_span_that_launched_it_however_late_it_runs():
    spans = [S("serve.decode", 0, 100), S("layer", 10, 50, 0),
             S("layer.attention", 20, 30, 1)]
    # launched at 25 inside the attention span, run at 60-90 after it closed
    a = pt.attribute([(25, 60, 90), (40, 90, 95)], spans, (0, 100))
    assert a.device_s == pytest.approx({"serve.decode/layer/layer.attention": 30e-9,
                                        "serve.decode/layer": 5e-9})
    assert a.kernels == {"serve.decode/layer/layer.attention": 1, "serve.decode/layer": 1}


def test_a_launch_from_a_second_thread_goes_under_the_enclosing_span():
    spans = [S("train.step", 0, 200), S("train.backward", 10, 190, 0),
             S("layer", 20, 80, thread=AUTOGRAD),
             S("layer.attention", 30, 40, 2, thread=AUTOGRAD),
             S("attention.backward", 100, 150, thread=AUTOGRAD)]
    a = pt.attribute([(35, 35, 45), (60, 60, 70), (120, 120, 140), (160, 160, 170)],
                     spans, (0, 200))
    assert a.device_s == pytest.approx({
        "train.step/train.backward/layer/layer.attention": 10e-9,
        "train.step/train.backward/layer": 10e-9,
        "train.step/train.backward/attention.backward": 20e-9,
        "train.step/train.backward": 10e-9})
    assert pt.Attribution.through(a.device_s, "attention.backward") == pytest.approx(20e-9)
    assert pt.Attribution.under(a.device_s, "train.step/train.backward/layer") == \
        pytest.approx(20e-9)


def test_data_spans_own_nothing_and_take_no_parent():
    spans = [S("train.forward", 0, 100), S("data.batch", 10, 90, thread=PREFETCH)]
    a = pt.attribute([(50, 50, 60), (95, 95, 98), (120, 120, 130)], spans, (0, 200))
    assert a.device_s == pytest.approx({"train.forward": 13e-9, pt.NO_SPAN: 10e-9})


def test_gaps_go_to_the_span_open_at_their_middle():
    spans = [S("serve.prefill", 0, 40), S("serve.decode", 50, 100),
             S("layer", 60, 70, 1)]
    # busy 0-10, 30-35, 62-64, 90-100: gaps 10-30 (mid 20, prefill), 35-62
    # (mid 48, no span), 64-90 (mid 77, decode)
    a = pt.attribute([(0, 0, 10), (20, 30, 35), (61, 62, 64), (80, 90, 100)],
                     spans, (0, 100))
    assert a.idle_s == pytest.approx({"serve.prefill": 20e-9, pt.NO_SPAN: 27e-9,
                                      "serve.decode": 26e-9})
    assert pt.Attribution.under(a.idle_s, "serve.decode") == pytest.approx(26e-9)
    assert pt.gaps([(0, 10), (5, 20)], (0, 30)) == [(20, 30)]


def test_busy_inside_the_benchmarks_spans_counts_the_union_once():
    kernels = [(0, 0, 10), (0, 5, 15), (0, 30, 40)]
    items = [("decode", 0, 12), ("decode", 35, 50), ("batch_wait", 12, 35)]
    assert pt.busy_inside(kernels, items, ("decode",)) == pytest.approx(17e-9)


CELLS = ["qwen3-longdoc", "qwen3-train"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_programs_spans(name):
    c = tiny.cell(name)
    r = spans_mod.run_cell(c, 9, 0.5, True, torch.device("cpu"), time.monotonic_ns())
    out = run_mod.result_line(c, r, True, "cpu", 1)
    assert out["correct"] is True, out["check"]
    report = spans_mod.program_report(c, r, True)
    new = spans_mod.PROGRAM_METRICS[c["traffic"]["kind"]]
    assert set(new) <= set(report["metrics"])
    for m in new:
        assert report["metrics"][m] >= 0
    assert report["spans"] > 0 and report["coverage"]["program_device_s"] > 0
    p = r.program.attribution
    if name == "qwen3-longdoc":
        steps = sum(len(q["decode_s"]) for q in r.requests)
        assert steps and report["metrics"]["decode_kernels_per_step.serve"] > 0
        assert report["metrics"]["decode_attn_ms_per_step.serve"] > 0
        assert report["coverage"]["bench_decode_idle_s"] >= 0
        assert any(k.startswith("serve.decode/layer/layer.ffn") for k in p.device_s)
    else:
        assert 0 <= report["metrics"]["batch_skip_pct.train"] < 100
        assert report["metrics"]["batch_make_ms.train"] > 0
        assert report["recipe_rows"]["rows_scanned"] > 0
        assert report["metrics"]["batch_skip_pct.train"] == pytest.approx(
            100 * report["recipe_rows"]["row_skip_fraction"])
        assert any(k.startswith("train.backward") for k in p.device_s)
    json.dumps(report)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_with_the_recorder_records_spans_and_no_attribution(name):
    c = tiny.cell(name)
    r = spans_mod.run_cell(c, 10, 0.3, False, torch.device("cpu"), time.monotonic_ns())
    assert r.trace is None and r.program.attribution is None and r.program.spans
    report = spans_mod.program_report(c, r, False)
    assert "coverage" not in report
    if name == "qwen3-train":
        assert report["metrics"]["batch_make_ms.train"] > 0


def test_the_new_readers_read_nothing_from_the_benchmarks_own_run():
    """The benchmark's own run (no recorder) carries no program spans: the
    readers return nothing and do not raise."""
    r = tiny.run("qwen3-train", seed=12, seconds=0.3)
    for m in spans_mod.PROGRAM_METRICS["train_ciao"]:
        assert bench.metric_reader(m)(r) is None
    assert not hasattr(r, "program")
