"""Run one cell of the benchmark with the program's span recorder on, and
print its result line with what the program's spans read.

    python3 -m perfbench.spans --workload qwen3-longdoc --seed 7 --seconds 30 --trace 1

From the root of a checkout, as ``perfbench.run``: the same harness, set-up,
window and check, with the harness's tracer replaced by
:class:`~perfbench.harness.program_trace.ProgramTracer` (and, in a
training cell, the store kept for its recipe counts), so the program's
spans are recorded in the window.  The last line of standard output is
``perfbench.run``'s result line with ``program`` added: every per-layer
metric of the cell and the readers of the program's spans
(:data:`PROGRAM_METRICS`) that read something; with ``--trace 1``,
``coverage`` (device seconds put down to program spans against the busy
seconds inside the benchmark's own step spans; decode's idle time against
``idle_gaps``' ``decode`` entry) and ``clock`` (the profiler's clock less
the monotonic one and its drift over the window; the marker's launch and
start after the tracer's ``marker_ns``, and the device clock's skew), and
``breakdown`` gains ``program_device`` and ``program_idle``: the top 10
``[span path, s]``.  With ``--trace 0`` the recorder's cost is the
difference from ``perfbench.run --trace 0``, which runs the cell with the
recorder off.
"""
from __future__ import annotations

import argparse
import json
import sys

from perfbench import run as run_mod

#: the per-layer metrics that read the program's own spans and counts, by
#: the kind of a cell's traffic
PROGRAM_METRICS = {
    "serve_closed_loop": ("decode_attn_ms_per_step.serve", "decode_idle_ms_per_step.serve",
                          "decode_kernels_per_step.serve"),
    "train_ciao": ("attn_bwd_ms_per_step.train", "batch_make_ms.train",
                   "batch_skip_pct.train"),
}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, dev,
             t0_ns: int, *, device_name: str = ""):
    """The harness's run of ``cell``, with ``run.program`` holding the
    program's spans and what they read."""
    from perfbench.harness import program_trace, serve, train
    runner = {"serve_closed_loop": serve, "train_ciao": train}[cell["traffic"]["kind"]]
    tracers, stores = [], []

    class Tracer(program_trace.ProgramTracer):
        def __init__(self, enabled, device):
            super().__init__(enabled, device, lambda: stores[-1] if stores else None)
            tracers.append(self)

    def load_store(tr, seed_):
        out = load(tr, seed_)
        stores.append(out[0])
        return out

    saved, load = runner.Tracer, getattr(runner, "load_store", None)
    runner.Tracer = Tracer
    if load is not None:
        runner.load_store = load_store
    try:
        r = runner.run(cell, seed, seconds, trace, dev, t0_ns, device_name=device_name)
    finally:
        runner.Tracer = saved
        if load is not None:
            runner.load_store = load
    r.program = tracers[-1].program
    return r


def program_report(cell: dict, r, trace: bool) -> dict:
    """``program``'s keys, and the two breakdown entries, of a finished
    run (module docstring)."""
    from perfbench.harness import bench
    from perfbench.harness.program_trace import NO_SPAN, Attribution
    metrics = {}
    names = [m["name"] for m in cell["per_layer"]]
    for m in names + list(PROGRAM_METRICS[cell["traffic"]["kind"]]):
        value = bench.metric_reader(m)(r)
        if value is not None:
            metrics[m] = value
    out = {"metrics": metrics}
    p = getattr(r, "program", None)
    if p is None:
        return out
    out["spans"] = len(p.spans)
    if p.rows is not None:
        out["recipe_rows"] = p.rows
    a = p.attribution
    if not trace or a is None:
        return out
    placed = sum(s for k, s in a.device_s.items() if k != NO_SPAN)
    out["coverage"] = {"program_device_s": placed, "bench_busy_s": p.bench_busy_s,
                       "device_share": placed / p.bench_busy_s if p.bench_busy_s else None}
    if "decode" in r.trace.idle_by_span:
        idle = Attribution.under(a.idle_s, "serve.decode")
        bench_idle = r.trace.idle_by_span["decode"]
        out["coverage"].update(decode_idle_s=idle, bench_decode_idle_s=bench_idle,
                               decode_idle_share=idle / bench_idle if bench_idle else None)
    out["clock"] = {"offset_ns": p.clock_offset_ns[0],
                    "drift_ns": p.clock_offset_ns[1] - p.clock_offset_ns[0], **p.clock}
    return out


def _top(table: dict) -> list:
    return [[k, s] for k, s in sorted(table.items(), key=lambda kv: -kv[1])[:10]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    run_mod._setup_environment()

    import torch

    from perfbench.harness import bench

    cell = bench.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available():
        run_mod._fail("no CUDA card: the benchmark measures the program on the card only")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    from repro_torch.kernels import cuda_build
    build_s = cuda_build.build(["flash_attention"])
    trace = bool(args.trace)
    r = run_cell(cell, args.seed, args.seconds, trace, dev, run_mod.T0_NS,
                 device_name=name)
    bad = run_mod.forbidden_modules()
    if bad:
        run_mod._fail(f"modules {bad} were loaded in this process", 3)
    result = run_mod.result_line(cell, r, trace, name, chips)
    result["device"]["card_and_power_limit"] = run_mod._power_limit()
    result["build_s"] = build_s
    result["program"] = program_report(cell, r, trace)
    p = getattr(r, "program", None)
    if trace and p is not None and p.attribution is not None:
        result["breakdown"]["program_device"] = _top(p.attribution.device_s)
        result["breakdown"]["program_idle"] = _top(p.attribution.idle_s)
    result["check"] = result.pop("check")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
