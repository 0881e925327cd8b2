"""Read the numbers that decide ``correct``, over many seeds in one process.

    python3 -m perfbench.calibrate --workload qwen3-longdoc --seconds 8 \\
        --seeds 101-112 --control 101-103 --out chiprun_out/calib.jsonl

For each seed: one run of the cell's driver with a short window (its own
load, its own sizes), then the check; on the ``--control`` seeds also the
control (the plain reference rounded to fp8 in the program's place), and
with ``--fault`` a run with that fault planted under the timed path
(:mod:`perfbench.faults`).  One JSON line a run goes to ``--out`` as it
ends.  The limits in ``perfbench/limits`` are set from these readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench import faults, run as run_mod
    from perfbench.harness import bench, runs, serve, train

    cell = bench.cell(args.workload)
    serving = cell["traffic"]["kind"] == "serve_closed_loop"
    driver = serve if serving else train
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    control = set(_seeds(args.control))
    plan = [(s, None) for s in _seeds(args.seeds)]
    plan += [(s, args.fault) for s in _seeds(args.fault_seeds)]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed, fault in plan:
        kw = {}
        if fault:
            kw["make_fns" if serving else "make_step"] = (
                faults.SERVE if serving else faults.TRAIN)[fault]
        t0 = time.monotonic_ns()
        torch.cuda.reset_peak_memory_stats(dev)
        run = driver.run(cell, seed, args.seconds, False, dev, t0, device_name=name,
                         control=seed in control and not fault, **kw)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "check": run.check, "setup_s": run.setup_s, "window_s": run.window_s,
                "done": len(run.requests) or len(run.steps),
                "correct": run_mod.result_line(cell, run, False, name, 1)["correct"],
                "memory_peak_bytes": run.memory_peak_bytes,
                "seconds_all": (time.monotonic_ns() - t0) / 1e9}
        if seed in control and not fault:
            line["control_correct"] = run_mod.result_line(
                cell, run, False, name, 1, side=".control")["correct"]
        runs.log(json.dumps(line))
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        del run
        runs.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
