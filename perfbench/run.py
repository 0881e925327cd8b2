"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds the program (``src/repro_torch``),
on a machine with as many CUDA cards as the cell asks for.  Set-up, then a
window of ``--seconds``, then the check against the plain reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which also close standard error.  ``build_s`` records apart the seconds
set-up spent building kernel F (0 where an earlier run built it).  No
card, too few cards, or JAX (or the JAX package) loaded in this process
by the end: an error and no result.
"""
from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return max(0.0, float(f.read().split()[0]) - start)
    except (OSError, ValueError, IndexError):
        return 0.0


T0_NS = time.monotonic_ns() - int(_process_age_s() * 1e9)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (by default the loaded modules)
    that are JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _setup_environment() -> None:
    """Program caches inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "perfbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        _fail(f"no program under {src}: run from the root of a checkout of the repository")
    sys.path.insert(0, str(src))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def judged(cell: dict, check: dict, side: str = "") -> dict:
    """Each number compared, its reading beside its limit: the program's,
    or with ``side=".control"`` the control's in the program's place."""
    return {number: {"value": check[number + side], "limit": spec["limit"]}
            for number, spec in cell["limits"]["numbers"].items()}


def result_line(cell: dict, run, trace: bool, name: str, chips: int,
                side: str = "") -> dict:
    """The result's keys from a finished run, ``check`` last; ``side`` as
    in :func:`judged`."""
    from perfbench.harness import bench

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = bench.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": name, "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": None, "attempted": len(run.requests) or len(run.steps),
              "failed": 0, "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    check = judged(cell, run.check, side)
    result["correct"] = all(c["value"] <= c["limit"] for c in check.values())
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_environment()

    import torch

    from perfbench.harness import bench, serve, train
    from perfbench.harness.runs import log

    cell = bench.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available():
        _fail("no CUDA card: the benchmark measures the program on the card only")
    if torch.cuda.device_count() < chips:
        _fail(f"{args.workload} needs {chips} cards, this machine has "
              f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    from repro_torch.kernels import cuda_build
    build_s = cuda_build.build(["flash_attention"])    # 0 where built before
    log(f"kernel F's build: {build_s:.3f} s")
    driver = {"serve_closed_loop": serve, "train_ciao": train}[cell["traffic"]["kind"]]
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), dev, T0_NS,
                     device_name=name)

    bad = forbidden_modules()
    if bad:
        _fail(f"modules {bad} were loaded in this process", 3)

    result = result_line(cell, run, bool(args.trace), name, chips)
    result["device"]["card_and_power_limit"] = _power_limit()
    result["build_s"] = build_s
    result["check"] = result.pop("check")
    log(f"setup_s {run.setup_s:.3f} (kernel F's build {build_s:.3f}), "
        f"window {run.window_s:.3f} s")
    for number, c in result["check"].items():
        print(f"check {number} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
