"""``chip_smoke.py`` with the profiler lost on purpose.

:func:`repro_torch.benchmarks.bench_reduce.trace` takes the profiler as
lost when every trace of a call records no device activity at all.  Then
kernel times come from CUDA events, and device-operation counts and
breakdowns read "not measured".  This probe shows that those routes run.
First it times kernel C's empty kernel through the profiler.  Then it
makes every trace record the CPU alone, so that no trace records device
activity, and runs ``chip_smoke.py``'s ``reduce_numbers``,
``flash_timing`` and ``serve_breakdown``.  Each must finish.  Last, it
restores the profiler and times the empty kernel again.

Needs a checkout (it imports ``chip_smoke.py`` from the repository's
root) and a CUDA card:

    python3 src/repro_torch/benchmarks/profiler_loss.py

Prints one JSON object.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def run() -> dict:
    import torch
    import torch.profiler as tp

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.benchmarks import bench_reduce as br
    from repro_torch.benchmarks.bench_train import _card
    from repro_torch.kernels import bitvector_ops

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cs.build()

    def noop() -> None:
        bitvector_ops.noop(dev)

    before = cs.kernel_ms(noop, 200, "noop_kernel")
    real = tp.profile
    tp.profile = lambda activities, **kw: real(
        activities=[tp.ProfilerActivity.CPU], **kw)
    try:
        reduce = cs.reduce_numbers(dev)
        flash = cs.flash_timing(dev)
        serve = cs.serve_breakdown(dev)
    finally:
        tp.profile = real
    after = cs.kernel_ms(noop, 200, "noop_kernel")
    shape = reduce["shapes"]["P=2 W=256"]
    return {
        "card": _card(), "device": torch.cuda.get_device_name(0),
        "noop_ms_profiler": before, "noop_ms_lost": reduce["floor_ms"],
        "noop_ms_restored": after,
        "reduce_kernel_ms_lost": shape["kernel_ms"],
        "reduce_ops_lost": [shape["kernel_call_ops"], shape["call_ops"]],
        "probe_ms_lost": reduce["probe"]["ms"],
        "probe_ms_from": reduce["probe"]["ms_from"],
        "flash_ms_lost": flash["ms"],
        "serve_breakdown_lost": serve,
        "lost": br.lost, "missed": br.missed,
        "seconds": time.perf_counter() - t0,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_loss: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
