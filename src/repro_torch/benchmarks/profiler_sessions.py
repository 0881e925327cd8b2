"""How reliably ``torch.profiler`` records kernels over many short traces.

``chip_smoke.py`` takes some hundred profiler traces in one process
(each kernel timing, the device operations of kernel C's calls, the serve
path's breakdown).  This probe takes ``--sessions`` traces in a row, as
:func:`repro_torch.benchmarks.bench_reduce.device_activity` takes them:
each one around :data:`REPS` launches of kernel C's empty launch-floor
kernel (``bitvector_ops.noop``), every tenth one also around 2,000
small PyTorch operations traced with the CPU (as the serve path's
breakdown is), and between traces :data:`THREADS` threads launch the
empty kernel too (the store phases launch from reader threads).  With
``--pad-ms``, each trace idles that long before its first launch and
after its last synchronise.  It counts the traces that recorded every
launch and lists the others: (trace, launches recorded, device
activities recorded, launch calls recorded on the host).  For each
trace that recorded both, the lag from the first launch call (host
clock) to the first kernel's start (device clock, as the profiler
converts it) is a few µs when the two clocks agree; its median, least
and largest over each tenth of the traces show whether they drift apart
as the process ages.

PyTorch's profiler tears CUPTI down after every trace unless
``TEARDOWN_CUPTI=0`` (it sets that itself only where CUDA graphs are
used); ``--teardown 0`` sets it before the first trace, ``--teardown 1``
leaves the default.  Run one process per setting:

    PYTHONPATH=src python -m repro_torch.benchmarks.profiler_sessions \\
        --teardown 1 --pad-ms 0
    PYTHONPATH=src python -m repro_torch.benchmarks.profiler_sessions \\
        --teardown 0 --pad-ms 0
    PYTHONPATH=src python -m repro_torch.benchmarks.profiler_sessions \\
        --pad-ms 250                        # bench_reduce.PAD_S

Prints one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

#: launches of the empty kernel in each trace
REPS = 10
#: threads that launch it between traces
THREADS = 4


def lag_tenths(lags, sessions: int) -> list:
    """[median, least, largest] lag (µs) over each tenth of the traces."""
    import numpy as np
    out = []
    for k in range(10):
        got = [lag for i, lag in lags
               if k * sessions // 10 <= i < (k + 1) * sessions // 10]
        out.append([float(np.median(got)), float(min(got)), float(max(got))]
                   if got else None)
    return out


def run(sessions: int, pad_s: float) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bitvector_ops

    dev = torch.device("cuda", 0)
    bitvector_ops.noop(dev)
    x = torch.zeros(64, device=dev)
    torch.cuda.synchronize()

    def launch(n: int) -> None:
        for _ in range(n):
            bitvector_ops.noop(dev)
        torch.cuda.synchronize()

    recorded, missed, heavy, lags = 0, [], 0, []
    t0 = time.perf_counter()
    for i in range(sessions):
        acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if i % 10 == 9
                else [ProfilerActivity.CUDA])
        with profile(activities=acts) as prof:
            time.sleep(pad_s)
            launch(REPS)
            if i % 10 == 9:
                for _ in range(1000):
                    x.add_(1.0)
                    x.mul_(0.5)
                torch.cuda.synchronize()
            time.sleep(pad_s)
        events = prof.events()
        starts = [e.time_range.start for e in events
                  if e.device_type == DeviceType.CUDA and "noop" in e.name]
        calls = [e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU
                 and "LaunchKernel" in e.name]
        if starts and calls:
            lags.append((i, min(starts) - min(calls)))
        heavy += i % 10 == 9
        if len(starts) >= REPS:
            recorded += 1
        else:
            missed.append((i, len(starts), sum(
                1 for e in events if e.device_type == DeviceType.CUDA),
                len(calls)))
        pool = [threading.Thread(target=launch, args=(REPS,))
                for _ in range(THREADS)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    return {"teardown_cupti": os.environ.get("TEARDOWN_CUPTI", "unset"),
            "sessions": sessions, "heavy_sessions": heavy,
            "reps": REPS, "threads": THREADS, "pad_ms": pad_s * 1e3,
            "recorded": recorded, "missed": missed,
            "lag_us_by_tenth": lag_tenths(lags, sessions),
            "seconds": time.perf_counter() - t0,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--teardown", choices=("0", "1"), default="1")
    ap.add_argument("--pad-ms", type=float, default=0.0,
                    help="idle host time inside each trace before the "
                         "first launch and after the last synchronise")
    ap.add_argument("--sessions", type=int, default=400)
    args = ap.parse_args(argv)
    if args.teardown == "0":
        os.environ["TEARDOWN_CUPTI"] = "0"
    print(json.dumps(run(args.sessions, args.pad_ms / 1e3)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
