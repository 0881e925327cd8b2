"""Kernel C (bitvector AND/OR/popcount) around its launches, on one card.

Measures the ``repro_torch`` package on the import path through the two
calls every version of kernel C has had, ``bitvector_ops.bitvector_reduce``
and ``ops.reduce_bitvectors``, so that two trees can be measured in turns
on one card:

* the kernel's device time (profiler) at the split path's shapes: P=2,
  W=256 (phase (b) and the scanner's AND-reduce hook) and P=12, W=256
  (phase (a));
* the whole ``ops.reduce_bitvectors`` call on the host clock, numpy in
  and numpy out;
* the device operations (kernels, copies, memsets) of one call of each;
* a bytes-bound probe, P=12, W=2,097,152 (not a path shape: 100.7 MB
  read and 16.8 MB written, twice the card's L2), beside its bound.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_reduce
    PYTHONPATH=<other tree>/src python src/repro_torch/benchmarks/bench_reduce.py

It prints one JSON object.  Needs a CUDA card.  ``chip_smoke.py`` runs
:func:`measure` on its own tree and holds the design on the result; its
other kernels' device times come from :func:`kernel_ms` too.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np
import torch

SHAPES = ((2, 256), (12, 256))
PROBE = (12, 2_097_152)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
#: every launch of kernel C, in each version, has this in its name
MARK = "bitvector"
KINDS = ("kernels", "copies_to_device", "copies_to_host", "copies_other",
         "memsets")


#: idle host time inside each trace before the first launch and after
#: the last synchronise: launched right after the profiler starts, or
#: traced right up to its stop, kernels now and then go unrecorded (a
#: trace loses its first or last one, or all of them), and this margin
#: removed that in ``profiler_sessions.py``
PAD_S = 0.25
#: traces in a row that may miss the kernel asked for before
#: :func:`device_activity` raises, each a second after the last
TRACES = 5
#: traces that recorded no launch of the kernel asked for, by its mark
missed: dict[str, int] = {}


def device_activity(fn, reps: int, mark: str = "") -> dict:
    """Every device activity the profiler records in ``reps`` calls of
    ``fn`` (kernels, copies, memsets), per call: {name: (count, device
    ms)}.  A trace that records none whose name holds ``mark`` is counted
    in :data:`missed` and taken again a second later; after
    :data:`TRACES` such traces in a row it raises, naming what the last
    one did record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACES):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        rows = {e.key: (e.count / reps, e.device_time_total / reps / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count}
        if any(mark in k and ms > 0 for k, (_, ms) in rows.items()):
            return rows
        missed[mark] = missed.get(mark, 0) + 1
    raise AssertionError(
        f"the profiler found no {mark or 'device activity'} in {TRACES} "
        f"traces; the last recorded {len(rows)} device activities: "
        f"{dict(list(rows.items())[:6])}")


def kernel_ms(fn, reps: int, name: str) -> float:
    """Device milliseconds per launch of the kernel ``name`` inside ``fn``,
    from the profiler's CUDA activity (kernel time alone)."""
    return next(ms / n for k, (n, ms) in
                device_activity(fn, reps, name).items() if name in k)


def device_ops(fn, traces: int = 5) -> dict:
    """The device operations of one call of ``fn``, by kind (:data:`KINDS`),
    with ``rows`` naming each: the fullest of ``traces`` traces of one
    call (the profiler now and then drops a record, never adds one)."""
    best = None
    for _ in range(traces):
        got, rows = dict.fromkeys(KINDS, 0), {}
        for name, (count, _) in device_activity(fn, 1).items():
            kind = ("copies_to_device" if name.startswith("Memcpy HtoD") else
                    "copies_to_host" if name.startswith("Memcpy DtoH") else
                    "copies_other" if name.startswith("Memcpy") else
                    "memsets" if name.startswith("Memset") else "kernels")
            got[kind] += int(count)
            rows[name] = int(count)
        got["rows"] = rows
        if best is None or sum(got[k] for k in KINDS) > \
                sum(best[k] for k in KINDS):
            best = got
    return best


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn`` (results on the host)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def measure(dev: torch.device, seed: int = 20240611) -> dict:
    """C's kernel time, call time and device operations per call at
    :data:`SHAPES`, and the probe's time beside its bytes bound."""
    from repro_torch.kernels import bitvector_ops, ops

    rng = np.random.default_rng(seed)
    out = {"shapes": {}}
    for P, W in SHAPES:
        host = rng.integers(0, 2**32, (P, W), dtype=np.uint32)
        t = torch.from_numpy(host).to(dev)
        kern = functools.partial(bitvector_ops.bitvector_reduce, t)
        call = functools.partial(ops.reduce_bitvectors, host)
        out["shapes"][f"P={P} W={W}"] = {
            "kernel_ms": kernel_ms(kern, 200, MARK),
            "call_ms": host_ms(call, 500),
            "kernel_call_ops": device_ops(kern),
            "call_ops": device_ops(call)}
    P, W = PROBE
    t = torch.from_numpy(rng.integers(0, 2**32, (P, W),
                                      dtype=np.uint32)).to(dev)
    # per launch of each kernel (a call launches each once), so a record
    # the profiler drops moves no time
    per_launch = {k: ms / n for k, (n, ms) in device_activity(
        lambda: bitvector_ops.bitvector_reduce(t), 20, MARK).items()}
    ms = sum(v for k, v in per_launch.items() if MARK in k)
    bound = (P * W * 4 + 2 * W * 4 + 4) / HBM_BYTES_PER_S * 1e3
    out["probe"] = {"shape": f"P={P} W={W}", "ms": ms, "bound_ms": bound,
                    "bound_by": "bytes", "bound_share": bound / ms,
                    "device_ms_per_launch": per_launch}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_reduce: needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    res = measure(torch.device("cuda", 0))
    print(json.dumps({"repro_torch": os.path.dirname(repro_torch.__file__),
                      "device": torch.cuda.get_device_name(0), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
