"""Device-resident scan plane vs the host columnar scanner (DESIGN.md §15),
on the port (the JAX package's ``benchmarks/bench_device.py``).

Measures the tentpole replacement: the host ``DataSkippingScanner``
walks segments one at a time (zone-prune, bitvector AND, vectorized
residual per segment, per query), while :class:`DeviceScanner` keeps
every hot segment resident on the card and evaluates the WHOLE query
batch against the WHOLE plane in one launch of kernel B
(``csrc/scan.cu``; ``--device cpu``: its plain version).

Setup reuses ``bench_scan``'s mixed-epoch / mixed-tier ycsb store and
its selective workload (pushed clauses from both epochs, pushed+residual
conjunctions, residual-only clauses, point lookups, no-match probes), so
the two artifacts describe the same population.

The gated ``numpy`` baseline is ``scan_core_numpy`` — the SAME
multi-query plane scan, numpy-vectorized, driven through the same
scanner pipeline (``DeviceScanner`` with ``backend="numpy"``, plane
mirrored to host) — so the speedup isolates what the fused single launch
buys on identical work.  The host ``DataSkippingScanner`` is the
CORRECTNESS oracle and is reported as ``host_skipping`` context.

Claim gates (``bench_schema.validate_device``, the reference's):

  * counts bit-identical to sequential host scans (plus full
    rows_scanned / rows_skipped accounting equality), for BOTH the
    device backend and the numpy reference;
  * ZERO steady-state host->device uploads;
  * fused batched device scan >= 2x the numpy-vectorized reference
    (0.5x quick);
  * a batch of 8 queries >= 3x over the same 8 queries launched
    sequentially (0.8x quick);
  * roofline fraction in (0, 1]: the least time the card could take for
    the launch's work — the bytes it must move, each input once, over the
    H100's 3.35 TB/s (:func:`scan_bytes`, as ``PERF.md`` §6 bounds kernel
    B) — over the measured wrapper call (``scan_counts``: the tables'
    upload, the launch and the counts' copy back, host clock), under the
    reference's roofline keys.  Beside it, ``roofline["analytic"]``
    carries the reference's analytic model of the same launch shape
    (``analysis.flops.scan_estimate`` through ``analysis.roofline.Roofline``
    at the H100's constants).  That model counts the reference's jnp
    path's traffic (every term row's gathered columns and parameters, the
    boolean intermediates), which kernel B does not move, so its time is
    NOT a bound on kernel B and its ``frac`` may exceed 1.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_device [--quick]

Writes ``artifacts/bench_torch_device.json`` with the card's name and
power limit, and exits 1 if ``validate_device`` fails.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analysis.flops import scan_estimate
from repro_torch.analysis.roofline import HBM_BW, Roofline
from repro_torch.benchmarks.bench_scan import _best_of, _build_store, _workload
from repro_torch.benchmarks.common import BACKEND, card, write_artifact
from repro_torch.core.device_scan import DeviceScanner
from repro_torch.core.server import DataSkippingScanner
from repro_torch.kernels import scan_fused

HBM_BYTES_PER_S = HBM_BW        # H100 SXM HBM3 (analysis.roofline)

# the plane columns a term of each kind reads: (column, bytes per row)
_COLUMNS = {scan_fused.KIND_PRESENCE: (("notn", 1),),
            scan_fused.KIND_EXACT: (("scod", 4),),
            scan_fused.KIND_SUBSTRING: (("scod", 4),),
            scan_fused.KIND_KV: (("pres", 1), ("notn", 1), ("isb", 1),
                                 ("numv", 1), ("rcod", 4))}


def scan_bytes(params, n_rows: int) -> int:
    """Bytes kernel B must move for ``params`` over ``n_rows`` resident
    rows: each (key, column) the live terms read once per row, the rows'
    slot ids and pushed bits (8 bytes per row), the parameter tables, and
    the counts and candidate counts written."""
    cells = {(int(k), col) for k, kind in zip(params.key_ids, params.kinds)
             for col in _COLUMNS.get(int(kind), ())}
    Q, S1 = params.pushed_tbl.shape
    return (sum(size for _, (_, size) in cells) * n_rows + 8 * n_rows
            + sum(np.asarray(a).nbytes for a in params) + 2 * Q * S1 * 4)


def _accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned,
            tuple(sorted((k, (g.count, g.rows_scanned, g.rows_skipped))
                         for k, g in r.groups.items())))


def run(n_records: int = 24576, chunk_records: int = 512,
        segment_capacity: int = 8192, repeats: int = 3,
        quick: bool | None = None, device: str = "cuda") -> dict:
    backend = BACKEND[device]
    quick = (n_records <= 8192) if quick is None else quick
    store, fam0, fam1, ranked, recs = _build_store(
        n_records, chunk_records, segment_capacity)
    rng = np.random.default_rng(5)
    queries = _workload(fam0, fam1, ranked, recs, rng)

    host = DataSkippingScanner(store, log_queries=False)
    dev = DeviceScanner(store, backend=backend, log_queries=False)
    npy = DeviceScanner(store, backend="numpy", log_queries=False)

    # warm pass: builds kernel B and uploads the plane.  The store was
    # fully promoted by _build_store, so repeated scans are idempotent
    # and the bit-identical gate can compare steady passes directly.
    dev_results = dev.scan_batch(queries)
    uploads_warm = dev.cache.uploads
    dev_results = dev.scan_batch(queries)
    uploads_steady = dev.cache.uploads - uploads_warm
    npy_results = npy.scan_batch(queries)

    host_results = [host.scan(q) for q in queries]
    counts_match = all(
        _accounting(d) == _accounting(h) == _accounting(n)
        for d, h, n in zip(dev_results, host_results, npy_results))

    host_s = _best_of(lambda: [host.scan(q) for q in queries], repeats)
    numpy_s = _best_of(lambda: npy.scan_batch(queries), repeats)
    device_s = _best_of(lambda: dev.scan_batch(queries), repeats)

    # multi-query fusion: 8 queries in one launch vs 8 single launches.
    # best-of with extra repeats — the two sides are compared against
    # each other, so this ratio is the most noise-sensitive gate
    qs8 = queries[:8]
    dev.scan_batch(qs8)
    for q in qs8:
        dev.scan_batch([q])
    reps8 = max(repeats, 5)
    batch8_s = _best_of(lambda: dev.scan_batch(qs8), reps8)
    seq8_s = _best_of(lambda: [dev.scan_batch([q]) for q in qs8], reps8)

    # roofline: the bytes bound of the EXACT steady launch shape vs the
    # measured wrapper call (parameter prep excluded); the reference's
    # analytic model of that shape beside it
    prep = dev._prepare(queries)
    p = prep.params
    plane = dev.cache.plane
    if p is None or plane is None:
        raise RuntimeError("the workload's batch launched nothing")
    n_rows = int(dev.cache._n_used)
    shape = dict(n_rows=n_rows, n_terms=int(p.kinds.shape[0]),
                 n_clauses=int(p.membership.shape[0]),
                 n_queries=int(p.query_clause.shape[0]),
                 n_slots=int(p.pushed_tbl.shape[1]) - 1)
    nbytes = scan_bytes(p, n_rows)
    launch = lambda: scan_fused.scan_counts(plane, p, backend=backend,
                                            table=prep.table)
    launch()
    launch_s = _best_of(launch, repeats)
    bound_s = nbytes / HBM_BYTES_PER_S
    est = scan_estimate(**shape)
    roof = Roofline(
        arch="h100", shape="x".join(f"{k[2:]}{v}" for k, v in shape.items()),
        mesh="1x1", device_flops=est.flops_global,
        device_bytes=est.hbm_bytes_global, collective_bytes=0.0,
        model_flops_global=est.flops_global, n_devices=1).finalize()
    roofline_frac = bound_s / launch_s

    n_queries = len(queries)
    n_segments = len(store.blocks) + len(store.jit_blocks)

    def side(scan_s: float) -> dict:
        return {
            "scan_s": scan_s,
            "us_per_query": scan_s / n_queries * 1e6,
            "records_per_s": int(n_records * n_queries / scan_s),
        }

    out = {
        "device": device, "card": card(device),
        "quick": bool(quick),
        "backend": backend,
        "interpret": False,
        "n_records": int(n_records),
        "n_segments": int(n_segments),
        "n_queries": n_queries,
        "n_slots": len(dev.cache.slots),
        "numpy": side(numpy_s),
        "host_skipping": side(host_s),
        "device_batched": side(device_s),
        "device_sequential": side(seq8_s / 8 * n_queries),
        "speedup": numpy_s / device_s,
        "batch8_speedup": seq8_s / batch8_s,
        "counts_match": bool(counts_match),
        "uploads_steady": int(uploads_steady),
        "upload_bytes_warm": int(dev.cache.upload_bytes),
        "roofline": {
            # the bound is the bytes one; no operation count is made
            "device_flops": None,
            "device_bytes": nbytes,
            "memory_s": bound_s,
            "step_time_s": bound_s,
            "measured_s": launch_s,
            "dominant": "memory",
            "bytes_per_s": HBM_BYTES_PER_S,
            "shape": shape,
            # the reference's jnp traffic: not a bound on kernel B
            "analytic": {"device_flops": est.flops_global,
                         "device_bytes": est.hbm_bytes_global,
                         "compute_s": roof.compute_s,
                         "memory_s": roof.memory_s,
                         "step_time_s": roof.step_time_s,
                         "dominant": roof.dominant,
                         "frac": roof.step_time_s / launch_s},
        },
        "roofline_frac": roofline_frac,
    }
    print(f"[device] {n_records} records, {n_segments} segments "
          f"({len(dev.cache.slots)} device-resident), {n_queries} queries, "
          f"backend={backend}")
    print(f"[device] numpy reference{numpy_s * 1e3:9.2f} ms/batch; host "
          f"skipping scanner {host_s * 1e3:.2f} ms/batch (context)")
    print(f"[device] device fused   {device_s * 1e3:9.2f} ms/batch "
          f"(x{out['speedup']:.2f}, counts_match={counts_match}, "
          f"steady uploads={uploads_steady})")
    print(f"[device] batch-of-8     {batch8_s * 1e3:9.2f} ms vs sequential "
          f"{seq8_s * 1e3:9.2f} ms (x{out['batch8_speedup']:.2f})")
    print(f"[device] wrapper call {launch_s * 1e6:9.1f} us measured; bytes "
          f"bound {bound_s * 1e6:.2f} us ({nbytes} B at 3.35 TB/s) -> "
          f"roofline_frac {roofline_frac:.4f}; the reference's analytic "
          f"model (jnp traffic, not a bound on kernel B) "
          f"{roof.step_time_s * 1e6:.2f} us ({roof.dominant}: "
          f"{est.flops_global:.3e} FLOP, {est.hbm_bytes_global:.3e} B), "
          f"{roof.step_time_s / launch_s:.4f}")
    return out


if __name__ == "__main__":
    from repro_torch.benchmarks.bench_schema import validate_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    out = run(n_records=6144 if args.quick else 24576,
              repeats=2 if args.quick else 3, quick=args.quick,
              device=args.device)
    print(f"wrote {write_artifact('device', out)}")
    validate_device(out)
