#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds both hand-written kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the paper's
loop at full size through the port's entry points:

  ycsb records (1,048,576, in 128 chunks of 8,192)
    -> build_plan at 1.0 us/record (200-query zipf(1.5) workload)
    -> KernelEngine("cuda") pushdown             [kernel A, csrc/pushdown.cu]
    -> CiaoStore partial load
    -> DeviceScanner("cuda") in batches of 64     [kernel B, csrc/scan.cu]

Every ScanResult is checked against the host DataSkippingScanner on the
same store, and a 65,536-record prefix against FullScanBaseline.  Any
mismatch or fault raises (exit code != 0).

    python3 chip_smoke.py                  # one CUDA card, full size
    python3 chip_smoke.py --records 65536  # a shorter rehearsal

Output: phase lines, then the card's name and power limit
(``nvidia-smi``), a JSON kernel table, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
CHUNK = 8192
SEED = 20240611
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)


def _records_part(args):
    """One chunk's records, generated in a worker from its own seed."""
    src, dataset, n, seed = args
    sys.path.insert(0, src)
    from repro_torch.data.datasets import generate_records
    return generate_records(dataset, n, seed=seed)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, reps: int, name: str) -> tuple[float, str]:
    """Device milliseconds per launch of the kernel ``name`` inside ``fn``.

    Read from the profiler's CUDA activity (kernel time alone); where the
    profiler records no device time for it, CUDA events around the whole
    call are used instead, and the second value says which.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total / e.count for e in prof.key_averages()
          if name in e.key and e.count]
    if us and us[0] > 0:
        return us[0] / 1e3, "profiler"
    return cuda_ms(fn, reps), "events"


def same_bits(a, b) -> int:
    """Max |difference| of two integer tensors compared bit for bit."""
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def accounting(r) -> tuple:
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.used_skipping,
            tuple(sorted((k, (g.count, g.rows_scanned, g.rows_skipped,
                              g.raw_parsed, g.segments_pruned))
                         for k, g in r.groups.items())))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def environment() -> str:
    import torch
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    from repro_torch.kernels import cuda_build
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}  ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)")
    return card


def build() -> None:
    from repro_torch.kernels import cuda_build
    secs = cuda_build.build()
    print(f"built {sorted(cuda_build.SOURCES.values())} in {secs:.2f} s "
          f"(one nvcc per source, in parallel)")
    for name, log in sorted(cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


def check_pushdown(dev) -> int:
    """Kernel A against its plain version: plan families and edge cases."""
    import numpy as np
    import torch
    from repro_torch.core.client import encode_chunk
    from repro_torch.core.planner import build_plan_family
    from repro_torch.core.predicates import (
        clause, exact, key_value, presence, substring,
    )
    from repro_torch.core.workload import generate_workload
    from repro_torch.data.datasets import generate_records, predicate_pool
    from repro_torch.kernels import fused, ops, ref
    from repro_torch.kernels.plan import compile_plan, tier_view

    def compare(data_np, plan, n_valid=None) -> int:
        data = torch.from_numpy(np.ascontiguousarray(data_np)).to(dev)
        R = data.shape[0]
        n_valid = R if n_valid is None else n_valid
        flat = ops.plan_tensors(plan, ops.FLAT_FIELDS, dev)
        uniq = ops.plan_tensors(plan, ops.UNIQUE_FIELDS, dev)
        got = fused.clause_bitvectors_fused(data, flat, n_valid,
                                            n_simple=plan.n_simple)
        want = ref.clause_bitvectors_ref(
            data, uniq["ukeys"], uniq["uklens"], uniq["uvals"],
            uniq["uvlens"], uniq["uunb"], uniq["key_ids"], uniq["val_ids"],
            uniq["membership"], n_valid, n_simple=plan.n_simple)
        err = max(same_bits(g, w) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"pushdown kernel != plain version "
                                 f"(R={R}, L={data.shape[1]}, "
                                 f"C={plan.n_clauses}, P={plan.n_preds})")
        return err

    n_checks = 0
    for ds in ("ycsb", "yelp", "winlog"):
        recs = generate_records(ds, 1000, seed=11)
        pool = predicate_pool(ds)
        wl = generate_workload(pool, n_queries=200, distribution="zipf",
                               zipf_a=1.5, rng=np.random.default_rng(0))
        fam = build_plan_family(wl, recs[:500],
                                tier_budgets_us=[0.25, 1.0, 4.0]).family
        full = compile_plan(tuple(fam.plan.clauses))
        data = encode_chunk(recs).data           # R = 1000: not a multiple
        for n in sorted(set(fam.tier_sizes) | {0, full.n_clauses}):
            compare(data, tier_view(full, n))
            n_checks += 1
        compare(data, compile_plan(tuple(pool)))  # every pool predicate
        compare(data, compile_plan(tuple(pool)), n_valid=517)
        n_checks += 2
        print(f"  {ds}: tiers {fam.tier_sizes} of {full.n_clauses} "
              f"clauses, pool of {len(pool)}: bit-identical")
    # edge cases: empty patterns, unbounded key-value, delimiters, records
    # that reach the stride end, values past the stride, odd row counts
    recs = [b'{"note":"hi","age":3}', b'{"age":4}',
            b'{"name":"par,is","age":7}', b'{"k":"a}b","z":1}',
            b'{"x":"' + b"y" * 112 + b'","age":5}',   # fills the stride, 128
            b'{"age":12,"tail":"bob"}', b'{"a":1}' * 3]
    cls = [clause(substring("note", "")), clause(key_value("note", "")),
           clause(key_value("name", "par,is")), clause(key_value("k", "a}b")),
           clause(key_value("age", 5)), clause(key_value("age", 1)),
           clause(exact("tail", "bob"), presence("zz")),
           clause(substring("x", "yyyy"), key_value("age", 3))]
    chunk = encode_chunk(recs)
    plan = compile_plan(tuple(cls))
    for n in range(len(cls) + 1):
        compare(chunk.data, tier_view(plan, n))
    for n_valid in (0, 1, 5, len(recs)):
        compare(chunk.data, plan, n_valid=n_valid)
    wide = encode_chunk([b'{"pad":"' + b"x" * 9000 + b'","age":7}',
                         b'{"age":8}'] * 20)   # stride too wide to stage
    compare(wide.data, compile_plan((clause(key_value("age", 7)),)))
    n_checks += len(cls) + 6
    print(f"  edge cases: bit-identical ({n_checks} comparisons in all)")
    return n_checks


def small_store():
    """Mixed-epoch, mixed-tier store with promoted raw rows (2,048 rows)."""
    import numpy as np
    from repro_torch.core.client import NumpyEngine, encode_chunk
    from repro_torch.core.predicates import Query, clause, key_value
    from repro_torch.core.server import (
        CiaoStore, PlanFamily, PushdownPlan, evolve_family,
    )
    from repro_torch.core.workload import estimate_selectivities
    from repro_torch.data.datasets import generate_records, predicate_pool

    recs = generate_records("ycsb", 2048, seed=7)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    fam1 = evolve_family(fam0, ranked[:4] + ranked[8:12], (2, 4, 8))
    store = CiaoStore(fam0, segment_capacity=512)
    eng = NumpyEngine()

    def ingest(lo, hi, epoch):
        fam = store.family
        for i, start in enumerate(range(lo, hi, 256)):
            tier = i % fam.n_tiers
            chunk = encode_chunk(recs[start:start + 256])
            bv = eng.eval_fused_prefix(chunk, fam.plan.clauses,
                                       fam.tier_sizes[tier])
            store.ingest_chunk(chunk, bv, epoch=epoch, tier=tier)

    ingest(0, 1024, 0)
    store.advance_epoch(fam1)
    ingest(1024, 2048, 1)
    store.jit_load_raw()
    qs = [Query((c,)) for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]]
    qs += [Query((fam0.plan.clauses[0], ranked[13]))]
    qs += [Query((c,)) for c in ranked[14:17]]
    qs += [Query((clause(key_value("linear_score", v)),))
           for v in (3, 55, 97, 250)]
    qs += [Query((clause(key_value("phone_country", "ZZ")),))]
    for s in range(8):
        idx = np.random.default_rng(s).choice(len(pool), 3, replace=False)
        qs.append(Query(tuple(pool[int(i)] for i in idx)))
    return store, qs


def check_scan(scanner, queries) -> int:
    """Kernel B against its plain version and the numpy reference."""
    from repro_torch.kernels import scan_fused
    prep = scanner._prepare(queries)
    plane = scanner.cache.plane
    got = scan_fused.scan_core_cuda(plane, prep.params)
    plain = scan_fused.scan_core(plane, prep.params)
    host = scan_fused.scan_core_numpy(
        *(a.cpu().numpy() for a in plane), prep.params)
    err = max(same_bits(g, p) for g, p in zip(got, plain))
    err_np = max(abs(g.cpu().numpy().astype("int64") - h).max()
                 for g, h in zip(got, host))
    if err or err_np:
        raise AssertionError("scan kernel != plain version / numpy")
    return err


def main_path(n_records: int, dev):
    """The paper's loop at full size, through the port's entry points."""
    import numpy as np
    import torch
    from repro_torch.core.client import encode_chunk
    from repro_torch.core.device_scan import DeviceScanner
    from repro_torch.core.planner import build_plan
    from repro_torch.core.server import (
        CiaoStore, DataSkippingScanner, FullScanBaseline,
    )
    from repro_torch.core.workload import generate_workload
    from repro_torch.data.datasets import predicate_pool
    from repro_torch.kernels import fused, scan_fused
    from repro_torch.kernels.engine import KernelEngine

    n_chunks = n_records // CHUNK
    seeds = [SEED + i for i in range(n_chunks)]
    print(f"  data: ycsb, {n_chunks} chunks x {CHUNK} records, chunk i "
          f"generated from seed {SEED}+i ({seeds[0]}..{seeds[-1]})")
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn")) as ex:
        parts = list(ex.map(_records_part,
                            [(SRC, "ycsb", CHUNK, s) for s in seeds]))
    chunks = [encode_chunk(p) for p in parts]
    print(f"  generated and encoded in {time.perf_counter() - t0:.1f} s "
          f"({workers} processes); stride {chunks[0].stride}")

    pool = predicate_pool("ycsb")
    workload = generate_workload(pool, n_queries=200, distribution="zipf",
                                 zipf_a=1.5, rng=np.random.default_rng(0))
    queries = list(workload.queries)
    batches = [queries[i:i + 64] for i in range(0, len(queries), 64)]

    # ---- the main path: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    fused.launches = 0
    scan_fused.launches = 0
    report = build_plan(workload, parts[0][:500], budget_us=1.0)
    clauses = report.plan.clauses
    engine = KernelEngine("cuda")
    store = CiaoStore(report.plan)
    bvs = []
    t_push = t_ingest = 0.0
    for chunk in chunks:
        t0 = time.perf_counter()
        bv = engine.eval_fused(chunk, clauses)
        t_push += time.perf_counter() - t0
        t0 = time.perf_counter()
        store.ingest_chunk(chunk, bv)
        t_ingest += time.perf_counter() - t0
        bvs.append(bv)
    scanner = DeviceScanner(store, backend="cuda")
    t0 = time.perf_counter()
    first = [r for b in batches for r in scanner.scan_batch(b)]
    t_first = time.perf_counter() - t0
    uploads = scanner.cache.uploads
    torch.cuda.synchronize()
    t_batches = []
    steady = []
    for b in batches:
        t0 = time.perf_counter()
        steady += scanner.scan_batch(b)
        t_batches.append(time.perf_counter() - t0)
    steady_uploads = scanner.cache.uploads - uploads
    launches = {"pushdown": fused.launches, "scan": scan_fused.launches}
    # ---------------------------------------------------------------------

    chunk_bytes = chunks[0].data.nbytes
    print(f"  plan: {len(clauses)} clauses pushed at 1.0 us/record; "
          f"loading ratio {store.stats.loading_ratio:.4%} "
          f"({store.stats.n_loaded}/{store.stats.n_records})")
    print(f"  pushdown (KernelEngine.eval_fused, host->card->host): "
          f"{t_push / n_chunks * 1e3:.3f} ms/chunk, "
          f"{chunk_bytes * n_chunks / t_push / 1e9:.3f} GB/s of chunk bytes")
    print(f"  ingest (CiaoStore, host): {t_ingest / n_chunks * 1e3:.3f} "
          f"ms/chunk")
    print(f"  scan (DeviceScanner.scan_batch, 64 queries): first pass "
          f"{t_first:.3f} s for {len(batches)} batches; steady state "
          f"{[round(t * 1e3, 3) for t in t_batches]} ms per batch")
    print(f"  plane: {scanner.cache.n_slots} segments, "
          f"{scanner.cache._n_used} rows resident of capacity "
          f"{scanner.cache.plane.pres.shape}, "
          f"{scanner.cache.bytes_used / 2**20:.1f} MiB")
    print(f"  launches on the main path: {launches}; steady-state "
          f"uploads {steady_uploads}")
    if launches["pushdown"] < 1 or launches["scan"] < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if steady_uploads:
        raise AssertionError(f"steady-state scans uploaded "
                             f"{steady_uploads} times")

    host = DataSkippingScanner(store, log_queries=False)
    for q, a, b in zip(queries, first, steady):
        h = host.scan(q)
        if accounting(b) != accounting(h) or a.count != h.count:
            raise AssertionError(f"device != host scanner: {q.describe()}")
    print(f"  {len(queries)} ScanResults identical to the host "
          "DataSkippingScanner (full accounting)")

    n_pre = min(8, n_chunks)
    prefix = CiaoStore(report.plan)
    base = FullScanBaseline()
    for chunk, bv in zip(chunks[:n_pre], bvs[:n_pre]):
        prefix.ingest_chunk(chunk, bv)
        base.ingest_chunk(chunk)
    pscan = DeviceScanner(prefix, backend="cuda", log_queries=False)
    unique = list(dict.fromkeys(queries))
    got = [r.count for i in range(0, len(unique), 64)
           for r in pscan.scan_batch(unique[i:i + 64])]
    want = [base.scan(q).count for q in unique]
    if got != want:
        raise AssertionError("device scan != FullScanBaseline on prefix")
    print(f"  {n_pre * CHUNK}-record prefix: {len(unique)} distinct "
          "queries identical to FullScanBaseline")
    return {"chunks": chunks, "plan": report.plan, "engine": engine,
            "scanner": scanner, "batches": batches, "launches": launches}


def kernel_table(run, dev) -> list[dict]:
    """Time each kernel at the main path's shapes beside its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused, ops, ref, scan_fused
    from repro_torch.kernels.plan import compile_plan

    rows = []
    # kernel A: one main-path chunk, device-resident inputs
    plan = compile_plan(tuple(run["plan"].clauses))
    data = torch.from_numpy(run["chunks"][0].data).to(dev)
    R, L = data.shape
    flat = ops.plan_tensors(plan, ops.FLAT_FIELDS, dev)
    uniq = ops.plan_tensors(plan, ops.UNIQUE_FIELDS, dev)

    def kern():
        return fused.clause_bitvectors_fused(data, flat, R,
                                             n_simple=plan.n_simple)

    def plain():
        return ref.clause_bitvectors_ref(
            data, uniq["ukeys"], uniq["uklens"], uniq["uvals"],
            uniq["uvlens"], uniq["uunb"], uniq["key_ids"], uniq["val_ids"],
            uniq["membership"], R, n_simple=plan.n_simple)

    err = max(same_bits(g, w) for g, w in zip(kern(), plain()))
    if err:
        raise AssertionError("pushdown kernel != plain version at main shape")
    ms, src = kernel_ms(kern, 50, "pushdown_kernel")
    call_ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 5)
    C, W = plan.n_clauses, (R + 31) // 32
    nbytes = (data.numel() + sum(t.numel() * t.element_size()
                                 for t in flat.values())
              + C * W * 4 + W * 4 + C * 4)
    rows.append({
        "name": "pushdown (clause_bitvectors_fused)", "route": "cuda",
        "source": "src/repro_torch/csrc/pushdown.cu",
        "replaces": "src/repro/kernels/fused.py:146",
        "launches": run["launches"]["pushdown"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "ms_from": src, "wrapper_call_ms": call_ms,
        "shape": f"R={R} L={L} P={plan.n_preds} C={C}",
        "chunk_GB_per_s": data.numel() / (ms * 1e-3) / 1e9,
    })
    # the same chunk under every predicate of the pool: how the kernel
    # scales with the plan (not the main path's plan; no launch counted)
    from repro_torch.data.datasets import predicate_pool
    big = compile_plan(tuple(predicate_pool("ycsb")))
    big_t = ops.plan_tensors(big, ops.FLAT_FIELDS, dev)
    big_ms, _ = kernel_ms(lambda: fused.clause_bitvectors_fused(
        data, big_t, R, n_simple=big.n_simple), 10, "pushdown_kernel")
    print(f"  pushdown at R={R} L={L} with the whole ycsb pool "
          f"(P={big.n_preds}, C={big.n_clauses}): {big_ms:.4f} ms")

    # kernel B: the plane and the first batch's parameter tables
    scanner = run["scanner"]
    prep = scanner._prepare(run["batches"][0])
    plane = scanner.cache.plane
    params = prep.params
    err = check_scan(scanner, run["batches"][0])
    staged = scan_fused.stage_params(params, dev)
    ms, src = kernel_ms(lambda: scan_fused.launch_scan(plane, staged), 50,
                        "scan_kernel")
    call_ms = cuda_ms(lambda: scan_fused.scan_core_cuda(plane, params), 50)
    plain_ms = cuda_ms(lambda: scan_fused.scan_core(plane, params), 5)
    n = scanner.cache._n_used
    need = {scan_fused.KIND_PRESENCE: (("notn", 1),),
            scan_fused.KIND_EXACT: (("scod", 4),),
            scan_fused.KIND_SUBSTRING: (("scod", 4),),
            scan_fused.KIND_KV: (("pres", 1), ("notn", 1), ("isb", 1),
                                 ("numv", 1), ("rcod", 4))}
    cells = {(int(k), a) for k, kind in zip(params.key_ids, params.kinds)
             for a in need.get(int(kind), ())}
    Q, S1 = params.pushed_tbl.shape
    nbytes = (sum(size for _, (_, size) in cells) * n + 8 * n
              + sum(np.asarray(a).nbytes for a in params) + 2 * Q * S1 * 4)
    rows.append({
        "name": "scan (scan_core_cuda)", "route": "cuda",
        "source": "src/repro_torch/csrc/scan.cu",
        "replaces": "src/repro/kernels/scan_fused.py:373",
        "launches": run["launches"]["scan"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "ms_from": src, "wrapper_call_ms": call_ms,
        "shape": (f"N={n} of {plane.pres.shape[1]} K={plane.pres.shape[0]} "
                  f"T={params.kinds.shape[0]} C={params.membership.shape[0]} "
                  f"Q={Q} S1={S1}"),
    })
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms ({r['ms_from']}; whole "
              f"wrapper call {r['wrapper_call_ms']:.4f} ms; plain "
              f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}) at {r['shape']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=1 << 20,
                    help="main-path records, a multiple of 8192")
    args = ap.parse_args(argv)
    if args.records < CHUNK or args.records % CHUNK:
        ap.error("--records must be a positive multiple of 8192")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase("environment")
    card = environment()
    phase("build")
    build()
    phase("kernel A: pushdown vs plain version (plan families, edges)")
    check_pushdown(dev)
    phase("kernel B: scan vs plain version and numpy (small store)")
    from repro_torch.core.device_scan import DeviceScanner
    store, qs = small_store()
    check_scan(DeviceScanner(store, backend="cuda", log_queries=False), qs)
    print(f"  {len(qs)} queries: bit-identical")
    phase(f"main path: {args.records} records")
    run = main_path(args.records, dev)
    phase("kernels at main-path shapes")
    rows = kernel_table(run, dev)
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
