#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds every hand-written kernel from ``src/repro_torch/csrc`` (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card, then drives two paths at full size through the port's entry
points.  The main path, the paper's loop:

  ycsb records (1,048,576, in 128 chunks of 8,192)
    -> build_plan at 1.0 us/record (200-query zipf(1.5) workload)
    -> KernelEngine("cuda") pushdown             [kernel A, csrc/pushdown.cu]
    -> CiaoStore partial load
    -> DeviceScanner("cuda") in batches of 64     [kernel B, csrc/scan.cu]

Every ScanResult is checked against the host DataSkippingScanner on the
same store, and a 65,536-record prefix against FullScanBaseline.  Then the
split path, on the same chunks:

  (a) the bench's 12-clause mixed plan: seed_split_eval (one match_any
      launch, one match_key_value launch per key-value pair, host OR and
      pack, one reduce launch for the load mask) == eval_fused, every chunk
                              [kernel D: csrc/substring_match.cu;
                               kernel E: csrc/key_value.cu;
                               kernel C: csrc/bitvector_reduce.cu]
  (b) the main plan: seed_split_eval -> a second CiaoStore
      -> DataSkippingScanner(and_reduce=residual.bv_and_many_cuda)
                                                  [kernels C, D, E]
      and every ScanResult equals the main path's.

Then a wide scan batch: 200 uniform ycsb queries in ONE
DeviceScanner("cuda").scan_batch on the main path's 65,536-record prefix
store (512 term and clause slots, 256 queries; kernel B), checked against
the host scanner and FullScanBaseline.

Then the sharded plane, on the main path's own chunks and bitvectors:

  ShardedCiaoStore, 4 shards, range-routed on the plan's routing key
    -> ShardedDeviceScanner("cuda"), batches of 64   [kernel B per shard]
    -> ShardedScanner(and_reduce=residual.bv_and_many_cuda)   [kernel C]
    -> ScanBatcher(and_reduce=..., ResultCache), cold and cached

every ScanResult equal across the three in full accounting (shards
scanned and pruned included), every count equal to the unsharded main
path, at least one shard pruned, 0 steady uploads; and the 65,536-record
prefix hash-routed on a key no query reads, where every query visits
every shard and the hook runs from the sharded scanner's thread pool,
against FullScanBaseline.  Then the client fleet, the paper's different
budgets for different clients:

  one ycsb PlanFamily of nested tiers (build_plan_family)
    -> 13 ClientShards (speeds 4.0 x1, 1.0 x4, 0.25 x8), each with its
       own KernelEngine("cuda") and seed              [kernel A, per tier]
    -> FleetTierAllocator: one global budget split over the clients
    -> IngestCoordinator -> ShardedCiaoStore, 4 shards, chunks of 8,192
    -> ShardedDeviceScanner("cuda")                    [kernel B]
    -> one Replanner step over the sharded store, a chunk at the new epoch

at 2 chunks per client (the clients make their records in this process),
every client's chunks at its assigned tier and every count equal to
FullScanBaseline, before and after the replan.  Then the store's serving
plane and its online tuner:

  CiaoServeEngine(ShardedCiaoStore, 4 range shards, device_backend="cuda",
                  result_cache=ResultCache())
    <- one feeder: the main path's 128 chunks, each through
       KernelEngine("cuda") just before ingest_chunk      [kernel A]
    -> four readers over the 200 zipf queries while it runs: two in
       device mode (ShardedDeviceScanner per snapshot)    [kernel B]
       one in host mode, one through query_batch (64)
  PhysicalDesignTuner, driven by CiaoServeEngine.start_tuner, on a
  4-shard store of the first 262,144 records (TUNER_RECORDS): panel A
  (linear_score), panel B (visits) on the stale layout, the migration to
  visits under four device-mode readers                   [kernel B]

every live count at most its final count, every quiesced count equal to
the main path's in host, batch and device mode (device == host in full
accounting), and every tuner-phase count equal to FullScanBaseline.

Then kernel F (flash attention, csrc/flash_attention.cu) against its plain
version on the TPU test shapes, the serving shape, unmasked, Sq != Sk and
ragged S, in f32 (the SIMT route) and bf16 (the tensor-core route, also
against its own numerics, ref.flash_attention_ref_bf16p), and the
model-serving path at full width:

  repro_torch.launch.serve.main(["--arch", "qwen3-1.7b", "--batch", "8",
                                 "--prompt-len", "512", "--gen", "32"])
    -> 28 dense layers (d 2048, 16/8 heads of 128, d_ff 6144, V 151,936),
       seeded random weights, eight ycsb records as prompts
    -> prefill: every layer's attention on kernel F
    -> 32 greedy decode steps (plain decode attention)

checked by (i) layer 0's q, k, v captured from the serving prefill, F's
output against the plain version, and (ii) in f32, forward logits at
position S-1 against prefill(S-1) + one decode step (B=2, S=128).

Kernel C is also held at contiguous row slices off 16 bytes, rows 4-12
bytes past 16 at W % 4 == 0, the one-block width +- 1 and a bytes-bound
probe (P=12, W=2,097,152; not a path shape), and measured around its
launches: the launch floor (an empty kernel of its block size), the whole
ops.reduce_bitvectors call on the host clock, the device operations per
call from the profiler (exactly one kernel per bitvector_reduce call, and
one upload, one kernel and one copy back per reduce_bitvectors call, or
the run fails) and the probe beside its bytes bound.

Any mismatch or fault raises (exit code != 0).

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
import threading
import time
from concurrent.futures import ProcessPoolExecutor

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
CHUNK = 8192
SEED = 20240611
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores (same)
SERVE_ARCH = "qwen3-1.7b"
SERVE_ARGS = ["--arch", SERVE_ARCH, "--batch", "8", "--prompt-len", "512",
              "--gen", "32"]
# kernel F against its plain version: N(0, 1) inputs; f32 as the TPU
# test's bound (the two sum in another order); bf16: the output rounds
# once (half a step, up to 2^-7 at |o| < 4) and the tensor-core route
# rounds p to bf16 for P.V, which moves o by at most 2^-9 |v| per unit
# of the other keys' weight (2^-9 * 4.5 = 8.8e-3 at the largest |v| of
# these draws; far less where many keys share the weight)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# kernel F's bf16 route against its own numerics
# (ref.flash_attention_ref_bf16p): max |got - want| / max(1, |want|).
# Both round p and o to bf16 at the same places and differ only in the
# order of f32 sums, so where that flips a rounding they are one bf16
# step apart: 2^-7 at unit size, scaled with |o| above it
FLASH_BF16P_TOL = 2.0 ** -7
# (ii): f32 logits of about unit size after 28 layers, forward (kernel F)
# against prefill + decode (plain decode attention), TF32 off
EXACT_TOL = 1e-3


def _records_part(args):
    """One chunk's records, generated in a worker from its own seed."""
    src, dataset, n, seed = args
    sys.path.insert(0, src)
    from repro_torch.data.datasets import generate_records
    return generate_records(dataset, n, seed=seed)


def _baseline_part(args):
    """FullScanBaseline's counts of ``queries`` over some chunks, in a
    worker."""
    src, chunks, queries = args
    sys.path.insert(0, src)
    from repro_torch.core.server import FullScanBaseline
    base = FullScanBaseline()
    for chunk in chunks:
        base.ingest_chunk(chunk)
    return [base.scan(q).count for q in queries]


def start_baseline(chunks, queries):
    """Start FullScanBaseline's counts of ``queries`` over ``chunks``, the
    rows split over worker processes; :func:`finish_baseline` sums them."""
    workers = min(8, os.cpu_count() or 1, len(chunks))
    ex = ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn"))
    return ex, [ex.submit(_baseline_part, (SRC, chunks[i::workers], queries))
                for i in range(workers)]


def finish_baseline(pending) -> list[int]:
    """The counts of a :func:`start_baseline`; stops its processes."""
    ex, futures = pending
    try:
        got = [f.result() for f in futures]
    finally:
        ex.shutdown(cancel_futures=True)
    return [sum(c) for c in zip(*got)]


def baseline_counts(chunks, queries) -> list[int]:
    """FullScanBaseline's count of each query over ``chunks``, the rows
    split over worker processes and the counts summed."""
    return finish_baseline(start_baseline(chunks, queries))


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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


def kernel_ms(fn, reps: int, name: str) -> float:
    """Device milliseconds per launch of the kernel ``name`` inside ``fn``,
    from the profiler's CUDA activity (kernel time alone)."""
    from repro_torch.benchmarks import bench_reduce
    return bench_reduce.kernel_ms(fn, reps, name)


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


def straddling_rows(L: int, key: bytes, val: bytes):
    """uint8[R, L] over an ``x`` filler: ``key`` and ``val`` placed across
    positions 31/32, 127/128 and L - 1 (a 32-position word, a lane's 4-byte
    word, the stride end): the value exactly at the key end, a delimiter
    exactly at the key end, the value two bytes on, two key hits of which
    only the second reaches its value, and a value ending at L."""
    import numpy as np
    mk, mv = len(key), len(val)
    rows = []

    def row(*parts):
        r = bytearray(b"x" * (L + 64))
        for pos, b in parts:
            r[pos:pos + len(b)] = b
        rows.append(bytes(r[:L]))

    for edge in (32, 128, L - 1):
        for s in range(max(0, edge - mk - mv - 3), min(L, edge + 2)):
            e = s + mk
            row((s, key), (e, val))
            row((s, key), (e, b","), (e + 1, val))
            row((s, key), (e, b"}" + val))
            row((s, key), (e + 2, val))
            row((s, key + b"0," + key + val))
            row((max(0, s - mk - 3), key + b"9,"), (s, key), (e, val))
    row((L - mv - mk, key + val))
    row((L - mv - mk - 1, key + b" " + val))
    return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, L).copy()


def needle_rows(L: int):
    """37 records of stride L for kernel D: a needle at positions across
    4-byte words, 128-position blocks and the stride end (cut there), a
    row that fills the stride, one with zero bytes, a pair ending at L;
    and a table of width 8: an empty pattern, the needle with and without
    a zero byte after it, one longer than the width, the pair."""
    import numpy as np
    rng = np.random.default_rng(L)
    data = rng.integers(1, 255, (37, L), dtype=np.uint8)
    data[0, :] = ord("B")
    data[1, L - 3:] = 0
    needle = np.frombuffer(b"needle!", np.uint8)
    for r, at in enumerate((0, 1, 2, 3, 29, 31, 124, 125, 126, 127, 128,
                            L - 7, L - 6, L - 4, L - 1), start=2):
        at = min(at, L - 1)
        data[r, at:at + len(needle)] = needle[:L - at]
    data[20, L - 2:] = ord("Z")
    pats = np.zeros((8, 8), np.uint8)
    plens = np.zeros((8,), np.int32)
    for i, p in enumerate((b"", b"needle!", b"needle!\x00", b"needle!xy",
                           b"ZZ", b"ZZ\x00", b"B" * 8, b"e")):
        pats[i, :min(len(p), 8)] = np.frombuffer(p[:8], np.uint8)
        plens[i] = len(p)
    plens[3] = 12
    return data, pats, plens


def unaligned(a, dev):
    """``a`` on ``dev`` as a contiguous view one byte past its allocation
    (rows off every 4- and 16-byte boundary)."""
    import torch
    R, L = a.shape
    buf = torch.empty(R * L + 1, dtype=torch.uint8, device=dev)
    out = buf[1:].view(R, L)
    out.copy_(torch.from_numpy(a))
    return out


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
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {entry}: {line.strip()}")


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
        data = data_np if isinstance(data_np, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(data_np)).to(dev)
        R = data.shape[0]
        n_valid = R if n_valid is None else n_valid
        flat = ops.plan_tensors(plan, ops.KERNEL_FIELDS, dev)
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
    if 32 * (wide.stride + 16) <= fused.MAX_SMEM:
        raise AssertionError("the wide chunk would still be staged")
    compare(wide.data, compile_plan((clause(key_value("age", 7)),)))
    n_checks += len(cls) + 6
    # keys and values across positions 31/32, 127/128 and L - 1, a value
    # and a delimiter exactly at the key end, several key hits per record;
    # strides that are not 16-byte multiples, and rows one byte past their
    # allocation (the 4- and 1-byte staging routes)
    kv_plan = compile_plan(tuple(cls) + (
        clause(key_value("age", 57)), clause(key_value("age", 12)),
        clause(key_value("age", "57"), exact("name", "par"))))
    n_edge = 0
    for L in (100, 257, 384, 1000):
        rows = np.concatenate([straddling_rows(L, b'"age"', b"57"),
                               straddling_rows(L, b'"age"', b":5")])
        for n in (3, kv_plan.n_clauses):
            compare(rows, tier_view(kv_plan, n))
        compare(unaligned(rows, dev), kv_plan)
        compare(unaligned(rows, dev), kv_plan, n_valid=len(rows) - 7)
        n_checks += 4
        n_edge += len(rows)
    for ds in ("ycsb", "yelp", "winlog"):       # pools at an odd stride
        recs = generate_records(ds, 300, seed=12)
        stride = max(len(r) for r in recs) + 3
        compare(encode_chunk(recs, stride=stride).data,
                compile_plan(tuple(predicate_pool(ds))))
        compare(unaligned(encode_chunk(recs).data, dev),
                compile_plan(tuple(predicate_pool(ds))))
        n_checks += 2
    print(f"  edge cases: bit-identical ({n_checks} comparisons in all; "
          f"{n_edge} straddling rows at strides 100, 257, 384, 1000, "
          "aligned and one byte off)")
    return n_checks


def check_split_kernels(dev) -> int:
    """Kernels C, D and E against their plain versions: the ycsb, yelp and
    winlog pools, edge cases, R not a multiple of 32, a stride too wide to
    stage in shared memory."""
    import numpy as np
    import torch
    from repro_torch.core.client import encode_chunk, encode_patterns
    from repro_torch.core.predicates import Kind
    from repro_torch.data.datasets import generate_records, predicate_pool
    from repro_torch.kernels import fused, ops, ref
    from repro_torch.kernels import substring_match as sm
    from repro_torch.kernels.plan import compile_plan

    n = 0                                   # comparisons made

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def check_d(data, patterns, plens=None) -> None:
        nonlocal n
        n += 1
        pats, plens = encode_patterns(patterns) if plens is None else \
            (patterns, plens)
        args = (data, on_dev(pats), on_dev(plens))
        if same_bits(sm.multi_match_any(*args), ref.multi_match_any_ref(*args)):
            raise AssertionError(f"match kernel != plain version "
                                 f"(R={data.shape[0]}, L={data.shape[1]}, "
                                 f"P={len(patterns)})")

    def check_e(data, key, val) -> None:
        nonlocal n
        n += 1
        args = (data, on_dev(np.frombuffer(bytearray(key), np.uint8)),
                on_dev(np.frombuffer(bytearray(val), np.uint8)),
                b"," in val or b"}" in val)
        if same_bits(sm.key_value_match(*args), ref.key_value_match_ref(*args)):
            raise AssertionError(f"key-value kernel != plain version "
                                 f"({key!r}, {val!r}, L={data.shape[1]})")

    def check_c(words) -> None:
        nonlocal n
        n += 1
        reduce_matches(words)

    for ds in ("ycsb", "yelp", "winlog"):
        pool = predicate_pool(ds)
        data = on_dev(encode_chunk(generate_records(ds, 1000, seed=11)).data)
        simple = list(dict.fromkeys(
            t.patterns()[0] for c in pool for t in c.terms
            if t.kind is not Kind.KEY_VALUE))
        pairs = list(dict.fromkeys(
            t.patterns() for c in pool for t in c.terms
            if t.kind is Kind.KEY_VALUE))
        check_d(data, simple)
        for k, v in pairs:
            check_e(data, k, v)
        plan = compile_plan(tuple(pool))
        words = fused.clause_bitvectors_fused(
            data, ops.plan_tensors(plan, ops.KERNEL_FIELDS, dev), 1000,
            n_simple=plan.n_simple)[0]
        every7 = words.view(torch.int32)[::7].contiguous().view(torch.uint32)
        for rows in (words, words[:1], words[:3], every7):
            check_c(rows)
        print(f"  {ds}: {len(simple)} patterns (D), {len(pairs)} key-value "
              f"pairs (E), pool words {tuple(words.shape)} (C), R=1000: "
              "bit-identical")
    # D: empty pattern (true iff the row holds a zero byte), windows at and
    # past the stride end, R not a multiple of 32
    edge = np.zeros((45, 128), np.uint8)
    edge[0, :5] = ord("A")
    edge[1, :] = ord("B")
    edge[2, :127] = ord("C")
    edge[3, 120:] = ord("A")
    edge[4:] = np.random.default_rng(3).integers(1, 255, (41, 128),
                                                 dtype=np.uint8)
    check_d(on_dev(edge), [b"", b"A", b"BB", b"A" * 8, b"A" * 9,
                           bytes(edge[9, 60:66])])
    # D: needles across 4-byte words, 128-position blocks and the stride
    # end at strides 100, 257 and 384, aligned and one byte off (the 16-,
    # 4- and 1-byte staging routes); a table of width M = 7 (staged byte
    # by byte), an empty pattern and one longer than M; 37 records
    for L in (100, 257, 384):
        rows, pats, plens = needle_rows(L)
        for d in (on_dev(rows), unaligned(rows, dev)):
            check_d(d, pats, plens)
            check_d(d, pats[:, :7].copy(), plens)
    # E: unbounded values, delimiters after the key, a value ending at the
    # stride end, records cut by the stride
    kv_recs = [b'{"name":"par,is","age":7}', b'{"k":"a}b","z":1}',
               b'{"age":4}', b'{"age":12,"tail":"bob"}',
               b'{"x":"' + b"y" * 112 + b'","age":5}',
               b'{"x":"' + b"y" * 113 + b'","age":5',
               b'{"age":', b'{"a":1,"age":"3}"}', b'{"age":,3}',
               b'{"age":}4'] * 7
    kv = on_dev(encode_chunk(kv_recs).data)
    kv_pairs = [(b'"name":', b'"par,is"'), (b'"name":', b'"par'),
                (b'"k":', b'"a}b"'), (b'"k":', b'b"'), (b'"age":', b'5'),
                (b'"age":', b'4'), (b'"age":', b'3'), (b'"age":', b'3}'),
                (b'"age":', b'12'), (b'"tail":', b'"bob"')]
    for k, v in kv_pairs:
        check_e(kv, k, v)
    for k, v in ((b'"age":', b""), (b"", b"5")):
        for fn in (sm.key_value_match, ref.key_value_match_ref):
            try:
                fn(kv, on_dev(np.frombuffer(bytearray(k), np.uint8)),
                   on_dev(np.frombuffer(bytearray(v), np.uint8)), False)
            except ValueError:
                n += 1
                continue
            raise AssertionError(f"{fn.__name__} took an empty pattern")
    # E: keys and values across 31/32, 127/128 and L - 1 at strides that
    # are not 16-byte multiples, aligned and one byte off
    for L in (100, 257, 384, 1000):
        rows = straddling_rows(L, b'"age":', b"57")
        for d in (on_dev(rows), unaligned(rows, dev)):
            for k, v in ((b'"age":', b"57"), (b'"age":', b"5"),
                         (b'"age":', b"7,"), (b"x", b"5")):
                check_e(d, k, v)
    # E: 200 seeded random (key, value, records) triples over a small
    # alphabet with the delimiters and a zero byte in it
    rng = np.random.default_rng(15)
    alphabet = np.frombuffer(b"ab,}\x00", np.uint8)
    for i in range(200):
        L = int(rng.integers(1, 300))
        d = on_dev(alphabet[rng.integers(0, 5, (int(rng.integers(1, 70)), L))])
        k = alphabet[rng.integers(0, 5, int(rng.integers(1, 6)))].tobytes()
        v = alphabet[rng.integers(0, 5, int(rng.integers(1, 4)))].tobytes()
        n += 1
        args = (d, on_dev(np.frombuffer(bytearray(k), np.uint8)),
                on_dev(np.frombuffer(bytearray(v), np.uint8)), bool(i % 2))
        if same_bits(sm.key_value_match(*args),
                     ref.key_value_match_ref(*args)):
            raise AssertionError(f"key-value kernel != plain version on "
                                 f"random triple {i} ({k!r}, {v!r}, L={L})")
    # a stride too wide for 8 records to fit in shared memory: read in place
    wide = on_dev(encode_chunk([b'{"pad":"' + b"x" * 30000 + b'","age":7}',
                                b'{"age":8,"a":"xx"}'] * 20).data)
    if 8 * wide.shape[1] <= sm.MAX_SMEM:     # E stages 8 rows, D 32
        raise AssertionError("the wide chunk would still be staged")
    check_d(wide, [b'"age":7', b"xx", b"", b"zz"])
    for k, v in kv_pairs[4:7]:
        check_e(wide, k, v)
    n += check_reduce(dev)
    print(f"  edge cases: bit-identical ({n} comparisons in all)")
    return n


def reduce_matches(t) -> None:
    """Kernel C on ``t`` (uint32[P, W] on the card) bit for bit against
    its plain version."""
    from repro_torch.kernels import bitvector_ops, ref
    got, want = bitvector_ops.bitvector_reduce(t), ref.bitvector_reduce_ref(t)
    if max(same_bits(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"reduce kernel != plain version "
                             f"(P, W = {tuple(t.shape)}, base "
                             f"{t.data_ptr() % 16} bytes past 16)")


def check_reduce(dev) -> int:
    """Kernel C's edge cases against its plain version: the TPU test
    sweep, uniform rows, a long row; contiguous row slices ``t[1:]``
    (bases off 16 bytes: the scalar route, and the vector route's head
    and tail at P == 1), rows off 16 bytes at W % 4 == 0 (the vector
    route's head and tail), the one-block width +- 1 (one launch, then a
    grid of blocks and the partials' sum) and the bytes-bound probe.
    Returns the comparisons made."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.bench_reduce import PROBE
    from repro_torch.kernels import bitvector_ops

    rng = np.random.default_rng(0)
    one = bitvector_ops.ONE_BLOCK_WORDS

    def words(p, w):
        return torch.from_numpy(rng.integers(0, 2**32, (p, w),
                                             dtype=np.uint32)).to(dev)

    cases = [words(p, w) for p, w in ((1, 1), (3, 64), (8, 130), (2, 257),
                                      (5, 100_003))]
    cases += [torch.from_numpy(np.full((4, 333), fill, np.uint32)).to(dev)
              for fill in (0, 0xFFFFFFFF)]
    cases += [words(p + 1, w)[1:] for w in (3, 5, 257) for p in (1, 2, 12)]
    for off in (1, 2, 3):
        flat = words(1, 12 * 256 + 3)[0]
        cases.append(flat[off:off + 12 * 256].view(12, 256))
    cases += [words(p, w) for w in (one - 1, one + 1) for p in (2, 12)]
    cases.append(words(*PROBE))
    for t in cases:
        reduce_matches(t)
    print(f"  reduce: {len(cases)} edge cases bit-identical (row slices "
          f"at W 3/5/257, rows 4-12 bytes past 16 at W 256, W {one - 1} "
          f"and {one + 1}, the probe P, W = {PROBE})")
    return len(cases)


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


def check_scan(plane, params, numpy: bool = True) -> int:
    """Kernel B on ``params`` over ``plane`` against its plain version and
    (with ``numpy``) the numpy reference, whose integer matrix products
    take minutes at 512 terms over 65,536 rows."""
    from repro_torch.kernels import scan_fused
    got = scan_fused.scan_core_cuda(plane, params)
    plain = scan_fused.scan_core(plane, params)
    err = max(same_bits(g, p) for g, p in zip(got, plain))
    if numpy:
        host = scan_fused.scan_core_numpy(
            *(a.cpu().numpy() for a in plane), params)
        err = max(err, max(abs(g.cpu().numpy().astype("int64") - h).max()
                           for g, h in zip(got, host)))
    if err:
        raise AssertionError("scan kernel != plain version / numpy")
    return err


def check_scan_routes(scanner, queries) -> None:
    """Kernel B on the small store: as the wrapper launches it, with the
    counters added into global memory directly (the route for counter
    tables over LOCAL_ACC_BYTES), and split by query under a small
    shared-memory limit (``MAX_SMEM`` lowered); each bit-identical to the
    plain version."""
    from repro_torch.kernels import scan_fused
    params = scanner._prepare(queries).params
    plane = scanner.cache.plane
    check_scan(plane, params)
    want = scan_fused.scan_core(plane, params)
    limit, saved = 6_000, (scan_fused.LOCAL_ACC_BYTES, scan_fused.MAX_SMEM)
    try:
        scan_fused.LOCAL_ACC_BYTES = 0
        table = scan_fused.scan_table(params)
        if scan_fused.scan_layout(table, params.pushed_tbl.shape[1]).local_acc:
            raise AssertionError("the counters would stay in shared memory")
        got = scan_fused.scan_core_cuda(plane, params)
        scan_fused.LOCAL_ACC_BYTES, scan_fused.MAX_SMEM = saved[0], limit
        groups = scan_fused.query_groups(params)
        before = scan_fused.launches
        split = scan_fused.scan_core_cuda(plane, params)
        n_split = scan_fused.launches - before
    finally:
        scan_fused.LOCAL_ACC_BYTES, scan_fused.MAX_SMEM = saved
    for name, g in (("global counters", got), ("split by query", split)):
        if max(same_bits(a, b) for a, b in zip(g, want)):
            raise AssertionError(f"scan kernel ({name}) != plain version")
    if len(groups) < 2 or n_split < 2:
        raise AssertionError(f"the batch was not split: {len(groups)} groups")
    print(f"  {len(queries)} queries: bit-identical (shared-memory counters, "
          f"global counters, and split by query into {len(groups)} groups, "
          f"{n_split} launches, under a {limit} B limit)")


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
            "scanner": scanner, "batches": batches, "launches": launches,
            "store": store, "bvs": bvs, "queries": queries,
            "results": steady, "prefix": (prefix, pscan, base),
            "prefix_counts": dict(zip(unique, want))}


def reduce_numbers(dev) -> dict:
    """Kernel C and what surrounds its launches
    (:func:`repro_torch.benchmarks.bench_reduce.measure`): the kernel's
    time at the path's shapes (P=2, W=256: phase (b) and the hook; P=12,
    W=256: phase (a)), the whole ``ops.reduce_bitvectors`` call on the
    host clock, the device operations of a ``bitvector_reduce`` call and
    of a ``reduce_bitvectors`` call (profiler), and the probe beside its
    bytes bound; here also the launch floor, an empty kernel of C's block
    size timed the same way.  Holds the design: exactly one kernel, C's,
    per ``bitvector_reduce`` call, and one upload, one kernel and one copy
    back per ``reduce_bitvectors`` call."""
    from repro_torch.benchmarks import bench_reduce
    from repro_torch.kernels import bitvector_ops

    def hold(got, want, what):
        if any(got[k] != want.get(k, 0) for k in bench_reduce.KINDS):
            raise AssertionError(f"device operations per {what} call "
                                 f"{got['rows']}, want {want}")

    out = bench_reduce.measure(dev, SEED)
    for shape, r in out["shapes"].items():
        k, c = r["kernel_call_ops"], r["call_ops"]
        print(f"  reduce at {shape}: kernel {r['kernel_ms']:.5f} ms; "
              f"reduce_bitvectors call {r['call_ms']:.4f} ms (host clock); "
              f"device operations per bitvector_reduce call {k['rows']}, "
              f"per reduce_bitvectors call {c['rows']}")
        hold(k, {"kernels": 1}, "bitvector_reduce")
        if not all("bitvector_reduce_kernel" in name for name in k["rows"]):
            raise AssertionError(f"a bitvector_reduce call launched another "
                                 f"kernel: {k['rows']}")
        hold(c, {"kernels": 1, "copies_to_device": 1, "copies_to_host": 1},
             "reduce_bitvectors")
    out["floor_ms"] = kernel_ms(lambda: bitvector_ops.noop(dev), 200,
                                "noop_kernel")
    print(f"  launch floor (empty kernel, {bitvector_ops.THREADS} threads): "
          f"{out['floor_ms']:.5f} ms")
    p = out["probe"]
    print(f"  reduce probe {p['shape']} (not a path shape): {p['ms']:.4f} "
          f"ms, bound {p['bound_ms']:.4f} ms by bytes "
          f"({p['bound_share']:.1%}); device ms per launch "
          f"{p['device_ms_per_launch']}")
    return out


def _zero_counters() -> None:
    from repro_torch.kernels import bitvector_ops, fused, scan_fused
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import substring_match as sm
    fused.launches = scan_fused.launches = bitvector_ops.launches = 0
    sm.match_launches = sm.kv_launches = fa.launches = 0


def _split_counters() -> dict:
    from repro_torch.kernels import bitvector_ops
    from repro_torch.kernels import substring_match as sm
    return {"reduce": bitvector_ops.launches, "match": sm.match_launches,
            "key_value": sm.kv_launches}


def split_path(run, dev) -> dict:
    """The split pushdown path on the main path's chunks: (a) split ==
    fused under the bench's mixed plan, (b) split ingest into a second
    store, scanned through kernel C's AND-reduce hook."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.bench_kernels import (
        mixed_plan, seed_split_eval,
    )
    from repro_torch.core import bitvector
    from repro_torch.core.server import CiaoStore, DataSkippingScanner
    from repro_torch.kernels import residual
    from repro_torch.kernels.engine import KernelEngine

    chunks, n = run["chunks"], len(run["chunks"])
    out = {}

    # ---- (a): counters at 0 just before, read just after ----
    mixed = mixed_plan("ycsb", 12, np.random.default_rng(0))
    engine = KernelEngine("cuda")
    torch.cuda.synchronize()
    _zero_counters()
    t_split = t_fused = 0.0
    for i, chunk in enumerate(chunks):
        t0 = time.perf_counter()
        words, or_words = seed_split_eval(chunk, mixed, "cuda")
        t_split += time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = engine.eval_fused(chunk, mixed)
        t_fused += time.perf_counter() - t0
        if not (np.array_equal(words, fused.words)
                and np.array_equal(or_words, fused.or_words)):
            raise AssertionError(f"(a) split != fused on chunk {i}")
    out["a"] = _split_counters()
    # -----------------------------------------------------------------------
    print(f"  (a) mixed plan ({len(mixed)} clauses): split == fused on all "
          f"{n} chunks; split {t_split / n * 1e3:.3f} ms/chunk, fused "
          f"{t_fused / n * 1e3:.3f} ms/chunk (host clock, results on the "
          f"host); launches {out['a']}")
    out["a_ms"] = (t_split / n * 1e3, t_fused / n * 1e3)

    # ---- (b): counters at 0 just before, read just after ----
    clauses = run["plan"].clauses
    torch.cuda.synchronize()
    _zero_counters()
    store = CiaoStore(run["plan"])
    t_split = t_ingest = 0.0
    for i, (chunk, want) in enumerate(zip(chunks, run["bvs"])):
        t0 = time.perf_counter()
        words, or_words = seed_split_eval(chunk, clauses, "cuda")
        t_split += time.perf_counter() - t0
        counts = bitvector.popcount_rows(words).astype(np.int32)
        if not (np.array_equal(words, want.words)
                and np.array_equal(or_words, want.or_words)
                and np.array_equal(counts, want.counts)):
            raise AssertionError(f"(b) split != fused on chunk {i}")
        t0 = time.perf_counter()
        store.ingest_chunk(chunk, bitvector.ChunkBitvectors(
            words=words, or_words=or_words, counts=counts,
            n_records=chunk.n_records))
        t_ingest += time.perf_counter() - t0
    hooked = DataSkippingScanner(store, log_queries=False,
                                 and_reduce=residual.bv_and_many_cuda)
    before = _split_counters()["reduce"]
    t0 = time.perf_counter()
    got = [hooked.scan(q) for q in run["queries"]]
    t_scan = time.perf_counter() - t0
    out["b"] = _split_counters()
    out["hook"] = out["b"]["reduce"] - before
    # -----------------------------------------------------------------------
    for q, a, b in zip(run["queries"], got, run["results"]):
        if accounting(a) != accounting(b):
            raise AssertionError(f"(b) hooked scan != main path: "
                                 f"{q.describe()}")
    main = run["store"].stats
    if (store.stats.n_loaded, store.stats.n_records) != \
            (main.n_loaded, main.n_records):
        raise AssertionError("(b) split ingest loaded other rows")
    print(f"  (b) main plan ({len(clauses)} clauses): split "
          f"{t_split / n * 1e3:.3f} ms/chunk, ingest "
          f"{t_ingest / n * 1e3:.3f} ms/chunk, loading ratio "
          f"{store.stats.loading_ratio:.4%}; {len(got)} hooked scans in "
          f"{t_scan:.3f} s, every ScanResult identical to the main path "
          f"(full accounting); launches {out['b']}, of which "
          f"{out['hook']} reduce launches by the and_reduce hook")
    for phase_name in ("a", "b"):
        if min(out[phase_name].values()) < 1:
            raise AssertionError(f"({phase_name}) a kernel was not "
                                 f"launched: {out[phase_name]}")
    if out["hook"] < 1:
        raise AssertionError("(b) the and_reduce hook never launched")
    out["b_ms"] = (t_split / n * 1e3, t_ingest / n * 1e3, t_scan)
    return out


def split_kernel_rows(run, split, dev, reduce) -> list[dict]:
    """Kernels C, D and E timed at phase (b)'s shapes (the main plan on a
    main-path chunk) beside their plain versions; C's row also carries
    ``reduce`` (:func:`reduce_numbers`)."""
    import torch
    from repro_torch.core.client import encode_patterns
    from repro_torch.core.predicates import Kind
    from repro_torch.kernels import bitvector_ops, ref
    from repro_torch.kernels import substring_match as sm

    data = torch.from_numpy(run["chunks"][0].data).to(dev)
    R, L = data.shape
    terms = [t for c in run["plan"].clauses for t in c.terms]
    simple = list(dict.fromkeys(t.patterns()[0] for t in terms
                                if t.kind is not Kind.KEY_VALUE))
    key, val = next(t.patterns() for t in terms if t.kind is Kind.KEY_VALUE)
    pats, plens = encode_patterns(simple)
    d_args = (data, torch.from_numpy(pats).to(dev),
              torch.from_numpy(plens).to(dev))
    e_args = (data, torch.tensor(list(key), dtype=torch.uint8, device=dev),
              torch.tensor(list(val), dtype=torch.uint8, device=dev),
              b"," in val or b"}" in val)
    words = torch.from_numpy(run["bvs"][0].words).to(dev)    # the load mask
    P, W = words.shape
    cases = [
        ("bitvector_reduce (load mask, and_reduce hook)",
         "src/repro_torch/csrc/bitvector_reduce.cu",
         "src/repro/kernels/bitvector_ops.py:39", "reduce",
         "bitvector_reduce_kernel",
         lambda: bitvector_ops.bitvector_reduce(words),
         lambda: ref.bitvector_reduce_ref(words),
         P * W * 4 + 2 * W * 4 + 4, f"P={P} W={W}",
         "no PyTorch call reduces with AND or OR or counts bits"),
        ("multi_match_any", "src/repro_torch/csrc/substring_match.cu",
         "src/repro/kernels/substring_match.py:105", "match",
         "multi_match_kernel", lambda: sm.multi_match_any(*d_args),
         lambda: ref.multi_match_any_ref(*d_args),
         R * L + pats.nbytes + plens.nbytes + len(simple) * R,
         f"R={R} L={L} P={len(simple)} M={pats.shape[1]}",
         "no PyTorch call searches bytes for substrings"),
        ("key_value_match", "src/repro_torch/csrc/key_value.cu",
         "src/repro/kernels/substring_match.py:201", "key_value",
         "key_value_kernel", lambda: sm.key_value_match(*e_args),
         lambda: ref.key_value_match_ref(*e_args),
         R * L + len(key) + len(val) + R,
         f"R={R} L={L} mk={len(key)} mv={len(val)}",
         "no PyTorch call matches a key-value predicate in bytes"),
    ]
    rows = []
    for (name, source, replaces, counter, kname, kern, plain, nbytes, shape,
         why) in cases:
        got, want = kern(), plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = max(same_bits(g, w) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{name} != plain version at main shape")
        ms = kernel_ms(kern, 50, kname)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": split["b"][counter],
            "max_abs_err": err, "ms": ms, "plain_ms": cuda_ms(plain, 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "library_note": why,
            "launches_phase_a": split["a"][counter],
            "ms_from": "profiler", "wrapper_call_ms": cuda_ms(kern, 50),
            "shape": shape,
        })
    c_row = next(r for r in rows if r["name"].startswith("bitvector_reduce"))
    shapes = reduce["shapes"]
    c_row.update({
        "floor_ms": reduce["floor_ms"],
        "ms_by_shape": {k: v["kernel_ms"] for k, v in shapes.items()},
        "call_ms_by_shape": {k: v["call_ms"] for k, v in shapes.items()},
        "device_ops_per_call": {
            "bitvector_reduce": shapes["P=2 W=256"]["kernel_call_ops"],
            "reduce_bitvectors": shapes["P=2 W=256"]["call_ops"]},
        "probe": reduce["probe"]})
    # kernel D: two more timing calls at phase (b)'s shape (its time has
    # read 0.0032 and 0.0065 ms in two runs of one build), and every simple
    # pattern of each dataset's pool on an 8,192-record chunk (no launch
    # counted)
    from repro_torch.core.client import encode_chunk
    from repro_torch.data.datasets import generate_records, predicate_pool
    d_row = next(r for r in rows if r["name"] == "multi_match_any")
    d_row["ms_calls"] = [d_row["ms"]] + [
        kernel_ms(lambda: sm.multi_match_any(*d_args), 50,
                  "multi_match_kernel") for _ in range(2)]
    whole = {}
    for ds in ("ycsb", "yelp", "winlog"):
        d = data if ds == "ycsb" else torch.from_numpy(encode_chunk(
            generate_records(ds, CHUNK, seed=SEED)).data).to(dev)
        pool = list(dict.fromkeys(
            t.patterns()[0] for c in predicate_pool(ds) for t in c.terms
            if t.kind is not Kind.KEY_VALUE))
        pp, pl = encode_patterns(pool)
        args = (d, torch.from_numpy(pp).to(dev), torch.from_numpy(pl).to(dev))
        ms = kernel_ms(lambda: sm.multi_match_any(*args), 10,
                       "multi_match_kernel")
        Rp, Lp = d.shape
        nbytes = Rp * Lp + pp.nbytes + pl.nbytes + len(pool) * Rp
        whole[ds] = {"ms": ms, "R": Rp, "L": Lp, "P": len(pool),
                     "M": pp.shape[1],
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"}
        print(f"  match, the whole {ds} pool at R={Rp} L={Lp} (P={len(pool)}"
              f", M={pp.shape[1]}): {ms:.4f} ms (bound "
              f"{whole[ds]['bound_ms']:.5f} ms)")
    d_row["ms_whole_pool"] = whole
    print(f"  match at phase (b)'s shape, three profiler calls: "
          f"{[round(x, 5) for x in d_row['ms_calls']]} ms")
    return rows


def check_flash(dev) -> int:
    """Kernel F against its plain versions: the TPU test shapes, the
    serving shape, unmasked, Sq != Sk, ragged S; f32 (SIMT route) and
    bf16 (tensor-core route, also against its own numerics); and the bf16
    route's refusal of rows that are not 16-byte aligned."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    cases = [  # B, H, Hkv, Sq, Sk, d, causal
        (2, 4, 2, 128, 128, 64, True), (1, 8, 8, 256, 256, 32, True),
        (2, 4, 1, 64, 64, 128, False), (1, 2, 2, 96, 96, 16, True),
        (1, 2, 2, 64, 64, 32, True),                  # the TPU bf16 test
        (8, 16, 8, 512, 512, 128, True),              # the serving shape
        (2, 16, 8, 512, 512, 128, False),
        (2, 8, 4, 300, 700, 64, False), (2, 8, 4, 700, 300, 64, True),
        (2, 16, 8, 1000, 1000, 128, True), (3, 4, 4, 77, 77, 16, False),
    ]
    worst = {"bf16p": 0.0}
    for i, (B, H, Hkv, Sq, Sk, d, causal) in enumerate(cases):
        rng = np.random.default_rng(100 + i)
        base = [torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
            np.float32)).to(dev) for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]
        shape = (f"B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} d={d} "
                 f"causal={causal}")
        for name, tol in FLASH_TOL.items():
            # (B, S, heads, d) handed over transposed, as the model does
            q, k, v = (a.to(getattr(torch, name)).transpose(1, 2)
                       for a in base)
            got = fa.flash_attention(q, k, v, causal=causal)
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not (err <= tol) or got.dtype != q.dtype:
                raise AssertionError(
                    f"flash kernel != plain version: {name} {shape}: max "
                    f"abs err {err} > {tol}")
            worst[name] = max(worst.get(name, 0.0), err)
            if name == "bfloat16":
                want = ref.flash_attention_ref_bf16p(q, k, v, causal=causal)
                rel = float(((got.float() - want.float()).abs()
                             / want.float().abs().clamp(min=1.0)).max())
                if not (rel <= FLASH_BF16P_TOL):
                    raise AssertionError(
                        f"flash kernel != its bf16 numerics: {shape}: "
                        f"{rel} > {FLASH_BF16P_TOL}")
                worst["bf16p"] = max(worst["bf16p"], rel)
    print(f"  {len(cases)} shapes: max abs err vs plain f32 "
          f"{worst['float32']:.3g} (tol {FLASH_TOL['float32']}), bf16 "
          f"{worst['bfloat16']:.3g} (tol {FLASH_TOL['bfloat16']}); bf16 vs "
          f"ref.flash_attention_ref_bf16p {worst['bf16p']:.3g} of "
          f"max(1, |o|) (tol {FLASH_BF16P_TOL:.3g})")
    # a q whose rows start 2 bytes off a 16-byte boundary is refused
    q = torch.zeros(1, 64 * 32 + 1, dtype=torch.bfloat16, device=dev)
    q = q[:, 1:].view(1, 1, 64, 32)
    k = torch.zeros(1, 1, 64, 32, dtype=torch.bfloat16, device=dev)
    try:
        fa.flash_attention(q, k, k)
    except ValueError as e:
        print(f"  misaligned bf16 rows refused: {str(e)[:70]}...")
    else:
        raise AssertionError("flash kernel took misaligned bf16 rows")
    return 2 * len(cases)


def serve_path(dev) -> dict:
    """The serve entry point at full width; layer 0's q, k, v and F's output
    are captured from the first prefill (check (i))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    cfg = get_config(SERVE_ARCH)
    n_params = build_model(cfg).param_count()
    print(f"  {SERVE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd()}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, qk_norm {cfg.qk_norm}, tied "
          f"{cfg.tied_embeddings}; param_count {n_params:,}")
    if abs(n_params - 1.7e9) / 1.7e9 >= 0.06:
        raise AssertionError(f"param_count {n_params} not within 6% of 1.7e9")

    captured = {}
    launch = fa.flash_attention

    def capture(q, k, v, *, causal=True):
        out = launch(q, k, v, causal=causal)
        if not captured:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(),
                            out=out.clone(), causal=causal)
        return out

    # ---- the serve path: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention = capture
    try:
        res = serve.main(SERVE_ARGS)
    finally:
        fa.flash_attention = launch
    torch.cuda.synchronize()
    launches = fa.launches
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated(dev)
    per_prefill = launches / res["prefill_calls"]
    print(f"  prefill {res['prefill_ms']:.3f} ms (warm), decode "
          f"{res['decode_ms_per_step']:.3f} ms/step, "
          f"{res['tokens_per_s']:.1f} tokens/s over {res['wall_s']:.3f} s "
          f"(batch {res['batch']}, {res['generated']} tokens each; host "
          f"clock, device synchronised around each step); peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"  kernel F launches: {launches} in {res['prefill_calls']} "
          f"prefills ({per_prefill:g} per prefill, {cfg.n_layers} layers)")
    if res["generated"] != 32 or per_prefill != cfg.n_layers:
        raise AssertionError(f"serve path: {res}, F launches {launches}")

    # (i) F on layer 0's captured inputs against the plain version
    q, k, v = captured["q"], captured["k"], captured["v"]
    want = ref.flash_attention_ref(q, k, v, causal=captured["causal"])
    err = float((captured["out"].float() - want.float()).abs().max())
    print(f"  (i) layer 0 of the serving prefill: q {tuple(q.shape)} k "
          f"{tuple(k.shape)} {q.dtype}, causal; F vs plain max abs err "
          f"{err:.3g} (tol {FLASH_TOL['bfloat16']})")
    if not (err <= FLASH_TOL["bfloat16"]):
        raise AssertionError(f"(i) F != plain on layer 0: {err}")
    return {"result": res, "launches": launches, "peak_bytes": peak,
            "param_count": n_params, "qkv": (q, k, v), "err": err}


def serve_breakdown(dev) -> dict:
    """Where one prefill and one decode step of the serve path spend their
    time: device kernel time by kind (profiler) against the host clock."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks import bench_reduce
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import make_serve_fns

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    params = model.compute_params(model.init(SEED, device=dev))
    B, S = 8, 512
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(dev)
    fns = make_serve_fns(model, batch=B, seq_len=S + 32 + 128)
    logits, cache = fns["prefill"](params, {"tokens": toks})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    fns["decode"](params, cache, tok, S)
    steps = {"prefill": lambda: fns["prefill"](params, {"tokens": toks}),
             "decode": lambda: fns["decode"](params, cache, tok, S + 1)}
    kinds = (("kernel F", ("flash_kernel",)),
             ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "gemv")))
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(bench_reduce.PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(bench_reduce.PAD_S)
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(ms for _, ms, _ in rows)
        by_kind = {k: sum(ms for key, ms, _ in rows
                          if any(m in key for m in marks))
                   for k, marks in kinds}
        by_kind["other"] = busy - sum(by_kind.values())
        if name == "prefill" and not by_kind["kernel F"] > 0:
            raise AssertionError("the profiler found no kernel F in a "
                                 "prefill: its name marks no longer match")
        launches = sum(n for _, _, n in rows)
        ops = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.cpu_parent is None
                  and e.name.startswith("aten::"))
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "idle_share": 1 - busy / wall, "kernels": launches,
                     "eager_ops": ops, "by_kind_ms": by_kind}
        top = sorted(rows, key=lambda r: -r[1])[:6]
        print(f"  {name}: {wall:.3f} ms host clock, {ops} eager ops "
              f"({ops / cfg.n_layers:.1f} per layer), {busy:.3f} ms of "
              f"kernels ({launches} launches; device idle "
              f"{1 - busy / wall:.1%}); by kind "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kind.items()))
        for key, ms, n in top:
            print(f"      {ms:8.3f} ms  x{n:<4d} {key[:90]}")
    return out


def exactness_f32(dev) -> float:
    """(ii) forward logits at S-1 against prefill(S-1) + decode, in f32."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import cache_alloc_len, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False      # PyTorch's default
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SERVE_ARCH), compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    B, S = 2, 128
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(dev)
    fa.launches = 0
    full, _ = transformer.forward(params, cfg, toks)
    last, cache = model.prefill(params, {"tokens": toks[:, :S - 1]},
                                s_alloc=cache_alloc_len(S),
                                cache_dtype=torch.float32)
    dec, _ = model.decode(params, cache, toks[:, S - 1], S - 1)
    torch.cuda.synchronize()
    err = float((full[:, S - 1] - dec).abs().max())
    err_pre = float((full[:, S - 2] - last).abs().max())
    scale = float(full[:, S - 1].abs().max())
    print(f"  (ii) f32, TF32 off, B={B} S={S}: forward (kernel F, "
          f"{fa.launches} launches with the prefill) vs prefill(S-1) + "
          f"decode (plain decode attention): max abs err {err:.3g} at S-1, "
          f"{err_pre:.3g} at S-2 (prefill), logits up to {scale:.3g}; tol "
          f"{EXACT_TOL}: f32 sums in another order over 28 layers")
    if not (err <= EXACT_TOL and err_pre <= EXACT_TOL):
        raise AssertionError(f"(ii) forward != prefill + decode: {err}, "
                             f"{err_pre}")
    if not torch.isfinite(full).all():
        raise AssertionError("(ii) non-finite logits")
    return err


#: kernel F's serving shape: batch, query heads, kv heads, prompt, head dim
FLASH_SHAPE = (8, 16, 8, 512, 128)


def flash_timing(dev) -> dict:
    """Kernel F at the serving shape, on seeded bf16 q, k, v laid out as
    the model hands them over ((B, S, heads, d) transposed), beside its
    plain version and ``scaled_dot_product_attention``.  Timed before the
    serve path: every profiler trace that missed its kernel in this
    script's runs came after the model had served."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, Hkv, S, d = FLASH_SHAPE
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
        np.float32)).to(dev).to(torch.bfloat16).transpose(1, 2)
        for h in (H, Hkv, Hkv))
    ms = kernel_ms(lambda: fa.flash_attention(q, k, v), 20, "flash_kernel")
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 2 * B * H * S * S * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:78",
        "ms": ms, "plain_ms": cuda_ms(
            lambda: ref.flash_attention_ref(q, k, v), 3),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": lib_ms,
        "library_note": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), timed only",
        "ms_from": "profiler", "wrapper_call_ms": cuda_ms(
            lambda: fa.flash_attention(q, k, v), 20),
        "shape": f"B={B} H={H} Hkv={Hkv} S={S} d={d} {q.dtype} causal",
        "bound_bytes_ms": bytes_ms, "bound_ops_ms": flops_ms,
        "tflop_per_s": flops / (ms * 1e-3) / 1e12,
        "bound_share": max(bytes_ms, flops_ms) / ms,
        "ms_over_library": ms / lib_ms,
    }


def flash_row(timing: dict, serve) -> dict:
    """Kernel F's row: :func:`flash_timing` with the serve path's launches
    and its check (i) on layer 0's captured q, k, v, of the same shape."""
    q, k, _ = serve["qkv"]
    got = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3])
    if got != FLASH_SHAPE:
        raise AssertionError(f"serving q, k shape {got} != {FLASH_SHAPE}")
    return {**timing, "launches": serve["launches"],
            "max_abs_err": serve["err"],
            "launches_per_prefill": serve["launches"]
            // serve["result"]["prefill_calls"]}


def kernel_table(run, scan, dev) -> list[dict]:
    """Time each kernel at the main path's shapes beside its plain version."""
    import torch
    from repro_torch.kernels import fused, ops, ref
    from repro_torch.kernels import plan as kplan
    from repro_torch.kernels.plan import compile_plan

    rows = []
    # kernel A: one main-path chunk, device-resident inputs
    plan = compile_plan(tuple(run["plan"].clauses))
    data = torch.from_numpy(run["chunks"][0].data).to(dev)
    R, L = data.shape
    flat = ops.plan_tensors(plan, ops.KERNEL_FIELDS, dev)
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
    ms = kernel_ms(kern, 50, "pushdown_kernel")
    call_ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 5)
    C = plan.n_clauses

    def pushdown_bytes(d, table, C):
        """chunk and plan table read once, words, mask and counts written"""
        W = (d.shape[0] + 31) // 32
        return d.numel() + table.numel() * 4 + C * W * 4 + W * 4 + C * 4

    nbytes = pushdown_bytes(data, flat["kernel_table"], C)
    # where A's time goes at this shape: a launch with no rows to evaluate
    # (n_valid 0: table, clause bits, outputs), and one whose only
    # predicate is an empty simple pattern (the rows staged, no search)
    from repro_torch.core.predicates import clause, substring
    bare = compile_plan((clause(substring("a", "")),))
    bare_t = ops.plan_tensors(bare, ops.KERNEL_FIELDS, dev)
    ms_no_rows = kernel_ms(lambda: fused.clause_bitvectors_fused(
        data, flat, 0, n_simple=plan.n_simple), 50, "pushdown_kernel")
    ms_staged = kernel_ms(lambda: fused.clause_bitvectors_fused(
        data, bare_t, R, n_simple=1), 50, "pushdown_kernel")
    print(f"  pushdown at R={R} L={L}: no rows evaluated {ms_no_rows:.4f} "
          f"ms; rows staged, no search {ms_staged:.4f} ms; the main plan "
          f"{ms:.4f} ms")
    # every predicate of each dataset's pool on an 8,192-record chunk: how
    # the kernel scales with the plan (not the main path's plan; no launch
    # counted)
    from repro_torch.core.client import encode_chunk
    from repro_torch.data.datasets import generate_records, predicate_pool
    whole = {}
    for ds in ("ycsb", "yelp", "winlog"):
        d = data if ds == "ycsb" else torch.from_numpy(encode_chunk(
            generate_records(ds, CHUNK, seed=SEED)).data).to(dev)
        big = compile_plan(tuple(predicate_pool(ds)))
        big_t = ops.plan_tensors(big, ops.KERNEL_FIELDS, dev)
        big_ms = kernel_ms(lambda: fused.clause_bitvectors_fused(
            d, big_t, d.shape[0], n_simple=big.n_simple), 10,
            "pushdown_kernel")
        table = big.kernel_table
        searches = int(table[kplan.TABLE_N_SIMPLE] + table[kplan.TABLE_N_GROUPS])
        whole[ds] = {
            "ms": big_ms, "R": d.shape[0], "L": d.shape[1],
            "P": big.n_preds, "C": big.n_clauses, "searches": searches,
            "bound_ms": pushdown_bytes(d, big_t["kernel_table"],
                                       big.n_clauses)
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        print(f"  pushdown, the whole {ds} pool at R={d.shape[0]} "
              f"L={d.shape[1]} (P={big.n_preds}, C={big.n_clauses}, "
              f"{searches} pattern and key searches): {big_ms:.4f} ms "
              f"(bound {whole[ds]['bound_ms']:.5f} ms)")
    rows.append({
        "name": "pushdown (clause_bitvectors_fused)", "route": "cuda",
        "source": "src/repro_torch/csrc/pushdown.cu",
        "replaces": "src/repro/kernels/fused.py:146",
        "launches": run["launches"]["pushdown"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "ms_from": "profiler", "wrapper_call_ms": call_ms,
        "shape": f"R={R} L={L} P={plan.n_preds} C={C}",
        "chunk_GB_per_s": data.numel() / (ms * 1e-3) / 1e9,
        "ms_whole_pool": whole, "ms_no_rows": ms_no_rows,
        "ms_rows_staged_no_search": ms_staged,
    })

    # kernel B: timed in the wide-batch phase, at both shapes
    b_main, b_wide = scan["main"], scan["wide"]
    b_wide["launches"] = scan["launches"]
    rows.append({
        "name": "scan (scan_core_cuda)", "route": "cuda",
        "source": "src/repro_torch/csrc/scan.cu",
        "replaces": "src/repro/kernels/scan_fused.py:373",
        "launches": run["launches"]["scan"], **b_main,
        "bound_by": "bytes", "library_ms": None, "ms_from": "profiler",
        "wide": b_wide,
    })
    return rows


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn`` (no device work)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def scan_timing(scanner, prep, dev, numpy: bool = True) -> dict:
    """Kernel B on one prepared batch's tables over the scanner's plane:
    checked against its plain version (and numpy), then timed beside it.
    ``wrapper_call_ms`` is the call ``DeviceScanner`` makes (the batch's
    ``scan_table`` built once, in ``_prepare``); ``table_ms`` is that
    table's host time, and ``wrapper_building_table_ms`` the wrapper call
    that builds it itself."""
    import numpy as np
    from repro_torch.kernels import scan_fused
    params, table = prep.params, prep.table
    plane = scanner.cache.plane
    err = check_scan(plane, params, numpy)
    staged = scan_fused.stage_params(params, dev, table)
    ms = kernel_ms(lambda: scan_fused.launch_scan(plane, staged), 50,
                   "scan_kernel")
    call_ms = cuda_ms(lambda: scan_fused.scan_core_cuda(plane, params, table),
                      20)
    call_table_ms = cuda_ms(
        lambda: scan_fused.scan_core_cuda(plane, params), 20)
    table_ms = host_ms(lambda: scan_fused.scan_table(params), 20)
    plain_ms = cuda_ms(lambda: scan_fused.scan_core(plane, params), 3)
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
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "wrapper_call_ms": call_ms, "table_ms": table_ms,
        "wrapper_building_table_ms": call_table_ms,
        "smem_bytes": staged.layout.smem,
        "shape": (f"N={n} of {plane.pres.shape[1]} K={plane.pres.shape[0]} "
                  f"T={params.kinds.shape[0]} C={params.membership.shape[0]} "
                  f"Q={Q} S1={S1} (live terms "
                  f"{int(np.sum(params.kinds >= 0))})"),
    }


def unpromoted(scanner, queries):
    """``scanner._prepare`` of ``queries`` with no raw promotion: the
    tables of the whole batch over the plane as it stands (kernel B's
    inputs at that shape; the rows still raw are in no table)."""
    store = scanner.store
    return scanner._prepare(
        queries, pushed_maps=[store.pushed_by_epoch(q) for q in queries],
        promoted=[{} for _ in queries],
        jit_vis=[len(store.jit_blocks)] * len(queries))


def wide_batch(run, dev) -> dict:
    """Kernel B timed at the main path's batch shape; then 200 uniform
    ycsb queries in ONE DeviceScanner.scan_batch (term and clause buckets
    512, 256 queries: the kernel before this one refused them) on the main
    path's 65,536-record prefix store, every ScanResult checked against
    the host scanner and every count against FullScanBaseline.  The
    uniform queries read clauses the plan did not push, so the batch first
    promotes the store's raw rows, as the host scanner would (on the
    1,048,576-record store that host work alone takes minutes).  B is
    checked and timed at the wide tables on both planes: the main store's
    (its resident rows, no promotion) and the prefix store's."""
    import numpy as np
    import torch
    from repro_torch.core.server import DataSkippingScanner
    from repro_torch.core.workload import generate_workload
    from repro_torch.data.datasets import predicate_pool
    from repro_torch.kernels import scan_fused

    main_scanner = run["scanner"]
    main = scan_timing(main_scanner, main_scanner._prepare(run["batches"][0]),
                       dev)
    store, scanner, base = run["prefix"]
    wide = list(generate_workload(predicate_pool("ycsb"), n_queries=200,
                                  distribution="uniform",
                                  rng=np.random.default_rng(0)).queries)
    # ---- the wide batch: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    first = scanner.scan_batch(wide)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    steady = scanner.scan_batch(wide)
    t_steady = time.perf_counter() - t0
    launches = scan_fused.launches
    # -----------------------------------------------------------------------
    prep = scanner._prepare(wide)
    params = prep.params
    print(f"  200 uniform queries in one scan_batch on the "
          f"{store.stats.n_records}-record prefix store "
          f"(T={params.kinds.shape[0]}"
          f" C={params.membership.shape[0]} Q={params.pushed_tbl.shape[0]}): "
          f"first {t_first:.3f} s (raw promotion included), steady "
          f"{t_steady * 1e3:.3f} ms; {launches} scan launches; plane "
          f"{scanner.cache.n_slots} segments, {scanner.cache._n_used} rows")
    if launches < 1:
        raise AssertionError("the wide batch did not launch the scan kernel")
    host = DataSkippingScanner(store, log_queries=False)
    t0 = time.perf_counter()
    for q, a, b in zip(wide, first, steady):
        h = host.scan(q)
        if accounting(b) != accounting(h) or a.count != h.count:
            raise AssertionError(f"wide batch: device != host scanner: "
                                 f"{q.describe()}")
        if b.count != base.scan(q).count:
            raise AssertionError(f"wide batch: device != FullScanBaseline: "
                                 f"{q.describe()}")
    print(f"  {len(wide)} ScanResults identical to the host "
          "DataSkippingScanner (full accounting) and their counts to "
          f"FullScanBaseline (checked in {time.perf_counter() - t0:.1f} s)")
    prefix = scan_timing(scanner, prep, dev, numpy=False)
    out = scan_timing(main_scanner, unpromoted(main_scanner, wide), dev,
                      numpy=False)
    for name, r in (("main batch", main), ("wide batch, main plane", out),
                    ("wide batch, prefix plane", prefix)):
        print(f"  scan kernel, {name} ({r['shape']}): {r['ms']:.4f} ms; "
              f"wrapper {r['wrapper_call_ms']:.4f} ms (its table, built "
              f"once per batch: {r['table_ms']:.4f} ms; the wrapper "
              f"building it: {r['wrapper_building_table_ms']:.4f} ms); "
              f"plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.5f} ms; "
              f"{r['smem_bytes']} B of shared memory per block")
    return {"main": main, "wide": dict(out, prefix_plane=prefix),
            "launches": launches, "ms_first": t_first * 1e3,
            "ms_steady": t_steady * 1e3}


def full_accounting(r) -> tuple:
    """``accounting`` plus the sharded fields (segments scanned, shards
    scanned and pruned)."""
    return accounting(r) + (r.segments_scanned, r.shards_scanned,
                            r.shards_pruned)


def timed_batches(fn, batches) -> tuple[list, list[float]]:
    """``fn`` over each batch: the results in order and ms per batch."""
    out, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        out += fn(b)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def sharded_plane(run, dev) -> dict:
    """The main path's chunks and kernel-A bitvectors in a 4-shard
    ShardedCiaoStore, range-routed on the plan's routing key from 800
    sampled records; the 200 zipf queries in batches of 64 through
    ShardedDeviceScanner("cuda") (kernel B once per surviving shard), the
    ShardedScanner with kernel C as its AND hook, called from its thread
    pool, and ScanBatcher with the hook and a ResultCache, twice.  Every
    ScanResult of the three is equal in full accounting and every count
    to the unsharded main path; a hash-routed 4-shard store of the
    65,536-record prefix counts as FullScanBaseline."""
    import torch
    from repro_torch.core.batch_scan import ResultCache, ScanBatcher
    from repro_torch.core.device_scan import ShardedDeviceScanner
    from repro_torch.core.shard import (
        ShardedCiaoStore, ShardedScanner, ShardRouter, choose_routing_key,
    )
    from repro_torch.kernels import bitvector_ops, residual, scan_fused

    chunks, bvs, plan = run["chunks"], run["bvs"], run["plan"]
    queries, batches = run["queries"], run["batches"]
    n = len(chunks)
    objs = [json.loads(chunks[0].record(i)) for i in range(800)]
    key = choose_routing_key(plan)
    # ---- the sharded plane: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    router = ShardRouter.from_samples(4, key, objs)
    store = ShardedCiaoStore(plan, router=router)
    t0 = time.perf_counter()
    for chunk, bv in zip(chunks, bvs):
        store.ingest_chunk(chunk, bv)
    t_ingest = time.perf_counter() - t0
    device = ShardedDeviceScanner(store, backend="cuda")
    t0 = time.perf_counter()
    first = [r for b in batches for r in device.scan_batch(b)]
    t_first = time.perf_counter() - t0
    uploads = sum(c.uploads for c in device.caches)
    torch.cuda.synchronize()
    dev_res, dev_ms = timed_batches(device.scan_batch, batches)
    steady_uploads = sum(c.uploads for c in device.caches) - uploads
    b_launches = scan_fused.launches
    threads = set()
    hook_calls = []

    def hook(words):
        """kernel C's AND (residual.bv_and_many_cuda), noting the thread"""
        threads.add(threading.current_thread().name)
        hook_calls.append(1)
        return residual.bv_and_many_cuda(words)

    # threshold 0: the shards are scanned on the pool for every query
    hooked = ShardedScanner(store, log_queries=False, and_reduce=hook,
                            parallel_threshold_rows=0)
    host_res, host_ms = timed_batches(
        lambda b: [hooked.scan(q) for q in b], batches)
    hooked.close()
    c_hooked = bitvector_ops.launches
    # each segment memoises its pushed clauses' AND: clear it, so the
    # batcher computes its own through kernel C too
    for seg in store.blocks:
        seg._and_masks = {}
    cache = ResultCache(cap=4096)
    batcher = ScanBatcher(store, log_queries=False, cache=cache,
                          and_reduce=residual.bv_and_many_cuda)
    cold, cold_ms = timed_batches(batcher.scan_batch, batches)
    hits, misses = cache.hits, cache.misses
    warm, warm_ms = timed_batches(batcher.scan_batch, batches)
    c_batcher = bitvector_ops.launches - c_hooked
    range_threads = set(threads)
    # the prefix, hash-routed on a key no query reads, so every query
    # visits every shard: the hooked scanner fans out on its pool here
    hstore = ShardedCiaoStore(
        plan, router=ShardRouter(n_shards=4, key=HASH_KEY, mode="hash"))
    prefix_store = run["prefix"][0]
    n_pre = prefix_store.stats.n_records // CHUNK
    for chunk, bv in zip(chunks[:n_pre], bvs[:n_pre]):
        hstore.ingest_chunk(chunk, bv)
    unique = list(dict.fromkeys(queries))
    hdev = ShardedDeviceScanner(hstore, backend="cuda", log_queries=False)
    hash_dev = [r for i in range(0, len(unique), 64)
                for r in hdev.scan_batch(unique[i:i + 64])]
    threads.clear()
    before = bitvector_ops.launches
    with ShardedScanner(hstore, log_queries=False, and_reduce=hook,
                        parallel_threshold_rows=0) as sc:
        hash_host = [sc.scan(q) for q in unique]
    c_pool = bitvector_ops.launches - before
    launches = {"scan": scan_fused.launches, "reduce": bitvector_ops.launches}
    # -----------------------------------------------------------------------
    rows = [s.stats.n_records for s in store.shards]
    loaded = [s.stats.n_loaded for s in store.shards]
    mib = [round(c.bytes_used / 2**20, 2) for c in device.caches]
    pruned = sum(r.shards_pruned for r in dev_res)
    print(f"  router: range on {key!r} from 800 sampled records, "
          f"boundaries {list(router.boundaries)}")
    print(f"  ingest (ShardedCiaoStore, host): "
          f"{t_ingest / n * 1e3:.3f} ms/chunk, of which routing "
          f"(route_time_s) {store.route_time_s / n * 1e3:.3f} ms/chunk")
    print(f"  rows per shard {rows}, loaded {loaded}; resident MiB per "
          f"shard {mib}, segments per shard "
          f"{[c.n_slots for c in device.caches]}")
    print(f"  ShardedDeviceScanner: first pass {t_first:.3f} s, steady "
          f"{[round(t, 3) for t in dev_ms]} ms per 64-query batch; "
          f"steady-state uploads {steady_uploads}; {b_launches} scan "
          f"launches; {pruned} shard prunes over the steady pass")
    visits = sorted({r.shards_scanned for r in dev_res})
    print(f"  ShardedScanner, kernel C hook: "
          f"{[round(t, 3) for t in host_ms]} ms per batch; "
          f"{len(hook_calls)} hook calls from {sorted(range_threads)} "
          f"(each query visits {visits} of 4 shards under range routing); "
          f"{c_hooked} reduce launches")
    print(f"  ScanBatcher, hook and ResultCache: cold "
          f"{[round(t, 3) for t in cold_ms]} ms, warm "
          f"{[round(t, 3) for t in warm_ms]} ms per batch; cache hits "
          f"{cache.hits - hits} of {cache.hits - hits + cache.misses - misses}"
          f" lookups on the warm run; {c_batcher} reduce launches")
    print(f"  launches in this phase: {launches}")
    if steady_uploads:
        raise AssertionError(f"sharded steady-state scans uploaded "
                             f"{steady_uploads} times")
    if min(launches.values()) < 1 or c_hooked < 1:
        raise AssertionError(f"a kernel was not launched: {launches}, "
                             f"{c_hooked} by the hook")
    if not any(t.startswith("ciao-shard-scan") for t in threads) \
            or c_pool < 1:
        raise AssertionError(f"the hook never launched kernel C in the "
                             f"pool: {threads}, {c_pool} launches")
    if cache.misses != misses or cache.hits == hits:
        raise AssertionError("the warm ScanBatcher run missed the cache")
    if not pruned:
        raise AssertionError("no query pruned a shard under range routing")
    for i, q in enumerate(queries):
        want = full_accounting(dev_res[i])
        for name, got in (("first pass", first[i]), ("hooked", host_res[i]),
                          ("batcher", cold[i]), ("cached", warm[i])):
            if full_accounting(got) != want:
                raise AssertionError(f"sharded {name} != device scanner: "
                                     f"{q.describe()}")
        if dev_res[i].count != run["results"][i].count:
            raise AssertionError(f"sharded != unsharded: {q.describe()}")
    for q, a, b in zip(unique, hash_dev, hash_host):
        if full_accounting(a) != full_accounting(b):
            raise AssertionError(f"hash-routed: device != hooked scanner: "
                                 f"{q.describe()}")
        if a.count != run["prefix_counts"][q]:
            raise AssertionError(f"hash-routed: device != FullScanBaseline: "
                                 f"{q.describe()}")
    print(f"  {len(queries)} ScanResults equal across ShardedDeviceScanner, "
          f"the hooked ShardedScanner and ScanBatcher (cold and cached), "
          f"full accounting; counts equal to the unsharded main path")
    print(f"  hash-routed on {HASH_KEY!r}, {hstore.stats.n_records}-record "
          f"prefix: {len(unique)} distinct queries, each on "
          f"{sorted({r.shards_scanned for r in hash_dev})} shards; device "
          f"scanner == hooked scanner (hook from {sorted(threads)}, "
          f"{c_pool} reduce launches) == FullScanBaseline")
    return {"launches": launches, "reduce_hook": c_hooked,
            "reduce_batcher": c_batcher, "ingest_ms": t_ingest / n * 1e3,
            "route_ms": store.route_time_s / n * 1e3, "rows": rows,
            "mib": mib, "device_ms": dev_ms, "host_ms": host_ms,
            "batcher_ms": cold_ms, "cached_ms": warm_ms,
            "first_s": t_first, "prunes": pruned, "reduce_pool": c_pool}


#: the hash-routed prefix store's routing key: one no query reads, so
#: every query visits every shard
HASH_KEY = "customer_id"

#: the JAX package's fleet benchmark (benchmarks/bench_tiers.py):
#: (speed, count) for one fast, four nominal and eight slow clients
FLEET = ((4.0, 1), (1.0, 4), (0.25, 8))
#: chunks per client: ClientShard makes its records in this process, so
#: the fleet runs at 2 x 8,192 records per client (212,992 records)
FLEET_CHUNKS = 2


def client_fleet(dev) -> dict:
    """Different budgets for different clients: one ycsb PlanFamily of
    nested tiers, 13 clients at the fleet benchmark's speeds, each with
    its own KernelEngine("cuda") and seed; FleetTierAllocator splits one
    global budget, IngestCoordinator feeds a 4-shard ShardedCiaoStore in
    chunks of 8,192; every client's chunks are held to its assigned tier,
    ShardedDeviceScanner's counts to FullScanBaseline over the same
    records (the floor tier leaves raw rows the queries promote); then one
    Replanner check over the sharded store, a chunk
    ingested under the new epoch, and the counts held again."""
    import numpy as np
    import torch
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.device_scan import ShardedDeviceScanner
    from repro_torch.core.planner import build_plan_family
    from repro_torch.core.predicates import Query
    from repro_torch.core.replan import Replanner, ReplanPolicy
    from repro_torch.core.server import FullScanBaseline
    from repro_torch.core.shard import (
        ShardedCiaoStore, ShardRouter, choose_routing_key,
    )
    from repro_torch.core.workload import Workload, generate_workload
    from repro_torch.data.datasets import generate_records, predicate_pool
    from repro_torch.data.pipeline import (
        ClientShard, FleetTierAllocator, IngestCoordinator,
    )
    from repro_torch.kernels import fused, scan_fused
    from repro_torch.kernels.engine import KernelEngine

    # the fleet benchmark's family, on the analytic cost model (no timed
    # calibration, so the tiers and the budget are the same every run)
    pool = predicate_pool("ycsb")
    wl = generate_workload(pool, n_queries=300, distribution="zipf",
                           zipf_a=1.1, rng=np.random.default_rng(3),
                           name="fleet-queries")
    sample = generate_records("ycsb", 400, seed=17)
    cm = CostModel().scaled(20.0)
    costs = sorted(cm.clause_cost(c, 0.2) for c in pool)
    med = costs[len(costs) // 2]
    budgets = [1.5 * med, 3.0 * med, 40.0 * med]
    family = build_plan_family(Workload(wl.name, wl.queries[:-120]), sample,
                               tier_budgets_us=budgets, cost_model=cm).family
    t1 = set(family.tier_clauses(1))
    queries = list(dict.fromkeys(q for q in wl.queries[-120:]
                                 if any(c in t1 for c in q.clauses)))
    clients = []
    for speed, count in FLEET:
        for _ in range(count):
            clients.append(ClientShard(
                "ycsb", len(clients), KernelEngine("cuda"), family.plan,
                chunk_records=CHUNK, speed=speed, cost_ewma_alpha=0.0))
    rates = np.array([c.speed * c.chunk_records for c in clients])
    weights = rates / rates.sum()
    target = {4.0: 1, 1.0: 1, 0.25: 0}
    budget = 1.02 * float(sum(w * c.cost_scale * family.tier_costs[
        target[c.speed]] for w, c in zip(weights, clients)))
    made = []

    def keep(c, produce):
        def next_chunk():
            chunk, bv = produce()
            made.append((c.shard_id, c.tier, bv.words.shape[0], chunk))
            return chunk, bv
        return next_chunk

    for c in clients:
        c.next_chunk = keep(c, c.next_chunk)
    key = choose_routing_key(family)
    store = ShardedCiaoStore(family, router=ShardRouter(
        n_shards=4, key=key, mode="hash"))
    # ---- the client fleet: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    alloc = FleetTierAllocator(family, budget, retier_every_records=10**9)
    # no stealing: every client makes its own chunks at its own tier (the
    # fast client would otherwise take the slow clients' slots)
    coord = IngestCoordinator(clients, store, allocator=alloc, steal=False)
    tiers = [c.tier for c in clients]
    t0 = time.perf_counter()
    coord.run(chunks_per_client=FLEET_CHUNKS)
    t_run = time.perf_counter() - t0
    scanner = ShardedDeviceScanner(store, backend="cuda")
    t0 = time.perf_counter()
    got = [r.count for i in range(0, len(queries), 64)
           for r in scanner.scan_batch(queries[i:i + 64])]
    t_scan = time.perf_counter() - t0
    a_fleet = fused.launches
    # one Replanner check over the sharded store: a drifted workload
    # (clauses the family does not push) in the query log, a forced step
    rp = Replanner(store, sample, tier_budgets_us=budgets,
                   base_workload=Workload(wl.name, wl.queries[:-120]),
                   cost_model=cm, policy=ReplanPolicy(
                       check_every_records=CHUNK, min_observe_records=CHUNK,
                       min_window_queries=4, recalibrate_cost=False))
    pushed = set(family.plan.clauses)
    drift = [Query((c,)) for c in pool if c not in pushed][:8]
    for q in drift * 4:
        store.log_query(q)
    new = rp.step(force=True)
    retier = None
    if new is not None:
        alloc.set_family(new, clients)
        retier = [c.tier for c in clients]
        chunk, bv = clients[0].next_chunk()
        store.ingest_chunk(chunk, bv, epoch=new.plan.epoch,
                           tier=clients[0].tier)
    after = [r.count for i in range(0, len(queries), 64)
             for r in scanner.scan_batch(queries[i:i + 64])]
    launches = {"pushdown": fused.launches, "scan": scan_fused.launches}
    # -----------------------------------------------------------------------
    n_made = sum(ch.n_records for *_, ch in made)
    by_speed = {s: [t for c, t in zip(clients, tiers) if c.speed == s]
                for s, _ in FLEET}
    print(f"  depth cut: {FLEET_CHUNKS} chunks of {CHUNK} records per client"
          f" ({FLEET_CHUNKS * CHUNK * len(clients)} records): ClientShard "
          f"makes its records in this process (fleet run {t_run:.1f} s)")
    print(f"  family: tier sizes {family.tier_sizes}, modelled tier costs "
          f"{[round(x, 3) for x in family.tier_costs]} us/record")
    print(f"  allocation (tier per client by speed): "
          f"{ {s: t for s, t in by_speed.items()} }; modelled fleet spend "
          f"{alloc.allocation.spent:.4f} us/record against a budget of "
          f"{budget:.4f}; makespan {coord.makespan:.2f} (no stealing)")
    print(f"  store: rows per shard {[s.stats.n_records for s in store.shards]}"
          f", per (epoch, tier) {dict(sorted(store.group_records.items()))}; "
          f"{len(queries)} queries scanned in {t_scan:.3f} s (first pass)")
    if new is None:
        raise AssertionError("the replanner kept the family under a "
                             "drifted workload")
    print(f"  replan: epoch {store.epoch} on every shard "
          f"({sorted({s.plan.epoch for s in store.shards})}), tier sizes "
          f"{new.tier_sizes}, clients re-tiered to {retier}; one chunk "
          f"ingested under the new epoch")
    print(f"  launches in this phase: {launches} ({a_fleet} pushdown "
          f"launches during the fleet's ingest)")
    for sid, tier, n_rows, _ in made[:-1]:
        if tier != tiers[sid] or n_rows != family.tier_sizes[tier]:
            raise AssertionError(f"client {sid} ran tier {tier} "
                                 f"({n_rows} clauses), assigned "
                                 f"{tiers[sid]}")
    if not alloc.allocation.feasible or len(set(tiers)) < 2:
        raise AssertionError(f"allocation {alloc.allocation}")
    if store.epoch != 1 or any(s.plan.epoch != 1 for s in store.shards):
        raise AssertionError("the epoch did not reach every shard")
    if min(launches.values()) < 1 or a_fleet < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    t0 = time.perf_counter()
    want = baseline_counts([chunk for *_, chunk in made[:-1]], queries)
    extra = FullScanBaseline()
    extra.ingest_chunk(made[-1][3])
    t_base = time.perf_counter() - t0
    if got != want:
        raise AssertionError("fleet store's device scan != FullScanBaseline")
    if after != [w + extra.scan(q).count for q, w in zip(queries, want)]:
        raise AssertionError("after the replan: device scan != "
                             "FullScanBaseline")
    print(f"  every client's chunks at its assigned tier; {len(queries)} "
          f"counts equal to FullScanBaseline over the fleet's "
          f"{n_made - made[-1][3].n_records} records, and again after the "
          f"replan's chunk (baseline {t_base:.1f} s)")
    return {"launches": launches, "pushdown_fleet": a_fleet,
            "tiers": tiers, "spent": alloc.allocation.spent,
            "budget": budget, "run_s": t_run, "scan_s": t_scan}


#: the tuner phase's store: the first TUNER_RECORDS of the main path's
#: records (all of them where ``--records`` is smaller)
TUNER_RECORDS = 1 << 18
#: the tuner's panels (the JAX package's benchmarks/bench_tuner.py):
#: point lookups on the routing key, then on the key the workload
#: drifts onto
PANEL_A = ("linear_score", 2, 97)
PANEL_B = ("visits", 5, 990)


def _latencies(readers) -> dict:
    """p50/p99 (µs) and call count over some readers' calls."""
    from repro_torch.benchmarks.bench_serve import pcts
    lat = [x for r in readers for x in r.lat]
    p50, p99 = pcts(lat)
    return {"calls": len(lat), "p50_us": p50, "p99_us": p99}


def store_serving(run, dev) -> dict:
    """The store's serving plane under live ingest: a fresh 4-shard
    ShardedCiaoStore, range-routed as the sharded plane is, wrapped in
    CiaoServeEngine(device_backend="cuda", result_cache=ResultCache())
    with the reference defaults (queue depth 64, one writer per shard,
    a 0.02 s snapshot refresh, blocking backpressure).  One feeder
    evaluates each of the main path's chunks with kernel A just before
    ``ingest_chunk``; four readers loop over the 200 zipf queries until it
    is done: two in device mode (kernel B over each snapshot's plane), one
    in host mode, one through ``query_batch`` in slices of 64.  Every live
    count is at most the main path's, and a live device reader launched
    kernel B; after ``quiesce()`` every query in host, batch and device
    mode equals the main path's count and device equals host in full
    accounting."""
    import torch
    from repro_torch.benchmarks.bench_serve import (
        Reader, bundle_report, live_ingest, run_readers,
    )
    from repro_torch.core import device_scan
    from repro_torch.core.batch_scan import ResultCache
    from repro_torch.core.shard import (
        ShardedCiaoStore, ShardRouter, choose_routing_key,
    )
    from repro_torch.kernels import fused, scan_fused
    from repro_torch.serve.store_engine import CiaoServeEngine

    chunks, plan, engine = run["chunks"], run["plan"], run["engine"]
    queries = run["queries"]
    want = [r.count for r in run["results"]]
    objs = [json.loads(chunks[0].record(i)) for i in range(800)]
    router = ShardRouter.from_samples(4, choose_routing_key(plan), objs)
    bvs = []

    def evaluate(chunk, tier):
        """kernel A, in the feeder, just before the submit"""
        bv = engine.eval_fused(chunk, plan.clauses)
        bvs.append(bv)
        return bv

    b_calls: dict[str, int] = {}
    lock = threading.Lock()
    scan_counts = device_scan.scan_counts

    def noted(*args, **kw):
        """kernel B's wrapper, noting the calling thread"""
        name = threading.current_thread().name
        with lock:
            b_calls[name] = b_calls.get(name, 0) + 1
        return scan_counts(*args, **kw)

    def readers(tag: str, min_loops: int) -> list:
        return [Reader(serve, queries, ("device",), min_loops=min_loops,
                       name=f"{tag}-device-0"),
                Reader(serve, queries, ("device",), min_loops=min_loops,
                       name=f"{tag}-device-1"),
                Reader(serve, queries, ("host",), min_loops=min_loops,
                       name=f"{tag}-host"),
                Reader(serve, queries, batch=64, min_loops=min_loops,
                       name=f"{tag}-batch")]

    store = ShardedCiaoStore(plan, router=router)
    # ---- store serving: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    serve = CiaoServeEngine(store, device_backend="cuda",
                            result_cache=ResultCache())
    device_scan.scan_counts = noted
    try:
        live_readers = readers("live", 1)
        live = live_ingest(serve, [(c, None, None) for c in chunks],
                           live_readers, evaluate=evaluate)
        bundles = bundle_report(serve.stats_report()["snapshots"])
        b_live = scan_fused.launches
        peak_live = torch.cuda.max_memory_allocated()
        quiesced = run_readers(readers("quiesced", 2))
        t0 = time.perf_counter()
        res = {m: [serve.query(q, mode=m) for q in queries]
               for m in ("host", "batch", "device")}
        t_check = time.perf_counter() - t0
        rep = serve.stats_report()["engine"]
    finally:
        device_scan.scan_counts = scan_counts
        serve.close()
    launches = {"pushdown": fused.launches, "scan": scan_fused.launches}
    peak = torch.cuda.max_memory_allocated()
    # -----------------------------------------------------------------------
    n = len(chunks)
    per = bundles["per_device_bundle"]
    print(f"  engine: {rep['writers']} writers, queue depth 64, refresh "
          f"0.02 s; {rep['submitted']} chunks submitted, {rep['enqueued']} "
          f"slices enqueued, {rep['drained']} drained, {rep['errors']} "
          f"errors")
    print(f"  ingest through the engine: {live['wall_s'] / n * 1e3:.3f} ms "
          f"per chunk to quiesced ({live['feed_s'] / n * 1e3:.3f} ms per "
          f"submit, of which kernel A {live['eval_s'] / n * 1e3:.3f}); "
          f"blocked {rep['blocked_s']:.3f} s on full queues")
    print(f"  snapshot bundles built during ingest: {bundles['bundles']} "
          f"(capture, the shard locks' wait included: mean "
          f"{bundles['capture_s'] / max(1, bundles['bundles']) * 1e3:.1f} "
          f"ms, max {bundles['capture_max_s'] * 1e3:.1f}), "
          f"{bundles['device_bundles']} with a device scanner; per device "
          f"bundle {per['uploads']:.1f} uploads, {per['upload_mib']:.2f} "
          f"MiB, {per['sync_ms']:.2f} ms host in sync (totals "
          f"{bundles['uploads']} uploads, {bundles['upload_mib']:.1f} MiB, "
          f"{bundles['sync_s'] * 1e3:.1f} ms)")
    lat = {"live": {}, "quiesced": {}}
    for tag, rs in (("live", live_readers), ("quiesced", quiesced)):
        for mode, group in (("device", rs[:2]), ("host", rs[2:3]),
                            ("batch64", rs[3:])):
            lat[tag][mode] = _latencies(group)
        print(f"  {tag} latency, p50 / p99 ms: " + ", ".join(
            f"{m} {v['p50_us'] / 1e3:.3f} / {v['p99_us'] / 1e3:.3f} "
            f"({v['calls']} calls)" for m, v in lat[tag].items()))
    print(f"  peak memory: {peak_live / 2**30:.2f} GiB during ingest, "
          f"{peak / 2**30:.2f} GiB over the phase; quiesced checks "
          f"{t_check:.1f} s")
    print(f"  launches in this phase: {launches} (B {b_live} during ingest;"
          f" by thread {dict(sorted(b_calls.items()))})")
    for r in live_readers:
        for qi, (_, hi) in r.counts.items():
            if hi > want[qi]:
                raise AssertionError(f"live {r.name}: {hi} > final "
                                     f"{want[qi]}: {queries[qi].describe()}")
    if rep["errors"] or rep["drained"] != rep["enqueued"] or \
            rep["submitted"] != n:
        raise AssertionError(f"engine counters: {rep}")
    for m, rs in res.items():
        if [r.count for r in rs] != want:
            raise AssertionError(f"quiesced {m} counts != the main path's")
    for q, d, h in zip(queries, res["device"], res["host"]):
        if full_accounting(d) != full_accounting(h):
            raise AssertionError(f"quiesced device != host: {q.describe()}")
    if fused.launches != n:
        raise AssertionError(f"{fused.launches} pushdown launches for {n} "
                             f"chunks")
    if scan_fused.launches != sum(b_calls.values()):
        raise AssertionError(f"scan launches {scan_fused.launches} != "
                             f"{sum(b_calls.values())} wrapper calls")
    b_live_readers = sum(v for k, v in b_calls.items()
                         if k.startswith("live-device-"))
    if not b_live_readers:
        raise AssertionError(f"no live device reader launched B: {b_calls}")
    print(f"  every live count <= its final count; kernel B launched "
          f"{b_live_readers} times by the live device readers; "
          f"{len(queries)} quiesced queries equal to the main path's in "
          f"host, batch and device mode, device == host in full accounting")
    return {"launches": launches, "b_live": b_live, "b_calls": b_calls,
            "router": router, "bvs": bvs, "live": live,
            "bundles": bundles, "latency": lat, "peak_live": peak_live,
            "peak": peak, "blocked_s": rep["blocked_s"]}


def online_tuner(run, serving, dev, n_records: int, oracle) -> dict:
    """The tuner after a workload drift (the JAX package's
    benchmarks/bench_tuner.py): a 4-shard store range-routed on
    linear_score, the first ``n_records`` of the store-serving phase's
    chunks with their bitvectors; panel A (8 point lookups on
    linear_score), then panel B (8 on visits) on the stale layout, whose
    scans feed the query log; then CiaoServeEngine.start_tuner(
    PhysicalDesignTuner(store), interval_s=0.02) while four device-mode
    readers answer panel B until the migration finishes; then panel B
    again.  Counts are held to FullScanBaseline (``oracle``, counted in
    other processes) in every phase."""
    import torch
    from repro_torch.benchmarks import bench_tuner as bt
    from repro_torch.benchmarks.bench_serve import bundle_report
    from repro_torch.core.shard import ShardedCiaoStore, ShardedScanner
    from repro_torch.core.tuner import PhysicalDesignTuner
    from repro_torch.kernels import fused, scan_fused
    from repro_torch.serve.store_engine import CiaoServeEngine

    n = n_records // CHUNK
    store = ShardedCiaoStore(run["plan"], router=serving["router"])
    for chunk, bv in zip(run["chunks"][:n], serving["bvs"][:n]):
        store.ingest_chunk(chunk, bv)
    panel_a, panel_b = bt.panel(*PANEL_A), bt.panel(*PANEL_B)
    want = finish_baseline(oracle)
    want_a, want_b = want[:len(panel_a)], want[len(panel_a):]
    split = {}
    # ---- the tuner: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    first = bt.timed_panel(store, panel_a + panel_b, want, passes=1)
    t_first = time.perf_counter() - t0
    before = bt.timed_panel(store, panel_a, want_a, passes=6)
    post_drift = bt.timed_panel(store, panel_b, want_b, passes=6)
    serve = CiaoServeEngine(store, device_backend="cuda")
    try:
        def note_split(tag: str) -> None:
            split[tag] = bt.plane_split(serve.snapshot(), dev)

        tuner = PhysicalDesignTuner(store)
        mig = bt.migrate_under_readers(
            serve, tuner, panel_b, want_b, modes=("device",),
            query_threads=4, quiesced_s=1.0, interval_s=0.02,
            before_tuner=lambda: note_split("before"))
        bundles = bundle_report(serve.stats_report()["snapshots"])
        b_during = scan_fused.launches
        serve.quiesce()
        after_dev = [serve.query(q, mode="device").count for q in panel_b]
        note_split("after")
        b_after = scan_fused.launches - b_during
        errors = serve.stats_report()["engine"]["errors"]
    finally:
        serve.close()
    after = bt.timed_panel(store, panel_b, want_b, passes=6)
    probe_scan = ShardedScanner(store, log_queries=False, telemetry=False)
    pruned = sum(probe_scan.scan(q).shards_pruned for q in panel_b)
    launches = {"pushdown": fused.launches, "scan": scan_fused.launches}
    peak = torch.cuda.max_memory_allocated()
    t_phase = time.perf_counter() - t_phase
    # -----------------------------------------------------------------------
    m = tuner.migration
    recovery = after["qps"] / post_drift["qps"]
    q99, d99 = mig["quiesced"]["p99_us"], mig["during"]["p99_us"]
    print(f"  store: {store.stats.n_records} records in 4 shards, routed on "
          f"{PANEL_A[0]!r}; first pass of both panels {t_first:.1f} s "
          f"(raw promotion, columns, zone maps)")
    print(f"  qps (host, one thread, 6 passes of 8): before (panel A) "
          f"{before['qps']:.1f}, post-drift (panel B) "
          f"{post_drift['qps']:.1f}, after {after['qps']:.1f}; recovery "
          f"{recovery:.3f}x")
    print(f"  tuner: {[e.describe() for e in tuner.history]}")
    print(f"  migration: {m.rows_moved} rows moved, {m.rows_kept} kept, "
          f"{m.segments_moved} items, {m.batches} batches in "
          f"{mig['migrate_s']:.1f} s; shards pruned after: {pruned} over "
          f"panel B")
    print(f"  device readers (4): p99 {d99 / 1e3:.3f} ms during the "
          f"migration ({mig['during']['queries']} queries) against "
          f"{q99 / 1e3:.3f} ms quiesced ({mig['quiesced']['queries']}), "
          f"{d99 / q99:.2f}x; p50 {mig['during']['p50_us'] / 1e3:.3f} / "
          f"{mig['quiesced']['p50_us'] / 1e3:.3f} ms")
    print(f"  rows on kernel B / host fallback: before the retune "
          f"{split['before']}, after {split['after']}")
    print(f"  snapshot bundles over the readers' phases: {bundles}")
    print(f"  peak memory {peak / 2**30:.2f} GiB; launches in this phase: "
          f"{launches} (B {b_during} through the migration, {b_after} "
          f"after); phase {t_phase:.1f} s")
    if not (first["counts_match"] and before["counts_match"]
            and post_drift["counts_match"] and after["counts_match"]
            and mig["counts_match"] and after_dev == want_b):
        raise AssertionError("a tuner-phase count != FullScanBaseline")
    if store.router.key != PANEL_B[0]:
        raise AssertionError(f"router key {store.router.key!r}")
    if m.batches < 2 or m.rows_moved <= 0:
        raise AssertionError(f"migration not incremental: {m.batches} "
                             f"batches, {m.rows_moved} rows moved")
    if pruned <= 0 or errors:
        raise AssertionError(f"{pruned} shards pruned after, {errors} "
                             f"engine errors")
    if b_during < 1 or b_after < 1:
        raise AssertionError(f"B launches: {b_during} during, {b_after} "
                             f"after the migration")
    print(f"  counts equal to FullScanBaseline in every phase (its "
          f"{len(want)} counts from other processes)")
    return {"launches": launches, "b_during": b_during, "b_after": b_after,
            "recovery": recovery, "p99_ratio": d99 / q99, "split": split,
            "rows_moved": m.rows_moved, "batches": m.batches,
            "phase_s": t_phase, "peak": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=1 << 20,
                    help="main-path records, a multiple of 8192")
    args = ap.parse_args(argv)
    if args.records < CHUNK or args.records % CHUNK:
        ap.error("--records must be a positive multiple of 8192")
    tuner_records = min(TUNER_RECORDS, args.records)
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
    check_scan_routes(DeviceScanner(store, backend="cuda", log_queries=False),
                      qs)
    phase(f"main path: {args.records} records")
    run = main_path(args.records, dev)
    phase("kernels C/D/E: reduce, match, key-value vs plain versions")
    check_split_kernels(dev)
    phase("kernel C around its launches: floor, calls, device operations, "
          "probe")
    reduce = reduce_numbers(dev)
    phase("split path: (a) split vs fused, (b) split ingest + hooked scan")
    split = split_path(run, dev)
    phase("wide scan batch: 200 uniform queries in one DeviceScanner batch")
    scan = wide_batch(run, dev)
    # every profiler timing comes before the serve path: in this script's
    # runs, traces that recorded no launch of their kernel (up to five in
    # a row, a second apart) came only after the model had served
    phase("kernels at main-path shapes")
    rows = (kernel_table(run, scan, dev)
            + split_kernel_rows(run, split, dev, reduce))
    f_timing = flash_timing(dev)
    phase("sharded plane: the main path's records in 4 shards")
    t0 = time.perf_counter()
    sharded = sharded_plane(run, dev)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase("client fleet: 13 clients, one budget, 4 shards, one replan")
    t0 = time.perf_counter()
    fleet = client_fleet(dev)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    from repro_torch.benchmarks.bench_tuner import panel
    # the tuner phase's oracle, counted in other processes meanwhile
    oracle = start_baseline(run["chunks"][:tuner_records // CHUNK],
                            panel(*PANEL_A) + panel(*PANEL_B))
    try:
        phase("store serving: CiaoServeEngine, live ingest + device scans")
        t0 = time.perf_counter()
        serving = store_serving(run, dev)
        print(f"  phase {time.perf_counter() - t0:.1f} s")
        phase(f"online tuner: drift to 'visits', migration under device "
              f"readers ({tuner_records} records)")
        t0 = time.perf_counter()
        tuned = online_tuner(run, serving, dev, tuner_records, oracle)
        print(f"  phase {time.perf_counter() - t0:.1f} s")
    finally:
        oracle[0].shutdown(cancel_futures=True)
    phase("kernel F: flash attention vs plain version")
    check_flash(dev)
    phase(f"serve path: {' '.join(SERVE_ARGS)}")
    serve = serve_path(dev)
    phase("serve path breakdown: one prefill, one decode step (profiler)")
    serve_breakdown(dev)
    phase("exactness at full width: forward vs prefill + decode (f32)")
    exactness_f32(dev)
    rows.append(flash_row(f_timing, serve))
    # launches on this slice's paths, each read from its own phase
    rows[0]["launches_client_fleet"] = fleet["launches"]["pushdown"]
    rows[1]["launches_sharded_plane"] = sharded["launches"]["scan"]
    rows[1]["launches_client_fleet"] = fleet["launches"]["scan"]
    for r, k in ((rows[0], "pushdown"), (rows[1], "scan")):
        r["launches_store_serving"] = serving["launches"][k]
        r["launches_tuner"] = tuned["launches"][k]
    c_row = next(r for r in rows if r["name"].startswith("bitvector_reduce"))
    c_row["launches_sharded_plane"] = sharded["launches"]["reduce"]
    c_row["launches_sharded_plane_by"] = {
        "ShardedScanner hook, range store": sharded["reduce_hook"],
        "ScanBatcher hook, range store": sharded["reduce_batcher"],
        "ShardedScanner hook from its pool, hash store":
            sharded["reduce_pool"]}
    for r in rows:
        lib = "" if r["library_ms"] is None else \
            f"; library {r['library_ms']:.4f} ms"
        if "tflop_per_s" in r:
            lib += (f" ({r['ms_over_library']:.2f}x); {r['tflop_per_s']:.1f} "
                    f"TFLOP/s, {r['bound_share']:.1%} of the bound")
        print(f"  {r['name']}: {r['ms']:.4f} ms ({r['ms_from']}; whole "
              f"wrapper call {r['wrapper_call_ms']:.4f} ms; plain "
              f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}{lib}; {r['launches']} launches on the path) "
              f"at {r['shape']}")
    from repro_torch.benchmarks import bench_reduce
    print(f"  profiler traces retried, no record of the kernel in them: "
          f"{bench_reduce.missed or 'none'}")
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
