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
DeviceScanner("cuda").scan_batch on a 16,384-record prefix store of the
main path's chunks (512 term and clause slots, 256 queries; kernel B),
checked against the host scanner and FullScanBaseline.

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
against FullScanBaseline.  With one card and no process group,
scan_mesh(4) is None and ShardedDeviceScanner(spmd=True), which places
shard r on rank r, refuses to run.  Then the client fleet, the paper's different
budgets for different clients:

  one ycsb PlanFamily of nested tiers (build_plan_family)
    -> 13 ClientShards (speeds 4.0 x1, 1.0 x4, 0.25 x8), each with its
       own KernelEngine("cuda") and seed              [kernel A, per tier]
    -> FleetTierAllocator: one global budget split over the clients
    -> IngestCoordinator -> ShardedCiaoStore, 4 shards, chunks of 8,192
    -> ShardedDeviceScanner("cuda")                    [kernel B]
    -> one Replanner step over the sharded store, a chunk at the new epoch

at 1 chunk per client (the clients make their records in this process),
every client's chunks at its assigned tier and every count equal to
FullScanBaseline, before and after the replan.  Then the paper's own
evaluation, Figs 3-5 at 1.0 us/record (repro_torch.benchmarks):

  the 9 dataset x workload cells (winlog, yelp, ycsb x A, B, C), 10,000
  records and 60 queries each, through run_end_to_end
    -> KernelEngine("cuda") on every 1,000-record chunk     [kernel A]
    -> CiaoStore partial load, DataSkippingScanner (host)
    -> DeviceScanner("cuda"), first and steady pass         [kernel B]

every chunk's bitvectors bit-equal to NumpyEngine's, every count equal to
FullScanBaseline's in host and device mode, the loading, query, end-to-end
and overlapped speedups printed per cell; then bench_device at its quick
size, its correctness gates held.  Then the store's serving plane and its
online tuner:

  CiaoServeEngine(ShardedCiaoStore, 4 range shards, device_backend="cuda",
                  result_cache=ResultCache())
    <- one feeder: the main path's 128 chunks, each through
       KernelEngine("cuda") just before ingest_chunk      [kernel A]
    -> four readers over the 200 zipf queries while it runs: two in
       device mode (ShardedDeviceScanner per snapshot)    [kernel B]
       one in host mode, one through query_batch (64)
  PhysicalDesignTuner, driven by CiaoServeEngine.start_tuner, on a
  4-shard store of the first 131,072 records (TUNER_RECORDS): panel A
  (linear_score), panel B (visits) on the stale layout, the migration to
  visits under four device-mode readers                   [kernel B]

every live count at most its final count, every quiesced count equal to
the main path's in host, batch and device mode (device == host in full
accounting), and every tuner-phase count equal to FullScanBaseline.

Then kernel F (flash attention, csrc/flash_attention.cu) against its plain
version on the TPU test shapes, the serving shape, unmasked, Sq != Sk and
ragged S, d 192 (v at 192 and at MLA's 128) and 256, in f32 (the SIMT
route) and bf16 (the tensor-core routes, also against their own
numerics, ref.flash_attention_ref_bf16p), and the model-serving path at
full width:

  repro_torch.launch.serve.main(["--arch", "qwen3-1.7b", "--batch", "8",
                                 "--prompt-len", "512", "--gen", "32"])
    -> 28 dense layers (d 2048, 16/8 heads of 128, d_ff 6144, V 151,936),
       seeded random weights, eight ycsb records as prompts
    -> prefill: every layer's attention on kernel F
    -> 32 greedy decode steps (plain decode attention)

checked by (i) layer 0's q, k, v captured from the serving prefill, F's
output against the plain version, and (ii) in f32, forward logits at
position S-1 against prefill(S-1) + one decode step (B=2, S=128).  Then
MoE, MLA and vision serving at published widths, each cut to 4 layers:

  llama4-scout-17b-a16e (16 experts top-1 + shared) and deepseek-v3-671b
  (MLA, 3 dense + 1 MoE layer of 256 experts top-8 + shared) through
  launch.serve.main, internvl2-76b with 1,024 seeded patch embeddings
  through make_serve_fns; batch 8, prompt 512, 32 greedy tokens
    -> prefill: every attention layer on kernel F (deepseek-v3: qk head
       dim 192, v at its own 128, on flash_kernel_wgmma)
    -> the MoE layers: models/moe.py (routing, dispatch, experts)

checked by (i) F on layer 0 against its plain version (deepseek-v3's v
and o 128 wide: no padded copy), (ii) the first MoE layer's routing on
the card against the CPU's from the same f32 logits and its f32 output
against a per-expert loop, (iii) forward against prefill + decode in f32
at 2 layers; each prefill's device time by kind from the profiler.

Then the recurrent, hybrid and encoder-decoder families at published
widths:

  recurrentgemma-9b cut to 8 layers (two rec, rec, attn periods and the
  rec, rec remainder; batch 2, prompt 2,560, 16 tokens) and rwkv6-3b (32
  layers; batch 4, prompt 64, 32 tokens) through launch.serve.main,
  seamless-m4t-medium (12 + 12 layers, 1,024 seeded frames, 128 target
  tokens, 32 generated) through make_serve_fns
    -> recurrentgemma's local layers on kernel F's band (window 2,048,
       head dim 256; the prompt runs past the window and the 2,176-slot
       ring), its RG-LRU scans and RWKV's time loops as PyTorch ops
    -> seamless: F unmasked over the frames, causal in the decoder,
       unmasked with Sq != Sk for cross attention

checked by (i) F's first call of each form against its plain version,
(iii) forward against prefill + decode in f32 at 3, 2 and 2 + 2 layers;
each prefill's device time by kind, and the recurrences' time between
CUDA events.  Kernel F's band is also timed at recurrentgemma's prefill
shape beside SDPA with a boolean band mask, with the ptxas registers and
spills of the d = 256 instances.

Then the training path, kernel F under a gradient (its forward, then the
plain version's recompute under autograd in the backward):

  (1) qwen3-1.7b at full width and 2 layers, f32 and bf16: Model.loss and
      every gradient through F's autograd Function against autograd over
      the plain version; every gradient finite and non-zero, the routes
      within F's forward bounds of each leaf's max |g|;
  (2) repro_torch.launch.train.main(["--arch", "qwen3-1.7b", "--batch",
      "8", "--seq", "256", "--steps", "8"]): CIAO ingest (NumpyEngine
      clients, work stealing), recipe batches, 28 layers with f32 master
      parameters, bf16 compute, each layer checkpointed, AdamW; every loss
      finite, every parameter leaf changed, F launched twice per layer per
      step (the forward and the recompute); step ms, tokens/s, MFU, peak
      memory;
  (3) tests/test_train.py's crash at step 6 and resume to step 10, at the
      reduced config, with the checkpoints in a temporary directory.

Then every other family trained at published width, cut in depth
(llama4-scout 2 MoE layers, deepseek-v3 one dense and one MoE layer of
256 experts, internvl2 2 layers over 1,024 patch embeddings,
recurrentgemma one rec, rec, attn period, rwkv6 2 layers, seamless 2 + 2
layers; batch 8, S 256):

  (1) Model.loss and every gradient in bf16 through F's autograd
      Function (d 128; 192 with v at 128; 256 on the band; unmasked over
      the frames and across at Sq != Sk) against autograd over the plain
      version, the MoE's top-k choice replayed from the first route;
      every gradient finite and non-zero, within F's bf16 bound of each
      leaf's max |g|, F's launches those of the forward and the recompute;
  (2) one train step from train_step.make_train_step (adafactor for the
      bf16-parameter archs, AdamW for the others), timed on the host
      clock, against analysis.flops.estimate's bound.

Then the model mesh, the remat policies, the roofline and the dry run:

  (1) an NCCL process group of one rank (a HashStore) and a (1, 1) mesh:
      repro_torch.launch.serve.main([... "--mesh-shape", "1,1"]) with the
      serve path's arguments, DTensor parameters, activations and cache,
      every layer's attention under local_map on kernel F; the greedy
      tokens equal the serve path's run without a mesh, 28 F launches per
      prefill;
  (2) qwen3-1.7b at full width cut to 4 layers on the mesh against the
      same model without one: every leaf's f32 gradient within 2e-5 of
      its max |g|, then two bf16 train steps with grad_specs, each loss
      and every leaf after them within tests/test_dist.py's 5e-3; F's
      launches counted over the mesh steps alone, 16 (4 layers x 2 steps,
      the forward and the recompute);
  (3) the remat policies at 2 layers at full width in f32: the grads
      under "dots" and "save_block_io" (and "none") within 2e-5 of each
      leaf's max |g| of "full", and each policy's peak memory;
  (4) the serve path's prefill and decode step and the training step
      against analysis.flops.estimate at the H100's constants
      (analysis.roofline), beside the MFU line; kernel B's main-batch
      launch against its bytes bound, with scan_estimate's figure (the
      reference's jnp traffic, not a bound on B) beside it;
  (5) python -m repro_torch.launch.dryrun over a fake world of 256 for
      qwen3-1.7b x train_4k and deepseek-v3-671b x prefill_32k (mesh
      single), each record read back, and qwen3-1.7b x decode_32k, which
      reaches the flash-decoding stub as the JAX package's does; these
      run in their own processes on the host meanwhile.

Kernel A is also held to one launch per eval_fused call (a 41-record
chunk, tests/test_fused.py's mixed plan).  Kernel C is also held at
contiguous row slices off 16 bytes, rows 4-12
bytes past 16 at W % 4 == 0, the one-block width +- 1 and a bytes-bound
probe (P=12, W=2,097,152; not a path shape), and measured around its
launches: the launch floor (an empty kernel of its block size), the whole
ops.reduce_bitvectors call on the host clock, the device operations per
call from the profiler (exactly one kernel per bitvector_reduce call, and
one upload, one kernel and one copy back per reduce_bitvectors call, or
the run fails) and the probe beside its bytes bound.

Kernel times come from the profiler.  Where five traces in a row record
no device activity at all, the profiler is taken as lost: that time
comes from CUDA events around the calls (the row's ms_from says so), and
device-operation counts and breakdowns print "not measured".

Any mismatch or fault raises (exit code != 0).

    python3 chip_smoke.py                  # one CUDA card, full size
    python3 chip_smoke.py --records 65536  # a shorter rehearsal

Output: phase lines, then the card's name and power limit
(``nvidia-smi``), a JSON kernel table, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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
NOT_TRACED = "not measured (the profiler recorded no device activity)"
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
# kernel F's backward (bf16, (128, 128)) against its own numerics
# (ref.flash_attention_bwd_ref_bf16p): max |got - want| / max |want| of
# each of dq, dk and dv.  Both round P and dS to bf16 as the operands of
# their products; they differ in the order of f32 sums (which can flip a
# rounding of P or dS), the kernel's ex2.approx and the gradient's one
# rounding to bf16 (2^-9 of an element); 0.0016-0.0036 on the first card
# runs.  The forward's row log-sum-exp against its oracle: f32 in another
# order, |lse| under 20 at these shapes
FLASH_BWD_TOL = 1e-2
FLASH_LSE_TOL = 1e-4
# (B, H, Hkv, Sq, Sk, causal, window[, "slice"]) of the backward check at
# d 128: qwen3's train shape first; G 1, 2 and 8, ragged, unmasked with
# Sq != Sk, causal with Sq < Sk (keys past Sq get no gradient), the band
# (window 2: each row sees two keys), q, k and v as column slices of one
# projection
FLASH_BWD_CASES = (
    (8, 16, 8, 2048, 2048, True, 0), (1, 2, 2, 64, 64, True, 0),
    (2, 4, 2, 300, 300, True, 0), (2, 4, 2, 200, 333, False, 0),
    (2, 4, 2, 333, 200, False, 0), (1, 8, 1, 257, 257, True, 0),
    (1, 4, 2, 100, 300, True, 0), (1, 4, 1, 1000, 1000, True, 300),
    (1, 4, 2, 700, 700, True, 2), (2, 16, 8, 300, 300, True, 0, "slice"))
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


#: (phase, its start on the script's clock), in order
_PHASES: list = []


def phase(name: str) -> None:
    _PHASES.append((name, time.perf_counter() - _T0))
    print(f"== {name} (at {_PHASES[-1][1]:.1f} s)", flush=True)


def phase_seconds() -> None:
    """Every phase's seconds, to the end of the script."""
    ends = [t for _, t in _PHASES[1:]] + [time.perf_counter() - _T0]
    print("  seconds by phase: " + "; ".join(
        f"{name.split(':')[0]} {end - start:.1f}"
        for (name, start), end in zip(_PHASES, ends)))


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
    from the profiler's CUDA activity (kernel time alone), or between CUDA
    events where the profiler was lost (:func:`ms_from`)."""
    from repro_torch.benchmarks import bench_reduce
    return bench_reduce.kernel_ms(fn, reps, name)


def ms_from(name: str) -> str:
    from repro_torch.benchmarks import bench_reduce
    return bench_reduce.ms_from(name)


def profiled(fn, mark: str):
    """The profiler (CPU and CUDA) around one call of ``fn``, retried as
    :func:`repro_torch.benchmarks.bench_reduce.trace` retries until a
    trace records device time of an activity named by ``mark``; None
    where the profiler was lost."""
    from torch.autograd import DeviceType
    from repro_torch.benchmarks import bench_reduce

    def found(prof) -> bool:
        return any(e.device_type == DeviceType.CUDA and mark in e.key
                   and e.self_device_time_total > 0
                   for e in prof.key_averages())

    try:
        return bench_reduce.trace(fn, 1, found, mark, cpu=True)
    except bench_reduce.ProfilerLost:
        return None


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


def one_launch_per_chunk(dev) -> int:
    """tests/test_fused.py's launch count on the card: a 41-record chunk
    and that test's mixed plan (simple and key-value terms) through
    ``KernelEngine("cuda").eval_fused`` launch kernel A once per call,
    twice for two calls, with the same words both times and the words of
    kernel A's plain version."""
    import json as json_mod

    import numpy as np
    from repro_torch.core.client import encode_chunk
    from repro_torch.core.predicates import (
        clause, exact, key_value, presence, substring,
    )
    from repro_torch.kernels import fused
    from repro_torch.kernels.engine import KernelEngine

    rng = np.random.default_rng(7)
    keys = ["name", "age", "tags", "city", "note"]
    recs = [json_mod.dumps({k: int(rng.integers(0, 30)) for k in keys
                            if rng.random() < 0.6},
                           separators=(",", ":")).encode()
            for _ in range(41)]
    chunk = encode_chunk(recs)
    clauses = [clause(exact("name", "bob"), key_value("age", 7)),
               clause(key_value("age", 11)),
               clause(substring("note", "zz"), key_value("city", 3)),
               clause(presence("tags"))]
    eng = KernelEngine("cuda", device=dev)
    before = fused.launches
    a = eng.eval_fused(chunk, clauses)
    one = fused.launches - before
    b = eng.eval_fused(chunk, clauses)
    two = fused.launches - before
    want = KernelEngine("torch").eval_fused(chunk, clauses)
    same = all(np.array_equal(getattr(x, f), getattr(want, f))
               for x in (a, b) for f in ("words", "or_words", "counts"))
    print(f"  one launch per chunk (41 seeded records, tests/test_fused.py's"
          f" 4 mixed clauses): {one} after one eval_fused, {two} after two; "
          f"words equal to the plain version's: {same}")
    if (one, two) != (1, 2) or not same:
        raise AssertionError(f"kernel A per chunk: {one}, {two} launches, "
                             f"same {same}")
    return two


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
        if got is None:         # the profiler was lost: nothing to hold
            return
        if any(got[k] != want.get(k, 0) for k in bench_reduce.KINDS):
            raise AssertionError(f"device operations per {what} call "
                                 f"{got['rows']}, want {want}")

    out = bench_reduce.measure(dev, SEED)
    for shape, r in out["shapes"].items():
        k, c = r["kernel_call_ops"], r["call_ops"]
        print(f"  reduce at {shape}: kernel {r['kernel_ms']:.5f} ms; "
              f"reduce_bitvectors call {r['call_ms']:.4f} ms (host clock); "
              f"device operations per bitvector_reduce call "
              f"{k['rows'] if k else NOT_TRACED}, per reduce_bitvectors call "
              f"{c['rows'] if c else NOT_TRACED}")
        hold(k, {"kernels": 1}, "bitvector_reduce")
        if k and not all("bitvector_reduce_kernel" in name
                         for name in k["rows"]):
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
          f"ms ({p['ms_from']}), bound {p['bound_ms']:.4f} ms by bytes "
          f"({p['bound_share']:.1%}); device ms per launch "
          f"{p['device_ms_per_launch']}")
    return out


def _zero_counters() -> None:
    from repro_torch.kernels import bitvector_ops, fused, scan_fused
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import substring_match as sm
    fused.launches = scan_fused.launches = bitvector_ops.launches = 0
    sm.match_launches = sm.kv_launches = fa.launches = 0
    _zero_flash_routes()


def _zero_flash_routes() -> None:
    """Kernel F's launches by the source's kernel, and its backwards on
    the plain recompute, to 0."""
    from repro_torch.kernels import flash_attention as fa
    for name in fa.route_launches:
        fa.route_launches[name] = 0
    fa.plain_backwards = 0


def _backward_check(what: str, cfg, n: int) -> str:
    """F's backwards since the last :func:`_zero_flash_routes`: raises
    unless all ``n`` ran the backward kernel where the wrapper sends the
    config's (qk, v) head dims in its compute dtype there (bf16 at (128,
    128): qwen3, llama4, internvl2), and all ``n`` took the plain
    recompute elsewhere (f32, MLA's (192, 128), d 256, d 64)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    if cfg.attention == "mla":
        pair = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim)
    else:
        pair = (cfg.hd(), cfg.hd())
    kernel = fa.backward_on_kernel(torch.device("cuda"),
                                   getattr(torch, cfg.compute_dtype), *pair)
    got = {name: fa.route_launches[name] for name in (
        "flash_bwd_delta", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")}
    want_k, want_p = (n, 0) if kernel else (0, n)
    if set(got.values()) != {want_k} or fa.plain_backwards != want_p:
        raise AssertionError(
            f"{what}: F's backwards {got} on the kernel, "
            f"{fa.plain_backwards} plain; want {want_k} and {want_p} "
            f"({cfg.compute_dtype} at {pair})")
    route = "the backward kernel" if kernel else "the plain recompute"
    return f"F's {n} backwards on {route} ({cfg.compute_dtype} at {pair})"


def _wgmma_check(arch: str, cfg, launches: int) -> int:
    """Kernel F's launches on ``flash_kernel_wgmma`` since the last
    :func:`_zero_flash_routes`; raises unless they are all of ``launches``
    where the wrapper sends the config's qk head dim there in bf16 (64
    seamless, 128 qwen3, llama4 and internvl2, 192 MLA, 256
    recurrentgemma) and none elsewhere (the small configs' 16 and 32, on
    ``flash_kernel_mma``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    qkd = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
           if cfg.attention == "mla" else cfg.hd())
    got = fa.route_launches["flash_kernel_wgmma"]
    on_wgmma = fa._kernel_name(torch.bfloat16, qkd) == "flash_kernel_wgmma"
    want = launches if on_wgmma else 0
    if got != want:
        raise AssertionError(f"{arch}: {got} launches of flash_kernel_wgmma"
                             f", want {want} (qk head dim {qkd})")
    return got


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
            "ms_from": ms_from(kname), "wrapper_call_ms": cuda_ms(kern, 50),
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
    d_row["ms_from"] = ms_from("multi_match_kernel")   # with these timings
    print(f"  match at phase (b)'s shape, three profiler calls: "
          f"{[round(x, 5) for x in d_row['ms_calls']]} ms")
    return rows


def check_flash(dev) -> int:
    """Kernel F against its plain versions: the TPU test shapes, the
    serving shape, internvl2's prefill, seamless's three calls at d 64,
    unmasked, Sq != Sk, ragged S (at d 128 causal with Sq != Sk too), q,
    k and v as column slices of one projection, d = 192 (v at 192 and at
    MLA's 128: its prefill shape, ragged, Sq != Sk unmasked) and 256
    (causal, ragged, unmasked), and the causal band (local attention) at
    recurrentgemma's shape and others, window 1 and window >= S
    (bit-equal to causal); f32 (SIMT route) and bf16 (tensor-core routes,
    also against their own numerics over each instance's key tile), with
    flash_kernel_mma launched at d 16 and 32; and the bf16 route's
    refusal of rows that are not 16-byte aligned."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    # B, H, Hkv, Sq, Sk, d, causal, window[, dv (default d)[, "slice": q,
    # k and v column slices of one (B, S, H + 2 Hkv, d) projection, as a
    # fused qkv matmul leaves them]]
    B8, H64, Hkv8, S1536, d128 = FLASH_VISION_SHAPE
    B4, H16, Hkv16, d64 = FLASH_ENCDEC_SHAPE
    cases = [
        (2, 4, 2, 128, 128, 64, True, 0), (1, 8, 8, 256, 256, 32, True, 0),
        (2, 4, 1, 64, 64, 128, False, 0), (1, 2, 2, 96, 96, 16, True, 0),
        (1, 2, 2, 64, 64, 32, True, 0),               # the TPU bf16 test
        (8, 16, 8, 512, 512, 128, True, 0),           # the serving shape
        (2, 16, 8, 512, 512, 128, False, 0),
        (2, 8, 4, 300, 700, 64, False, 0), (2, 8, 4, 700, 300, 64, True, 0),
        (2, 16, 8, 1000, 1000, 128, True, 0), (3, 4, 4, 77, 77, 16, False, 0),
        (2, 16, 16, 512, 512, 192, True, 0),          # d 192, v 192
        (1, 8, 8, 300, 700, 192, False, 0), (2, 4, 2, 130, 130, 192, True, 0),
        (8, 128, 128, 512, 512, 192, True, 0, 128),   # MLA's prefill, v 128
        (2, 4, 2, 130, 130, 192, True, 0, 128),       # ragged
        (1, 8, 8, 300, 700, 192, False, 0, 128),      # Sq != Sk, unmasked
        (1, 8, 8, 700, 300, 192, True, 0, 128),
        (2, 16, 1, 512, 512, 256, True, 0),           # recurrentgemma's d
        (1, 8, 2, 333, 333, 256, True, 0),            # ragged, causal
        (1, 8, 8, 300, 700, 256, False, 0),
        (1, 16, 1, 2560, 2560, 256, True, 2048),      # recurrentgemma's band
        (1, 4, 1, 1000, 1000, 256, True, 300),        # ragged band
        (2, 8, 2, 700, 700, 64, True, 128), (1, 4, 1, 300, 300, 256, True, 37),
        (1, 4, 2, 200, 200, 64, True, 1),             # each row sees itself
        (1, 4, 2, 77, 77, 256, True, 1),
        (1, 4, 2, 150, 150, 128, True, 4096),         # window >= S: causal
        (1, 4, 1, 150, 150, 256, True, 4096),
        (B8, H64, Hkv8, S1536, S1536, d128, True, 0),  # internvl2's prefill
        *((B4, H16, Hkv16, sq, sk, d64, causal, 0)     # seamless's calls
          for _, sq, sk, causal in FLASH_ENCDEC_CALLS),
        (2, 8, 2, 333, 517, 128, True, 0),            # ragged, Sq != Sk
        (2, 16, 8, 300, 300, 128, True, 0, 128, "slice"),
    ]
    worst = {"bf16p": 0.0}
    bf16p = {}                  # the bf16p check's worst, by (d, dv)
    mma = fa.route_launches["flash_kernel_mma"]
    for i, (B, H, Hkv, Sq, Sk, d, causal, window, *rest) in enumerate(cases):
        dv = rest[0] if rest else d
        sliced = rest[1:] == ["slice"]
        rng = np.random.default_rng(100 + i)
        if sliced:
            qkv = torch.from_numpy(rng.normal(size=(
                B, Sq, H + 2 * Hkv, d)).astype(np.float32)).to(dev)
            cuts = (slice(0, H), slice(H, H + Hkv), slice(H + Hkv, None))
        else:
            base = [torch.from_numpy(rng.normal(size=(B, S, h, w)).astype(
                np.float32)).to(dev)
                for S, h, w in ((Sq, H, d), (Sk, Hkv, d), (Sk, Hkv, dv))]
        shape = (f"B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} d={d} dv={dv} "
                 f"causal={causal} window={window}"
                 + (" (column slices)" if sliced else ""))
        for name, tol in FLASH_TOL.items():
            # (B, S, heads, d) handed over transposed, as the model does
            if sliced:
                cast = qkv.to(getattr(torch, name))
                q, k, v = (cast[:, :, c].transpose(1, 2) for c in cuts)
                if k.is_contiguous() or k.stride(2) != (H + 2 * Hkv) * d:
                    raise AssertionError("the slices came out dense")
            else:
                q, k, v = (a.to(getattr(torch, name)).transpose(1, 2)
                           for a in base)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if (not (err <= tol) or got.dtype != q.dtype
                    or got.shape != (B, H, Sq, dv)):
                raise AssertionError(
                    f"flash kernel != plain version: {name} {shape}: max "
                    f"abs err {err} > {tol} (or out {tuple(got.shape)})")
            worst[name] = max(worst.get(name, 0.0), err)
            if window >= Sq and not torch.equal(
                    got, fa.flash_attention(q, k, v, causal=True)):
                raise AssertionError(f"flash kernel: {name} {shape}: a "
                                     f"window past S != causal")
            if name == "bfloat16":
                want = ref.flash_attention_ref_bf16p(q, k, v, causal=causal,
                                                     window=window)
                rel = float(((got.float() - want.float()).abs()
                             / want.float().abs().clamp(min=1.0)).max())
                if not (rel <= FLASH_BF16P_TOL):
                    raise AssertionError(
                        f"flash kernel != its bf16 numerics: {shape}: "
                        f"{rel} > {FLASH_BF16P_TOL}")
                worst["bf16p"] = max(worst["bf16p"], rel)
                bf16p[(d, dv)] = max(bf16p.get((d, dv), 0.0), rel)
    mma = fa.route_launches["flash_kernel_mma"] - mma
    want_mma = sum(1 for c in cases if fa._kernel_name(
        torch.bfloat16, c[5]) == "flash_kernel_mma")
    if not mma or mma != want_mma:
        raise AssertionError(f"flash_kernel_mma launched {mma} times, want "
                             f"{want_mma}, one a bf16 case at d 16 or 32")
    print(f"  flash_kernel_mma checked at d 16 and 32: {mma} launches")
    print(f"  {len(cases)} shapes ({sum(1 for c in cases if c[7])} with a "
          f"band, {sum(1 for c in cases if c[5] == 256)} at d = 256, "
          f"{sum(1 for c in cases if c[8:] == (128,))} at MLA's (192, "
          f"128)): max "
          f"abs err vs plain f32 {worst['float32']:.3g} (tol "
          f"{FLASH_TOL['float32']}), bf16 {worst['bfloat16']:.3g} (tol "
          f"{FLASH_TOL['bfloat16']}); bf16 vs ref.flash_attention_ref_bf16p "
          f"{worst['bf16p']:.3g} of max(1, |o|) (tol {FLASH_BF16P_TOL:.3g}); "
          f"window >= S bit-equal to causal on both routes")
    print("  bf16 vs ref.flash_attention_ref_bf16p by (d, dv): " + ", ".join(
        f"{pair} {rel:.3g}" for pair, rel in sorted(bf16p.items())))
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


def check_flash_backward(dev) -> dict:
    """Kernel F's backward (``flash_attention_backward``: delta, dq,
    dk/dv) against its plain numerics,
    ``ref.flash_attention_bwd_ref_bf16p``, from the forward's own output
    and row log-sum-exp, which the training instance stores and which is
    held against ``ref.flash_attention_lse_ref``; at FLASH_BWD_CASES (qwen3's
    train shape first), every gradient finite, in bf16 and in its input's
    shape; the same bits twice at qwen3's shape (no atomics)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "lse": 0.0}
    d = 128
    for i, (B, H, Hkv, Sq, Sk, causal, window, *rest) in enumerate(
            FLASH_BWD_CASES):
        rng = np.random.default_rng(500 + i)

        def draw(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(dev).to(torch.bfloat16)

        if rest == ["slice"]:
            qkv = draw(B, Sq, H + 2 * Hkv, d)
            q, k, v = (qkv[:, :, c].transpose(1, 2) for c in (
                slice(0, H), slice(H, H + Hkv), slice(H + Hkv, None)))
        else:
            q, k, v = (draw(B, S, h, d).transpose(1, 2)
                       for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
        dout = draw(B, Sq, H, d).transpose(1, 2)
        shape = (f"B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} causal={causal} "
                 f"window={window}" + (" (column slices)" if rest else ""))
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                      with_lse=True)
        grads = fa.flash_attention_backward(q, k, v, out, lse, dout,
                                            causal=causal, window=window)
        torch.cuda.synchronize()
        lse_err = float((lse - ref.flash_attention_lse_ref(
            q, k, causal=causal, window=window)).abs().max())
        worst["lse"] = max(worst["lse"], lse_err)
        if not lse_err <= FLASH_LSE_TOL:
            raise AssertionError(f"F's lse != its oracle: {shape}: "
                                 f"{lse_err} > {FLASH_LSE_TOL}")
        want = ref.flash_attention_bwd_ref_bf16p(q, k, v, out, dout, lse,
                                                 causal=causal, window=window)
        for name, got, w, x in zip(("dq", "dk", "dv"), grads, want,
                                   (q, k, v)):
            if (got.dtype != torch.bfloat16 or got.shape != x.shape
                    or not bool(torch.isfinite(got).all())):
                raise AssertionError(f"F's backward {name}: {shape}: "
                                     f"{got.dtype} {tuple(got.shape)}")
            rel = float((got.float() - w).abs().max() / w.abs().max())
            worst[name] = max(worst[name], rel)
            if not rel <= FLASH_BWD_TOL:
                raise AssertionError(
                    f"F's backward != its bf16 numerics: {name} {shape}: "
                    f"{rel} > {FLASH_BWD_TOL} of max |{name}|")
        if i == 0:
            again = fa.flash_attention_backward(q, k, v, out, lse, dout)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError("F's backward: two runs differ")
            del again
            timing = _flash_backward_kernels(q, k, v, out, lse, dout)
        del want, grads
    print(f"  F's backward at {len(FLASH_BWD_CASES)} shapes (qwen3's train "
          f"shape, ragged, Sq != Sk unmasked, causal Sq < Sk, band, G 1/2/8,"
          f" column slices) vs ref.flash_attention_bwd_ref_bf16p: max "
          f"{worst['dq']:.3g} / {worst['dk']:.3g} / {worst['dv']:.3g} of "
          f"max |g| (dq / dk / dv; tol {FLASH_BWD_TOL}); lse vs its oracle "
          f"{worst['lse']:.3g} (tol {FLASH_LSE_TOL}); the same bits twice")
    return {"max_rel_err": worst, **timing}


def _flash_backward_kernels(q, k, v, out, lse, dout) -> dict:
    """At qwen3's train shape (q, k, v, dout in F's layout, transposed
    from the model's): the backward's three kernels apart (profiler),
    their registers, spills and shared memory, and the device kernels of
    one ``FlashAttention`` backward, none of them a GEMM (the f32
    recompute's SIMT and xmma products are gone)."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn

    names = ("flash_bwd_delta", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    row = {}
    for name in names:
        row[name + "_ms"] = kernel_ms(
            lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), 5,
            name)
        row[name + "_ms_from"] = ms_from(name)
    row["backward_build"] = {n: ptxas_report("flash_attention", n)
                             for n in names[1:]}
    row["backward_smem_bytes"] = fa.backward_smem_bytes(q.shape[3])
    print("  the backward's kernels at qwen3's train shape: " + ", ".join(
        f"{n} {row[n + '_ms']:.4f} ms ({row[n + '_ms_from']})"
        for n in names) + f"; ptxas {row['backward_build']}; dynamic shared "
        f"memory {row['backward_smem_bytes']}")
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    y = attn.FlashAttention.apply(*leaves, True, 1024, 1024, 0)
    prof = profiled(lambda: torch.autograd.grad(
        y, leaves, dout.transpose(1, 2), retain_graph=True), "flash_bwd")
    if prof is None:
        row["backward_device_kernels"] = NOT_TRACED
        print(f"  one FlashAttention backward's device kernels: "
              f"{NOT_TRACED}")
        return row
    kernels = sorted({e.key for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0})
    row["backward_device_kernels"] = kernels
    print(f"  one FlashAttention backward's device kernels: {kernels}")
    if any("gemm" in n.lower() for n in kernels) or not all(
            any(n in key for key in kernels) for n in names):
        raise AssertionError(f"F's backward ran {kernels}")
    return row


def ptxas_report(lib: str, mark: str) -> dict:
    """Registers and spill bytes of the kernel entry of ``lib`` whose
    mangled name holds ``mark``, from this run's ``ptxas -v`` report
    (none where ``build/`` held the library already)."""
    import re

    from repro_torch.kernels import cuda_build
    if lib not in cuda_build.build_logs:
        return {"registers": None, "note": "not measured: the library was "
                "built before this run"}
    entry, out = "", {}
    for line in cuda_build.build_logs[lib].splitlines():
        if "Compiling entry function" in line:
            entry = line
            continue
        if mark not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out["spill_store_bytes"], out["spill_load_bytes"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
    if "registers" not in out:
        raise AssertionError(f"no ptxas report for {mark} in {lib}")
    return out


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

    def capture(q, k, v, *, causal=True, window=0):
        out = launch(q, k, v, causal=causal, window=window)
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
    wgmma = _wgmma_check(SERVE_ARCH, cfg, launches)
    print(f"  kernel F launches: {launches} in {res['prefill_calls']} "
          f"prefills ({per_prefill:g} per prefill, {cfg.n_layers} layers); "
          f"{wgmma} of them on flash_kernel_wgmma")
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
        prof = profiled(fn, "flash_kernel" if name == "prefill" else "")
        if prof is None:
            print(f"  {name}: {wall:.3f} ms host clock; by kind {NOT_TRACED}")
            out[name] = {"wall_ms": wall, "device_ms": None}
            continue
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(ms for _, ms, _ in rows)
        by_kind = {k: sum(ms for key, ms, _ in rows
                          if any(m in key for m in marks))
                   for k, marks in kinds}
        by_kind["other"] = busy - sum(by_kind.values())
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


# ---------------------------------------------------------------------------
# MoE, MLA and vision serving: llama4-scout, deepseek-v3, internvl2
# ---------------------------------------------------------------------------

#: (arch, layers kept) at published widths: llama4 4 moe_attn layers
#: (about 10.9 B bf16 params); deepseek-v3 3 dense_attn + 1 moe_attn
#: (first_dense_layers kept at 3; about 15.1 B); internvl2 4 layers
#: (about 5.5 B)
MODEL_CUTS = (("llama4-scout-17b-a16e", 4), ("deepseek-v3-671b", 4),
              ("internvl2-76b", 4))
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = 8, 512, 32
# (ii) the MoE layer's f32 output against a plain per-expert loop over
# the same routing, relative to max |out| (f32 sums in another order)
MOE_TOL = 1e-4
#: (iii) layers at full width in f32 (deepseek-v3: 1 dense + 1 MoE)
EXACT_LAYERS = 2
#: kinds of a prefill's device time: kernel F, cuBLAS, the MoE's
#: routing and data movement (index_add, gathers, top-k, cumsum; the
#: embedding lookup's gather counts here too)
MODEL_KINDS = (("kernel F", ("flash_kernel",)),
               ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
               ("scatter/gather/top-k", ("index", "gather", "scatter",
                                         "topk", "TopK", "sort", "Sort",
                                         "scan", "cub")))


def _free() -> None:
    """Drop what earlier phases left cached on the card."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _cut_config(arch: str, n_layers: int, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers, **kw)


def _extra_embeds(cfg, B: int, dev, dtype):
    """Seeded stand-ins for the vision frontend's patch embeddings."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    return torch.from_numpy(rng.normal(size=(B, cfg.frontend_len, cfg.d_model))
                            .astype(np.float32)).to(dev).to(dtype)


def _vision_generate(cfg, dev) -> dict:
    """What ``launch.serve.main`` does, with ``extra_embeds``: seeded bf16
    weights, eight ycsb records as prompts, a warm-up generation of one
    step, then prefill + ``MODEL_GEN`` greedy steps, each step timed on
    the host clock with the device synchronised around it; the first
    decode index is frontend_len + S."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import make_serve_fns

    model = build_model(cfg)
    params = model.compute_params(model.init(0, device=dev))
    inputs = {"tokens": _record_prompts(cfg, MODEL_BATCH, MODEL_PROMPT, dev),
              "extra_embeds": _extra_embeds(cfg, MODEL_BATCH, dev,
                                            torch.bfloat16)}
    first = cfg.frontend_len + MODEL_PROMPT
    fns = make_serve_fns(model, batch=MODEL_BATCH,
                         seq_len=first + MODEL_GEN + 128)
    return _generate_timed(fns, params, inputs, first, MODEL_BATCH,
                           MODEL_GEN, dev)


def _moe_check(cfg, h, p, dev) -> dict:
    """(ii) on the first MoE layer's captured input ``h`` and parameters
    ``p``: the routing on the card and on the CPU from the same f32
    logits (ids, pos, keep, slot equal exactly), then ``apply_moe`` in
    f32 against a plain loop over the experts with that routing."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import silu

    m = cfg.moe
    T, d = h.shape[0] * h.shape[1], h.shape[2]
    logits = h.reshape(T, d).float() @ p["router"].float()
    got = moe_mod.route(logits, m)
    want = moe_mod.route(logits.cpu(), m)
    for name in ("ids", "pos", "keep", "slot"):
        a, b = getattr(got, name).cpu(), getattr(want, name)
        if not torch.equal(a, b):
            n_bad = int((a != b).sum())
            top = torch.topk(want.probs, m.top_k + 1, dim=-1).values
            gap = float((top[:, -2] - top[:, -1]).min())
            raise AssertionError(
                f"(ii) routing on the card != on the CPU: {name} differs "
                f"at {n_bad} places; smallest gap between the k-th and "
                f"(k+1)-th probability {gap:.3g}")
    gates_err = float((got.gates.cpu() - want.gates).abs().max())
    dropped = int((~want.keep).sum())

    x = h.float()
    out, aux = moe_mod.apply_moe(p, x, cfg)
    # the plain version: each kept assignment through its expert, weighted
    xf = x.reshape(T, d)
    ref = torch.zeros_like(xf)
    keep = got.keep.view(T, m.top_k)
    for e in range(m.n_experts):
        t_idx, j_idx = torch.nonzero((got.ids == e) & keep, as_tuple=True)
        if t_idx.numel() == 0:
            continue
        xe = xf[t_idx]
        y = ((xe @ p["wi"][e].float()) * silu(xe @ p["wg"][e].float())
             ) @ p["wo"][e].float()
        ref.index_add_(0, t_idx, y * got.gates[t_idx, j_idx][:, None])
    if m.n_shared_experts:
        ref += ((xf @ p["shared_wi"].float())
                * silu(xf @ p["shared_wg"].float())) @ p["shared_wo"].float()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out.reshape(T, d) - ref).abs().max())
    print(f"  (ii) first MoE layer, T={T}, E={m.n_experts}, top-{m.top_k}, "
          f"C={got.C}: routing on the card == on the CPU (ids, pos, keep, "
          f"slot; gates within {gates_err:.3g}), {dropped} of {T * m.top_k} "
          f"assignments dropped; f32 apply_moe vs the per-expert loop: max "
          f"abs err {err:.3g} of max |out| {scale:.3g} (tol {MOE_TOL} "
          f"relative), aux {float(aux):.4g}")
    if not (err <= MOE_TOL * scale) or not torch.isfinite(out).all():
        raise AssertionError(f"(ii) apply_moe != the per-expert loop: {err}")
    return {"C": got.C, "dropped": dropped, "gates_err": gates_err,
            "max_rel_err": err / scale}


def _prefill_breakdown(cfg, dev, B: int = MODEL_BATCH,
                       S: int = MODEL_PROMPT) -> dict:
    """Device time of one warm prefill by kind (profiler), fresh seeded
    weights of ``cfg`` at batch B and prompt S (the vision frontend's
    embeddings, encdec's frames), as :func:`serve_breakdown`; where the
    model has recurrences, their time between CUDA events in another
    call (:func:`_recurrence_ms`)."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import make_serve_fns

    model = build_model(cfg)
    params = model.compute_params(model.init(SEED, device=dev))
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED))
    inputs = {"tokens": toks}
    if cfg.frontend == "vision":
        inputs["extra_embeds"] = _extra_embeds(cfg, B, dev, torch.bfloat16)
    if cfg.family == "encdec":
        inputs["frames"] = _frames(cfg, B, dev)
    fns = make_serve_fns(model, batch=B,
                         seq_len=cfg.frontend_len + S + MODEL_GEN)

    def prefill():
        return fns["prefill"](params, inputs)

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    out, rec = {"wall_ms": wall}, ""
    if cfg.family in ("hybrid", "rwkv"):
        rec_ms, n_rec, rec_wall = _recurrence_ms(prefill)
        out.update(recurrence_ms=rec_ms, recurrences=n_rec,
                   recurrence_share=rec_ms / rec_wall)
        rec = (f"; recurrences {rec_ms:.3f} ms between CUDA events around "
               f"{n_rec} scans in a call of {rec_wall:.3f} ms "
               f"({rec_ms / rec_wall:.1%})")
    prof = profiled(prefill, "flash_kernel" if _f_per_prefill(cfg) else "")
    if prof is None:
        print(f"  prefill breakdown: {wall:.3f} ms host clock{rec}; by kind "
              f"{NOT_TRACED}")
        return {**out, "device_ms": None}
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    by_kind, left = {}, list(rows)
    for kind, marks in MODEL_KINDS:
        mine = [r for r in left if any(mk in r[0] for mk in marks)]
        by_kind[kind] = sum(ms for _, ms, _ in mine)
        left = [r for r in left if r not in mine]
    by_kind["other"] = sum(ms for _, ms, _ in left)
    launches = sum(n for _, _, n in rows)
    print(f"  prefill breakdown: {wall:.3f} ms host clock, {busy:.3f} ms of "
          f"kernels ({launches} launches; device idle {1 - busy / wall:.1%})"
          f"; by kind " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in by_kind.items()) + rec)
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:5]:
        print(f"      {ms:8.3f} ms  x{n:<5d} {key[:90]}")
    return {**out, "device_ms": busy, "kernels": launches,
            "idle_share": 1 - busy / wall, "by_kind_ms": by_kind}


def serve_model(arch: str, n_layers: int, dev) -> dict:
    """One configuration of the phase: its serve path (``launch.serve.
    main``, or :func:`_vision_generate` with the frontend's embeddings),
    counters at 0 just before and read just after, with (i) F on layer
    0's captured q, k, v and (ii) on the first MoE layer's input; then
    one profiled prefill."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model

    cfg = _cut_config(arch, n_layers)
    full = serve.get_config(arch)
    n_params = build_model(cfg).param_count()
    shape = (f"MLA (q_lora {cfg.mla.q_lora_rank}, kv_lora "
             f"{cfg.mla.kv_lora_rank}, qk {cfg.mla.qk_nope_head_dim}+"
             f"{cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim})"
             if cfg.attention == "mla" else f"head dim {cfg.hd()}")
    moe = (f"; MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
           f"{cfg.moe.n_shared_experts} shared, ff {cfg.moe.d_ff_expert}, "
           f"capacity_factor {cfg.moe.capacity_factor}"
           if cfg.moe else "")
    print(f"  {arch}: depth cut to {n_layers} of {full.n_layers} layers "
          f"(groups {cfg.layer_groups()}); published widths: d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {shape}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}{moe}; frontend "
          f"{cfg.frontend} ({cfg.frontend_len}); param_count {n_params:,} "
          f"({n_params * 2 / 1e9:.1f} GB bf16; published "
          f"{build_model(full).param_count():,})")

    captured, moe_in = {}, {}
    launch, apply_moe = fa.flash_attention, moe_mod.apply_moe

    def capture(q, k, v, *, causal=True, window=0):
        out = launch(q, k, v, causal=causal, window=window)
        if not captured:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone(),
                            out=out.clone())
        return out

    def capture_moe(p, x, c):
        if not moe_in:
            moe_in.update(h=x.clone(), p=p)
        return apply_moe(p, x, c)

    # ---- the serve path: counters at 0 just before, read just after ----
    _free()
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention, moe_mod.apply_moe = capture, capture_moe
    get_config = serve.get_config
    serve.get_config = lambda a: cfg if a == arch else get_config(a)
    try:
        if cfg.frontend == "vision":
            res = _vision_generate(cfg, dev)
        else:
            res = serve.main(["--arch", arch, "--batch", str(MODEL_BATCH),
                              "--prompt-len", str(MODEL_PROMPT), "--gen",
                              str(MODEL_GEN), "--device", str(dev)])
    finally:
        fa.flash_attention, moe_mod.apply_moe = launch, apply_moe
        serve.get_config = get_config
    torch.cuda.synchronize()
    launches = fa.launches
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated(dev)
    per_prefill = launches / res["prefill_calls"]
    print(f"  prefill {res['prefill_ms']:.3f} ms (warm), decode "
          f"{res['decode_ms_per_step']:.3f} ms/step, "
          f"{res['tokens_per_s']:.1f} tokens/s over {res['wall_s']:.3f} s "
          f"(batch {res['batch']}, prompt {MODEL_PROMPT}"
          + (f" + {cfg.frontend_len} patch embeddings" if cfg.frontend_len
             else "") + f", {res['generated']} tokens each); peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    wgmma = _wgmma_check(arch, cfg, launches)
    print(f"  kernel F launches: {launches} in {res['prefill_calls']} "
          f"prefills ({per_prefill:g} per prefill, {n_layers} attention "
          f"layers); {wgmma} of them on flash_kernel_wgmma")
    if res["generated"] != MODEL_GEN or per_prefill != n_layers:
        raise AssertionError(f"{arch}: {res}, F launches {launches}")

    # (i) F on layer 0's captured inputs against the plain version
    q, k, v = captured["q"], captured["k"], captured["v"]
    want = ref.flash_attention_ref(q, k, v)
    err = float((captured["out"].float() - want.float()).abs().max())
    vwidth = ""
    if cfg.attention == "mla":
        vd = cfg.mla.v_head_dim
        if v.shape[-1] != vd or captured["out"].shape[-1] != vd:
            raise AssertionError(f"(i) F took v {tuple(v.shape)} and gave "
                                 f"o {tuple(captured['out'].shape)}: want "
                                 f"v and o at {vd}, unpadded")
        vwidth = (f"; v {tuple(v.shape)} at its own head dim {vd} (no "
                  f"padded copy), o {tuple(captured['out'].shape)}")
    print(f"  (i) layer 0: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}, "
          f"causal; F vs plain max abs err {err:.3g} (tol "
          f"{FLASH_TOL['bfloat16']}){vwidth}")
    if not (err <= FLASH_TOL["bfloat16"]):
        raise AssertionError(f"(i) F != plain on layer 0: {err}")
    del captured, q, k, v, want
    out = {"result": res, "launches": launches, "peak_bytes": peak,
           "param_count": n_params, "err": err, "layers": n_layers,
           "wgmma_launches": wgmma}
    if cfg.moe is not None:
        out["moe"] = _moe_check(cfg, moe_in["h"], moe_in["p"], dev)
    del moe_in
    _free()
    out["breakdown"] = _prefill_breakdown(cfg, dev)
    _free()
    return out


def exactness_model(arch: str, dev) -> float:
    """(iii) f32 forward logits at S-1 against prefill(S-1) + decode, at
    full width and ``EXACT_LAYERS`` layers (deepseek-v3: 1 dense + 1 MoE
    layer, about 13.9 B f32 params, 56 GB), capacity_factor 16 as the
    reference's ``test_decode_matches_forward``, TF32 off; nothing else
    resident."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import cache_alloc_len, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"compute_dtype": "float32", "param_dtype": "float32"}
    m = get_config(arch).moe
    if m is not None:
        kw["moe"] = dataclasses.replace(
            m, capacity_factor=16.0,
            first_dense_layers=min(m.first_dense_layers, 1))
    cfg = _cut_config(arch, EXACT_LAYERS, **kw)
    # decode routes B tokens with C = max(1, round(B k / E * 16)) slots an
    # expert: deepseek-v3 (k 8 of E 256) gets C = 1 at B = 2, so two
    # tokens sharing an expert would drop one in decode and not in the
    # forward; at B = 1 no expert can get two
    B, S = (1 if m is not None and moe_mod.capacity(2, cfg.moe) < 2
            else 2), 128
    _free()
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(dev)
    extra = (_extra_embeds(cfg, B, dev, torch.float32)
             if cfg.frontend == "vision" else None)
    F = cfg.frontend_len if extra is not None else 0
    fa.launches = 0
    full, _ = transformer.forward(params, cfg, toks, extra_embeds=extra)
    last, cache = model.prefill(
        params, {"tokens": toks[:, :S - 1], "extra_embeds": extra},
        s_alloc=cache_alloc_len(F + S), cache_dtype=torch.float32)
    dec, _ = model.decode(params, cache, toks[:, S - 1], F + S - 1)
    torch.cuda.synchronize()
    err = float((full[:, F + S - 1] - dec).abs().max())
    err_pre = float((full[:, F + S - 2] - last).abs().max())
    scale = float(full[:, F + S - 1].abs().max())
    print(f"  (iii) {arch}, {EXACT_LAYERS} layers {cfg.layer_groups()}, "
          f"{model.param_count():,} f32 params, B={B} S={S}"
          + (f" + {F} patch embeddings" if F else "") + f": forward "
          f"(kernel F f32, {fa.launches} launches with the prefill) vs "
          f"prefill + decode: max abs err {err:.3g} at S-1, {err_pre:.3g} "
          f"at S-2, logits up to {scale:.3g}; tol {EXACT_TOL}")
    if not (err <= EXACT_TOL and err_pre <= EXACT_TOL):
        raise AssertionError(f"(iii) {arch}: forward != prefill + decode: "
                             f"{err}, {err_pre}")
    if not torch.isfinite(full).all():
        raise AssertionError(f"(iii) {arch}: non-finite logits")
    del params, cache, full
    _free()
    return err


def model_serving(dev) -> dict:
    """The phase: each configuration's serve path, checks (i) and (ii) and
    a profiled prefill, then (iii) for each; every model freed before the
    next."""
    out = {arch: serve_model(arch, n, dev) for arch, n in MODEL_CUTS}
    for arch, _ in MODEL_CUTS:
        out[arch]["exact_err"] = exactness_model(arch, dev)
    return out


#: kernel F at deepseek-v3's MLA prefill: batch, heads, prompt, qk and v
#: head dims
FLASH_MLA_SHAPE = (8, 128, 512, 192, 128)


def _flash_build_report(*pairs) -> dict:
    """ptxas registers and spills, and shared memory a block, of kernel F's
    instances at ``pairs`` ((d, dv)): the bf16 route's flash_kernel_wgmma
    and the f32 route's flash_kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out = {}
    for d, dv in pairs:
        bn = ref.flash_key_tile(d, dv)
        out[f"flash_kernel_wgmma<{d}, {dv}, {bn}>"] = {
            **ptxas_report("flash_attention",
                           f"flash_kernel_wgmmaILi{d}ELi{dv}ELi{bn}E"),
            "smem_bytes": fa.smem_bytes(torch.bfloat16, d, dv)}
        out[f"flash_kernel<{d}, {dv}>"] = {
            **ptxas_report("flash_attention", f"flash_kernelILi{d}ELi{dv}E"),
            "smem_bytes": fa.smem_bytes(torch.float32, d, dv)}
    for name, rep_ in out.items():
        print(f"  {name}: {rep_}")
    return out


def flash_mla_timing(dev) -> dict:
    """Kernel F at the MLA shape, v at its own head dim of 128 (a column
    slice of the kv projection, as ``attention.run_flash_kernel`` hands
    it over), beside its plain version and
    ``scaled_dot_product_attention`` at q/k 192, v 128.  The bound counts
    MLA's function: q and k at 192, v and o at 128, causal QK^T and P.V;
    with the build's registers, spills and shared memory of the (192,
    128) instances."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, S, dqk, dv = FLASH_MLA_SHAPE
    rng = np.random.default_rng(SEED + 2)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for d in (dqk, dqk, dv))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    ms = kernel_ms(lambda: fa.flash_attention(q, k, v), 20, "flash_kernel")
    nbytes = (q.numel() + k.numel() + 2 * v.numel()) * q.element_size()
    flops = B * H * S * S * (dqk + dv)        # 2 S^2 (dqk + dv) / 2 causal
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    return {
        "name": "flash_attention (MLA, d 192)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:78",
        "ms": ms, "plain_ms": cuda_ms(
            lambda: ref.flash_attention_ref(q, k, v), 3),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": lib_ms,
        "library_note": "scaled_dot_product_attention(is_causal=True) at "
                        "q/k 192, v 128, timed only",
        "ms_from": ms_from("flash_kernel"), "wrapper_call_ms": cuda_ms(
            lambda: fa.flash_attention(q, k, v), 20),
        "shape": f"B={B} H={H} Hkv={H} S={S} d={dqk} dv={dv} {q.dtype} "
                 f"causal",
        "bound_bytes_ms": bytes_ms, "bound_ops_ms": flops_ms,
        "tflop_per_s": flops / (ms * 1e-3) / 1e12,
        "bound_share": max(bytes_ms, flops_ms) / ms,
        "ms_over_library": ms / lib_ms,
        "build": _flash_build_report((dqk, dv)),
    }


def flash_mla_row(timing: dict, served: dict) -> dict:
    """F's MLA row: :func:`flash_mla_timing` with deepseek-v3's serve-path
    launches and its check (i)."""
    ds = served["deepseek-v3-671b"]
    return {**timing, "launches": ds["launches"], "max_abs_err": ds["err"],
            "launches_per_prefill": ds["launches"]
            // ds["result"]["prefill_calls"]}


# ---------------------------------------------------------------------------
# recurrent, hybrid and encoder-decoder serving: recurrentgemma, rwkv6,
# seamless-m4t
# ---------------------------------------------------------------------------

#: kernel F's band at recurrentgemma's prefill: batch, heads, kv heads,
#: prompt, head dim, window
FLASH_BAND_SHAPE = (2, 16, 1, 2560, 256, 2048)
#: (arch, layers kept, batch, prompt, generated tokens) at published
#: widths: recurrentgemma cut to 8 layers, two (rec, rec, attn) periods
#: and the (rec, rec) remainder group, its prompt past the window and the
#: local layers' 2,176-slot ring (about 3.3 B params); rwkv6 and seamless
#: (12 + 12 layers, over ENCDEC_FRAMES seeded frames) at full depth
RECURRENT_RUNS = (("recurrentgemma-9b", 8, 2, 2560, 16),
                  ("rwkv6-3b", 32, 4, 64, 32),
                  ("seamless-m4t-medium", 24, 4, 128, 32))
ENCDEC_FRAMES = 1024
#: (iii) layers at full width in f32 and the prompt: recurrentgemma's
#: (rec, rec, attn) at S 2,300, past its 2,176-slot ring; rwkv6 2 layers;
#: seamless 2 + 2 layers over ENCDEC_FRAMES frames
RECURRENT_EXACT = (("recurrentgemma-9b", 3, 2300), ("rwkv6-3b", 2, 128),
                   ("seamless-m4t-medium", 2, 128))


def _encdec_config(arch: str, per_stack: int, **kw):
    """The published encdec config with ``per_stack`` encoder and decoder
    layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), enc_layers=per_stack,
                               dec_layers=per_stack, n_layers=2 * per_stack,
                               **kw)


def _f_per_prefill(cfg) -> int:
    """Kernel F launches in one prefill: one per attention layer; encdec's
    encoder layers, and its decoder layers twice (self and cross)."""
    from repro_torch.models.transformer import _group_block_types
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return sum(n * sum(bt in ("attn", "dense_attn", "moe_attn")
                       for bt in _group_block_types(gt))
               for gt, n in cfg.layer_groups())


def _frames(cfg, B: int, dev):
    """Seeded stand-ins for the audio frontend's frame embeddings (f32, as
    ``configs.input_specs`` gives them)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 3)
    return torch.from_numpy(rng.normal(size=(B, ENCDEC_FRAMES, cfg.d_model))
                            .astype(np.float32)).to(dev)


def _record_prompts(cfg, B: int, S: int, dev):
    """``launch.serve``'s prompts: B ycsb records, byte-tokenized, padded to
    S."""
    import torch
    from repro_torch.data.datasets import generate_records
    from repro_torch.data.tokenizer import ByteTokenizer
    tok = ByteTokenizer(vocab_size=cfg.vocab_size)
    recs = generate_records("ycsb", B, seed=0)
    return torch.from_numpy(tok.pad_batch(
        [tok.encode(r, add_eos=False) for r in recs], S)).to(dev)


def _encdec_generate(cfg, B: int, S: int, n_gen: int, dev) -> dict:
    """What ``launch.serve.main`` does, with frames: seeded bf16 weights,
    B ycsb records as the target prompts, ``ENCDEC_FRAMES`` seeded frames
    through ``make_serve_fns``; a warm-up generation of one step, then
    prefill + ``n_gen`` greedy steps, each timed on the host clock with
    the device synchronised around it."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import make_serve_fns

    model = build_model(cfg)
    params = model.compute_params(model.init(0, device=dev))
    inputs = {"frames": _frames(cfg, B, dev),
              "tokens": _record_prompts(cfg, B, S, dev)}
    fns = make_serve_fns(model, batch=B, seq_len=S + n_gen + 128)
    return _generate_timed(fns, params, inputs, S, B, n_gen, dev)


def _generate_timed(fns, params, inputs, first: int, B: int, n_gen: int,
                    dev) -> dict:
    """A warm-up generation of one step, then prefill + ``n_gen`` greedy
    steps from decode index ``first``, each step timed on the host clock
    with the device synchronised around it; ``launch.serve.main``'s
    result dict."""
    import torch

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def generate(n: int):
        (logits, cache), pre = timed(fns["prefill"], params, inputs)
        tok_ = torch.argmax(logits, dim=-1).to(torch.int32)
        steps, out = [], []
        for i in range(n):
            out.append(tok_)
            (logits, cache), dt = timed(fns["decode"], params, cache, tok_,
                                        first + i)
            tok_ = torch.argmax(logits, dim=-1).to(torch.int32)
            steps.append(dt)
        return torch.stack(out, dim=1), pre, steps

    generate(1)                                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, pre, steps = generate(n_gen)
    wall = time.perf_counter() - t0
    return {"batch": B, "generated": int(out.shape[1]),
            "tokens_per_s": B * n_gen / wall, "wall_s": wall,
            "prefill_ms": pre * 1e3,
            "decode_ms_per_step": sum(steps) / len(steps) * 1e3,
            "prefill_calls": 2, "device": str(dev)}


def _recurrence_ms(run) -> tuple[float, int, float]:
    """Device milliseconds between CUDA events around every RG-LRU scan
    (``rglru._prefix_scan``) and RWKV recurrence (``rwkv6._wkv_scan``) in
    one call of ``run`` (the gaps where the device waits for the host's
    launches included), how many there were, and that call's host-clock
    milliseconds, the device synchronised around it."""
    import torch
    from repro_torch.models import rglru, rwkv6
    events = []
    scans = (rglru._prefix_scan, rwkv6._wkv_scan)

    def timed(fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            events.append((start, stop))
            return out
        return call

    rglru._prefix_scan, rwkv6._wkv_scan = (timed(f) for f in scans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        rglru._prefix_scan, rwkv6._wkv_scan = scans
    wall = (time.perf_counter() - t0) * 1e3
    return sum(a.elapsed_time(b) for a, b in events), len(events), wall


def serve_recurrent(arch: str, n_layers: int, B: int, S: int, n_gen: int,
                    dev) -> dict:
    """One configuration of the phase: its serve path (``launch.serve.
    main`` with ``serve.get_config`` patched to the cut config, or
    :func:`_encdec_generate` with frames), counters at 0 just before and
    read just after, with (i) F on the first call of each form (causal,
    band, unmasked, cross) against its plain version; then one profiled
    prefill."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    full = serve.get_config(arch)
    cfg = (_encdec_config(arch, n_layers // 2) if full.family == "encdec"
           else _cut_config(arch, n_layers))
    n_params = build_model(cfg).param_count()
    if cfg.family == "encdec":
        depth = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder "
                 f"layers (not cut), {ENCDEC_FRAMES} seeded frames")
    else:
        depth = (f"depth {n_layers} of {full.n_layers} layers (groups "
                 f"{cfg.layer_groups()})")
    extra = (f", head dim {cfg.hd()}, window {cfg.window}, lru width "
             f"{cfg.lru_width}" if cfg.family == "hybrid" else
             f", head size {cfg.rwkv_head_size}" if cfg.family == "rwkv"
             else f", head dim {cfg.hd()}")
    print(f"  {arch} ({cfg.family}): {depth}; published widths: d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads{extra}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; param_count "
          f"{n_params:,} ({n_params * 2 / 1e9:.1f} GB bf16; published "
          f"{build_model(full).param_count():,})")

    captured, calls = {}, {}
    launch = fa.flash_attention

    def capture(q, k, v, *, causal=True, window=0):
        before = fa.launches
        out = launch(q, k, v, causal=causal, window=window)
        form = (causal, window, q.shape[2] == k.shape[2])
        # the wrapper's own count of this call's launches
        calls[form] = calls.get(form, 0) + fa.launches - before
        if form not in captured:
            captured[form] = (q.clone(), k.clone(), v.clone(), out.clone())
        return out

    # ---- the serve path: counters at 0 just before, read just after ----
    _free()
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention = capture
    get_config = serve.get_config
    serve.get_config = lambda a: cfg if a == arch else get_config(a)
    try:
        if cfg.family == "encdec":
            res = _encdec_generate(cfg, B, S, n_gen, dev)
        else:
            res = serve.main(["--arch", arch, "--batch", str(B),
                              "--prompt-len", str(S), "--gen", str(n_gen),
                              "--device", str(dev)])
    finally:
        fa.flash_attention = launch
        serve.get_config = get_config
    torch.cuda.synchronize()
    launches = fa.launches
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated(dev)
    per_prefill = launches / res["prefill_calls"]
    want_per = _f_per_prefill(cfg)
    print(f"  prefill {res['prefill_ms']:.3f} ms (warm), decode "
          f"{res['decode_ms_per_step']:.3f} ms/step, "
          f"{res['tokens_per_s']:.1f} tokens/s over {res['wall_s']:.3f} s "
          f"(batch {res['batch']}, prompt {S}, {res['generated']} tokens "
          f"each); peak max_memory_allocated {peak / 2**30:.2f} GiB")
    wgmma = _wgmma_check(arch, cfg, launches)
    print(f"  kernel F launches: {launches} in {res['prefill_calls']} "
          f"prefills ({per_prefill:g} per prefill; {want_per} attention "
          f"calls per prefill); {wgmma} of them on flash_kernel_wgmma")
    if res["generated"] != n_gen or per_prefill != want_per:
        raise AssertionError(f"{arch}: {res}, F launches {launches}")
    if sum(calls.values()) != launches:
        raise AssertionError(f"{arch}: F's launches by form {calls} do not "
                             f"add up to its {launches}")

    errs, form_launches = {}, {}
    for (causal, window, square), (q, k, v, out) in sorted(captured.items()):
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((out.float() - want.float()).abs().max())
        form = ("band" if window else "causal" if causal else
                "unmasked" if square else "cross")
        errs[form] = err
        form_launches[form] = calls[(causal, window, square)]
        print(f"  (i) first {form} call (of {form_launches[form]} launches):"
              f" q {tuple(q.shape)} k "
              f"{tuple(k.shape)} {q.dtype}, window {window}; F vs plain max "
              f"abs err {err:.3g} (tol {FLASH_TOL['bfloat16']})")
        if not (err <= FLASH_TOL["bfloat16"]):
            raise AssertionError(f"(i) {arch}: F != plain ({form}): {err}")
    want_forms = ({"band"} if cfg.family == "hybrid" else set()
                  if cfg.family == "rwkv" else
                  {"causal", "unmasked", "cross"})
    if set(errs) != want_forms:
        raise AssertionError(f"{arch}: F ran {sorted(errs)}, want "
                             f"{sorted(want_forms)}")
    del captured
    out = {"result": res, "launches": launches, "peak_bytes": peak,
           "param_count": n_params, "errs": errs, "layers": n_layers,
           "wgmma_launches": wgmma, "form_launches": form_launches}
    _free()
    out["breakdown"] = _prefill_breakdown(cfg, dev, B, S)
    _free()
    return out


def exactness_recurrent(arch: str, n_layers: int, S: int, dev) -> float:
    """(iii) f32 forward logits at S-1 and S-2 against prefill(S-1) +
    decode, at full width and ``n_layers`` layers, TF32 off; nothing
    else resident."""
    import numpy as np
    import torch
    from repro_torch.configs import cache_alloc_len, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import encdec, transformer
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"compute_dtype": "float32", "param_dtype": "float32"}
    cfg = (_encdec_config(arch, n_layers, **kw)
           if get_config(arch).family == "encdec"
           else _cut_config(arch, n_layers, **kw))
    B = 1
    _free()
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(dev)
    fa.launches = 0
    s_alloc = cache_alloc_len(S)
    if cfg.family == "encdec":
        frames = _frames(cfg, B, dev)
        full, _ = encdec.forward(params, cfg, frames, toks)
        last, cache = model.prefill(
            params, {"frames": frames, "tokens": toks[:, :S - 1]},
            s_alloc=s_alloc, cache_dtype=torch.float32)
    else:
        full, _ = transformer.forward(params, cfg, toks)
        last, cache = model.prefill(params, {"tokens": toks[:, :S - 1]},
                                    s_alloc=s_alloc,
                                    cache_dtype=torch.float32)
    dec, _ = model.decode(params, cache, toks[:, S - 1], S - 1)
    torch.cuda.synchronize()
    err = float((full[:, S - 1] - dec).abs().max())
    err_pre = float((full[:, S - 2] - last).abs().max())
    scale = float(full[:, S - 1].abs().max())
    ring = ""
    if cfg.family == "hybrid":
        ring = (f", local ring {min(s_alloc, cfg.window + 128)} slots, "
                f"window {cfg.window}")
    print(f"  (iii) {arch}, f32, {model.param_count():,} params, B={B} "
          f"S={S}{ring}: forward (kernel F f32, {fa.launches} launches with "
          f"the prefill) vs prefill + decode: max abs err {err:.3g} at S-1, "
          f"{err_pre:.3g} at S-2, logits up to {scale:.3g}; tol {EXACT_TOL}")
    if not (err <= EXACT_TOL and err_pre <= EXACT_TOL):
        raise AssertionError(f"(iii) {arch}: forward != prefill + decode: "
                             f"{err}, {err_pre}")
    if not torch.isfinite(full).all():
        raise AssertionError(f"(iii) {arch}: non-finite logits")
    del params, cache, full
    _free()
    return err


def recurrent_serving(dev) -> dict:
    """The phase: each configuration's serve path, check (i) and a
    profiled prefill, then (iii) for each; every model freed before the
    next."""
    out = {arch: serve_recurrent(arch, n, B, S, g, dev)
           for arch, n, B, S, g in RECURRENT_RUNS}
    for arch, n, S in RECURRENT_EXACT:
        out[arch]["exact_err"] = exactness_recurrent(arch, n, S, dev)
    return out


def flash_band_timing(dev) -> dict:
    """Kernel F's band at recurrentgemma's prefill shape (bf16, window
    2,048, d 256, MQA), beside its plain version and
    ``scaled_dot_product_attention`` with a boolean band mask.  The bound
    counts the band's pairs alone: 4 B H d per (query, key) pair with
    0 <= q - k < window, over the bf16 tensor-core rate, against q, k, v
    and o once over the memory rate; with the build's registers, spills
    and shared memory of the d = 256 instances."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, Hkv, S, d, W = FLASH_BAND_SHAPE
    rng = np.random.default_rng(SEED + 4)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
        np.float32)).to(dev).to(torch.bfloat16).transpose(1, 2)
        for h in (H, Hkv, Hkv))
    ms = kernel_ms(lambda: fa.flash_attention(q, k, v, window=W), 20,
                   "flash_kernel")
    pairs = sum(min(i + 1, W) for i in range(S))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * pairs * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    i = torch.arange(S, device=dev)
    diff = i[:, None] - i[None, :]
    band = (diff >= 0) & (diff < W)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=band, enable_gqa=True), 10)
    return {
        "name": "flash_attention (band, d 256)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:78",
        "ms": ms, "plain_ms": cuda_ms(
            lambda: ref.flash_attention_ref(q, k, v, window=W), 3),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": lib_ms,
        "library_note": "scaled_dot_product_attention(attn_mask=band, "
                        "enable_gqa=True), timed only",
        "ms_from": ms_from("flash_kernel"), "wrapper_call_ms": cuda_ms(
            lambda: fa.flash_attention(q, k, v, window=W), 20),
        "shape": f"B={B} H={H} Hkv={Hkv} S={S} d={d} {q.dtype} window={W}",
        "band_pairs_per_head": pairs,
        "bound_bytes_ms": bytes_ms, "bound_ops_ms": flops_ms,
        "tflop_per_s": flops / (ms * 1e-3) / 1e12,
        "bound_share": max(bytes_ms, flops_ms) / ms,
        "ms_over_library": ms / lib_ms,
        "build": _flash_build_report((d, d)),
    }


def flash_band_row(timing: dict, served: dict) -> dict:
    """F's band row: :func:`flash_band_timing` with recurrentgemma's
    serve-path launches and its check (i) on the first band call."""
    rg = served["recurrentgemma-9b"]
    return {**timing, "launches": rg["launches"],
            "max_abs_err": rg["errs"]["band"],
            "launches_per_prefill": rg["launches"]
            // rg["result"]["prefill_calls"]}


# ---------------------------------------------------------------------------
# training: launch/train.py, Model.loss, kernel F under a gradient
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", SERVE_ARCH, "--batch", "8", "--seq", "256",
              "--steps", "8"]
#: layers of the full-width model in the gradient-route check
GRAD_LAYERS = 2
# F's route (its forward, then autograd through the plain version) against
# autograd through the plain version alone: F's forward bounds
# (FLASH_TOL), taken relative to each leaf's max |g|
GRAD_TOL = FLASH_TOL
#: crash and resume at the reduced config: tests/test_train.py's arguments
RESUME_ARGS = ["--arch", SERVE_ARCH, "--reduced", "--dataset", "ycsb",
               "--steps", "10", "--batch", "2", "--seq", "64",
               "--ckpt-every", "2", "--n-clients", "2",
               "--chunks-per-client", "2", "--chunk-records", "64",
               "--log-every", "5"]
#: bytes of f32 training state per parameter: params, AdamW's m and v
STATE_BYTES_PER_PARAM = 12


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """Leaf paths of a nested dict in ``layers.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}" if prefix
                                     else k)]
    return [prefix]


def gradient_routes(dev) -> dict:
    """(1) The loss and every gradient at full width and GRAD_LAYERS
    layers, f32 and bf16, through F's autograd Function (the trainer's
    route) and through autograd over the plain version; every gradient
    finite and non-zero, the routes within GRAD_TOL of each leaf's max
    |g|."""
    import dataclasses

    import torch
    from repro_torch.configs import ShapeConfig, get_config, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_attention_plain
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad

    out = {}
    for dt, tol in GRAD_TOL.items():
        cfg = dataclasses.replace(get_config(SERVE_ARCH),
                                  n_layers=GRAD_LAYERS, compute_dtype=dt)
        model = build_model(cfg)
        params = model.init(SEED, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, ShapeConfig("grad", "train", 256, 8), seed=SEED).items()}
        torch.cuda.synchronize()
        fa.launches = 0
        _zero_flash_routes()
        t0 = time.perf_counter()
        loss_f, g_f = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        t_f = time.perf_counter() - t0
        launches = fa.launches
        backwards = _backward_check(f"gradient routes, {dt}", cfg,
                                    GRAD_LAYERS)
        t0 = time.perf_counter()
        loss_p, g_p = value_and_grad(model, params, batch,
                                     attention=flash_attention_plain)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        if fa.launches != launches:
            raise AssertionError("the plain route launched kernel F")
        worst, bad = 0.0, []
        g_f, g_p = tree_leaves(g_f), tree_leaves(g_p)
        for name, a, b in zip(_leaf_names(params), g_f, g_p):
            if not all(torch.isfinite(g).all() and float(g.abs().max()) > 0
                       for g in (a, b)):
                bad.append(f"{name} (zero or not finite)")
                continue
            rel = float((a.float() - b.float()).abs().max()
                        / b.float().abs().max())
            worst = max(worst, rel)
            if not rel <= tol:
                bad.append(f"{name} ({rel:.3g})")
        print(f"  (1) {dt}, {GRAD_LAYERS} layers at full width, B=8 S=256: "
              f"loss {float(loss_f):.6f} (F) vs {float(loss_p):.6f} (plain);"
              f" {len(g_f)} gradients, all finite and non-zero, F route vs "
              f"plain max {worst:.3g} of the leaf's max |g| (tol {tol}); F "
              f"launches {launches} ({GRAD_LAYERS} forward + {GRAD_LAYERS} "
              f"in the checkpoint's recompute), {backwards}; "
              f"{t_f * 1e3:.1f} ms vs {t_p * 1e3:.1f} ms (host clock)")
        if bad or launches != 2 * GRAD_LAYERS:
            raise AssertionError(f"gradient routes, {dt}: {bad}, F "
                                 f"launches {launches}")
        out[dt] = {"max_rel_err": worst, "launches": launches,
                   "ms_f": t_f * 1e3, "ms_plain": t_p * 1e3}
        del params, g_f, g_p
    return out


def train_full_width(dev, card: str) -> dict:
    """(2) ``repro_torch.launch.train.main`` with TRAIN_ARGS: CIAO ingest,
    then qwen3-1.7b at full width, f32 master parameters, bf16 compute,
    AdamW.  Every loss finite, every parameter leaf changed, F launched on
    every layer of every step (twice with remat "full": the forward and
    the checkpoint's recompute)."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model

    cfg = get_config(SERVE_ARCH)
    n_params = build_model(cfg).param_count()
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    B = int(TRAIN_ARGS[TRAIN_ARGS.index("--batch") + 1])
    S = int(TRAIN_ARGS[TRAIN_ARGS.index("--seq") + 1])
    per_step = cfg.n_layers * (2 if cfg.remat == "full" else 1)
    # ---- the training path: counters at 0 just before, read just after --
    torch.cuda.synchronize()
    _zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated(dev)
    retries = torch.cuda.memory_stats(dev)["num_alloc_retries"]
    reserved = torch.cuda.memory_reserved(dev)
    trained = res.pop("params")
    start = build_model(cfg).init(0, device=dev)     # main's --seed 0
    same = [i for i, (a, b) in enumerate(zip(tree_leaves(start),
                                             tree_leaves(trained)))
            if torch.equal(a, b)]
    del start, trained
    step_ms = [t * 1e3 for t in res["step_s"]]
    med = statistics.median(step_ms[2:])
    tokens = B * S
    # MFU: the model's FLOPs (6 N tokens for a train step) over the step
    # time and the H100's peak, through analysis.roofline's definitions
    from repro_torch.analysis.roofline import PEAK_FLOPS, model_flops
    from repro_torch.configs import ShapeConfig
    mfu = model_flops(cfg, ShapeConfig("train", "train", S, B),
                      n_params) / (med * 1e-3) / PEAK_FLOPS
    print(f"  (2) {' '.join(TRAIN_ARGS)}: {res['steps_run']} steps in "
          f"{wall:.1f} s (CIAO ingest and init included); step ms "
          + ", ".join(f"{t:.1f}" for t in step_ms)
          + f"; median after the first two {med:.3f} ms, "
          f"{tokens / (med * 1e-3):.0f} tokens/s, MFU {mfu:.1%} "
          f"(analysis.roofline.model_flops, 6 N tokens, / step time / "
          f"PEAK_FLOPS 989 TFLOP/s, N {n_params:,}); peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB, reserved "
          f"{reserved / 2**30:.2f} GiB, allocator retries {retries}; {card}")
    print(f"  loss first {res['first_loss']:.4f}, last "
          f"{res['last_loss']:.4f} (warmup 100 steps: step {steps}'s lr is "
          f"{steps}% of peak); kernel F launches {launches} "
          f"({launches / steps:g} per step, {cfg.n_layers} layers x "
          f"{per_step // cfg.n_layers}); loading ratio "
          f"{res['loading_ratio']:.4f}")
    if (res["steps_run"] != steps or res["device"] != "cuda"
            or not all(math.isfinite(x) for x in res["losses"])):
        raise AssertionError(f"training: {res}")
    if same:
        raise AssertionError(f"training left parameter leaves {same} as "
                             "they were")
    if launches != per_step * steps:
        raise AssertionError(f"training: F launches {launches} != "
                             f"{per_step} x {steps} steps")
    wgmma = _wgmma_check(SERVE_ARCH, cfg, launches)
    backwards = _backward_check("training", cfg, cfg.n_layers * steps)
    print(f"  all {wgmma} of F's launches on flash_kernel_wgmma; "
          f"{backwards}: {cfg.n_layers} a step, none plain")
    return {"step_ms": step_ms, "median_ms": med, "tokens_per_s":
            tokens / (med * 1e-3), "mfu": mfu, "peak_bytes": peak,
            "launches": launches, "launches_per_step": launches // steps,
            "param_count": n_params, "losses": res["losses"]}


def crash_and_resume(n_params: int) -> dict:
    """(3) tests/test_train.py's crash and resume, on the card, at the
    reduced config."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt

    state_gb = n_params * STATE_BYTES_PER_PARAM / 1e9
    print(f"  (3) the full-width state ({n_params:,} parameters x "
          f"{STATE_BYTES_PER_PARAM} B = {state_gb:.1f} GB of f32 params, m "
          f"and v) is not checkpointed in this script: writing it out and "
          f"reading it back would take more than this phase's time; the "
          f"crash and resume runs at the reduced config, as "
          f"tests/test_train.py does")
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "run")
        args = RESUME_ARGS + ["--ckpt-dir", d]
        try:
            train.main(args + ["--fail-at-step", "6"])
        except SystemExit as e:
            if e.code != 42:
                raise
        else:
            raise AssertionError("--fail-at-step 6 did not crash")
        resumed_from = ckpt.latest_step(d)
        res = train.main(args)
        del res["params"]
        if not (resumed_from is not None and 2 <= resumed_from <= 6
                and 4 <= res["steps_run"] <= 8
                and res["last_loss"] is not None
                and ckpt.latest_step(d) == 10 and res["device"] == "cuda"):
            raise AssertionError(f"crash and resume: from {resumed_from}, "
                                 f"{res}")
    print(f"  crashed at step 6, latest checkpoint step {resumed_from}, "
          f"resumed and ran {res['steps_run']} steps to step 10 on "
          f"{res['device']}; last loss {res['last_loss']:.4f}")
    return {"resumed_from": resumed_from, "steps_run": res["steps_run"]}


def flash_training_timing(dev) -> dict:
    """Kernel F at the training shapes (B 8, H 16/8, d 128, bf16, causal;
    S 256, and S 2,048, the benchmark's train cell), CUDA events: its
    forward launch (the training instance, which stores lse, beside the
    serving one), its backward kernel (delta, dq, dk/dv) and the plain
    version's recompute under autograd (the backward before the kernel,
    still every other pair's)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn

    _, H, Hkv, _, d = FLASH_SHAPE
    B = 8
    out = {}
    for S in (256, 2048):
        rng = np.random.default_rng(SEED + S)
        q, k, v, g = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
            np.float32)).to(dev).to(torch.bfloat16) for h in (H, Hkv, Hkv, H))
        pos = torch.arange(S, device=dev)
        qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
        o, lse = fa.flash_attention(qt, kt, vt, with_lse=True)

        def plain():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            y = attn.flash_attention_plain(qd, kd, vd, q_positions=pos,
                                           k_positions=pos)
            torch.autograd.grad(y, (qd, kd, vd), g)

        fwd = cuda_ms(lambda: fa.flash_attention(qt, kt, vt), 20)
        fwd_lse = cuda_ms(lambda: fa.flash_attention(qt, kt, vt,
                                                     with_lse=True), 20)
        bwd = cuda_ms(lambda: fa.flash_attention_backward(
            qt, kt, vt, o, lse, gt), 20)
        rec = cuda_ms(plain, 3, warmup=1)
        flop = 5 * 2 * B * H * S * S * d / 2     # five products, causal
        row = {"shape": f"B={B} H={H} Hkv={Hkv} S={S} d={d} bfloat16 "
                        f"causal", "forward_ms": fwd,
               "forward_lse_ms": fwd_lse, "backward_ms": bwd,
               "backward_tflop_per_s": flop / bwd / 1e9,
               "backward_bound_ms": flop / BF16_FLOP_PER_S * 1e3,
               "backward_recompute_ms": rec}
        print(f"  F at the training shape B={B} H={H}/{Hkv} S={S} d={d} "
              f"bf16: forward {fwd:.4f} ms (training instance {fwd_lse:.4f}"
              f"), backward kernel {bwd:.4f} ms ({flop / bwd / 1e9:.1f} "
              f"TFLOP/s of the five causal products, "
              f"{flop / BF16_FLOP_PER_S * 1e3 / bwd:.1%} of the bf16 "
              f"bound {flop / BF16_FLOP_PER_S * 1e3:.4f} ms), plain "
              f"recompute + autograd {rec:.3f} ms (CUDA events)")
        out[f"seq_{S}"] = row
    return out


def training(dev, card: str) -> dict:
    """The training phase: (1) gradient routes, (2) launch/train.py at
    full width, (3) crash and resume; then F's times at the training
    shape.  Frees what it allocated."""
    # cached blocks of earlier phases' shapes would crowd the full-width
    # state into allocator retries
    _free()
    out = {"routes": gradient_routes(dev)}
    _free()
    out["train"] = train_full_width(dev, card)
    out["resume"] = crash_and_resume(out["train"]["param_count"])
    out["flash"] = flash_training_timing(dev)
    _free()
    return out


# ---------------------------------------------------------------------------
# training every family: F's gradient route and one train step each
# ---------------------------------------------------------------------------

#: (arch, cut, optimizer) at published widths, cut in depth only:
#: llama4-scout 2 MoE layers (6.47 B, bf16 parameters), deepseek-v3 one
#: dense + one MoE layer (13.94 B, bf16; its 256 experts as published),
#: internvl2 2 layers (3.81 B, bf16), recurrentgemma 3 layers, one
#: (rec, rec, attn) period with the band (2.54 B, f32), rwkv6 2 layers
#: (0.51 B, f32), seamless 2 + 2 layers (0.58 B, f32).  The bf16-parameter
#: archs step with adafactor: AdamW's f32 moments would be 48 GiB for
#: llama4, 104 GiB for deepseek and 28 GiB beside internvl2's update
#: temporaries; the others with their configs' AdamW
FAMILY_TRAIN = (("llama4-scout-17b-a16e", {"n_layers": 2}, "adafactor"),
                ("deepseek-v3-671b", {"n_layers": 2, "first_dense": 1},
                 "adafactor"),
                ("internvl2-76b", {"n_layers": 2}, "adafactor"),
                ("recurrentgemma-9b", {"n_layers": 3}, "adamw"),
                ("rwkv6-3b", {"n_layers": 2}, "adamw"),
                ("seamless-m4t-medium", {"per_stack": 2}, "adamw"))
#: batch and sequence of every train step (internvl2 adds its 1,024
#: patch embeddings; seamless splits S into 128 frames and 128 tokens,
#: as configs.input_specs does)
FAMILY_BATCH, FAMILY_SEQ = 8, 256
#: elements of the gradients compared at a time (a deepseek-v3 expert
#: stack is 3.76 G)
COMPARE_PIECE = 1 << 26


def _grad_err(a_host, b, dev) -> tuple[bool, float]:
    """(finite and non-zero, max |a - b| / max |b|) of a gradient leaf on
    the host and its twin on the card, a piece at a time."""
    import torch
    ok, diff, amax, bmax = True, 0.0, 0.0, 0.0
    for a, c in zip(a_host.reshape(-1).split(COMPARE_PIECE),
                    b.reshape(-1).split(COMPARE_PIECE)):
        a, c = a.to(dev).float(), c.float()
        ok = ok and bool(torch.isfinite(a).all() and torch.isfinite(c).all())
        diff = max(diff, float((a - c).abs().max()))
        amax = max(amax, float(a.abs().max()))
        bmax = max(bmax, float(c.abs().max()))
    return ok and amax > 0 and bmax > 0, diff / max(bmax, 1e-30)


def _family_config(arch: str, cut: dict):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if "per_stack" in cut:
        return _encdec_config(arch, cut["per_stack"])
    if "first_dense" in cut:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=cut["first_dense"]))
    return dataclasses.replace(cfg, n_layers=cut["n_layers"])


@contextlib.contextmanager
def _routing(record: list, replay: bool):
    """The MoE's top-k choice recorded (F's route) or replayed (the plain
    route) call by call, forward and the checkpoint's recompute alike; the
    gates stay functions of the router's logits, so the router's gradient
    is taken as it is.  The choice is discrete: a tie broken the other way
    by an attention output that differs in its last bf16 bit would move a
    token's whole contribution between experts, which no bound on F's
    numerics covers.  Yields the count of assignments the plain route's
    own routing would have chosen otherwise."""
    import torch
    from repro_torch.models import moe

    real, calls, moved = moe.route, iter(record), [0]

    def route(logits, m):
        r = real(logits, m)
        if not replay:
            record.append(r.ids)
            return r
        ids = next(calls)
        moved[0] += int((torch.sort(r.ids, -1)[0]
                         != torch.sort(ids, -1)[0]).sum())
        gates = r.probs.gather(-1, ids)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        pos, keep, slot = moe._place(ids.reshape(-1), m.n_experts, r.C)
        return moe.Routing(r.probs, ids, gates, pos, keep, slot, r.C)

    moe.route = route
    try:
        yield moved
    finally:
        moe.route = real


def family_route(arch: str, cfg, model, params, batch, dev) -> dict:
    """(1) ``value_and_grad`` through F's autograd Function (the trainer's
    route) against autograd through the plain version, in the config's
    bf16 compute: every gradient finite and non-zero, the routes within
    GRAD_TOL of each leaf's max |g| (bf16 parameters' gradients are
    rounded to bf16 too: 2^-8 of the max at most, inside the bound), F's
    launches those of the forward and the checkpoint's recompute.  The
    first route's gradients wait in host memory meanwhile."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_attention_plain
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.train_step import value_and_grad

    tol = GRAD_TOL["bfloat16"]
    want = _f_per_prefill(cfg) * (2 if cfg.remat == "full" else 1)
    record: list = []
    torch.cuda.synchronize()
    fa.launches = 0
    _zero_flash_routes()
    t0 = time.perf_counter()
    with _routing(record, replay=False):
        loss_f, g_f = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    launches = fa.launches
    wgmma = _wgmma_check(arch, cfg, launches)
    backwards = _backward_check(arch, cfg, _f_per_prefill(cfg))
    g_host = [g.to("cpu") for g in tree_leaves(g_f)]
    del g_f
    t0 = time.perf_counter()
    with _routing(record, replay=True) as moved:
        loss_p, g_p = value_and_grad(model, params, batch,
                                     attention=flash_attention_plain)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    if fa.launches != launches:
        raise AssertionError(f"{arch}: the plain route launched kernel F")
    worst, bad = 0.0, []
    for name, a, b in zip(_leaf_names(params), g_host, tree_leaves(g_p)):
        ok, rel = _grad_err(a, b, dev)
        if not ok:
            bad.append(f"{name} (zero or not finite)")
            continue
        worst = max(worst, rel)
        if not rel <= tol:
            bad.append(f"{name} ({rel:.3g})")
    del g_p, g_host
    n_assign = sum(int(r.numel()) for r in record)
    print(f"  (1) {arch}: loss {float(loss_f):.6f} (F) vs "
          f"{float(loss_p):.6f} (plain); {len(_leaf_names(params))} "
          f"gradients, all finite and non-zero, F route vs plain max "
          f"{worst:.3g} of the leaf's max |g| (tol {tol}); F launches "
          f"{launches} (want {want}: forward + the checkpoint's recompute;"
          f" {wgmma} on flash_kernel_wgmma), {backwards}"
          + (f"; routing replayed: the plain route's own top-k differs in "
             f"{moved[0]} of {n_assign} sorted expert ids (forward and "
             f"recompute)" if record else "")
          + f"; {t_f * 1e3:.1f} ms vs {t_p * 1e3:.1f} ms (host clock)")
    if bad or launches != want:
        raise AssertionError(f"gradient route, {arch}: {bad}, F launches "
                             f"{launches} != {want}")
    return {"max_rel_err": worst, "launches": launches,
            "wgmma_launches": wgmma,
            "routing_moved": moved[0] if record else None,
            "ms_f": t_f * 1e3, "ms_plain": t_p * 1e3}


def family_step(arch: str, cfg, model, params, batch, kind: str, dev,
                card: str) -> dict:
    """(2) ``train.train_step.make_train_step`` with ``kind`` on the
    batch: a first step, then the timed one (host clock, the device
    synchronised by reading the loss); finite losses, the final norm's
    scale moved, F on every attention layer of each step; ms, tokens/s,
    peak memory and the step's share of ``analysis.flops.estimate``'s
    bound at the H100's constants."""
    import dataclasses

    import torch
    from repro_torch.analysis import flops as flops_mod
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import make_train_step, opt_config_for

    oc = dataclasses.replace(opt_config_for(cfg), kind=kind)
    state = opt_mod.init(params, oc)
    step = make_train_step(model, oc)
    norm = params["ln_f"].detach().clone()
    want = _f_per_prefill(cfg) * (2 if cfg.remat == "full" else 1)
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        torch.cuda.synchronize()
        fa.launches = 0
        _zero_flash_routes()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if fa.launches != want:
            raise AssertionError(f"train step, {arch}: F launches "
                                 f"{fa.launches} != {want}")
        wgmma = _wgmma_check(arch, cfg, want)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = not torch.equal(norm, params["ln_f"])
    B = FAMILY_BATCH
    S = sum(batch[k].shape[1] for k in ("tokens", "extra_embeds", "frames")
            if k in batch)
    shape = ShapeConfig("train", "train", S, B)
    n, n_act = model.param_count(), model.active_param_count()
    est = flops_mod.estimate(cfg, shape, n, n_act)
    compute_s = est.flops_global / rl.PEAK_FLOPS
    memory_s = est.hbm_bytes_global / rl.HBM_BW
    bound_ms = max(compute_s, memory_s) * 1e3
    print(f"  (2) {arch}, {kind}, B {B} x S {S}: step ms {ms[0]:.1f} "
          f"(first), {ms[1]:.3f} (timed); {B * S / (ms[1] * 1e-3):.0f} "
          f"tokens/s; losses {losses[0]:.4f}, {losses[1]:.4f}; bound "
          f"{bound_ms:.3f} ms by "
          f"{'compute' if compute_s >= memory_s else 'memory'} "
          f"(flops.estimate: {est.flops_global:.4e} FLOP, "
          f"{est.hbm_bytes_global:.4e} B), share {bound_ms / ms[1]:.2%}; "
          f"peak max_memory_allocated {peak / 2**30:.2f} GiB; F {want} a "
          f"step ({wgmma} on flash_kernel_wgmma); ln_f moved {moved}; "
          f"{card}")
    if not all(math.isfinite(x) for x in losses) or not moved:
        raise AssertionError(f"train step, {arch}: losses {losses}, ln_f "
                             f"moved {moved}")
    return {"optimizer": kind, "batch": B, "seq": S, "step_ms": ms[1],
            "first_step_ms": ms[0], "tokens_per_s": B * S / (ms[1] * 1e-3),
            "bound_ms": bound_ms, "share": bound_ms / ms[1],
            "peak_bytes": peak, "losses": losses, "launches_per_step": want,
            "param_count": n}


def family_training(dev, card: str) -> dict:
    """Each of FAMILY_TRAIN at published width and cut depth: (1) F's
    gradient route against the plain route, (2) one timed train step.
    Frees what each family allocated before the next."""
    import torch
    from repro_torch.configs import ShapeConfig, make_batch
    from repro_torch.models.model import build_model

    out = {}
    for arch, cut, kind in FAMILY_TRAIN:
        _free()
        cfg = _family_config(arch, cut)
        model = build_model(cfg)
        S = FAMILY_SEQ + cfg.frontend_len
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, ShapeConfig("family", "train", S, FAMILY_BATCH),
            seed=SEED).items()}
        t0 = time.perf_counter()
        params = model.init(SEED, device=dev)
        torch.cuda.synchronize()
        print(f"  {arch}: {cfg.n_layers} layers at published width, "
              f"{model.param_count():,} parameters in {cfg.param_dtype}, "
              f"compute {cfg.compute_dtype}, remat {cfg.remat}; init "
              f"{time.perf_counter() - t0:.1f} s")
        route = family_route(arch, cfg, model, params, batch, dev)
        _free()
        out[arch] = {"route": route, "step": family_step(
            arch, cfg, model, params, batch, kind, dev, card)}
        del params, batch
    _free()
    return out


#: the model mesh phase (PR 25): the train steps' depth and the remat
#: check's (full width); tolerances from the JAX package's tests
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_TOL = 5e-3          # tests/test_dist.py's sharded train step
MESH_GRAD_TOL = 2e-5           # F's f32 bound, of each leaf's max |g|
REMAT_TOL = 2e-5               # F's f32 bound, of each leaf's max |g|
#: dry-run cells, each its own process over a fake world of 256: the
#: dense decode cell reaches the flash-decoding stub in both packages
#: (a model axis of 16 divides its 32,896-slot cache), so the dense
#: train cell gives the dense record
DRYRUN_CELLS = (("qwen3-1.7b", "decode_32k"), ("qwen3-1.7b", "train_4k"),
                ("deepseek-v3-671b", "prefill_32k"))


def start_dryrun(out_dir: str) -> list:
    """The dry-run cells, started at once in their own processes (CPU
    only: meta tensors and a fake process group)."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return [(arch, shape, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for arch, shape in DRYRUN_CELLS]


def finish_dryrun(procs: list, out_dir: str) -> dict:
    """(5) Each dry-run cell's record read back: device FLOPs, the
    collective counts, the dominant term, the seconds; the stub cell
    must fail with the stub's error, as the JAX package's does."""
    out = {}
    for arch, shape, t0, p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        path = os.path.join(out_dir, f"{arch}_{shape}_single.json")
        if shape == "decode_32k" and arch == "qwen3-1.7b":
            if p.returncode == 0 or "sharded_decode_attention_gqa" not in log:
                raise AssertionError(f"dry run {arch} x {shape}: expected "
                                     f"the flash-decoding stub: {log[-2000:]}")
            print(f"  (5) {arch} x {shape} x single: raises the "
                  f"flash-decoding stub (NotImplementedError, "
                  f"sharded_decode_attention_gqa) as the JAX package's "
                  f"dry run does; {wall:.1f} s")
            out[f"{arch}_{shape}"] = {"stub": True, "wall_s": wall}
            continue
        if p.returncode != 0 or not os.path.exists(path):
            raise AssertionError(f"dry run {arch} x {shape}: rc "
                                 f"{p.returncode}: {log[-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        ro, mem = rec["roofline"], rec["memory_analysis"]
        if not (ro["device_flops"] > 0 and ro["n_devices"] == 256
                and sum(ro["collectives"]["counts"].values()) > 0):
            raise AssertionError(f"dry run record {path}: {rec}")
        print(f"  (5) {arch} x {shape} x single (256 ranks): device FLOPs "
              f"{ro['device_flops']:.4e}, bytes {ro['device_bytes']:.4e}, "
              f"collectives {ro['collectives']['counts']} "
              f"({ro['collective_bytes']:.4e} B); terms compute "
              f"{ro['compute_s']:.4e} s, memory {ro['memory_s']:.4e} s, "
              f"collective {ro['collective_s']:.4e} s -> {ro['dominant']}, "
              f"roofline_frac {ro['roofline_frac']:.4f}; per rank "
              f"{mem['argument_bytes'] / 1e9:.3f} GB arguments, "
              f"{mem['temp_bytes'] / 1e9:.3f} GB saved by autograd (a "
              f"lower bound); build {rec['lower_s']} s, run "
              f"{rec['compile_s']} s, process {wall:.1f} s")
        out[f"{arch}_{shape}"] = {
            "device_flops": ro["device_flops"], "dominant": ro["dominant"],
            "collective_counts": ro["collectives"]["counts"],
            "roofline_frac": ro["roofline_frac"], "wall_s": wall}
    return out


def _one_rank_group():
    """An NCCL process group of one rank (a ``HashStore``: no address),
    the mesh's world."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)


def mesh_serve(serve) -> dict:
    """(1) ``launch.serve.main --mesh-shape 1,1`` over a one-rank NCCL
    group: DTensor parameters, activations and cache, attention under
    ``local_map`` on kernel F; the greedy tokens equal the serve phase's
    run without a mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_mod

    cfg = get_config(SERVE_ARCH)
    args = SERVE_ARGS + ["--mesh-shape", "1,1"]
    # ---- the mesh serve path: counters at 0 just before, read just after
    torch.cuda.synchronize()
    _zero_counters()
    res = serve_mod.main(args)
    torch.cuda.synchronize()
    launches = fa.launches
    # -----------------------------------------------------------------------
    want = serve["result"]["tokens"]
    same = bool(torch.equal(res["tokens"].cpu(), want.cpu()))
    per_prefill = launches / res["prefill_calls"]
    wgmma = _wgmma_check(SERVE_ARCH, cfg, launches)
    print(f"  (1) {' '.join(args)} (one-rank NCCL group, (1, 1) mesh, "
          f"DTensor parameters): prefill {res['prefill_ms']:.3f} ms, decode "
          f"{res['decode_ms_per_step']:.3f} ms/step (without a mesh: "
          f"{serve['result']['prefill_ms']:.3f} / "
          f"{serve['result']['decode_ms_per_step']:.3f}); greedy tokens "
          f"{tuple(res['tokens'].shape)} equal to the run without a mesh: "
          f"{same}; kernel F launches {launches} ({per_prefill:g} per "
          f"prefill, {cfg.n_layers} layers; {wgmma} on flash_kernel_wgmma)")
    if not same or per_prefill != cfg.n_layers:
        raise AssertionError(f"mesh serve: tokens equal {same}, F launches "
                             f"{launches}")
    return {"launches": launches, "prefill_ms": res["prefill_ms"],
            "decode_ms_per_step": res["decode_ms_per_step"]}


def mesh_train(dev) -> dict:
    """(2) qwen3-1.7b at full width, cut to MESH_TRAIN_LAYERS layers, on
    the (1, 1) mesh against the same model without one: first every
    leaf's gradient in f32 (``value_and_grad``) within MESH_GRAD_TOL of
    its max |g|, then two bf16 train steps with ``grad_specs``, each loss
    and every leaf after them within MESH_TRAIN_TOL.  Kernel F's launches
    are counted over the mesh steps alone: one per layer per forward,
    twice with remat "full"."""
    import dataclasses

    import torch
    from repro_torch.configs import ShapeConfig, get_config, make_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import make_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import param_axes
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (make_train_step,
                                              opt_config_for, value_and_grad)

    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=MESH_TRAIN_LAYERS)
    mesh = make_mesh("1,1")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, ShapeConfig("mesh", "train", 256, 8), seed=SEED).items()}
    b_mesh = tree_map(shd.distribute, batch, shd.batch_shardings(batch, mesh))

    # ---- the gradients, in f32
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(f32)
    plain = model.init(SEED, device=dev)
    psh = shd.param_shardings(plain, param_axes(f32), mesh)
    on_mesh = shd.shard_params(tree_map(torch.clone, plain), psh)
    loss0, g0 = value_and_grad(model, plain, batch)
    with shd.use_mesh(mesh):
        loss1, g1 = value_and_grad(model, on_mesh, b_mesh)
    torch.cuda.synchronize()
    grad_err = max(float((a.full_tensor() - b).abs().max() / b.abs().max())
                   for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
    grad_loss = abs(float(loss0) - float(loss1.full_tensor()
                                         if shd.is_dtensor(loss1)
                                         else loss1))
    del g0, g1, plain, on_mesh
    _free()

    # ---- two train steps in bf16
    model = build_model(cfg)
    oc = opt_config_for(cfg)
    plain = model.init(SEED, device=dev)
    on_mesh = shd.shard_params(tree_map(torch.clone, plain), psh)
    st_plain, st_mesh = opt_mod.init(plain, oc), opt_mod.init(on_mesh, oc)
    step = make_train_step(model, oc)
    step_mesh = make_train_step(model, oc,
                                grad_specs=tree_map(lambda s: s.spec, psh))
    plain_losses = []
    for _ in range(2):
        plain, st_plain, m0 = step(plain, st_plain, batch)
        plain_losses.append(float(m0["loss"]))
    # ---- the mesh steps: counters at 0 just before, read just after
    torch.cuda.synchronize()
    _zero_counters()
    mesh_losses = []
    with shd.use_mesh(mesh):
        for _ in range(2):
            on_mesh, st_mesh, m1 = step_mesh(on_mesh, st_mesh, b_mesh)
            mesh_losses.append(float(m1["loss"]))
    torch.cuda.synchronize()
    launches = fa.launches
    # -----------------------------------------------------------------------
    want = 2 * cfg.n_layers * (2 if cfg.remat == "full" else 1)
    losses = list(zip(plain_losses, mesh_losses))
    leaf = max(float((a.full_tensor() - b).abs().max())
               for a, b in zip(tree_leaves(on_mesh), tree_leaves(plain)))
    dl = max(abs(a - b) for a, b in losses)
    print(f"  (2) qwen3-1.7b at full width cut to {MESH_TRAIN_LAYERS} "
          f"layers, B 8 x 256, on the (1, 1) mesh vs without: f32 grads "
          f"max {grad_err:.3g} of the leaf's max |g| (tol {MESH_GRAD_TOL}), "
          f"loss diff {grad_loss:.3g}; 2 bf16 train steps with grad_specs: "
          f"losses " + ", ".join(f"{a:.6f} / {b:.6f}" for a, b in losses)
          + f"; max |loss diff| {dl:.3g}, max |leaf diff| after the steps "
          f"{leaf:.3g} (tol {MESH_TRAIN_TOL}); kernel F launches in the "
          f"mesh steps {launches} (want {want}: {cfg.n_layers} layers x 2 "
          f"steps, remat {cfg.remat!r})")
    if not (grad_err <= MESH_GRAD_TOL and dl <= MESH_TRAIN_TOL
            and leaf <= MESH_TRAIN_TOL):
        raise AssertionError(f"mesh train: grads {grad_err}, loss diff {dl},"
                             f" leaf diff {leaf}")
    if launches != want:
        raise AssertionError(f"mesh train: F launches {launches} != {want}")
    del plain, on_mesh, st_plain, st_mesh
    return {"loss_diff": dl, "leaf_diff": leaf, "grad_rel_err": grad_err,
            "launches": launches, "losses": losses}


def remat_policies(dev) -> dict:
    """(3) The remat policies at GRAD_LAYERS layers at full width in f32:
    the grads under "dots" and "save_block_io" against "full" within
    REMAT_TOL of each leaf's max |g|, each policy's peak memory."""
    import dataclasses

    import torch
    from repro_torch.configs import ShapeConfig, get_config, make_batch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad

    base = dataclasses.replace(get_config(SERVE_ARCH), n_layers=GRAD_LAYERS,
                               compute_dtype="float32")
    params = build_model(base).init(SEED, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        base, ShapeConfig("remat", "train", 256, 8), seed=SEED).items()}
    out, ref = {}, None
    for policy in ("full", "dots", "save_block_io", "none"):
        model = build_model(dataclasses.replace(base, remat=policy))
        torch.cuda.synchronize()
        _free()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        loss, g = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        g = tree_leaves(g)
        if ref is None:
            ref = g
        worst = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(g, ref))
        out[policy] = {"loss": float(loss), "max_rel_err": worst,
                       "peak_bytes": peak}
        print(f"  (3) remat {policy!r}: loss {float(loss):.6f}, grads vs "
              f"'full' max {worst:.3g} of the leaf's max |g| (tol "
              f"{REMAT_TOL}); peak above the parameters "
              f"{peak / 2**30:.3f} GiB")
        if not worst <= REMAT_TOL:
            raise AssertionError(f"remat {policy}: {worst}")
        del g
    del params, ref
    return out


def roofline_shares(serve, trained, rows, card: str) -> dict:
    """(4) Measured times against the analytic model at the H100's
    constants (``analysis.flops.estimate``, ``analysis.roofline``): the
    serve phase's prefill and decode step, the training phase's step;
    beside them the 6·N MFU line, and kernel B's main-batch launch against
    its bytes bound, with ``scan_estimate``'s figure (the reference's jnp
    traffic: not a bound on B)."""
    from repro_torch.analysis import flops as flops_mod
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.model import build_model

    cfg = get_config(SERVE_ARCH)
    m = build_model(cfg)
    n, n_act = m.param_count(), m.active_param_count()
    B = int(SERVE_ARGS[SERVE_ARGS.index("--batch") + 1])
    S = int(SERVE_ARGS[SERVE_ARGS.index("--prompt-len") + 1])
    gen = int(SERVE_ARGS[SERVE_ARGS.index("--gen") + 1])
    tB = int(TRAIN_ARGS[TRAIN_ARGS.index("--batch") + 1])
    tS = int(TRAIN_ARGS[TRAIN_ARGS.index("--seq") + 1])
    res = serve["result"]
    # the decode step's context: the mean cache length over the run
    cells = (("prefill", ShapeConfig("serve", "prefill", S, B),
              res["prefill_ms"]),
             ("decode", ShapeConfig("serve", "decode", S + (gen - 1) // 2,
                                    B), res["decode_ms_per_step"]),
             ("train", ShapeConfig("train", "train", tS, tB),
              trained["train"]["median_ms"]))
    out = {}
    for name, shape, ms in cells:
        est = flops_mod.estimate(cfg, shape, n, n_act)
        compute_s = est.flops_global / rl.PEAK_FLOPS
        memory_s = est.hbm_bytes_global / rl.HBM_BW
        bound_ms = max(compute_s, memory_s) * 1e3
        out[name] = {"measured_ms": ms, "bound_ms": bound_ms,
                     "share": bound_ms / ms,
                     "bound_by": "compute" if compute_s >= memory_s
                     else "memory", "flops": est.flops_global,
                     "bytes": est.hbm_bytes_global,
                     "model_flops_share": rl.model_flops(cfg, shape, n_act)
                     / rl.PEAK_FLOPS * 1e3 / ms}
        print(f"  (4) {name} ({shape.kind}, B {shape.global_batch}, S "
              f"{shape.seq_len}): measured {ms:.3f} ms; analytic "
              f"{est.flops_global:.4e} FLOP, {est.hbm_bytes_global:.4e} B "
              f"-> bound {bound_ms:.4f} ms by {out[name]['bound_by']}, "
              f"share {out[name]['share']:.2%}; model FLOPs at peak "
              f"{out[name]['model_flops_share']:.2%} (MFU)")
    b = next(r for r in rows if r["name"].startswith("scan"))
    print(f"  (4) kernel B, the main path's 64-query batch ({b['shape']}): "
          f"{b['ms']:.4f} ms; scan_estimate {b['analytic_flops']:.4e} FLOP, "
          f"{b['analytic_bytes']:.4e} B -> {b['analytic_ms']:.5f} ms, "
          f"{b['analytic_ms'] / b['ms']:.2%} of the kernel's time (the "
          f"reference's jnp traffic, not a bound on B); the bytes bound "
          f"{b['bound_ms']:.5f} ms, share {b['bound_ms'] / b['ms']:.2%}; "
          f"train MFU line: {trained['train']['mfu']:.2%}; {card}")
    out["scan"] = {"ms": b["ms"], "analytic_ms": b["analytic_ms"],
                   "bound_ms": b["bound_ms"],
                   "share": b["bound_ms"] / b["ms"]}
    return out


def model_mesh(serve, trained, rows, dev, card: str) -> dict:
    """The model mesh phase: (1) serving and (2) two train steps on a
    (1, 1) mesh over a one-rank NCCL group, (3) the remat policies, (4)
    the roofline shares, (5) the dry run, whose cells run in their own
    processes meanwhile."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryrun(tmp)
        try:
            _free()
            _one_rank_group()
            out = {"serve": mesh_serve(serve)}
            _free()
            out["train"] = mesh_train(dev)
            _free()
            out["remat"] = remat_policies(dev)
            _free()
            out["roofline"] = roofline_shares(serve, trained, rows, card)
            out["dryrun"] = finish_dryrun(procs, tmp)
        finally:
            for *_, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if dist.is_initialized():
                dist.destroy_process_group()
    return out


#: kernel F's serving shape: batch, query heads, kv heads, prompt, head dim
FLASH_SHAPE = (8, 16, 8, 512, 128)


#: kernel F at internvl2's prefill (1,024 patch embeddings and 512 text
#: tokens): batch, heads, kv heads, positions, head dim
FLASH_VISION_SHAPE = (8, 64, 8, 1536, 128)
#: kernel F at seamless-m4t-medium's prefill, d 64: batch, heads, kv
#: heads, head dim; and its three calls, (form, Sq, Sk, causal)
FLASH_ENCDEC_SHAPE = (4, 16, 16, 64)
FLASH_ENCDEC_CALLS = (("unmasked", ENCDEC_FRAMES, ENCDEC_FRAMES, False),
                      ("causal", 128, 128, True),
                      ("cross", 128, ENCDEC_FRAMES, False))


def _flash_timing(dev, name: str, shape, seed: int, build=None) -> dict:
    """Kernel F at ``shape`` (B, H, Hkv, Sq, Sk, d, causal) on seeded bf16
    q, k, v laid out as the model hands them over ((B, S, heads, d)
    transposed), beside its plain version and
    ``scaled_dot_product_attention``.  The bound counts q, k, v and o
    once against 4 d operations a (query, key) pair, half of Sq Sk when
    causal; ``build``: the (d, dv) pairs whose ptxas report to add."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, Hkv, Sq, Sk, d, causal = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
        np.float32)).to(dev).to(torch.bfloat16).transpose(1, 2)
        for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    ms = kernel_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20,
                   "flash_kernel")
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * Sq * Sk * d // (2 if causal else 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), 20)
    mask = "causal" if causal else "unmasked"
    out = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:78",
        "ms": ms, "plain_ms": cuda_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=causal), 3),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": lib_ms,
        "library_note": f"scaled_dot_product_attention(is_causal={causal}, "
                        f"enable_gqa=True), timed only",
        "ms_from": ms_from("flash_kernel"), "wrapper_call_ms": cuda_ms(
            lambda: fa.flash_attention(q, k, v, causal=causal), 20),
        "shape": f"B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} d={d} {q.dtype} "
                 f"{mask}",
        "kernel": fa._kernel_name(q.dtype, d),
        "bound_bytes_ms": bytes_ms, "bound_ops_ms": flops_ms,
        "tflop_per_s": flops / (ms * 1e-3) / 1e12,
        "bound_share": max(bytes_ms, flops_ms) / ms,
        "ms_over_library": ms / lib_ms,
    }
    if build:
        out["build"] = _flash_build_report(*build)
    return out


def flash_timing(dev) -> dict:
    """Kernel F at the serving shape (:func:`_flash_timing`), with the
    build's registers, spills and shared memory of the (128, 128)
    instances.  Timed before the serve path: every profiler trace that
    missed its kernel in this script's runs came after the model had
    served."""
    B, H, Hkv, S, d = FLASH_SHAPE
    return _flash_timing(dev, "flash_attention", (B, H, Hkv, S, S, d, True),
                         SEED, build=[(d, d)])


def flash_vision_timing(dev) -> dict:
    """Kernel F at internvl2's prefill shape (:func:`_flash_timing`)."""
    from repro_torch.configs import get_config

    B, H, Hkv, S, d = FLASH_VISION_SHAPE
    cfg = get_config("internvl2-76b")
    if (cfg.n_heads, cfg.n_kv_heads, cfg.hd(), cfg.frontend_len + MODEL_PROMPT,
            MODEL_BATCH) != (H, Hkv, d, S, B):
        raise AssertionError(f"FLASH_VISION_SHAPE {FLASH_VISION_SHAPE} is "
                             f"not internvl2's prefill")
    return _flash_timing(dev, "flash_attention (internvl2, S 1,536)",
                         (B, H, Hkv, S, S, d, True), SEED + 6)


def flash_encdec_timing(dev) -> list[dict]:
    """Kernel F at seamless-m4t-medium's three prefill calls at d 64
    (:func:`_flash_timing`): the encoder over the frames, unmasked; the
    decoder, causal; cross attention from the decoder to the frames; with
    the (64, 64) instances' ptxas report on the first."""
    from repro_torch.configs import get_config

    B, H, Hkv, d = FLASH_ENCDEC_SHAPE
    cfg = get_config("seamless-m4t-medium")
    if (cfg.n_heads, cfg.n_kv_heads, cfg.hd()) != (H, Hkv, d):
        raise AssertionError(f"FLASH_ENCDEC_SHAPE {FLASH_ENCDEC_SHAPE} is "
                             f"not seamless's")
    return [_flash_timing(dev, f"flash_attention (seamless, {form}, d 64)",
                          (B, H, Hkv, sq, sk, d, causal), SEED + 7 + i,
                          build=[(d, d)] if i == 0 else None)
            for i, (form, sq, sk, causal) in enumerate(FLASH_ENCDEC_CALLS)]


def flash_vision_row(timing: dict, served: dict) -> dict:
    """F's internvl2 row: :func:`flash_vision_timing` with internvl2's
    serve-path launches and its check (i)."""
    iv = served["internvl2-76b"]
    return {**timing, "launches": iv["launches"], "max_abs_err": iv["err"],
            "launches_per_prefill": iv["launches"]
            // iv["result"]["prefill_calls"]}


def flash_encdec_rows(timings: list, recurrent: dict) -> list[dict]:
    """F's seamless rows: :func:`flash_encdec_timing` with seamless's
    serve-path launches of each form and its check (i) on the first call
    of that form."""
    sm = recurrent["seamless-m4t-medium"]
    return [{**t, "launches": sm["form_launches"][form],
             "max_abs_err": sm["errs"][form],
             "launches_per_prefill": sm["form_launches"][form]
             // sm["result"]["prefill_calls"]}
            for t, (form, *_) in zip(timings, FLASH_ENCDEC_CALLS)]


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
        "ms_from": ms_from("pushdown_kernel"), "wrapper_call_ms": call_ms,
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
        "bound_by": "bytes", "library_ms": None,
        "ms_from": ms_from("scan_kernel"),
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
    from repro_torch.analysis.flops import scan_estimate
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.benchmarks.bench_device import scan_bytes
    n = scanner.cache._n_used
    Q, S1 = params.pushed_tbl.shape
    nbytes = scan_bytes(params, n)
    est = scan_estimate(n_rows=n, n_terms=int(params.kinds.shape[0]),
                        n_clauses=int(params.membership.shape[0]),
                        n_queries=Q, n_slots=S1 - 1)
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        # the analytic model of the same launch (scan_estimate at the
        # H100's constants): the reference's jnp traffic, which kernel B
        # does not move, so NOT a bound on it (bound_ms is)
        "analytic_flops": est.flops_global,
        "analytic_bytes": est.hbm_bytes_global,
        "analytic_ms": max(est.flops_global / PEAK_FLOPS,
                                 est.hbm_bytes_global / HBM_BW) * 1e3,
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


#: chunks of the wide batch's prefix store (16,384 records): its host
#: checks scan every record for each of the 200 queries
WIDE_CHUNKS = 2


def wide_batch(run, dev) -> dict:
    """Kernel B timed at the main path's batch shape; then 200 uniform
    ycsb queries in ONE DeviceScanner.scan_batch (term and clause buckets
    512, 256 queries: the kernel before this one refused them) on a
    WIDE_CHUNKS-chunk prefix of the main path's records, every ScanResult checked against
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

    from repro_torch.core.device_scan import DeviceScanner
    from repro_torch.core.server import CiaoStore, FullScanBaseline

    main_scanner = run["scanner"]
    main = scan_timing(main_scanner, main_scanner._prepare(run["batches"][0]),
                       dev)
    store, base = CiaoStore(run["plan"]), FullScanBaseline()
    for chunk, bv in zip(run["chunks"][:WIDE_CHUNKS],
                         run["bvs"][:WIDE_CHUNKS]):
        store.ingest_chunk(chunk, bv)
        base.ingest_chunk(chunk)
    scanner = DeviceScanner(store, backend="cuda", log_queries=False)
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


def spmd_refusal(store) -> None:
    """The sharded device scan over ranks needs a process group of one
    rank a shard, one card a rank: on this one-card machine, with no
    group, ``scan_mesh`` is None and ``spmd=True`` raises (the default
    scans the shards in turn on one card, as below)."""
    import torch
    from repro_torch.core.device_scan import ShardedDeviceScanner
    from repro_torch.dist.sharding import scan_mesh

    mesh = scan_mesh(store.n_shards)
    try:
        ShardedDeviceScanner(store, backend="cuda", spmd=True)
        refused = "did not raise"
    except RuntimeError as e:
        refused = f"raises RuntimeError ({e})"
    print(f"  scan_mesh({store.n_shards}) is {mesh} on this machine "
          f"({torch.cuda.device_count()} card); ShardedDeviceScanner("
          f"spmd=True) "
          f"{refused}")
    if mesh is not None or not refused.startswith("raises"):
        raise AssertionError(f"spmd on one card: mesh {mesh}, {refused}")


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
    spmd_refusal(store)
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
#: the fleet runs at one chunk of 8,192 records per client (106,496)
FLEET_CHUNKS = 1


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


#: the end-to-end phase (paper Figs 3-5): records per cell (half the
#: reference grid's 20,000, for the script's time limit) and executed
#: queries, at the paper's headline budget
E2E_RECORDS = 10000
E2E_QUERIES = 60
E2E_BUDGET = 1.0


def end_to_end(dev) -> dict:
    """Paper Figs 3-5 at 1.0 us/record: the 9 dataset x workload cells of
    ``repro_torch.benchmarks.bench_end_to_end`` at E2E_RECORDS records, each
    through the port's ``run_end_to_end`` with KernelEngine("cuda")
    (kernel A on every 1,000-record chunk) and DeviceScanner("cuda")
    (kernel B, the first and the steady pass). Every chunk's packed
    bitvectors are held bit for bit to NumpyEngine's and the loaded-row
    count to NumpyEngine's load mask (so n_pushed and the loading ratio are
    a NumpyEngine run's); every count, host and device, to
    FullScanBaseline's (``run_end_to_end`` raises on a difference). Then
    ``bench_device`` at its quick size, its correctness gates held."""
    import torch
    from repro_torch.benchmarks import bench_device, bench_end_to_end
    from repro_torch.benchmarks.common import make_workload, run_end_to_end
    from repro_torch.core.client import NumpyEngine
    from repro_torch.data.datasets import generate_records
    from repro_torch.kernels import fused, scan_fused
    from repro_torch.kernels.engine import KernelEngine

    records = {ds: generate_records(ds, E2E_RECORDS, seed=17)
               for ds in bench_end_to_end.DATASETS}
    workloads = {(ds, w): make_workload(ds, w)
                 for ds in bench_end_to_end.DATASETS
                 for w in bench_end_to_end.WORKLOADS}
    numpy_engine = NumpyEngine()
    # ---- the cells: counters at 0 just before, read just after ----
    torch.cuda.synchronize()
    _zero_counters()
    engine = KernelEngine("cuda")
    rows = []
    for (ds, w), wl in workloads.items():
        r = run_end_to_end(ds, wl, E2E_BUDGET, n_records=E2E_RECORDS,
                           n_queries_exec=E2E_QUERIES, engine=engine,
                           records=records[ds], scan_backend="cuda",
                           hold_to=numpy_engine)
        rows.append(bench_end_to_end.row(r))
        print(f"  {ds}/{w}: {r.n_pushed} pushed, loading ratio "
              f"{r.loading_ratio:.4f} ({r.held_chunks} chunks bit-equal to "
              f"NumpyEngine); load x{r.loading_speedup:.2f}, query "
              f"x{r.query_speedup:.2f}, e2e x{r.end_to_end_speedup:.2f}, "
              f"overlapped x{r.end_to_end_overlapped_speedup:.2f}; device "
              f"query first {r.device_first_s * 1e3:.1f} ms, steady "
              f"{r.device_steady_s * 1e3:.1f} ms (x"
              f"{r.device_query_speedup:.2f}); {len(r.counts)} counts == "
              f"FullScanBaseline, host and device", flush=True)
    launches = {"pushdown": fused.launches, "scan": scan_fused.launches}
    # -----------------------------------------------------------------------
    print(f"  launches in the 9 cells: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    best = bench_end_to_end.best(rows)
    print("  best: " + ", ".join(
        f"{k} x{v['x']:.2f} ({v['dataset']}/{v['workload']})"
        for k, v in best.items()) + " (paper: 21x / 23x / 19x)")
    print("  e2e cells: " + json.dumps(
        [{k: v for k, v in r.items() if k != "counts"} for r in rows]))

    b_before = scan_fused.launches
    out = bench_device.run(n_records=6144, repeats=2, quick=True,
                           device="cuda")
    if not out["counts_match"] or out["uploads_steady"] != 0 or \
            not 0 < out["roofline_frac"] <= 1:
        raise AssertionError(f"bench_device's correctness gates: "
                             f"counts_match {out['counts_match']}, steady "
                             f"uploads {out['uploads_steady']}, roofline "
                             f"fraction {out['roofline_frac']}")
    print(f"  bench_device (quick): counts exact, 0 steady uploads; x"
          f"{out['speedup']:.2f} over numpy (quick floor 0.5), batch-of-8 "
          f"x{out['batch8_speedup']:.2f} (quick floor 0.8), wrapper call "
          f"{out['roofline']['measured_s'] * 1e6:.1f} us against the "
          f"bytes bound of {out['roofline']['step_time_s'] * 1e6:.3f} us "
          f"(scan_estimate's jnp traffic, not a bound on B: "
          f"{out['roofline']['analytic']['step_time_s'] * 1e6:.3f} us) "
          f"({scan_fused.launches - b_before} B launches)")
    return {"launches": launches, "rows": rows, "best": best,
            "device": out}


#: the tuner phase's store: the first TUNER_RECORDS of the main path's
#: records (all of them where ``--records`` is smaller)
TUNER_RECORDS = 1 << 17
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
    one_launch_per_chunk(dev)
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
    f_mla_timing = flash_mla_timing(dev)
    f_band_timing = flash_band_timing(dev)
    f_vision_timing = flash_vision_timing(dev)
    f_encdec_timing = flash_encdec_timing(dev)
    phase("sharded plane: the main path's records in 4 shards")
    t0 = time.perf_counter()
    sharded = sharded_plane(run, dev)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase("client fleet: 13 clients, one budget, 4 shards, one replan")
    t0 = time.perf_counter()
    fleet = client_fleet(dev)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase(f"end to end (paper Figs 3-5): 9 cells at {E2E_BUDGET} us/record, "
          f"{E2E_RECORDS} records, kernels A and B")
    t0 = time.perf_counter()
    e2e = end_to_end(dev)
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
    f_backward = check_flash_backward(dev)
    phase(f"serve path: {' '.join(SERVE_ARGS)}")
    serve = serve_path(dev)
    phase("serve path breakdown: one prefill, one decode step (profiler)")
    serve_breakdown(dev)
    phase("exactness at full width: forward vs prefill + decode (f32)")
    exactness_f32(dev)
    phase(f"MoE, MLA and vision serving: {', '.join(a for a, _ in MODEL_CUTS)}"
          f" at published widths, batch {MODEL_BATCH}, prompt "
          f"{MODEL_PROMPT}, {MODEL_GEN} tokens")
    t0 = time.perf_counter()
    served = model_serving(dev)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase("recurrent, hybrid and encoder-decoder serving: "
          + ", ".join(f"{a} ({n} layers, batch {b}, prompt {p}, {g} tokens)"
                      for a, n, b, p, g in RECURRENT_RUNS)
          + " at published widths")
    t0 = time.perf_counter()
    recurrent = recurrent_serving(dev)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase(f"training: gradient routes, {' '.join(TRAIN_ARGS)}, crash and "
          "resume")
    t0 = time.perf_counter()
    trained = training(dev, card)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase("training every family: F's gradient route and one train step, "
          + ", ".join(a for a, _, _ in FAMILY_TRAIN)
          + f" at published widths, batch {FAMILY_BATCH}, S {FAMILY_SEQ}")
    families = family_training(dev, card)
    phase(f"model mesh, remat, roofline and dry run: {' '.join(SERVE_ARGS)} "
          f"--mesh-shape 1,1; 2 train steps on the mesh "
          f"({MESH_TRAIN_LAYERS} layers); remat at {GRAD_LAYERS} layers; "
          f"roofline shares; dry run of "
          + ", ".join(f"{a} x {s}" for a, s in DRYRUN_CELLS))
    t0 = time.perf_counter()
    meshed = model_mesh(serve, trained, rows, dev, card)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    rows.append(flash_row(f_timing, serve))
    rows[-1]["launches_mesh"] = meshed["serve"]["launches"]
    rows[-1]["launches_mesh_train"] = meshed["train"]["launches"]
    rows[-1]["training"] = {
        "launches": trained["train"]["launches"],
        "launches_per_step": trained["train"]["launches_per_step"],
        **trained["flash"], "backward": f_backward,
        "gradient_route_max_rel_err": {
            dt: r["max_rel_err"] for dt, r in trained["routes"].items()}}
    rows[-1]["launches_moe_mla_vision"] = {
        a: r["launches"] for a, r in served.items() if a != "deepseek-v3-671b"}
    rows[-1]["launches_recurrent_encdec"] = {
        a: r["launches"] for a, r in recurrent.items()
        if a != "recurrentgemma-9b"}
    rows[-1]["training_families"] = {
        a: {"launches_route": r["route"]["launches"],
            "launches_per_step": r["step"]["launches_per_step"],
            "gradient_route_max_rel_err": r["route"]["max_rel_err"],
            "step_ms": r["step"]["step_ms"], "share": r["step"]["share"]}
        for a, r in families.items()}
    rows.append(flash_mla_row(f_mla_timing, served))
    rows.append(flash_band_row(f_band_timing, recurrent))
    rows.append(flash_vision_row(f_vision_timing, served))
    rows.extend(flash_encdec_rows(f_encdec_timing, recurrent))
    # launches on this slice's paths, each read from its own phase
    rows[0]["launches_client_fleet"] = fleet["launches"]["pushdown"]
    rows[1]["launches_sharded_plane"] = sharded["launches"]["scan"]
    rows[1]["launches_client_fleet"] = fleet["launches"]["scan"]
    rows[0]["launches_end_to_end"] = e2e["launches"]["pushdown"]
    rows[1]["launches_end_to_end"] = e2e["launches"]["scan"]
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
          f"{bench_reduce.missed or 'none'}; calls that lost the profiler "
          f"(no device activity in any trace): {bench_reduce.lost or 'none'}")
    phase_seconds()
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
