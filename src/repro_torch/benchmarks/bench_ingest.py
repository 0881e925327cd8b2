"""Host ingest time per chunk: the plain store and the 4-shard store.

Measures the ``repro_torch`` package on the import path, so that copies
of one tree that differ in a host change can be measured in turns on one
machine:

* ``CiaoStore.ingest_chunk``: the partial load of one 8,192-record ycsb
  chunk under the main path's plan (``build_plan`` at 1.0 us/record on a
  200-query zipf(1.5) workload), segments and their zone maps included;
* ``ShardedCiaoStore.ingest_chunk``: the same chunks range-routed over 4
  shards on the plan's routing key, with ``route_time_s`` (the routing
  parse) apart;
* the sharded ingest's three stages, each timed alone on a second
  4-shard store: ``route_slices``, every slice's ``ShardSummary.update``,
  and every slice's per-shard ``CiaoStore.ingest_chunk``.

Records are made, and their bitvectors computed by kernel A
(``KernelEngine("cuda")``, as on the main path), before the clock starts:
chunk i from seed 20240611 + i, as ``chip_smoke.py`` makes them.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_ingest

It prints one JSON object with the card's name and power limit.  Needs a
CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

CHUNK = 8192
N_CHUNKS = 16
SEED = 20240611


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(n_chunks: int = N_CHUNKS) -> dict:
    import repro_torch
    from repro_torch.core.client import encode_chunk
    from repro_torch.core.planner import build_plan
    from repro_torch.core.server import CiaoStore
    from repro_torch.core.shard import (
        ShardedCiaoStore, ShardRouter, choose_routing_key,
    )
    from repro_torch.core.workload import generate_workload
    from repro_torch.data.datasets import generate_records, predicate_pool
    from repro_torch.kernels.engine import KernelEngine

    parts = [generate_records("ycsb", CHUNK, seed=SEED + i)
             for i in range(n_chunks)]
    workload = generate_workload(predicate_pool("ycsb"), n_queries=200,
                                 distribution="zipf", zipf_a=1.5,
                                 rng=np.random.default_rng(0))
    plan = build_plan(workload, parts[0][:500], budget_us=1.0).plan
    chunks = [encode_chunk(p) for p in parts]
    engine = KernelEngine("cuda")
    bvs = [engine.eval_fused(c, plan.clauses) for c in chunks]
    samples = [json.loads(r) for r in parts[0][:800]]

    def sharded() -> ShardedCiaoStore:
        return ShardedCiaoStore(plan, router=ShardRouter.from_samples(
            4, choose_routing_key(plan), samples))

    def per_chunk(seconds: float) -> float:
        return seconds / n_chunks * 1e3

    def whole(store) -> float:
        t0 = time.perf_counter()
        for chunk, bv in zip(chunks, bvs):
            store.ingest_chunk(chunk, bv)
        return per_chunk(time.perf_counter() - t0)

    out = {"tree": os.path.dirname(os.path.dirname(repro_torch.__file__)),
           "card": _card(), "chunks": n_chunks, "records": CHUNK,
           "plain_ms_per_chunk": whole(CiaoStore(plan))}
    store = sharded()
    out["sharded_ms_per_chunk"] = whole(store)
    out["sharded_route_ms_per_chunk"] = per_chunk(store.route_time_s)

    store = sharded()
    stages = {"route": 0.0, "summaries": 0.0, "shard_ingest": 0.0}
    for chunk, bv in zip(chunks, bvs):
        t0 = time.perf_counter()
        slices = store.route_slices(chunk, bv)
        t1 = time.perf_counter()
        for s, _, _, objs in slices:
            store.summaries[s].update(objs)
        t2 = time.perf_counter()
        for s, sub_chunk, sub_bv, objs in slices:
            store.shards[s].ingest_chunk(sub_chunk, sub_bv, objs=objs)
        t3 = time.perf_counter()
        stages["route"] += t1 - t0
        stages["summaries"] += t2 - t1
        stages["shard_ingest"] += t3 - t2
    out["stages_ms_per_chunk"] = {k: per_chunk(v) for k, v in stages.items()}
    return out


def main() -> None:
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
