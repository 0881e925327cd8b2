"""Pushdown engines and the fused-vs-split comparison, on the port.

Two sections, as in the JAX package's ``benchmarks/bench_kernels.py``:

  * engine table — µs/record for every engine on a mixed plan (python
    ``bytes.find``, numpy, the plain PyTorch version, the CUDA kernel);
  * fused vs seed-split — the fused single-launch path
    (``KernelEngine.eval_fused``, kernel A) against the seed pipeline it
    replaced (:func:`seed_split_eval`: one ``match_any`` launch, kernel D,
    + one ``match_key_value`` launch per key-value pair, kernel E + host
    OR/pack + a ``reduce_bitvectors`` launch for the load mask, kernel C),
    per backend.  Both must agree bit for bit.

    python -m repro_torch.benchmarks.bench_kernels            # needs a card
    python -m repro_torch.benchmarks.bench_kernels --backends torch

Writes ``artifacts/bench_torch_kernels.json`` at the repository root.
Times are host wall clock around calls whose results come back to the
host, best of ``--repeats``; each row names the device it ran on.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import bitvector
from repro_torch.core.client import (
    NumpyEngine, PythonEngine, dedup_terms, encode_chunk, encode_patterns,
)
from repro_torch.core.predicates import Kind
from repro_torch.data.datasets import generate_records, predicate_pool
from repro_torch.kernels import ops
from repro_torch.kernels.engine import KernelEngine

ARTIFACT = Path(__file__).resolve().parents[3] / "artifacts" / \
    "bench_torch_kernels.json"


def mixed_plan(dataset: str, n_clauses: int, rng: np.random.Generator):
    """Half simple-pattern clauses, half key-value clauses (paper Table I)."""
    pool = predicate_pool(dataset)
    kv, simple = [], []
    for c in pool:
        (kv if any(t.kind is Kind.KEY_VALUE for t in c.terms) else simple).append(c)
    take_kv = min(n_clauses // 2, len(kv))
    take_s = min(n_clauses - take_kv, len(simple))
    picked = [kv[i] for i in rng.choice(len(kv), size=take_kv, replace=False)]
    picked += [simple[i] for i in rng.choice(len(simple), size=take_s, replace=False)]
    return picked


def seed_split_eval(chunk, clauses, backend: str, device=None):
    """The seed pushdown pipeline: one launch for the simple patterns, one
    launch PER key-value pair, host-side OR of disjuncts + numpy bit-pack,
    then a reduce launch for the ingest load mask.

    Returns ``(words uint32[C, W], or_words uint32[W])``, bit-identical to
    the fused pass.  The chunk goes to the device once for all launches.
    """
    simple_pats: dict[bytes, int] = {}
    kv_pairs: dict[tuple[bytes, bytes], int] = {}
    for cl in clauses:
        for t in cl.terms:
            if t.kind is Kind.KEY_VALUE:
                kv_pairs.setdefault(t.patterns(), len(kv_pairs))
            else:
                simple_pats.setdefault(t.patterns()[0], len(simple_pats))
    R = chunk.n_records
    dev = ops.resolve_device(backend, device)
    data = torch.from_numpy(chunk.data).to(dev)
    simple_hits = np.zeros((len(simple_pats), R), dtype=bool)
    if simple_pats:
        pats, plens = encode_patterns(list(simple_pats))
        simple_hits = ops.match_any(data, pats, plens, backend=backend)
    kv_hits = np.zeros((len(kv_pairs), R), dtype=bool)
    for (k, v), idx in kv_pairs.items():
        kv_hits[idx] = ops.match_key_value(data, k, v, backend=backend)
    out = np.zeros((len(clauses), R), dtype=bool)
    for ci, cl in enumerate(clauses):
        row = out[ci]
        for t in cl.terms:
            if t.kind is Kind.KEY_VALUE:
                row |= kv_hits[kv_pairs[t.patterns()]]
            else:
                row |= simple_hits[simple_pats[t.patterns()[0]]]
    words = bitvector.pack(out)
    _, or_words, _ = ops.reduce_bitvectors(words, backend=backend, device=dev)
    return words, or_words


def _best_of(fn, repeats: int) -> float:
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _device_name(backend: str) -> str:
    return torch.cuda.get_device_name(0) if backend == "cuda" else "cpu"


def main(n_records: int = 4000, n_clauses: int = 12, repeats: int = 3,
         backends=("cuda", "torch")) -> dict:
    records = generate_records("ycsb", n_records, seed=43)
    clauses = mixed_plan("ycsb", n_clauses, np.random.default_rng(0))
    terms = dedup_terms(clauses)[0]
    n_kv_pairs = sum(1 for t in terms if t.kind is Kind.KEY_VALUE)
    has_simple = any(t.kind is not Kind.KEY_VALUE for t in terms)
    chunk = encode_chunk(records)
    chunk_bytes = chunk.data.nbytes

    engines = [("python-bytes-find", PythonEngine(), "python"),
               ("numpy-vectorized", NumpyEngine(), "numpy")]
    engines += [("cuda-kernel" if b == "cuda" else "torch-plain",
                 KernelEngine(backend=b), b) for b in backends]
    rows, expected = [], None
    for name, eng, backend in engines:
        out = eng.eval(chunk, clauses)          # warm up (builds a kernel)
        best = _best_of(lambda: eng.eval(chunk, clauses), repeats)
        if expected is None:
            expected = out
        if not np.array_equal(out, expected):
            raise AssertionError(f"{name} disagrees with {engines[0][0]}")
        rows.append({
            "engine": name, "backend": backend,
            "device": _device_name(backend), "interpret": False,
            "records_per_s": int(n_records / best),
            "us_per_record": best / n_records * 1e6,
            "effective_GBps": chunk_bytes * n_clauses / best / 1e9,
        })
        print(f"[kernels] {name:20s} {rows[-1]['records_per_s']:12.0f} rec/s "
              f"({rows[-1]['us_per_record']:8.2f} us/rec) on "
              f"{rows[-1]['device']}")

    fused_vs_split = []
    for backend in backends:
        eng = KernelEngine(backend=backend)
        words, or_words = seed_split_eval(chunk, clauses, backend)
        fused = eng.eval_fused(chunk, clauses)
        if not (np.array_equal(fused.words, words)
                and np.array_equal(fused.or_words, or_words)):
            raise AssertionError(f"split != fused on {backend}")
        t_split = _best_of(
            lambda: seed_split_eval(chunk, clauses, backend), repeats)
        t_fused = _best_of(lambda: eng.eval_fused(chunk, clauses), repeats)
        entry = {
            "backend": backend, "device": _device_name(backend),
            "n_records": n_records, "n_clauses": len(clauses),
            "n_kv_pairs": n_kv_pairs,
            "split_ms": t_split * 1e3, "fused_ms": t_fused * 1e3,
            "split_us_per_record": t_split / n_records * 1e6,
            "fused_us_per_record": t_fused / n_records * 1e6,
            "speedup": t_split / t_fused,
            # match_any (iff simple patterns exist) + per-kv-pair + reduce
            "launches_split": int(has_simple) + n_kv_pairs + 1,
            "launches_fused": 1,
        }
        fused_vs_split.append(entry)
        print(f"[kernels] fused-vs-split {backend:6s} {entry['split_ms']:9.3f}"
              f" -> {entry['fused_ms']:9.3f} ms per chunk "
              f"(x{entry['speedup']:.2f}, launches "
              f"{entry['launches_split']}->1)")
    return {"engines": rows, "fused_vs_split": fused_vs_split}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=4000)
    ap.add_argument("--clauses", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--backends", default="cuda,torch",
                    help="comma-separated kernel backends (cuda, torch)")
    args = ap.parse_args()
    result = main(args.records, args.clauses, args.repeats,
                  tuple(args.backends.split(",")))
    ARTIFACT.parent.mkdir(parents=True, exist_ok=True)
    ARTIFACT.write_text(json.dumps(result, indent=1))
    print(f"wrote {ARTIFACT}")
