"""Where a training step of the port spends its time, on one card.

The train step of ``repro_torch.train.train_step.make_train_step`` on a
configuration at full width (qwen3-1.7b by default: 28 layers, f32
master parameters, bf16 compute, each layer checkpointed, AdamW), on
seeded tokens (``configs.make_batch``), after two warm-up steps:

* the whole step, and its parts timed alone on the host clock with the
  device synchronised around each: loss and grads
  (``train_step.value_and_grad``: forward, the checkpoints' recompute and
  the backward), ``clip_by_global_norm``, the AdamW update, and the
  forward alone without a gradient;
* one profiled step: device kernel time by kind (kernel F, its
  backward's plain recompute under ``FlashAttentionBackward``, matmul,
  other), launches, eager ops and the device's idle share;
* the host cost of one recipe batch's tokens at the configuration's
  vocab (``ByteTokenizer.encode`` over ycsb records), the work the
  trainer's prefetch thread does beside the step.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_train

It prints one JSON object with the card's name and power limit.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

#: marks of the kernels by kind in the profiler's names
KINDS = (("kernel F", ("flash_kernel",)),
         ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "gemv")))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(arch: str, batch: int, seq: int, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeConfig, get_config, make_batch
    from repro_torch.data.datasets import generate_records
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (
        init_opt_state, make_train_step, opt_config_for, value_and_grad,
    )

    dev = resolve_device("cuda")
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    oc = opt_config_for(cfg)
    state = init_opt_state(model, params, oc)
    data = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, ShapeConfig("bench", "train", seq, batch)).items()}
    step = make_train_step(model, oc)

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        params, state, _ = step(params, state, data)
    step_ms, parts = [], {"loss_and_grads": [], "clip": [], "update": [],
                          "forward_no_grad": []}
    fa.launches = 0
    for _ in range(steps):
        (params, state, _), ms = timed(lambda: step(params, state, data))
        step_ms.append(ms)
    launches = fa.launches / steps
    for _ in range(steps):
        (_, grads), ms = timed(lambda: value_and_grad(model, params, data))
        parts["loss_and_grads"].append(ms)
        (clipped, _), ms = timed(lambda: opt_mod.clip_by_global_norm(
            grads, oc.grad_clip))
        parts["clip"].append(ms)
        del grads
        (params, state, _), ms = timed(lambda: opt_mod.update(
            params, clipped, state, oc))
        parts["update"].append(ms)
        del clipped
        with torch.no_grad():
            _, ms = timed(lambda: model.loss(params, data))
        parts["forward_no_grad"].append(ms)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, data)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    by_kind = {k: sum(ms for key, ms, _ in rows
                      if any(m in key for m in marks)) for k, marks in KINDS}
    by_kind["other"] = busy - sum(by_kind.values())
    recompute = sum(e.device_time_total / 1e3 for e in prof.key_averages()
                    if e.key == "FlashAttentionBackward")
    ops = sum(1 for e in prof.events()
              if e.device_type == DeviceType.CPU and e.cpu_parent is None
              and e.name.startswith("aten::"))

    tok = ByteTokenizer(vocab_size=cfg.vocab_size)
    recs = generate_records("ycsb", 64, seed=1)
    tok.encode(recs[0])                       # the pair table, built once
    t0 = time.perf_counter()
    n_tok = sum(len(tok.encode(r)) for r in recs)
    enc_ms = (time.perf_counter() - t0) * 1e3
    per_batch = enc_ms / n_tok * batch * seq

    med = statistics.median(step_ms)
    return {
        "card": _card(), "device": torch.cuda.get_device_name(0),
        "arch": arch, "batch": batch, "seq": seq, "steps": steps,
        "param_count": model.param_count(),
        "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": batch * seq / (med * 1e-3),
        "parts_ms_median": {k: statistics.median(v) for k, v in parts.items()},
        "f_launches_per_step": launches,
        "profiled_step": {
            "wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "kernels": sum(n for _, _, n in rows), "eager_ops": ops,
            "by_kind_ms": by_kind,
            "f_backward_recompute_device_ms": recompute},
        "tokenize_ms_per_batch": per_batch,
        "tokenize_note": f"{n_tok} tokens of 64 ycsb records in "
                         f"{enc_ms:.1f} ms, vocab {cfg.vocab_size}",
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.arch, args.batch, args.seq, args.steps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
