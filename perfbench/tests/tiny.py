"""Tiny cells for CPU tests: the benchmark's cells with every size cut."""
from __future__ import annotations

import copy
import time

import torch

from perfbench.harness import bench

QWEN = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            intermediate_size=128, num_hidden_layers=2, vocab_size=512)
TRAFFIC = {
    "qwen3-longdoc": dict(prompt_lengths={"24": 2, "40": 1}, output_tokens=6,
                          check_requests=3),
    "qwen3-train": dict(batch=2, seq_len=64, clients=2, chunks_per_client=2,
                        chunk_records=256),
}


def cell(name: str) -> dict:
    c = copy.deepcopy(bench.cell(name))
    c["config"].update(QWEN)
    c["traffic"].update(TRAFFIC[name])
    return c


def run(name: str, seed: int = 3, seconds: float = 0.5, **kw):
    from perfbench.harness import serve, train
    c = cell(name)
    driver = serve if c["traffic"]["kind"] == "serve_closed_loop" else train
    return driver.run(c, seed, seconds, False, torch.device("cpu"),
                      time.monotonic_ns(), **kw)
