"""Tiny cells for CPU tests: the benchmark's cells with every size cut.

A configuration's sizes come from its reference module's ``TINY``, a
traffic mix's by its ``kind``."""
from __future__ import annotations

import copy
import time

import torch

from perfbench.harness import bench

TRAFFIC = {
    "serve_closed_loop": dict(prompt_lengths={"24": 2, "40": 1}, output_tokens=6,
                              check_requests=3),
    "train_ciao": dict(batch=2, seq_len=64, clients=2, chunks_per_client=2,
                       chunk_records=256),
}


def cut(c: dict) -> dict:
    """A copy of the cell ``c`` at CPU size."""
    c = copy.deepcopy(c)
    c["config"].update(bench.architecture(c["config"]).reference.TINY)
    c["traffic"].update(TRAFFIC[c["traffic"]["kind"]])
    return c


def cell(name: str) -> dict:
    return cut(bench.cell(name))


def run(name: str, seed: int = 3, seconds: float = 0.5, **kw):
    from perfbench.harness import serve, train
    c = cell(name)
    driver = serve if c["traffic"]["kind"] == "serve_closed_loop" else train
    return driver.run(c, seed, seconds, False, torch.device("cpu"),
                      time.monotonic_ns(), **kw)
