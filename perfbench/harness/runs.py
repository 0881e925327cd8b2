"""What a run hands its metric readers, and small helpers of the drivers."""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from .record import Spans, Trace


@dataclass
class Run:
    arch: object                   # perfbench.reference.arch.Arch
    traffic: dict
    device_name: str
    setup_s: float = 0.0
    window_s: float = 0.0
    spans: Spans = field(default_factory=Spans)
    requests: list = field(default_factory=list)   # serve: one dict a request
    steps: list = field(default_factory=list)      # train: one dict a step
    trace: Trace | None = None
    memory_peak_bytes: int = 0
    check: dict = field(default_factory=dict)      # name -> value compared


def memory_peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def now_ns() -> int:
    return time.monotonic_ns()


def log(msg: str) -> None:
    print(f"[perfbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
