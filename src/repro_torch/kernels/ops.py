"""Public wrapper of the pushdown pass with backend dispatch.

Backends:
  * ``"cuda"``  — the hand-written kernel (``kernels.fused``) on a card;
  * ``"torch"`` — its plain PyTorch version (``kernels.ref``) on any
    device, the CPU included.

Rows are padded to a multiple of the fixed record block and sliced back,
so callers never see alignment constraints and launches see a bounded set
of shapes (DESIGN.md §3.5).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref
from .fused import clause_bitvectors_fused

BACKENDS = ("cuda", "torch")

#: CompiledPlan fields each side reads: the kernel reads the flat
#: per-predicate rows, the plain version the unique tables
FLAT_FIELDS = ("keys", "klens", "vals", "vlens", "kinds", "unbounded",
               "membership")
UNIQUE_FIELDS = ("ukeys", "uklens", "uvals", "uvlens", "uunb", "key_ids",
                 "val_ids", "membership")


def resolve_device(backend: str, device=None) -> torch.device:
    """The device a backend runs on; ``"cuda"`` raises without a card."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda":
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError("backend 'cuda' runs on a CUDA device, "
                             f"not {dev}")
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'cuda' needs a CUDA device and "
                               "none is available")
        return dev
    return torch.device("cpu" if device is None else device)


def _pad_rows(data: np.ndarray, r_blk: int) -> np.ndarray:
    R = data.shape[0]
    padded = max(((R + r_blk - 1) // r_blk) * r_blk, r_blk)
    if padded != R:
        data = np.concatenate(
            [data, np.zeros((padded - R,) + data.shape[1:], data.dtype)], axis=0
        )
    return data


def plan_tensors(plan, fields, device) -> dict:
    """CompiledPlan fields as contiguous tensors on ``device``."""
    out = {}
    for name in fields:
        a = np.ascontiguousarray(getattr(plan, name))
        if a.dtype == bool:
            a = a.astype(np.uint8)
        out[name] = torch.from_numpy(a).to(device)
    return out


def clause_bitvectors(data, plan, *, backend: str = "cuda",
                      r_blk: int = 256, device=None, tensors=None):
    """Fused pushdown pass: dense chunk -> packed per-clause bitvectors.

    ONE device launch regardless of plan composition.  ``plan`` is a
    :class:`repro_torch.kernels.plan.CompiledPlan`; ``tensors`` may carry
    its fields already on the device (``plan_tensors``).  Returns numpy
    ``(words uint32[C, W], or_words uint32[W], counts int32[C])`` with
    ``W = ceil(R / 32)``.
    """
    dev = resolve_device(backend, device)
    data = np.asarray(data, dtype=np.uint8)
    R = data.shape[0]
    C, P = plan.membership.shape
    if C == 0 or P == 0 or R == 0:  # nothing to evaluate: empty outputs
        W = (R + 31) // 32
        return (np.zeros((C, W), np.uint32), np.zeros((W,), np.uint32),
                np.zeros((C,), np.int32))
    if not np.all(np.diff(plan.kinds) >= 0):
        raise ValueError("predicates must be ordered simple-first "
                         "(kernels.plan.compile_plan does this)")
    padded = torch.from_numpy(_pad_rows(data, r_blk)).to(dev)
    if backend == "torch":
        t = tensors or plan_tensors(plan, UNIQUE_FIELDS, dev)
        words, or_words, counts = ref.clause_bitvectors_ref(
            padded, t["ukeys"], t["uklens"], t["uvals"], t["uvlens"],
            t["uunb"], t["key_ids"], t["val_ids"], t["membership"], R,
            n_simple=plan.n_simple)
    else:
        t = tensors or plan_tensors(plan, FLAT_FIELDS, dev)
        words, or_words, counts = clause_bitvectors_fused(
            padded, t, R, n_simple=plan.n_simple)
    W = (R + 31) // 32
    return (words[:, :W].cpu().numpy(), or_words[:W].cpu().numpy(),
            counts.cpu().numpy())
