"""Public wrappers of the kernels with backend dispatch.

Backends:
  * ``"cuda"``  — the hand-written kernel (``kernels.fused``,
    ``kernels.substring_match``, ``kernels.bitvector_ops``) on a card;
  * ``"torch"`` — its plain PyTorch version (``kernels.ref``) on any
    device, the CPU included.

Every wrapper takes and returns numpy, as the JAX package's do; the
split path's wrappers (``match_any``, ``match_key_value``,
``reduce_bitvectors``) also take a tensor already on the device, so a
chunk is copied once for all of its launches.  The pushdown pass pads rows
to a multiple of the fixed record block and slices them back (DESIGN.md
§3.5); the split path's CUDA kernels take any R and W, so nothing else is
padded.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitvector_ops, ref
from .fused import clause_bitvectors_fused
from .substring_match import key_value_match, multi_match_any

BACKENDS = ("cuda", "torch")

#: CompiledPlan fields each side reads: the kernel reads its packed table
#: (``membership`` only for its shape), the plain version the unique tables
KERNEL_FIELDS = ("kernel_table", "membership")
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
        t = tensors or plan_tensors(plan, KERNEL_FIELDS, dev)
        words, or_words, counts = clause_bitvectors_fused(
            padded, t, R, n_simple=plan.n_simple)
    W = (R + 31) // 32
    return (words[:, :W].cpu().numpy(), or_words[:W].cpu().numpy(),
            counts.cpu().numpy())


_TORCH_TYPES = {np.uint8: torch.uint8, np.int32: torch.int32,
                np.uint32: torch.uint32}


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    """``a`` (numpy, or a tensor of this type) contiguous on ``dev``."""
    if isinstance(a, torch.Tensor):
        if a.dtype != _TORCH_TYPES[dtype]:
            raise ValueError(f"want a {_TORCH_TYPES[dtype]} tensor, "
                             f"got {a.dtype}")
        return a.to(dev).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def _split_device(backend: str, device, data) -> torch.device:
    """The backend's device; a tensor argument's own device by default."""
    if device is None and isinstance(data, torch.Tensor):
        device = data.device
    return resolve_device(backend, device)


def match_any(data, patterns, plens, *, backend: str = "cuda",
              device=None) -> np.ndarray:
    """bool[P, R] any-position multi-pattern match (kernel D).

    ``patterns uint8[P, M]`` zero-padded, ``plens`` int ``[P]`` or
    ``[P, 1]`` (``client.encode_patterns``).
    """
    dev = _split_device(backend, device, data)
    d = _tensor(data, np.uint8, dev)
    pats = _tensor(patterns, np.uint8, dev)
    lens = _tensor(np.asarray(plens, dtype=np.int32).reshape(-1), np.int32,
                   dev)
    fn = ref.multi_match_any_ref if backend == "torch" else multi_match_any
    return fn(d, pats, lens).cpu().numpy().astype(bool)


def match_key_value(data, key: bytes, val: bytes, *, backend: str = "cuda",
                    device=None) -> np.ndarray:
    """bool[R] key-value predicate match (paper Table I row 4, kernel E).

    A value holding ``,`` or ``}`` is searched unbounded; an empty key or
    value raises ``ValueError``.
    """
    if not key or not val:
        raise ValueError("key and value patterns must be non-empty")
    dev = _split_device(backend, device, data)
    d = _tensor(data, np.uint8, dev)
    k = _tensor(np.frombuffer(bytearray(key), np.uint8), np.uint8, dev)
    v = _tensor(np.frombuffer(bytearray(val), np.uint8), np.uint8, dev)
    unbounded = b"," in val or b"}" in val
    fn = ref.key_value_match_ref if backend == "torch" else key_value_match
    return fn(d, k, v, unbounded).cpu().numpy().astype(bool)


def reduce_bitvectors(bitvecs, *, backend: str = "cuda", device=None):
    """(and_words, or_words, surviving_count) over uint32[P, W] (kernel C).

    ``P >= 1``; numpy ``uint32[W]`` words and an int count.  On the card:
    one upload (unless ``bitvecs`` is there already), one launch and one
    copy back of the kernel's [AND | OR | count] buffer.
    """
    dev = _split_device(backend, device, bitvecs)
    bv = _tensor(bitvecs, np.uint32, dev)
    if backend == "torch":
        a, o, c = ref.bitvector_reduce_ref(bv)
        return a.cpu().numpy(), o.cpu().numpy(), int(c)
    return bitvector_ops.split(
        bitvector_ops.bitvector_reduce_buffer(bv).cpu().numpy(), bv.shape[1])
