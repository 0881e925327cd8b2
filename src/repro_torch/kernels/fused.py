"""Fused single-pass pushdown kernel: chunk -> packed clause bitvectors.

Wrapper of the hand-written CUDA kernel ``csrc/pushdown.cu``, the port of
the TPU kernel ``repro.kernels.fused.clause_bitvectors_fused``.  One launch
evaluates a whole compiled plan on a dense chunk and emits the packed
per-clause words, the OR'd load mask and the per-clause popcounts.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version,
:func:`repro_torch.kernels.ref.clause_bitvectors_ref`, which reads the
plan's unique tables where the kernel reads its packed table
(:func:`repro_torch.kernels.plan.kernel_table`).  Any stride and any row
alignment run in the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref
from .cuda_build import check_tensor as check

WORD_BITS = 32
#: shared memory one block may use on an H100 (opt-in dynamic limit)
MAX_SMEM = 232_448

#: launches of the CUDA kernel in this process (the main-path proof)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("pushdown")
    if not getattr(lib, "_typed", False):
        lib.ciao_pushdown.argtypes = [
            _I, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P]
        lib.ciao_pushdown.restype = _I
        lib.ciao_pushdown_smem_bytes.argtypes = [_I, _I]
        lib.ciao_pushdown_smem_bytes.restype = _I
        lib._typed = True
    return lib


def clause_bitvectors_fused(data: torch.Tensor, plan: dict,
                            n_valid: int, *, n_simple: int):
    """(words uint32[C, W], or_words uint32[W], counts int32[C]).

    ``data uint8[R, L]``; ``plan`` maps :class:`CompiledPlan` field names
    to tensors on ``data``'s device: ``ops.KERNEL_FIELDS`` for the kernel,
    ``ops.UNIQUE_FIELDS`` for the plain version (``ops.plan_tensors``).
    ``W = ceil(R / 32)``; rows ``>= n_valid`` are zero.
    """
    if data.device.type == "cpu":
        return ref.clause_bitvectors_ref(
            data, plan["ukeys"], plan["uklens"], plan["uvals"],
            plan["uvlens"], plan["uunb"], plan["key_ids"], plan["val_ids"],
            plan["membership"], n_valid, n_simple=n_simple)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    global launches
    dev = data.device
    R, L = data.shape
    C, P = plan["membership"].shape
    table = plan["kernel_table"]
    check(data, "data", torch.uint8, (R, L), dev)
    check(table, "kernel_table", torch.uint32, (table.numel(),), dev)
    if table.numel() % 4 or table.data_ptr() % 16:
        raise ValueError("kernel_table must be whole 16-byte units on a "
                         "16-byte boundary (plan.kernel_table)")
    lib = _lib()
    smem = lib.ciao_pushdown_smem_bytes(table.numel() // 4, C)
    if smem > MAX_SMEM:
        raise ValueError(f"a plan of {P} predicates and {C} clauses needs "
                         f"{smem} B of shared memory per block "
                         f"(limit {MAX_SMEM})")
    W = (R + WORD_BITS - 1) // WORD_BITS
    # one zeroed buffer: the kernel writes every word, counts accumulate
    out = torch.zeros((C * W + W + C,), dtype=torch.int32, device=dev)
    words = out[:C * W].view(torch.uint32).view(C, W)
    or_words = out[C * W:C * W + W].view(torch.uint32)
    counts = out[C * W + W:]
    err = lib.ciao_pushdown(
        dev.index, data.data_ptr(), R, L, int(n_valid), table.data_ptr(),
        table.numel() // 4, C, words.data_ptr(), or_words.data_ptr(),
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "pushdown")
    launches += 1
    return words, or_words, counts
