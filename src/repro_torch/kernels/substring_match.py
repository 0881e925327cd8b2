"""The split pushdown path's matchers: a pattern set, and one key-value
predicate, over a dense chunk.

Wrappers of the hand-written CUDA kernels ``csrc/substring_match.cu``
(kernel D) and ``csrc/key_value.cu`` (kernel E), the ports of the TPU
kernels ``repro.kernels.substring_match.multi_match_any`` and
``key_value_match``.  Each keeps its own launch counter.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.
Unlike the fused pushdown kernel, D compares an empty pattern's padding
byte (it matches a record holding a zero byte), and E refuses an empty
key or value, as the TPU kernels do.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref
from .cuda_build import check_tensor as check
from .fused import MAX_SMEM

#: launches of each CUDA kernel in this process (the main-path proof)
match_launches = 0
kv_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _match_lib() -> ctypes.CDLL:
    lib = cuda_build.load("substring_match")
    if not getattr(lib, "_typed", False):
        lib.ciao_multi_match.argtypes = [_I, _P, _I, _I, _P, _I, _P, _I, _P,
                                         _P]
        lib.ciao_multi_match.restype = _I
        lib.ciao_match_smem_bytes.argtypes = [_I, _I]
        lib.ciao_match_smem_bytes.restype = _I
        lib._typed = True
    return lib


def _kv_lib() -> ctypes.CDLL:
    lib = cuda_build.load("key_value")
    if not getattr(lib, "_typed", False):
        lib.ciao_key_value.argtypes = [_I, _P, _I, _I, _P, _I, _P, _I, _I,
                                       _P, _P]
        lib.ciao_key_value.restype = _I
        lib._typed = True
    return lib


def _device_of(data: torch.Tensor) -> torch.device | None:
    """None for a CPU tensor (plain version); the CUDA device otherwise."""
    if data.device.type == "cpu":
        return None
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    return data.device


def multi_match_any(data: torch.Tensor, patterns: torch.Tensor,
                    plens: torch.Tensor) -> torch.Tensor:
    """uint8[P, R]: pattern p occurs anywhere in record r.

    ``data uint8[R, L]``, ``patterns uint8[P, M]`` zero-padded with
    ``M >= 1``, ``plens int32[P]``.  No padding of ``R``.
    """
    if patterns.dim() != 2 or patterns.shape[1] == 0:
        raise ValueError(f"patterns must be uint8[P, M >= 1], got "
                         f"{list(patterns.shape)}")
    dev = _device_of(data)
    if dev is None:
        return ref.multi_match_any_ref(data, patterns, plens)
    global match_launches
    R, L = data.shape
    P, M = patterns.shape
    check(data, "data", torch.uint8, (R, L), dev)
    check(patterns, "patterns", torch.uint8, (P, M), dev)
    check(plens, "plens", torch.int32, (P,), dev)
    out = torch.empty((P, R), dtype=torch.uint8, device=dev)
    if P == 0 or R == 0:
        return out
    lib = _match_lib()
    smem = lib.ciao_match_smem_bytes(P, M)
    if smem > MAX_SMEM:
        raise ValueError(f"{P} patterns of width {M} need {smem} B of shared "
                         f"memory per block (limit {MAX_SMEM})")
    err = lib.ciao_multi_match(
        dev.index, data.data_ptr(), R, L, patterns.data_ptr(), M,
        plens.data_ptr(), P, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "multi_match")
    match_launches += 1
    return out


def key_value_match(data: torch.Tensor, key: torch.Tensor, val: torch.Tensor,
                    unbounded: bool) -> torch.Tensor:
    """uint8[R]: the key-value predicate (``key``, ``val``) per record.

    ``key`` and ``val`` are non-empty ``uint8[m]``; ``unbounded`` drops
    the stop at ``,``/``}`` (a value that holds a delimiter).  Any stride
    and any row alignment run in the kernel.
    """
    if key.numel() == 0 or val.numel() == 0:
        raise ValueError("key and value patterns must be non-empty")
    dev = _device_of(data)
    if dev is None:
        return ref.key_value_match_ref(data, key, val, unbounded)
    global kv_launches
    R, L = data.shape
    check(data, "data", torch.uint8, (R, L), dev)
    check(key, "key", torch.uint8, (key.numel(),), dev)
    check(val, "val", torch.uint8, (val.numel(),), dev)
    out = torch.empty((R,), dtype=torch.uint8, device=dev)
    if R == 0:
        return out
    lib = _kv_lib()
    err = lib.ciao_key_value(
        dev.index, data.data_ptr(), R, L, key.data_ptr(), key.numel(),
        val.data_ptr(), val.numel(), int(bool(unbounded)), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "key_value")
    kv_launches += 1
    return out
