"""AND / OR / popcount over packed bitvector rows.

Wrapper of the hand-written CUDA kernel ``csrc/bitvector_reduce.cu``, the
port of the TPU kernel ``repro.kernels.bitvector_ops.bitvector_reduce``.
It serves the split pushdown path's load mask (the OR) and the host
scanner's AND-reduce hook (:mod:`repro_torch.kernels.residual`).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version,
:func:`repro_torch.kernels.ref.bitvector_reduce_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref
from .cuda_build import check_tensor as check

#: launches of the CUDA kernel in this process (the main-path proof)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("bitvector_reduce")
    if not getattr(lib, "_typed", False):
        lib.ciao_bitvector_reduce.argtypes = [_I, _P, _I, _I, _P, _P, _P, _P]
        lib.ciao_bitvector_reduce.restype = _I
        lib._typed = True
    return lib


def bitvector_reduce(bitvecs: torch.Tensor):
    """(and uint32[W], or uint32[W], popcount of the AND as int32[]).

    ``bitvecs uint32[P, W]`` with ``P >= 1``; no padding of ``W``.
    """
    if bitvecs.dim() != 2 or bitvecs.shape[0] == 0:
        raise ValueError(f"bitvector_reduce needs uint32[P >= 1, W], got "
                         f"{list(bitvecs.shape)}")
    if bitvecs.device.type == "cpu":
        return ref.bitvector_reduce_ref(bitvecs)
    if bitvecs.device.type != "cuda":
        raise ValueError(f"unsupported device {bitvecs.device}")
    global launches
    dev = bitvecs.device
    P, W = bitvecs.shape
    check(bitvecs, "bitvecs", torch.uint32, (P, W), dev)
    and_w = torch.empty((W,), dtype=torch.uint32, device=dev)
    or_w = torch.empty((W,), dtype=torch.uint32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if W == 0:
        return and_w, or_w, count
    lib = _lib()
    err = lib.ciao_bitvector_reduce(
        dev.index, bitvecs.data_ptr(), P, W, and_w.data_ptr(),
        or_w.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "bitvector_reduce")
    launches += 1
    return and_w, or_w, count
