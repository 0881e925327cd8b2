"""AND / OR / popcount over packed bitvector rows.

Wrapper of the hand-written CUDA kernel ``csrc/bitvector_reduce.cu``, the
port of the TPU kernel ``repro.kernels.bitvector_ops.bitvector_reduce``.
It serves the split pushdown path's load mask (the OR) and the host
scanner's AND-reduce hook (:mod:`repro_torch.kernels.residual`).

The kernel writes one buffer, ``uint32[2W + 1]`` = [AND words | OR words |
count], so a caller brings the whole result back in one copy
(:func:`bitvector_reduce_buffer`, :func:`split`).  Up to
:data:`ONE_BLOCK_WORDS` words a call is one launch of one block; above
it, a grid of blocks writes one partial count each after the buffer's
count word and a second one-block launch sums them.  This module sizes
the launch (:data:`THREADS`, :func:`grid_blocks`); the kernel reads it
from its launch.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version,
:func:`repro_torch.kernels.ref.bitvector_reduce_ref`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build, ref
from .cuda_build import check_tensor as check

#: kernel launches in this process (the main-path proof): one per call up
#: to :data:`ONE_BLOCK_WORDS`, two above it (the partials' sum)
launches = 0

#: threads a block (the kernel takes whole warps, at most 256)
THREADS = 256
#: the widest W one block reduces alone (one launch, count stored by it)
ONE_BLOCK_WORDS = 8192
#: at most this many blocks per SM in a grid of blocks
BLOCKS_PER_SM = 2

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    return cuda_build.load("bitvector_reduce", {
        "ciao_bitvector_reduce": ([_I, _P, _I, _I, _I, _I, _P, _P], _I),
        "ciao_noop": ([_I, _I, _P], _I),
    })


def _check_rows(bitvecs: torch.Tensor) -> None:
    if bitvecs.dim() != 2 or bitvecs.shape[0] == 0:
        raise ValueError(f"bitvector_reduce needs uint32[P >= 1, W], got "
                         f"{list(bitvecs.shape)}")


def grid_blocks(W: int, n_sms: int) -> int:
    """Blocks of one launch over ``W`` words on a card of ``n_sms`` SMs:
    a block takes 4 words a thread per grid-stride step."""
    if W <= ONE_BLOCK_WORDS:
        return 1
    return min(-(-W // (4 * THREADS)), BLOCKS_PER_SM * n_sms)


def split(buf: torch.Tensor, W: int):
    """Views (and uint32[W], or uint32[W], count int32[]) of a buffer
    laid out [AND | OR | count]; a numpy buffer gives numpy views and an
    int count."""
    if isinstance(buf, np.ndarray):
        return (buf[:W], buf[W:2 * W],
                int(buf[2 * W:2 * W + 1].view(np.int32)[0]))
    return (buf[:W], buf[W:2 * W],
            buf[2 * W:2 * W + 1].view(torch.int32).reshape(()))


def bitvector_reduce_buffer(bitvecs: torch.Tensor) -> torch.Tensor:
    """uint32[2W + 1] = [AND words | OR words | popcount of the AND].

    ``bitvecs uint32[P, W]`` with ``P >= 1``, contiguous, at any 4-byte
    aligned address (a row slice of a contiguous tensor will do); no
    padding of ``W``.
    """
    _check_rows(bitvecs)
    if bitvecs.device.type == "cpu":
        a, o, c = ref.bitvector_reduce_ref(bitvecs)
        return torch.cat((a, o, c.view(torch.uint32).reshape(1)))
    if bitvecs.device.type != "cuda":
        raise ValueError(f"unsupported device {bitvecs.device}")
    global launches
    dev = bitvecs.device
    P, W = bitvecs.shape
    check(bitvecs, "bitvecs", torch.uint32, (P, W), dev)
    blocks = 1 if W <= ONE_BLOCK_WORDS else grid_blocks(
        W, torch.cuda.get_device_properties(dev).multi_processor_count)
    # partial counts, one per block, follow the count word when blocks > 1
    out = torch.empty((2 * W + 1 + (blocks if blocks > 1 else 0),),
                      dtype=torch.uint32, device=dev)
    lib = _lib()
    err = lib.ciao_bitvector_reduce(
        dev.index, bitvecs.data_ptr(), P, W, blocks, THREADS,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "bitvector_reduce")
    with cuda_build.counter_lock:
        launches += 1 if blocks == 1 else 2
    return out[:2 * W + 1]


def bitvector_reduce(bitvecs: torch.Tensor):
    """(and uint32[W], or uint32[W], popcount of the AND as int32[]).

    ``bitvecs uint32[P, W]`` with ``P >= 1``; no padding of ``W``.  On a
    CUDA tensor the three are views of one buffer
    (:func:`bitvector_reduce_buffer`).
    """
    _check_rows(bitvecs)
    if bitvecs.device.type == "cpu":
        return ref.bitvector_reduce_ref(bitvecs)
    return split(bitvector_reduce_buffer(bitvecs), bitvecs.shape[1])


def noop(device: torch.device) -> None:
    """Launch an empty kernel of C's block size on ``device``'s current
    stream: the launch floor C is measured against.  No path calls it."""
    lib = _lib()
    err = lib.ciao_noop(device.index, THREADS,
                        torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(lib, err, "noop")
