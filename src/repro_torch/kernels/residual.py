"""Device offload hooks for the columnar scanner's residual phase.

The columnar scan (DESIGN.md §13) is host-side numpy by default: packed
bitvector AND, candidate unpack, vectorized column predicates.  The AND
over a segment's pushed clause rows has a natural device form — it is the
AND output of kernel C (``csrc/bitvector_reduce.cu``, via
``ops.reduce_bitvectors``) — so this module exposes it as an optional
``and_reduce`` for :class:`repro_torch.core.server.DataSkippingScanner`:

    scanner = DataSkippingScanner(store, and_reduce=bv_and_many_cuda)

Both hooks take and return numpy, run on the card by default and raise
where there is none; ``backend="torch"`` runs kernel C's plain version.
The JAX package pads each call to power-of-two ``(P, W)`` buckets, which
only bounds XLA's jit cache (one trace per shape); a CUDA launch takes any
shape and caches nothing per shape, so the buckets are left out.
Column-predicate evaluation stays on the host (the full device residual
path is ``kernels.scan_fused``).
"""
from __future__ import annotations

import numpy as np

from . import ops


def bv_and_many_cuda(words: np.ndarray, *, backend: str = "cuda",
                     device=None) -> np.ndarray:
    """AND-reduce packed rows (P, W) -> (W,) through kernel C.

    Drop-in for :func:`repro_torch.core.bitvector.bv_and_many`
    (bit-identical).
    """
    return ops.reduce_bitvectors(words, backend=backend, device=device)[0]


def popcount_cuda(words: np.ndarray, *, backend: str = "cuda",
                  device=None) -> int:
    """Total set bits of a packed array: kernel C's count over a
    one-row view (the AND of one row is the row)."""
    flat = np.asarray(words, np.uint32).reshape(1, -1)
    return ops.reduce_bitvectors(flat, backend=backend, device=device)[2]
