"""Multi-shard collectives (port of ``repro.dist.collectives``).

:func:`tree_reduce` is the deterministic host-local binary-tree
reduction that the sharded store plane (``repro_torch.core.shard``)
routes its scatter-gather ``ScanResult`` merge through, so merged
results have a FIXED association order regardless of shard completion
order.

The reference's mesh collectives are not in this module:
``compressed_allreduce`` (an int8-compressed SUM all-reduce over a mesh
axis) and ``sharded_decode_attention_gqa`` (flash-decoding with the KV
sequence sharded over a mesh axis) belong to the model mesh, which the
port has not reached yet (ROADMAP.md Queue 1, the model mesh item).
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

T = TypeVar("T")


def tree_reduce(items: Sequence[T], fn: Callable[[T, T], T]) -> T:
    """Reduce ``items`` with a deterministic binary tree.

    Association order is fixed by position — ``((x0·x1)·(x2·x3))…`` with
    an odd trailing element carried up unchanged — and never by arrival
    or completion order.  This is the host-local form of the pairwise
    reduction a pod-axis all-reduce performs; the shard scan merge uses
    it so N-shard results are bit-reproducible run to run.
    """
    xs = list(items)
    if not xs:
        raise ValueError("tree_reduce needs >= 1 item")
    while len(xs) > 1:
        nxt = []
        for i in range(0, len(xs) - 1, 2):
            nxt.append(fn(xs[i], xs[i + 1]))
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]
