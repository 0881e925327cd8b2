"""Multi-shard and mesh collectives (port of ``repro.dist.collectives``).

  * :func:`tree_reduce` is the deterministic host-local binary-tree
    reduction that the sharded store plane (``repro_torch.core.shard``)
    routes its scatter-gather ``ScanResult`` merge through, so merged
    results have a FIXED association order regardless of shard
    completion order.
  * :func:`compressed_allreduce` is the int8-compressed SUM all-reduce
    of a tree over one mesh axis, as ``torch.distributed`` collectives on
    that axis's process group: each rank quantizes its own tensors to
    int8 with a scale agreed over the axis, sums in int32 over the axis,
    and dequantizes.  Each rank's tensors are its own values (the JAX
    package's ``shard_map`` with replicated ``in_specs``).

The flash-decoding sharded attention path is a documented stub in the
JAX package (``ATTENTION_IS_STUB``), and here too:
:func:`sharded_decode_attention_gqa` raises as the JAX package's does,
and ``models.transformer._use_sharded_decode`` guards it at the same
condition.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, TypeVar

import torch

T = TypeVar("T")

# the reduce plane (tree_reduce, compressed_allreduce) is implemented
REDUCE_IS_STUB = False
# the flash-decoding attention path is a stub, as in the JAX package
ATTENTION_IS_STUB = True
# gate for the model-parallel tests that end in the sharded attention
IS_STUB = ATTENTION_IS_STUB

_MSG = ("repro_torch.dist.collectives keeps the JAX package's stub: the "
        "multi-device {name} path has not been restored there yet")


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


def _quantized_psum(x: torch.Tensor, group) -> torch.Tensor:
    """One leaf of :func:`compressed_allreduce` over ``group``: int8
    quantize -> int32 sum -> dequantize, in the JAX package's order:

      1. all-reduce MAX of this rank's ``max|x|`` (f32) over the group;
      2. scale = amax / 127, or 1 / 127 when amax is 0;
      3. round to int8 half-to-even (``torch.round``, as ``jnp.round``),
         clipped to +-127;
      4. all-reduce SUM of the int8 payload in int32;
      5. dequantize with the shared scale, in x's type (f32 for integers).

    The scale is AGREED first: dequantizing the summed payload with a
    rank-local scale is wrong the moment inputs differ across the axis.
    """
    import torch.distributed as dist

    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    xf = x.float()
    amax = xf.abs().max() if xf.numel() else xf.new_zeros(())
    amax = amax.reshape(1).clone()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    amax = amax[0]
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    s = q.to(torch.int32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return (s.float() * scale).to(out_dtype)


def compressed_allreduce(tree: Any, mesh, axis: str = "pod") -> Any:
    """int8-compressed SUM all-reduce of a tree (nested dicts, tuples and
    lists of tensors) over mesh ``axis``.

    Per leaf (:func:`_quantized_psum`): the per-rank ``max|x|`` is
    MAX-agreed over ``axis``, values quantize to int8 with the shared
    scale ``amax / 127``, the int8 payload sums in int32, and the sum
    dequantizes with the same shared scale.  Wire cost is 1/4 of an f32
    all-reduce (the int32 sum carries int8 values); the error per element
    is bounded by ``n_axis * scale / 2``.
    """
    group = mesh.get_group(axis)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return _quantized_psum(t, group)

    return walk(tree)


def sharded_decode_attention_gqa(q, k, v, pos, mesh=None, *, window: int = 0,
                                 q_position=None, batch_axes=("data",),
                                 seq_axis: str = "model"):
    """Flash-decoding GQA with the KV sequence sharded over ``seq_axis``:
    a stub in the JAX package, and the same stub here."""
    raise NotImplementedError(_MSG.format(name="sharded_decode_attention_gqa"))
