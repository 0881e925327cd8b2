"""Collective bytes of one step, recorded as it runs (the role of
``repro.analysis.hlo``: there is no compiled HLO to parse here).

:class:`CommsRecorder` is a ``TorchDispatchMode``.  On an op over
DTensors it returns ``NotImplemented``, so DTensor runs first and lowers
the op into collectives over local tensors, which the mode then sees (as
PyTorch's ``CommDebugMode`` does); it also sees the collectives that code
issues itself (``torch.distributed.all_reduce`` and the functional
collectives).  Each is recorded by kind with the bytes of its result,
as the JAX package's parser reads each collective's result shape from
the per-device HLO, all-reduce counted twice (a ring's reduce-scatter
and all-gather phases).  Every op that runs is counted once: a Python
loop over layers issues its collectives once per layer, so no trip
count is needed.  :meth:`CommsRecorder.result` gives the JAX package's
``{"bytes": {kind: bytes}, "counts": {kind: n}, "total": bytes}``.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_F = torch.ops._c10d_functional
_C = torch.ops.c10d

#: op packet -> the JAX package's collective kind
KINDS: dict = {}
for _name, _kind in (
        ("all_reduce", "all-reduce"), ("all_reduce_coalesced", "all-reduce"),
        ("all_gather_into_tensor", "all-gather"),
        ("all_gather_into_tensor_coalesced", "all-gather"),
        ("reduce_scatter_tensor", "reduce-scatter"),
        ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
        ("all_to_all_single", "all-to-all"),
        ("broadcast", "collective-broadcast")):
    KINDS[getattr(_F, _name)] = _kind
for _name, _kind in (
        ("allreduce_", "all-reduce"), ("allreduce_coalesced_", "all-reduce"),
        ("allgather_", "all-gather"), ("_allgather_base_", "all-gather"),
        ("allgather_into_tensor_coalesced_", "all-gather"),
        ("reduce_scatter_", "reduce-scatter"),
        ("_reduce_scatter_base_", "reduce-scatter"),
        ("reduce_scatter_tensor_coalesced_", "reduce-scatter"),
        ("alltoall_", "all-to-all"), ("alltoall_base_", "all-to-all"),
        ("broadcast_", "collective-broadcast")):
    if hasattr(_C, _name):
        KINDS[getattr(_C, _name)] = _kind


def _nbytes(out) -> int:
    leaves, _ = tree_flatten(out)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _result(func, args, kwargs, out):
    """The tensors a collective leaves behind: its output, or for an
    in-place c10d op its output list (all-gather's gathered tensors) or
    its tensors."""
    if func in (_C.allgather_, getattr(_C, "_allgather_base_", None),
                getattr(_C, "allgather_into_tensor_coalesced_", None),
                getattr(_C, "_reduce_scatter_base_", None),
                getattr(_C, "alltoall_base_", None)):
        return args[0]
    if isinstance(out, tuple) and out and isinstance(out[0], (list, tuple)):
        return out[0]
    return out


class CommsRecorder(TorchDispatchMode):
    """Record every collective run inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = KINDS.get(func._overloadpacket)
        if kind is not None:
            b = _nbytes(_result(func._overloadpacket, args, kwargs, out))
            if kind == "all-reduce":
                b *= 2
            self.bytes[kind] = self.bytes.get(kind, 0) + b
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return out

    def result(self) -> dict:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total": sum(self.bytes.values())}
