"""Logical-axis -> mesh sharding rules (port of ``repro.dist.sharding``).

Every parameter spec carries logical axis names (``models.layers.Spec``
``axes``, :func:`repro_torch.models.layers.model_axes`); this module maps
them onto the axes of a ``torch.distributed`` ``DeviceMesh``.  The
contract is the JAX package's:

  * a logical axis maps to a mesh axis only when that mesh axis exists,
    has size > 1, and divides the dimension; otherwise the dim is
    replicated (``None`` in the :class:`PartitionSpec`);
  * a mesh axis is consumed at most once per leaf (first dim wins);
  * with no active mesh every helper degrades to a no-op or to
    replication, so single-device code paths never pay a constraint.

A :class:`PartitionSpec` is the port's own tuple with the JAX package's
entries (a mesh axis name, a tuple of names, or ``None``; trailing
``None``s dropped).  :func:`placements` turns it into DTensor placements,
one per mesh dim: ``Shard(d)`` where tensor dim ``d`` names that mesh
axis, else ``Replicate()``.  A dim sharded over ``("pod", "data")`` takes
``Shard(d)`` on both mesh dims, pod outermost, the JAX layout.

PyTorch has no global mesh: :func:`current_mesh` and :func:`use_mesh`
keep one in a ``contextvars`` variable.  Helpers that read a mesh's sizes
read only ``mesh.shape`` and ``mesh.mesh_dim_names``; a mesh whose
``shape`` is a mapping of axis names to sizes (as a JAX mesh's is) works
as well.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from repro_torch.models.layers import tree_map

# mesh axes that carry the batch dimension of activations / inputs
BATCH_AXES = ("pod", "data")

# profile -> logical axis -> mesh axis preference (first admissible wins)
_RULES: dict[str, dict[str, tuple[str, ...]]] = {
    # tensor-parallel heads/ffn + FSDP over data for the embed axis
    "tp_fsdp": {
        "ffn": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
        "embed": ("data",),
        "q_lora": ("model",),
        "kv_lora": ("model",),
    },
    # pure ZeRO-3: shard the largest axis over every data-like mesh axis
    "fsdp": {
        "embed": ("data",),
        "ffn": ("data",),
        "vocab": ("data",),
        "expert": ("data",),
    },
    # serving tensor-parallel layout: weights split over model only
    "serve_tp": {
        "ffn": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
    },
}


class PartitionSpec(tuple):
    """One entry per leading tensor dim: a mesh axis name, a tuple of
    names, or ``None``; the JAX ``PartitionSpec``'s entries (a tuple of
    one name is that name, as JAX canonicalises it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


def rules_for(profile: str) -> Mapping[str, tuple[str, ...]]:
    if profile not in _RULES:
        raise ValueError(f"unknown sharding profile {profile!r}")
    return _RULES[profile]


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh inside the ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_sizes(mesh) -> dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def mesh_axes(mesh) -> tuple[str, ...]:
    """The mesh's axis names in mesh-dim order."""
    if isinstance(mesh.shape, Mapping):
        return tuple(mesh.shape)
    return tuple(mesh.mesh_dim_names)


def scan_mesh(n_shards: int):
    """1-D ``("shards",)`` mesh placing store shard *i* on rank *i* of the
    default process group, or ``None``: with fewer than 2 shards, no
    initialised process group of at least ``n_shards`` ranks, or, over
    NCCL, fewer cards than shards.  Its device type is
    :func:`~repro_torch.launch.mesh.mesh_device_type`'s (``cpu`` over
    gloo).  ``ShardedDeviceScanner(spmd=True)`` scans on it and refuses
    to run where it is ``None``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import mesh_device_type

    if n_shards < 2 or not dist.is_initialized() \
            or dist.get_world_size() < n_shards:
        return None
    kind = mesh_device_type()
    if kind == "cuda" and torch.cuda.device_count() < n_shards:
        return None
    return DeviceMesh(kind, list(range(n_shards)),
                      mesh_dim_names=("shards",))


def spec_for_leaf(shape: Sequence[int], axes: Sequence[str | None], mesh,
                  rules: Mapping[str, tuple[str, ...]] | None = None
                  ) -> PartitionSpec:
    """PartitionSpec for one leaf; mesh axes of size 1 are dropped
    entirely."""
    if rules is None:
        rules = _RULES["tp_fsdp"]
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list[str | None] = []
    for dim, name in zip(shape, axes):
        placed = None
        for mesh_axis in rules.get(name or "", ()):
            sz = sizes.get(mesh_axis, 1)
            if sz > 1 and mesh_axis not in used and dim % sz == 0:
                placed = mesh_axis
                used.add(mesh_axis)
                break
        entries.append(placed)
    while entries and entries[-1] is None:  # trailing Nones are implicit
        entries.pop()
    return PartitionSpec(*entries)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that mesh axis
    (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_axes(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the JAX ``NamedSharding``'s counterpart."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(values: Any, axes: Any, mesh,
                    rules: Mapping[str, tuple[str, ...]] | None = None
                    ) -> Any:
    """values/axes trees (``Model.abstract_params``, or parameters and
    ``param_axes``) -> a tree of :class:`NamedSharding`."""
    return tree_map(lambda v, a: NamedSharding(
        mesh, spec_for_leaf(tuple(v.shape), a, mesh, rules)), values, axes)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` as a DTensor laid out as ``sharding``.  Every rank passes the
    same full tensor (drawn from one seed, or read from one file): each
    keeps its own slice, and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def shard_params(values: Any, shardings: Any) -> Any:
    """Every leaf of ``values`` distributed as its sharding
    (:func:`distribute`)."""
    return tree_map(distribute, values, shardings)


def batch_entry(mesh, batch_size: int | None) -> tuple[str, ...] | None:
    sizes = mesh_sizes(mesh)
    picked = tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)
    if not picked:
        return None
    total = 1
    for a in picked:
        total *= sizes[a]
    if batch_size is not None and batch_size % total:
        return None
    return picked


def batch_spec(mesh, ndim: int, batch_size: int | None = None
               ) -> PartitionSpec:
    """Shard dim 0 over the (pod, data) axes; replicate the rest."""
    entry = batch_entry(mesh, batch_size)
    if entry is None:
        return PartitionSpec()
    return PartitionSpec(entry, *(None,) * (ndim - 1))


def _shape(x) -> tuple:
    """A leaf's shape: a tensor's, or the first item of ``input_specs``'
    ``(shape, dtype)`` pairs."""
    return tuple(x[0]) if isinstance(x, tuple) else tuple(x.shape)


def batch_shardings(specs: Any, mesh, profile: str | None = None) -> Any:
    """:class:`NamedSharding` tree for a batch (tensors, or the
    ``(shape, dtype)`` pairs of ``configs.input_specs``)."""
    del profile  # batch layout is profile-independent in this build

    def one(s):
        shp = _shape(s)
        return NamedSharding(mesh, batch_spec(
            mesh, len(shp), batch_size=shp[0] if shp else None))

    return {k: one(v) for k, v in specs.items()}


def cache_shardings(cache: Any, mesh, batch_size: int | None = None) -> Any:
    """KV caches shard over batch (dim 0); non-batch leaves replicate.  As
    in the JAX package, a leaf stacked on a leading layers dim shards only
    where that dim equals ``batch_size``."""

    def one(x):
        shp = _shape(x)
        if shp and batch_size is not None and shp[0] == batch_size:
            return NamedSharding(mesh, batch_spec(mesh, len(shp),
                                                  batch_size=batch_size))
        return NamedSharding(mesh, PartitionSpec())

    return tree_map(one, cache)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate_all(x):
    """A DTensor replicated on every mesh dim (gathered where sharded)."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def replicate_dim(x, dim: int):
    """A DTensor with tensor dim ``dim`` no longer sharded on any mesh dim
    (gathered where it was); any other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def on_mesh(x, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    taken as the same value on every rank (replicated)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unflatten_last(x, *sizes: int):
    """``x`` with its last dim split into ``sizes``; a DTensor sharded on
    that dim over a mesh dim that does not divide ``sizes[0]`` (heads a
    mesh axis does not divide) is gathered on it first, since DTensor
    cannot split such a dim."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = x.ndim - 1
        want = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                     and sizes[0] % x.device_mesh.size(i) else p
                     for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(*x.shape[:-1], *sizes)


def _constrain(x, spec: PartitionSpec):
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def constrain_act(x, profile: str | None = None, vocab_dim: bool = False):
    """Lay an activation's batch dim over (pod, data); a no-op off a mesh
    or on a plain tensor.

    ``vocab_dim=True`` marks logits: the last dim additionally shards over
    ``model`` when divisible (the unembed projection's natural layout).
    """
    del profile
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x) or x.ndim == 0:
        return x
    sizes = mesh_sizes(mesh)
    entry = batch_entry(mesh, x.shape[0])
    last = None
    if vocab_dim and x.ndim >= 2 and sizes.get("model", 1) > 1 \
            and x.shape[-1] % sizes["model"] == 0:
        last = "model"
    if entry is None and last is None:
        return x
    entries = [entry] + [None] * (x.ndim - 1)
    if last is not None:
        entries[-1] = last
    return _constrain(x, PartitionSpec(*entries))


def constrain_seq(x):
    """Megatron-SP residual layout: batch over (pod, data), seq over
    model; a no-op off a mesh or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x) or x.ndim < 3:
        return x
    sizes = mesh_sizes(mesh)
    entry = batch_entry(mesh, x.shape[0])
    seq = "model" if sizes.get("model", 1) > 1 \
        and x.shape[1] % sizes["model"] == 0 else None
    if entry is None and seq is None:
        return x
    return _constrain(x, PartitionSpec(entry, seq, *(None,) * (x.ndim - 2)))


def replicated_call(fn, *args, like):
    """``fn(*args)`` on every rank of ``like``'s mesh over whole (gathered)
    tensors, as ``local_map`` does it: each DTensor leaf of ``args``
    (nested dicts and tuples) is replicated and taken as its local
    tensor, and every tensor ``fn`` returns becomes a replicated DTensor.
    Every rank computes the same values, so the gradients are whole on
    every rank too."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map as pytree_map

    mesh = like.device_mesh
    rep = (Replicate(),) * mesh.ndim

    def local(a):
        return a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a

    def wrap(o):
        return (DTensor.from_local(o, mesh, rep, run_check=False)
                if isinstance(o, torch.Tensor) else o)

    return pytree_map(wrap, fn(*pytree_map(local, args)))


_REPLICATING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_implicit_replication", default=False)


def mesh_ops(x):
    """The context a model entry point runs in: ``implicit_replication``
    where ``x`` (a parameter) is a DTensor, so the tensors the model
    makes itself (positions, rotary tables, masks) count as replicated;
    else nothing.  Nested uses keep the outermost one (PyTorch's context
    turns the flag off on every exit), so a backward run inside the
    outer block, checkpoint recomputes included, still has it."""
    if not is_dtensor(x) or _REPLICATING.get():
        return contextlib.nullcontext()
    return _replicating()


@contextlib.contextmanager
def _replicating():
    from torch.distributed.tensor.experimental import implicit_replication

    token = _REPLICATING.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING.reset(token)


def shard_cache(cache: Any, *, like) -> Any:
    """A model's cache on ``like``'s mesh where ``like`` is a DTensor,
    else the cache as it is.  Every leaf is replicated: the port's caches
    are stacked on a leading layers dim, which :func:`cache_shardings`
    (the JAX package's rule) shards only where it happens to equal the
    batch, and the model unbinds the layers one by one, which a DTensor
    cannot do along a sharded dim."""
    if not is_dtensor(like):
        return cache
    rep = NamedSharding(like.device_mesh, PartitionSpec())
    return shard_params(cache, tree_map(lambda _: rep, cache))
