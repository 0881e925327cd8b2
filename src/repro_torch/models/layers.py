"""Shared layers: parameter specs, norms, RoPE, MLPs, embeddings.

The port of ``repro.models.layers``.  Parameters are plain nested dicts of
tensors with the JAX package's names and layouts.  An init function
returns a tree of :class:`Spec` leaves (shape and distribution), which
:func:`materialize` draws from an explicit ``torch.Generator`` on an
explicit device, so a parameter count (:func:`count`) never allocates.
The distributions are those of ``mk``: normal times ``fan_in ** -0.5``
(``fan_in`` the product of all but the last dim of one layer's shape, the
first dim of a vector), embeddings times 0.02, norms and biases zero,
RWKV's output-norm scale one, and the RG-LRU's ``lam`` as Griffin draws
it (``rglru.py``).  Every spec also carries ``axes``, the logical axis
names that the JAX package's ``mk`` records beside each leaf (one per
dim; a stacked group prepends ``"layers"``, :func:`model_axes`), which
:mod:`repro_torch.dist.sharding` maps onto a mesh.
``torch.Generator`` cannot give ``jax.random``'s numbers; tests that
compare the two packages convert the JAX package's parameters
(:mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Spec(NamedTuple):
    shape: tuple[int, ...]
    init: str = "normal"               # normal | zeros | ones | lru_lambda
    scale: float | None = None         # None -> fan_in ** -0.5
    axes: tuple[str | None, ...] | None = None   # logical names, one a dim


#: the RG-LRU's c: a = exp(-c softplus(lam) r) (``rglru.py``)
LRU_C = 8.0


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} needs a CUDA device and none is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the configs name dtypes)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict and the matching leaves of
    ``rest`` (nested dicts with the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, dict keys sorted: JAX's leaf order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, flat: list):
    """``flat`` in the structure of ``like``: nested dicts (keys sorted, as
    :func:`tree_leaves` lists them), tuples and lists (in order, as JAX
    lists them)."""
    it = iter(flat)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(x) for x in tree)
        return next(it)

    return walk(like)


def materialize(specs, generator: torch.Generator, device, dtype,
                n_layers: int | None = None):
    """Draw every leaf of ``specs``; ``n_layers`` stacks a leading layers
    axis (each layer drawn from the per-layer spec, as the JAX package's
    ``vmap`` over ``mk``)."""
    lead = () if n_layers is None else (n_layers,)

    def draw(s: Spec) -> torch.Tensor:
        shape = lead + tuple(s.shape)
        if s.init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if s.init == "lru_lambda":
            # Griffin: a = exp(-c softplus(lam)) ~ U[0.9, 0.999] at r = 1,
            # so lam = softplus^-1(-log(u) / c)
            u = torch.rand(shape, generator=generator, dtype=dtype,
                           device=device) * (0.999 - 0.9) + 0.9
            return torch.log(torch.expm1(-torch.log(u) / LRU_C))
        if s.init != "normal":
            raise ValueError(f"unknown init {s.init!r}")
        fan_in = (s.shape[0] if len(s.shape) == 1
                  else math.prod(s.shape[:-1]))
        scale = s.scale if s.scale is not None else \
            1.0 / max(float(fan_in), 1.0) ** 0.5
        out = torch.randn(shape, generator=generator, dtype=dtype,
                          device=device)
        return out.mul_(scale)

    return tree_map(draw, specs)


def count(specs, n_layers: int = 1) -> int:
    """Number of parameters in ``specs`` (times ``n_layers``)."""
    return n_layers * sum(math.prod(s.shape) for s in tree_leaves(specs))


class Stacked(NamedTuple):
    """A model entry of ``n`` layers: ``tree`` is one layer's spec tree,
    stacked on a leading layers axis."""
    tree: dict
    n: int


def _entries(specs: dict):
    """(name, spec tree, layers or None) of a model's top-level specs."""
    for name, spec in specs.items():
        if isinstance(spec, Stacked):
            yield name, spec.tree, spec.n
        else:
            yield name, spec, None


def model_count(specs: dict) -> int:
    """Parameters of a model's specs, :class:`Stacked` entries times their
    layers (nothing allocated)."""
    return sum(count(tree, n or 1) for _, tree, n in _entries(specs))


def model_shapes(specs: dict) -> dict:
    """Every parameter's shape, :class:`Stacked` entries with their layers
    axis."""
    return {name: tree_map(lambda s, lead=(() if n is None else (n,)):
                           lead + tuple(s.shape), tree)
            for name, tree, n in _entries(specs)}


def _axes(s: Spec, lead: tuple) -> tuple:
    if s.axes is None or len(s.axes) != len(s.shape):
        raise ValueError(f"spec {s} needs one logical axis name per dim")
    return lead + tuple(s.axes)


def model_axes(specs: dict) -> dict:
    """Every parameter's logical axes, :class:`Stacked` entries with
    ``"layers"`` first (the JAX package's ``vmap`` rebuild of its
    ``Leaf`` axes)."""
    return {name: tree_map(lambda s, lead=(() if n is None else
                                           ("layers",)): _axes(s, lead),
                           tree)
            for name, tree, n in _entries(specs)}


def model_materialize(specs: dict, generator: torch.Generator, device,
                      dtype) -> dict:
    """Draw every parameter of a model's specs (:func:`materialize`)."""
    return {name: materialize(tree, generator, device, dtype, n)
            for name, tree, n in _entries(specs)}


# ---------------------------------------------------------------------------
# shapes only (the dry run on the meta device)
# ---------------------------------------------------------------------------

_SHAPE_ONLY: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_shape_only", default=False)


@contextlib.contextmanager
def shape_only():
    """Inside the block, the two computations whose cost on the ``meta``
    device grows with the sequence (attention, ``attention.
    flash_attention``, and RWKV's time loop, ``rwkv6._wkv_scan``) return
    their outputs' shapes and types on meta tensors without computing:
    the dry run builds its steps on meta, which holds no data, and takes
    its FLOPs from the analytic model.  Neither issues a collective."""
    token = _SHAPE_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPE_ONLY.reset(token)


def shape_only_active() -> bool:
    return _SHAPE_ONLY.get()


# ---------------------------------------------------------------------------
# named residuals (JAX's checkpoint_name)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that carries ``name`` to a selective-checkpoint policy."""
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

_NAMING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_checkpoint_names", default=False)


@contextlib.contextmanager
def naming():
    """Inside the block, :func:`checkpoint_name` tags its tensors (a
    ``"save_block_io"`` layer, forward and recompute alike)."""
    token = _NAMING.set(True)
    try:
        yield
    finally:
        _NAMING.reset(token)


def checkpoint_name(x, name: str):
    """``x`` tagged ``name`` for the remat policy ``"save_block_io"``,
    through the ``repro_torch::checkpoint_name`` op (a copy) inside
    :func:`naming`; ``x`` itself anywhere else.  On a mesh the copy is
    of ``x``'s local shard, and the result keeps ``x``'s placements, as
    the JAX package's ``checkpoint_name`` runs under any mesh."""
    if not _NAMING.get():
        return x
    if type(x).__name__ == "DTensor":
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            _checkpoint_name(x.to_local(), name), x.device_mesh,
            x.placements, run_check=False, shape=x.shape, stride=x.stride())
    return _checkpoint_name(x, name)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def groupnorm_heads(x, scale, bias, eps: float = 1e-5):
    """GroupNorm over (..., H, hd) per head (RWKV output norm): f32, biased
    variance, in x's type."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


class RopeTables(NamedTuple):
    """cos and sin of the rotary angles at some positions, (..., S, 1, hd):
    ``cos`` is cos twice, ``sin`` is -sin then sin."""
    cos: torch.Tensor
    sin: torch.Tensor


def rope_tables(positions, head_dim: int, theta: float) -> RopeTables:
    """The tables of :func:`apply_rope`, computed once for every layer that
    rotates at the same positions."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return RopeTables(torch.cat([cos, cos], dim=-1)[..., None, :],
                      torch.cat([-sin, sin], dim=-1)[..., None, :])


def rotate(x, tables: RopeTables):
    """``[x1 cos - x2 sin, x2 cos + x1 sin]`` in f32, in x's type: the
    same products and sums as the JAX package's ``apply_rope``, so the
    same bits."""
    x32 = x.float()
    h = x.shape[-1] // 2
    swapped = torch.cat([x32[..., h:], x32[..., :h]], dim=-1)   # [x2, x1]
    return (x32 * tables.cos + swapped * tables.sin).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, act: str = "silu") -> dict:
    p = {"wi": Spec((d_model, d_ff), axes=("embed", "ffn")),
         "wo": Spec((d_ff, d_model), axes=("ffn", "embed"))}
    if act in ("silu", "swiglu", "geglu"):
        p["wg"] = Spec((d_model, d_ff), axes=("embed", "ffn"))
    return p


def silu(x):
    """``jax.nn.silu`` as the JAX package computes it: ``x * 1 / (1 +
    exp(-x))``, rounded to x's type after each step (``F.silu`` rounds
    once, and differs in bf16)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def apply_mlp(p, x, act: str = "silu"):
    h = x @ p["wi"].to(x.dtype)
    if "wg" in p:
        g = x @ p["wg"].to(x.dtype)
        # jax.nn.gelu is the tanh approximation by default
        gate = silu(g) if act != "geglu" else F.gelu(g, approximate="tanh")
        h = h * gate
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(cfg) -> dict:
    p = {"tok": Spec((cfg.vocab_size, cfg.d_model), scale=0.02,
                     axes=("vocab", "embed"))}
    if not cfg.tied_embeddings:
        p["unembed"] = Spec((cfg.d_model, cfg.vocab_size),
                            axes=("embed", "vocab"))
    return p


def embed_tokens(p, tokens, compute_dtype):
    # gather, then cast: the same values as casting the whole table first
    if type(tokens).__name__ == "DTensor":
        return _embed_on_mesh(p["tok"], tokens).to(compute_dtype)
    return p["tok"][tokens].to(compute_dtype)


def _embed_on_mesh(tok, tokens):
    """The lookup of DTensor ``tokens`` under ``local_map``: each rank
    gathers its own batch rows from the whole table (gathered first), so
    the table's gradient is a partial sum over the batch axes; DTensor's
    own index ops are left out (PyTorch 2.11's fail on a sharded index)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist import sharding

    mesh = tokens.device_mesh
    tok = sharding.on_mesh(tok, mesh)
    tok_pl = (Replicate(),) * mesh.ndim
    tok_grad = tuple(Partial() if p.is_shard() else Replicate()
                     for p in tokens.placements)
    return local_map(lambda t, i: t[i], out_placements=(tokens.placements,),
                     in_placements=(tok_pl, tokens.placements),
                     in_grad_placements=(tok_grad, tokens.placements),
                     device_mesh=mesh, redistribute_inputs=True)(tok, tokens)


def unembed(p, x, tied: bool):
    w = p["tok"].T if tied else p["unembed"]
    return x @ w.to(x.dtype)
