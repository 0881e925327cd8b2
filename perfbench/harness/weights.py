"""The weights both sides get: drawn on the device from the seed.

One draw a parameter leaf (a layer group's leaf stacks all its layers, so
a model is a few dozen large calls) from one ``torch.Generator`` on the
device, in the type the program holds them in.  Norm scales (stored as
offsets from one) and anything the program's layout marks ``zeros`` start
at zero; embeddings keep the program's stated scale (0.02); every other
matrix is normal times ``fan_in ** -0.5``, ``fan_in`` being the dims a
product contracts, so each layer's output starts at unit scale.  A stacked
axis is no such dim: neither the layers' nor an ``expert`` axis, over
which each expert's matrix contracts alone.

The same seed gives the same weights, leaf for leaf, so the plain
reference draws its own copy again after the program's state is freed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer
from repro_torch.models.layers import Stacked

from perfbench.reference.train import named_leaves


def _fan_in(shape, axes) -> int:
    dims = [(n, a) for n, a in zip(shape, axes) if a != "expert"]
    if len(dims) == 1:
        return dims[0][0]
    out = 2 if [a for _, a in dims[-2:]] == ["heads", "head_dim"] else 1
    return math.prod(n for n, _ in dims[:-out])


def _specs(cfg) -> dict:
    """``path -> (shape with layers, Spec)`` in leaf order."""
    out = {}
    for name, entry in transformer.param_specs(cfg).items():
        lead = (entry.n,) if isinstance(entry, Stacked) else ()
        tree = entry.tree if isinstance(entry, Stacked) else entry
        leaves = named_leaves(tree, name + ".") if isinstance(tree, dict) else [(name, tree)]
        for path, spec in leaves:
            out[path] = (lead + tuple(spec.shape), spec)
    return dict(sorted(out.items()))


def iter_weights(cfg, seed: int, device, dtype):
    """``(path, tensor)`` of every parameter, drawn in path order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for path, (shape, spec) in _specs(cfg).items():
        if spec.init == "zeros":
            yield path, torch.zeros(shape, dtype=dtype, device=device)
            continue
        if spec.init != "normal":
            raise ValueError(f"{path}: init {spec.init!r} is not drawn here")
        scale = spec.scale if spec.scale is not None else _fan_in(spec.shape, spec.axes) ** -0.5
        yield path, torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(scale)


def make_weights(cfg, seed: int, device, dtype) -> dict:
    """The nested dict the program takes (``group0.sub0.attn.wq`` ...)."""
    tree: dict = {}
    for path, t in iter_weights(cfg, seed, device, dtype):
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree
