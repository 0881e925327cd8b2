"""Training step: microbatched grad accumulation, clipping, optimizer
update (the port of ``repro.train.train_step``).

``make_train_step(model, opt_cfg)`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
with ``batch`` a dict of tensors on the parameters' device.  The step
differentiates ``model.loss`` with ``torch.autograd.grad`` with respect
to detached copies of the parameter leaves, so the caller's tensors never
require a gradient, then updates the parameters and the optimizer state
in place (:mod:`repro_torch.train.optimizer`).  Microbatching splits the
global batch into ``n_micro`` parts along its first dim and accumulates
their grads in f32.

Optional int8 gradient compression with error feedback (``compress=True``)
runs the accumulated grads through a quantize/dequantize pair whose
residual is carried in ``opt_state["ef"]``.

On a mesh the parameters and the batch are DTensors
(``dist.sharding.shard_params``, ``batch_shardings``); autograd gives
DTensor grads, and ``grad_specs`` (a tree of ``PartitionSpec`` beside
the parameters) redistributes each grad to its
placements before the update, the counterpart of the JAX package's
``with_sharding_constraint`` (ZeRO: a grad laid out as its parameter
is reduce-scattered, not all-reduced).  The step runs under
``implicit_replication``, and AdamW updates the DTensor leaves in place;
the metrics come back as plain tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist import sharding
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten

from . import optimizer as opt_mod
from .optimizer import OptConfig


def _split_batch(batch: dict, n_micro: int) -> list[dict]:
    """``n_micro`` microbatches of consecutive rows, the JAX package's
    split.  A batch-sharded DTensor is gathered first and each
    microbatch laid out over the batch axes again (a rank's rows are not
    one microbatch's)."""
    parts = {}
    for k, v in batch.items():
        mb = v.shape[0] // n_micro
        if sharding.is_dtensor(v):
            mesh = v.device_mesh
            full = sharding.replicate_all(v)
            parts[k] = [sharding.distribute(
                full[i * mb:(i + 1) * mb], sharding.NamedSharding(
                    mesh, sharding.batch_spec(mesh, v.ndim, batch_size=mb)))
                for i in range(n_micro)]
        else:
            parts[k] = list(v.reshape((n_micro, mb) + v.shape[1:]))
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def quantize_int8(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def value_and_grad(model, params, batch, *, attention=None):
    """(loss, grads): ``model.loss`` and its gradient with respect to
    every parameter leaf, grads shaped and typed like the parameters.  A
    leaf that the loss does not reach raises: a gradient never goes
    missing in silence.  ``attention``: as ``Model.loss``'s."""
    flat = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, flat)
    with torch.enable_grad(), sharding.mesh_ops(flat[0]):
        loss = model.loss(live, batch, attention=attention)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tree_unflatten(params, list(grads))


def _constrain_grad(g, spec):
    """``g`` laid out as ``spec`` (a ``PartitionSpec`` on g's mesh); a
    plain tensor as it is."""
    if not sharding.is_dtensor(g):
        return g
    return g.redistribute(g.device_mesh,
                          sharding.placements(spec, g.device_mesh))


def _plain(x):
    """A metric as a plain tensor (a DTensor's full value)."""
    return x.full_tensor() if sharding.is_dtensor(x) else x


def make_train_step(model, opt_cfg: OptConfig, *, n_micro: int = 1,
                    compress: bool = False, grad_specs=None) -> Callable:
    """``grad_specs``: optional tree of ``PartitionSpec`` matching the
    parameters; each grad is redistributed to it before the update
    (module docstring)."""

    def train_step(params, opt_state, batch):
        with sharding.mesh_ops(tree_leaves(params)[0]):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for mb in _split_batch(batch, n_micro):
                l_, g = value_and_grad(model, params, mb)
                loss = loss + l_
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)

        if grad_specs is not None:
            grads = tree_map(_constrain_grad, grads, grad_specs)

        if compress:
            # error-feedback int8: residual lives in opt_state["ef"]
            ef = opt_state.get("ef")
            if ef is None:
                ef = tree_map(lambda g: torch.zeros_like(
                    g, dtype=torch.float32), grads)
            g_plus = tree_map(lambda g, e: g.float() + e, grads, ef)
            deq = tree_map(lambda g: dequantize_int8(*quantize_int8(g)),
                           g_plus)
            new_ef = tree_map(lambda gp, d: gp - d, g_plus, deq)
            grads = deq
            opt_state = {**opt_state, "ef": new_ef}

        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.grad_clip)
        inner = {k: v for k, v in opt_state.items() if k != "ef"}
        params, inner, lr = opt_mod.update(params, grads, inner, opt_cfg)
        if "ef" in opt_state:
            inner["ef"] = opt_state["ef"]
        metrics = {
            "loss": _plain(loss.float()),
            "grad_norm": _plain(gnorm),
            "lr": _plain(lr),
            "step": _plain(inner["step"]),
        }
        return params, inner, metrics

    return train_step


def init_opt_state(model, params, opt_cfg: OptConfig):
    return opt_mod.init(params, opt_cfg)


def opt_config_for(cfg) -> OptConfig:
    return OptConfig(
        learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        grad_clip=cfg.grad_clip,
        opt_dtype=cfg.opt_dtype,
    )
