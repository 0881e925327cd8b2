"""Plain reference of a training step: loss, gradients, clipping, AdamW.

The loss is the mean next-token cross-entropy over every position of the
batch (each row's loss summed, divided by ``B * (S - 1)``), its gradient
taken by autograd through the architecture's reference ``row_loss_sum``
one row at a time (the rows' gradients add up to the batch's).  Then the
global norm is clipped to ``grad_clip`` and AdamW updates every leaf:
moments with ``b1``/``b2``, bias-corrected, ``eps`` outside the root,
decoupled weight decay on every leaf, the learning rate warmed up linearly
and decayed on a cosine, all as the configuration file's ``run.optimizer``
states.
"""
from __future__ import annotations

import math

import torch

from .precision import exact_f32


def named_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of a nested dict, keys sorted, paths dotted."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from named_leaves(v, path + ".")
        else:
            yield path, v


def learning_rate(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["learning_rate"] * warm * frac


def train(row_loss_sum, weights, arch, batches, opt: dict, initial, prec: str = "f32"):
    """Run one step a batch (each (B, S) int64 on the weights' device) on
    f32 ``weights``, updated in place; ``row_loss_sum(weights, arch, row,
    prec)`` is the architecture's reference loss of one row.  Returns each
    step's loss, the first step's clipped gradient norm a leaf, and each
    leaf's change norm after the last step against ``initial()``, an
    iterator of ``(path, leaf)`` of the starting weights."""
    with exact_f32():
        return _train(row_loss_sum, weights, arch, batches, opt, initial, prec)


def _train(row_loss_sum, weights, arch, batches, opt, initial, prec):
    leaves = list(named_leaves(weights))
    params = [p.requires_grad_() for _, p in leaves]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first_grad = [], {}
    for t, batch in enumerate(batches, start=1):
        B, S = batch.shape
        total = 0.0
        for b in range(B):
            loss = row_loss_sum(weights, arch, batch[b], prec) / (B * (S - 1))
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = [p.grad for p in params]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-12), max=1.0)
            lr = learning_rate(opt, t)
            for (path, p), g, mi, vi in zip(leaves, grads, m, v):
                g.mul_(scale)
                if t == 1:
                    first_grad[path] = float(g.norm())
                mi.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                vi.mul_(opt["b2"]).add_(g.square(), alpha=1 - opt["b2"])
                mhat = mi / (1 - opt["b1"] ** t)
                vhat = vi / (1 - opt["b2"] ** t)
                delta = mhat / (torch.sqrt(vhat) + opt["eps"])
                if p.ndim >= 1 and opt["weight_decay"]:
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
                p.grad = None
    del m, v
    change = {}
    with torch.no_grad():
        current = dict(leaves)
        for path, p0 in initial():
            change[path] = float((current[path] - p0.float()).norm())
            del p0
    return {"losses": losses, "first_grad": first_grad, "change": change}
