"""AdamW and adafactor-lite on nested dicts of tensors (the port of
``repro.train.optimizer``).

The state's moments are shaped like the parameters and stored in
``opt_dtype``; the math is f32.  ``update`` runs under ``torch.no_grad``
and writes the new parameters and moments into the given tensors, in
place: the counterpart of the JAX package's jitted step with donated
params and optimizer state.  It returns the same dicts.  Leaves are
visited in the JAX package's order (dict keys sorted), so sums over
leaves add in the same order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import torch_dtype, tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    opt_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step):
    """Linear warmup + cosine decay to min_lr_frac, in f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.learning_rate * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    # a true division, as the JAX package's (python / tensor would be a
    # reciprocal and a product)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw_init(params, cfg: OptConfig):
    """Zeroed moments laid out as the parameters (DTensors on a mesh)."""
    dt = torch_dtype(cfg.opt_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step0(params)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * torch.square(g32)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 1 and cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, lr


# ---------------------------------------------------------------------------
# adafactor-lite (factored v for matrices; full v for vectors)
# ---------------------------------------------------------------------------

def adafactor_init(params, cfg: OptConfig):
    dt = torch_dtype(cfg.opt_dtype)

    def one(p):
        if p.ndim >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=dt,
                                  device=p.device),
            }
        return {"v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    return {"f": tree_map(one, params), "step": _step0(params)}


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    decay = 1.0 - step.float() ** -0.8

    def upd(p, g, s):
        g32 = g.float()
        g2 = torch.square(g32) + 1e-30
        if p.ndim >= 2:
            vr = decay * s["vr"].float() + (1 - decay) * g2.mean(-1)
            vc = decay * s["vc"].float() + (1 - decay) * g2.mean(-2)
            denom = (vr[..., :, None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30))
            delta = g32 / torch.sqrt(denom + 1e-30)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = decay * s["v"].float() + (1 - decay) * g2
            delta = g32 / torch.sqrt(v + 1e-30)
            s["v"].copy_(v)
        # update clipping (RMS <= 1) as in the original
        rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
        delta = delta / torch.clamp(rms, min=1.0)
        if p.ndim >= 1 and cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                       _state_leaves(state["f"])):
        upd(p, g, s)
    return params, {"f": state["f"], "step": step}, lr


def _state_leaves(f) -> list[dict]:
    """The per-parameter state dicts of adafactor's ``f`` tree, in the
    parameters' leaf order."""
    if set(f) <= {"v", "vr", "vc"} and all(
            isinstance(x, torch.Tensor) for x in f.values()):
        return [f]
    return [s for k in sorted(f) for s in _state_leaves(f[k])]


def init(params, cfg: OptConfig):
    if cfg.kind == "adafactor":
        return adafactor_init(params, cfg)
    return adamw_init(params, cfg)


def update(params, grads, state, cfg: OptConfig):
    if cfg.kind == "adafactor":
        return adafactor_update(params, grads, state, cfg)
    return adamw_update(params, grads, state, cfg)
