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


#: elements of one piece of a large leaf: the global norm and adafactor's
#: update run piece by piece, so their f32 temporaries stay one piece's
#: size (a deepseek-v3 expert stack is 3.76 G elements: 15 GB a temporary,
#: where the JAX package's jitted step fuses them away)
PIECE = 1 << 26


def _sq_sum(x) -> torch.Tensor:
    """sum(x ** 2) in f32; a large plain leaf a piece at a time."""
    if type(x).__name__ == "DTensor" or x.numel() <= PIECE:
        return x.float().square().sum()
    total = None
    for c in x.reshape(-1).split(PIECE):
        part = c.float().square().sum()
        total = part if total is None else total + part
    return total


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [_sq_sum(x) for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """The grads scaled to a global norm of at most ``max_norm``, in place
    (the caller's grads are the step's own), and their norm."""
    norm = global_norm(grads)
    # a true division, as the JAX package's (python / tensor would be a
    # reciprocal and a product)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads), norm


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

def _zeros_dropping(p, dim: int, dt):
    """Zeros shaped as ``p`` without its dim ``dim``, laid out as ``p``:
    a plain tensor off a mesh; on a mesh a DTensor on ``p``'s mesh whose
    placements follow ``p``'s, a shard of the dropped dim replicated."""
    shape = p.shape[:dim] + p.shape[dim + 1:]
    if type(p).__name__ != "DTensor":
        return torch.zeros(shape, dtype=dt, device=p.device)
    from torch.distributed.tensor import Replicate, Shard, zeros

    def follow(pl):
        if not pl.is_shard() or pl.dim == dim:
            return Replicate()
        return Shard(pl.dim - (pl.dim > dim))

    return zeros(shape, dtype=dt, device_mesh=p.device_mesh,
                 placements=[follow(pl) for pl in p.placements])


def adafactor_init(params, cfg: OptConfig):
    """Factored second moments (``vr`` drops a matrix's last dim, ``vc``
    its second to last), a full ``v`` for vectors; each laid out as its
    parameter (DTensors on a mesh)."""
    dt = torch_dtype(cfg.opt_dtype)

    def one(p):
        if p.ndim >= 2:
            return {"vr": _zeros_dropping(p, p.ndim - 1, dt),
                    "vc": _zeros_dropping(p, p.ndim - 2, dt)}
        return {"v": torch.zeros_like(p, dtype=dt)}

    return {"f": tree_map(one, params), "step": _step0(params)}


def _mean(x, dim=None):
    """The mean over ``dim`` (every dim if None) as a sum over the count:
    on a DTensor sharded there, a partial sum that reduces to the global
    mean whatever the shards' sizes."""
    if dim is None:
        return x.sum() / x.numel()
    return x.sum(dim) / x.shape[dim]


def _scaled(g, vr, vc):
    """The factored update before its RMS clip: g / sqrt(vr vc / mean(vr))."""
    denom = (vr[..., :, None] * vc[..., None, :]
             / torch.clamp(_mean(vr, -1)[..., None, None], min=1e-30))
    return g.float() / torch.sqrt(denom + 1e-30)


def _apply(p, delta, lr, wd: float) -> None:
    if wd:
        delta = delta + wd * p.float()
    p.copy_(p.float() - lr * delta)


def _factored_update(p, g, s, decay, lr, wd: float) -> None:
    """One matrix (or stack of matrices) leaf.  A large plain leaf runs in
    pieces of whole matrices: the moments of each, then the RMS over the
    whole leaf, then each piece's update."""
    m, n = p.shape[-2:]
    k = max(1, PIECE // (m * n))
    if type(p).__name__ == "DTensor" or p.numel() <= k * m * n:
        parts = [(p, g, s["vr"], s["vc"])]
    else:
        parts = list(zip(*(t.split(k) for t in (
            p.view(-1, m, n), g.reshape(-1, m, n), s["vr"].view(-1, m),
            s["vc"].view(-1, n)))))
    moments, deltas, sq = [], [], None
    for _, gg, vr_s, vc_s in parts:
        g2 = torch.square(gg.float()) + 1e-30
        vr = decay * vr_s.float() + (1 - decay) * _mean(g2, -1)
        vc = decay * vc_s.float() + (1 - decay) * _mean(g2, -2)
        del g2
        delta = _scaled(gg, vr, vc)
        part = torch.square(delta).sum()
        sq = part if sq is None else sq + part
        moments.append((vr, vc))
        # one piece keeps its delta; pieces recompute theirs below
        deltas.append(delta if len(parts) == 1 else None)
    # update clipping (RMS <= 1) as in the original
    rms = torch.sqrt(sq / p.numel() + 1e-30)
    for (pp, gg, vr_s, vc_s), (vr, vc), delta in zip(parts, moments, deltas):
        vr_s.copy_(vr)
        vc_s.copy_(vc)
        if delta is None:
            delta = _scaled(gg, vr, vc)
        _apply(pp, delta / torch.clamp(rms, min=1.0), lr, wd)


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    decay = 1.0 - step.float() ** -0.8

    for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                       _state_leaves(state["f"])):
        wd = cfg.weight_decay if p.ndim >= 1 else 0.0
        if p.ndim >= 2:
            _factored_update(p, g, s, decay, lr, wd)
            continue
        g32 = g.float()
        v = decay * s["v"].float() + (1 - decay) * (torch.square(g32)
                                                    + 1e-30)
        delta = g32 / torch.sqrt(v + 1e-30)
        s["v"].copy_(v)
        rms = torch.sqrt(_mean(torch.square(delta)) + 1e-30)
        _apply(p, delta / torch.clamp(rms, min=1.0), lr, wd)
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
