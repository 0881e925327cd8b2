"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared experts.

The port of ``repro.models.moe``.  Dispatch is scatter-based (a
Switch-style position-in-expert cumsum), not the GShard one-hot einsum:
the (tokens x E x C) dispatch tensor would be hundreds of MB at
deepseek-v3 scale, while the scatter form is O(tokens * k) index
arithmetic and two gathers.  Expert weights are stacked ``(E, d, ff)``.

The router runs in f32 from the stored router (never the compute-dtype
copy: ``transformer.compute_params`` keeps it as stored); the aux
load-balance loss follows Switch (mean fraction x mean probability per
expert, scaled by E).  :func:`route` holds the routing arithmetic (ids,
gates, positions in expert, capacity, slots) apart from the data
movement, so tests can compare its integers with the JAX package's.

Tokens an expert cannot take (position >= capacity C) are dropped, as in
the reference: their slot is the overflow row ``E * C``, which is never
read back.  The expert FFN is three batched matrix products over the
stacked weights; the JAX package computes them in jnp, outside any Pallas
kernel, so no TPU kernel is ported here.  The expert-parallel form
(``apply_moe_sharded``) comes with the model mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .layers import Spec, silu

#: where the expert-parallel MoE is planned
_ROADMAP_MESH = "ROADMAP.md Queue 1, item 14 (model mesh)"


def init_moe(cfg) -> dict:
    """Parameter specs of one MoE FFN; the shared expert only where
    ``n_shared_experts`` is set."""
    m = cfg.moe
    d, E, ff = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {
        "router": Spec((d, E), scale=0.02),
        "wi": Spec((E, d, ff)),
        "wg": Spec((E, d, ff)),
        "wo": Spec((E, ff, d)),
    }
    if m.n_shared_experts:
        sff = m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
        p["shared_wi"] = Spec((d, sff))
        p["shared_wg"] = Spec((d, sff))
        p["shared_wo"] = Spec((sff, d))
    return p


def moe_sharding_available(cfg) -> bool:
    """Whether the expert-parallel path applies: never off a mesh, and
    the port has no mesh yet."""
    return False


def apply_moe_sharded(p, x, cfg):
    raise NotImplementedError(
        "the expert-parallel MoE (tokens replicated over the model axis, "
        f"experts sharded over it) comes with {_ROADMAP_MESH}")


def capacity(T: int, moe) -> int:
    """Slots per expert for ``T`` tokens: the reference's expression, with
    Python's ``round`` (half to even)."""
    return int(max(1, round(T * moe.top_k / moe.n_experts
                            * moe.capacity_factor)))


class Routing(NamedTuple):
    """Where each of ``T * k`` assignments (token-major) goes."""
    probs: torch.Tensor     # (T, E) f32 softmax of the router logits
    ids: torch.Tensor       # (T, k) int64 experts, best first
    gates: torch.Tensor     # (T, k) f32, renormalised over k
    pos: torch.Tensor       # (T * k,) int32 position in its expert
    keep: torch.Tensor      # (T * k,) bool: pos < C
    slot: torch.Tensor      # (T * k,) int64 row of the dispatch buffer
    C: int                  # capacity per expert


def route(logits: torch.Tensor, moe) -> Routing:
    """Top-k routing of f32 logits ``(T, E)``, line for line the
    reference's: softmax, top-k (sorted, descending), gates renormalised
    with a 1e-9 floor, token-major position in expert by a one-hot
    cumsum, ``keep = pos < C``, dropped assignments to row ``E * C``."""
    T, E = logits.shape
    k = moe.top_k
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    C = capacity(T, moe)
    flat_ids = ids.reshape(-1)
    # the one-hot laid out (E, T * k), so the cumsum runs along the inner
    # dim: PyTorch's CUDA scan over an outer dim took 12 ms of
    # deepseek-v3's 4,096-token prefill (T * k 32,768, E 256), the inner
    # one does the same sums
    onehot = torch.nn.functional.one_hot(flat_ids, E).T.to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        0, flat_ids[None])[0] - 1
    keep = pos < C
    slot = torch.where(keep, flat_ids * C + pos, E * C)
    return Routing(probs, ids, gates, pos, keep, slot, C)


def aux_loss(r: Routing, moe) -> torch.Tensor:
    """Switch load-balance loss: E * sum(fraction routed * mean prob)."""
    T, E = r.probs.shape
    k = r.ids.shape[1]
    frac = torch.zeros(E, dtype=torch.float32, device=r.probs.device
                       ).index_add(0, r.ids.reshape(-1),
                                   torch.ones(T * k, device=r.probs.device)
                                   ) / (T * k)
    return E * torch.sum(frac * r.probs.mean(dim=0)) * moe.router_aux_weight


def apply_moe(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d) in x's type, aux f32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)

    logits = xf.float() @ p["router"].float()                     # (T, E)
    r = route(logits, m)
    aux = aux_loss(r, m)
    C = r.C

    # dispatch: each kept assignment to its own row of (E*C + 1, d)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device).index_add(
        0, r.slot, xf[tok_idx] * r.keep[:, None].to(dt))
    expert_in = buf[: E * C].view(E, C, d)

    # expert FFN over the stacked weights
    h = torch.bmm(expert_in, p["wi"].to(dt))
    g = torch.bmm(expert_in, p["wg"].to(dt))
    expert_out = torch.bmm(h * silu(g), p["wo"].to(dt))

    # combine: gather back per assignment, weight, sum over k
    flat_out = torch.cat([expert_out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=dt, device=x.device)])
    gathered = flat_out[r.slot].view(T, k, d)
    w = (r.gates * r.keep.view(T, k)).to(dt)
    out = torch.einsum("tkd,tk->td", gathered, w)

    if m.n_shared_experts:
        hs = xf @ p["shared_wi"].to(dt)
        gs = xf @ p["shared_wg"].to(dt)
        out = out + (hs * silu(gs)) @ p["shared_wo"].to(dt)
    return out.reshape(B, S, d), aux
