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
kernel, so no TPU kernel is ported here.

On a mesh (DTensor activations):

  * :func:`apply_moe_sharded` is the expert-parallel form (reference
    ``apply_moe_sharded``, under ``local_map``, ``shard_map``'s
    counterpart): tokens batch-sharded over (pod, data) and replicated
    over ``model``, experts sharded over ``model``.  Each rank routes its
    tokens, computes only its ``E / n_model`` experts with a per-device
    capacity, and one SUM over ``model`` combines the outputs.  The
    routing runs in its own ``local_map`` ahead of the experts, so the
    router's gradient is the same on every ``model`` rank and the token
    and gate gradients of the experts are partial sums over ``model``;
    every weight's gradient is a partial sum over the batch axes (each
    rank's tokens' share).  The aux
    loss is the global one (expert counts and probability sums summed
    over the batch axes), as :func:`apply_moe` computes it.
  * :func:`apply_moe` without the expert-parallel path (no ``model`` axis
    over 1, or experts it does not divide) runs on the gathered tokens
    on every rank, so its capacity is the global one, as in the JAX
    package's single program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist import sharding

from .layers import Spec, silu


def init_moe(cfg) -> dict:
    """Parameter specs of one MoE FFN; the shared expert only where
    ``n_shared_experts`` is set."""
    m = cfg.moe
    d, E, ff = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {
        "router": Spec((d, E), scale=0.02, axes=("embed", "expert")),
        "wi": Spec((E, d, ff), axes=("expert", "embed", "ffn")),
        "wg": Spec((E, d, ff), axes=("expert", "embed", "ffn")),
        "wo": Spec((E, ff, d), axes=("expert", "ffn", "embed")),
    }
    if m.n_shared_experts:
        sff = m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
        p["shared_wi"] = Spec((d, sff), axes=("embed", "ffn"))
        p["shared_wg"] = Spec((d, sff), axes=("embed", "ffn"))
        p["shared_wo"] = Spec((sff, d), axes=("ffn", "embed"))
    return p


def moe_sharding_available(cfg) -> bool:
    """Whether the expert-parallel path applies: a current mesh with a
    ``model`` axis over 1 that divides the experts."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return False
    n_model = sharding.mesh_sizes(mesh).get("model", 1)
    return n_model > 1 and cfg.moe.n_experts % n_model == 0


def _on_mesh(x, mesh, pl):
    """``x`` as a DTensor on ``mesh`` laid out as ``pl``; a plain tensor is
    taken as the same global value on every rank."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    if not sharding.is_dtensor(x):
        x = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim,
                              src_data_rank=None)
    return x.redistribute(mesh, pl)


def apply_moe_sharded(p, x, cfg):
    """Expert-parallel MoE on the current mesh (module docstring): x
    (B, S, d) -> (out, aux), both DTensors, out batch-sharded over (pod,
    data) and replicated over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    m = cfg.moe
    mesh = sharding.current_mesh()
    if mesh is None:
        raise RuntimeError("apply_moe_sharded runs on the current mesh "
                           "(dist.sharding.use_mesh) and there is none")
    names = sharding.mesh_axes(mesh)
    sizes = sharding.mesh_sizes(mesh)
    n_model = sizes["model"]
    E, k = m.n_experts, m.top_k
    E_loc = E // n_model
    B, S, d = x.shape
    batch = tuple(a for a in ("pod", "data")
                  if sizes.get(a, 1) > 1 and B % sizes[a] == 0)

    def pl(on_batch, on_model):
        return tuple(on_batch if a in batch else on_model if a == "model"
                     else Replicate() for a in names)

    tok = pl(Shard(0), Replicate())           # tokens, gates, ids
    rep = pl(Replicate(), Replicate())
    tok_partial = pl(Shard(0), Partial())     # grads of expert inputs
    summed = pl(Partial(), Replicate())       # counts, probability sums
    out_pl = pl(Shard(0), Partial())
    expert = pl(Replicate(), Shard(0))
    expert_grad = pl(Partial(), Shard(0))     # each rank's tokens' share
    sff = m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
    shared_ok = bool(m.n_shared_experts) and sff % n_model == 0

    def local_route(xb, router):
        T = xb.shape[0] * xb.shape[1]
        logits = xb.reshape(T, d).float() @ router.float()
        probs = torch.softmax(logits, dim=-1)
        gates, ids = torch.topk(probs, k, dim=-1, sorted=True)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        counts = torch.zeros(E, dtype=torch.float32, device=xb.device
                             ).index_add(0, ids.reshape(-1),
                                         torch.ones(T * k, device=xb.device))
        return (gates.view(*xb.shape[:2], k), ids.view(*xb.shape[:2], k),
                counts, probs.sum(dim=0))

    gates, ids, counts, prob_sum = local_map(
        local_route, out_placements=(tok, tok, summed, summed),
        in_placements=(tok, rep), in_grad_placements=(tok, summed),
        device_mesh=mesh, redistribute_inputs=True)(_on_mesh(x, mesh, tok),
                                  _on_mesh(p["router"], mesh, rep))
    T = B * S
    aux = E * torch.sum(counts / (T * k) * (prob_sum / T)) \
        * m.router_aux_weight

    col = mesh.get_local_rank("model")

    def local_experts(xb, gb, ib, wi, wg, wo, *shared):
        B_l, S_l, _ = xb.shape
        T_l = B_l * S_l
        dt = xb.dtype
        xf = xb.reshape(T_l, d)
        local_ids = ib.reshape(T_l, k) - col * E_loc
        mine = ((local_ids >= 0) & (local_ids < E_loc)).reshape(-1)
        C = int(max(1, round(T_l * k * m.capacity_factor / E)))
        flat = torch.where(mine, local_ids.reshape(-1), E_loc)
        _, keep, slot = _place(flat, E_loc, C, mine)
        out = _expert_ffn(xf, gb.reshape(T_l, k), keep, slot, E_loc, C,
                          wi, wg, wo)
        if shared:
            swi, swg, swo = shared    # ffn dim over model: row-parallel
            out = out + (xf @ swi.to(dt) * silu(xf @ swg.to(dt))) \
                @ swo.to(dt)
        return out.view(B_l, S_l, d)

    args = [_on_mesh(x, mesh, tok), gates, ids]
    args += [_on_mesh(p[n], mesh, expert) for n in ("wi", "wg", "wo")]
    in_pl = [tok, tok, tok, expert, expert, expert]
    grad_pl = [tok_partial, tok_partial, tok] + [expert_grad] * 3
    if shared_ok:
        col_split, row_split = pl(Replicate(), Shard(1)), expert
        args += [_on_mesh(p["shared_wi"], mesh, col_split),
                 _on_mesh(p["shared_wg"], mesh, col_split),
                 _on_mesh(p["shared_wo"], mesh, row_split)]
        in_pl += [col_split, col_split, row_split]
        grad_pl += [pl(Partial(), Shard(1))] * 2 + [expert_grad]
    out = local_map(local_experts, out_placements=(out_pl,),
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                    redistribute_inputs=True)(*args)
    out = out.redistribute(mesh, tok)
    if m.n_shared_experts and not shared_ok:
        xf = x.reshape(-1, d)
        hs = xf @ p["shared_wi"].to(x.dtype)
        gs = xf @ p["shared_wg"].to(x.dtype)
        out = out + ((hs * silu(gs)) @ p["shared_wo"].to(x.dtype)
                     ).reshape(x.shape)
    return out, aux


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


def _place(flat_ids, E: int, C: int, mine=None):
    """(pos, keep, slot) of ``T * k`` token-major assignments to ``E``
    experts of ``C`` slots: position in expert by a one-hot cumsum,
    ``keep = pos < C`` (and ``mine``, where given), dropped assignments to
    the overflow row ``E * C``.  With ``mine``, an id of ``E`` marks an
    assignment to no expert of this rank (a bucket of its own)."""
    n = E if mine is None else E + 1
    # the one-hot laid out (E, T * k), so the cumsum runs along the inner
    # dim: PyTorch's CUDA scan over an outer dim took 12 ms of
    # deepseek-v3's 4,096-token prefill (T * k 32,768, E 256), the inner
    # one does the same sums
    onehot = torch.nn.functional.one_hot(flat_ids, n).T.to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        0, flat_ids[None])[0] - 1
    keep = pos < C if mine is None else (pos < C) & mine
    slot = torch.where(keep, flat_ids * C + pos, E * C)
    return pos, keep, slot


def _expert_ffn(xf, gates, keep, slot, E: int, C: int, wi, wg, wo):
    """Dispatch, expert FFN and combine of tokens ``xf`` (T, d) routed
    to ``slot`` (:func:`_place`) of ``E`` stacked experts: (T, d) in
    xf's type."""
    T, d = xf.shape
    k = gates.shape[1]
    dt = xf.dtype
    # dispatch: each kept assignment to its own row of (E*C + 1, d)
    tok_idx = torch.arange(T, device=xf.device).repeat_interleave(k)
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=xf.device).index_add(
        0, slot, xf[tok_idx] * keep[:, None].to(dt))
    expert_in = buf[: E * C].view(E, C, d)

    # expert FFN over the stacked weights
    h = torch.bmm(expert_in, wi.to(dt))
    g = torch.bmm(expert_in, wg.to(dt))
    expert_out = torch.bmm(h * silu(g), wo.to(dt))

    # combine: gather back per assignment, weight, sum over k
    flat_out = torch.cat([expert_out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=dt, device=xf.device)])
    gathered = flat_out[slot].view(T, k, d)
    w = (gates * keep.view(T, k)).to(dt)
    return torch.einsum("tkd,tk->td", gathered, w)


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
    pos, keep, slot = _place(ids.reshape(-1), E, C)
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
    """x: (B, S, d) -> (out (B, S, d) in x's type, aux f32 scalar).  On
    DTensors: the whole computation on every rank over the gathered
    tokens (module docstring)."""
    if sharding.is_dtensor(x):
        return sharding.replicated_call(lambda pp, xx: apply_moe(pp, xx, cfg),
                                        p, x, like=x)
    m = cfg.moe
    B, S, d = x.shape
    E = m.n_experts
    dt = x.dtype
    xf = x.reshape(B * S, d)

    logits = xf.float() @ p["router"].float()                     # (T, E)
    r = route(logits, m)
    aux = aux_loss(r, m)
    out = _expert_ffn(xf, r.gates, r.keep, r.slot, E, r.C, p["wi"], p["wg"],
                      p["wo"])

    if m.n_shared_experts:
        hs = xf @ p["shared_wi"].to(dt)
        gs = xf @ p["shared_wg"].to(dt)
        out = out + (hs * silu(gs)) @ p["shared_wo"].to(dt)
    return out.reshape(B, S, d), aux
