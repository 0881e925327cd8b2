"""RWKV6 "Finch" block: data-dependent decay time-mix + channel-mix.

The port of ``repro.models.rwkv6``.  Time-mix (per head, state S in
R^{hd x hd}):
    y_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with data-dependent per-channel decay  w_t = exp(-exp(dd(x_t)))  and
data-dependent token-shift interpolation (the Finch ddlerp, low-rank).

The recurrence runs in f32 as a loop over time steps, which the JAX
package's ``lax.scan`` also is; decode is one step.  The JAX package has
no kernel for it, so it runs as PyTorch ops on every device.  State =
(S: (B, H, hd, hd) f32, the last token's x for both mixes, f32).
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import unflatten_last

from .layers import Spec, groupnorm_heads, shape_only_active, silu

_TM_RANK = 32
_TD_RANK = 64


def init_rwkv_time_mix(cfg) -> dict:
    """Parameter specs of one time-mix."""
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    H = d // hd
    return {
        "maa_x": Spec((d,), "zeros", axes=("embed",)),
        "maa_wkvrg": Spec((5, d), "zeros", axes=(None, "embed")),
        "maa_w1": Spec((d, 5 * _TM_RANK), scale=0.01, axes=("embed", None)),
        "maa_w2": Spec((5, _TM_RANK, d), scale=0.01,
                       axes=(None, None, "embed")),
        "decay": Spec((d,), "zeros", axes=("embed",)),
        "decay_w1": Spec((d, _TD_RANK), scale=0.01, axes=("embed", None)),
        "decay_w2": Spec((_TD_RANK, d), scale=0.01, axes=(None, "embed")),
        "bonus": Spec((H, hd), scale=0.1, axes=("heads", "head_dim")),
        "wr": Spec((d, d), axes=("embed", "ffn")),
        "wk": Spec((d, d), axes=("embed", "ffn")),
        "wv": Spec((d, d), axes=("embed", "ffn")),
        "wg": Spec((d, d), axes=("embed", "ffn")),
        "wo": Spec((d, d), axes=("ffn", "embed")),
        "ln_x_scale": Spec((H, hd), "ones", axes=("heads", "head_dim")),
        "ln_x_bias": Spec((H, hd), "zeros", axes=("heads", "head_dim")),
    }


def init_rwkv_channel_mix(cfg) -> dict:
    """Parameter specs of one channel-mix."""
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "maa_k": Spec((d,), "zeros", axes=("embed",)),
        "maa_r": Spec((d,), "zeros", axes=("embed",)),
        "wk": Spec((d, ff), axes=("embed", "ffn")),
        "wv": Spec((ff, d), axes=("ffn", "embed")),
        "wr": Spec((d, d), axes=("embed", "ffn")),
    }


def _shifted(x, last):
    """x_{t-1} along seq; the first step reads ``last`` (decode chaining)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def time_mix(p, x, cfg, state):
    """x: (B, S, d); state {"S": (B,H,hd,hd) f32, "x_tm": (B, d)}.
    Returns (out, {"S", "x_tm"})."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_size
    H = d // hd
    dt = x.dtype

    prev = _shifted(x, state["x_tm"].to(dt))
    sx = prev - x
    xxx = x + sx * p["maa_x"].to(dt)
    dd = unflatten_last(torch.tanh(xxx @ p["maa_w1"].to(dt)), 5, _TM_RANK)
    dd = torch.einsum("bsfr,frd->bsfd", dd, p["maa_w2"].to(dt))
    mix = p["maa_wkvrg"].to(dt) + dd                          # (B,S,5,d)
    xw, xk, xv, xr, xg = (x + sx * mix[:, :, i] for i in range(5))

    logw = -torch.exp(
        p["decay"].float()
        + (torch.tanh(xw @ p["decay_w1"].to(dt))
           @ p["decay_w2"].to(dt)).float())                   # (B,S,d) < 0
    w = torch.exp(logw)                                       # decay in (0,1)

    r = unflatten_last(xr @ p["wr"].to(dt), H, hd).float()
    k = unflatten_last(xk @ p["wk"].to(dt), H, hd).float()
    v = unflatten_last(xv @ p["wv"].to(dt), H, hd).float()
    g = silu(xg @ p["wg"].to(dt))
    y, S_final = _wkv_scan(r, k, v, unflatten_last(w, H, hd),
                           p["bonus"].float(), state["S"].float())
    y = groupnorm_heads(y, p["ln_x_scale"], p["ln_x_bias"]).to(dt)
    out = (y.reshape(B, S, d) * g) @ p["wo"].to(dt)
    return out, {"S": S_final, "x_tm": x[:, -1].float()}


def _wkv_scan(r, k, v, w, u, S0):
    """The time-mix recurrence in f32, one step at a time (the JAX
    package's ``lax.scan`` body): r, k, v, w (B, S, H, hd); u (H, hd);
    S0 (B, H, hd, hd).  Returns (y (B, S, H, hd), S after the last
    step)."""
    if r.device.type == "meta" and shape_only_active():
        return _ScanShape.apply(r, k, v, w, u, S0)
    u = u[None, :, :, None]                                   # (1,H,hd,1)
    Sst, ys = S0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], Sst + u * kv))
        Sst = w[:, t, :, :, None] * Sst + kv
    return torch.stack(ys, dim=1), Sst


class _ScanShape(torch.autograd.Function):
    """:func:`_wkv_scan`'s outputs' shapes on ``meta`` tensors
    (``layers.shape_only``), with gradients of the inputs' shapes."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        ctx.save_for_backward(r, k, v, w, u, S0)
        return torch.empty_like(r), torch.empty_like(S0)

    @staticmethod
    def backward(ctx, gy, gs):
        return tuple(torch.empty_like(t) for t in ctx.saved_tensors)


def channel_mix(p, x, state):
    """x: (B, S, d); state {"x_cm": (B, d)}.  Returns (out, {"x_cm"})."""
    dt = x.dtype
    prev = _shifted(x, state["x_cm"].to(dt))
    sx = prev - x
    xk = x + sx * p["maa_k"].to(dt)
    xr = x + sx * p["maa_r"].to(dt)
    kk = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * (kk @ p["wv"].to(dt))
    return out, {"x_cm": x[:, -1].float()}


def init_rwkv_state(cfg, batch: int, device="cpu",
                    n_layers: int | None = None) -> dict:
    """Zeroed f32 state (``n_layers`` stacks a leading layers axis)."""
    hd = cfg.rwkv_head_size
    H = cfg.d_model // hd
    lead = () if n_layers is None else (n_layers,)
    z = dict(dtype=torch.float32, device=device)
    return {
        "S": torch.zeros(lead + (batch, H, hd, hd), **z),
        "x_tm": torch.zeros(lead + (batch, cfg.d_model), **z),
        "x_cm": torch.zeros(lead + (batch, cfg.d_model), **z),
    }
