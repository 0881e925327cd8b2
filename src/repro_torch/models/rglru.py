"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of ``repro.models.rglru``.  Block: two parallel input linears
(d -> D); branch 1 -> GeLU gate; branch 2 -> causal depthwise conv1d
(width 4) -> RG-LRU; elementwise product -> output linear (D -> d).

RG-LRU (real-gated linear recurrent unit):
    r_t = sigmoid(BD_a(u_t));  i_t = sigmoid(BD_x(u_t))
    a_t = exp(-c * softplus(lambda) * r_t),   c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Gate projections are block-diagonal with n_heads blocks.  Prefill and
training run the recurrence as a log-depth prefix scan over time in
PyTorch (:func:`_rglru_scan`), with the JAX package's combine; decode is
one step of it.  State = (h: (B, D) f32, conv tail: (B, conv_width-1,
D)).  The JAX package has no kernel for the recurrence
(``lax.associative_scan``), so it runs as PyTorch ops on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import unflatten_last

from .layers import LRU_C, Spec


def init_rglru_block(cfg) -> dict:
    """Parameter specs of one RG-LRU block."""
    d = cfg.d_model
    D = cfg.lru_width or d
    H = cfg.n_heads
    bd = D // H
    return {
        "w_gelu": Spec((d, D), axes=("embed", "ffn")),
        "w_rec": Spec((d, D), axes=("embed", "ffn")),
        "conv_w": Spec((cfg.conv_width, D), scale=0.1, axes=(None, "ffn")),
        "conv_b": Spec((D,), "zeros", axes=("ffn",)),
        "gate_a": Spec((H, bd, bd), axes=("heads", None, None)),
        "gate_a_b": Spec((D,), "zeros", axes=("ffn",)),
        "gate_x": Spec((H, bd, bd), axes=("heads", None, None)),
        "gate_x_b": Spec((D,), "zeros", axes=("ffn",)),
        "lam": Spec((D,), "lru_lambda", axes=("ffn",)),
        "w_out": Spec((D, d), axes=("ffn", "embed")),
    }


def _block_diag(u, w, b, H: int):
    """u: (..., D) through block-diagonal (H, D/H, D/H) + bias, in u's
    type."""
    shp = u.shape
    uh = unflatten_last(u, H, shp[-1] // H)
    out = torch.einsum("...hi,hij->...hj", uh, w.to(u.dtype))
    return out.reshape(shp) + b.to(u.dtype)


def _conv1d_causal(x, w, b, tail=None):
    """x: (B, S, D) depthwise causal conv; tail: (B, cw-1, D) decode state.
    Returns (out, new tail), the taps summed in the JAX package's order."""
    cw = w.shape[0]
    if tail is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, S+cw-1, D)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    new_tail = xp[:, xp.shape[1] - (cw - 1):] if cw > 1 else \
        torch.zeros_like(pad)
    return out + b.to(x.dtype), new_tail


def _prefix_scan(a, b):
    """Inclusive scan over dim 1 of the affine maps h -> a h + b, composed
    left to right: ``(a_l a_r, b_l a_r + b_r)``, the JAX package's
    ``combine``.  Log-depth (Hillis-Steele): after the step with offset
    ``o``, position t holds the composition of t-2o+1..t."""
    S = a.shape[1]
    off = 1
    while off < S:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, off:] = a[:, :-off] * a[:, off:]
        b_new[:, off:] = b[:, :-off] * a[:, off:] + b[:, off:]
        a, b = a_new, b_new
        off *= 2
    return a, b


def _rglru_scan(u, p, cfg, h0):
    """u: (B, S, D); h0: (B, D) -> (y: (B, S, D) in u's type, h_final f32).

    f32 gates, decay and recurrence, cast as the JAX package casts them;
    the initial state enters as a pseudo-step ``h = 1 * 0 + h0``."""
    H = cfg.n_heads
    r = torch.sigmoid(_block_diag(u, p["gate_a"], p["gate_a_b"], H).float())
    i = torch.sigmoid(_block_diag(u, p["gate_x"], p["gate_x_b"], H).float())
    lam = p["lam"].float()
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -LRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * u.float())
    a_ext = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    b_ext = torch.cat([h0.float()[:, None], b], dim=1)
    _, h = _prefix_scan(a_ext, b_ext)
    return h[:, 1:].to(u.dtype), h[:, -1]


def rglru_block(p, x, cfg, *, state=None):
    """x: (B, S, d).  state=None (train) or {"h", "conv"} for decode chains.

    Returns (y, new_state)."""
    # jax.nn.gelu is the tanh approximation by default
    gelu_branch = F.gelu(x @ p["w_gelu"].to(x.dtype), approximate="tanh")
    u = x @ p["w_rec"].to(x.dtype)
    if state is None:
        h0 = torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                         device=x.device)
        conv_tail = None
    else:
        h0, conv_tail = state["h"], state["conv"]
    u, new_tail = _conv1d_causal(u, p["conv_w"], p["conv_b"], conv_tail)
    y, h_final = _rglru_scan(u, p, cfg, h0)
    out = (gelu_branch * y) @ p["w_out"].to(x.dtype)
    return out, {"h": h_final, "conv": new_tail}


def init_rglru_state(cfg, batch: int, dtype=torch.float32, device="cpu",
                     n_layers: int | None = None) -> dict:
    """Zeroed state (``n_layers`` stacks a leading layers axis): h in f32,
    the conv tail in ``dtype``."""
    D = cfg.lru_width or cfg.d_model
    lead = () if n_layers is None else (n_layers,)
    return {
        "h": torch.zeros(lead + (batch, D), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, D),
                            dtype=dtype, device=device),
    }
