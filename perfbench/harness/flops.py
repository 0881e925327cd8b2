"""Frozen FLOP and byte counts and the card's peaks: the yardstick.

Counts follow the model's mathematics from its configuration (a frozen
copy of the arithmetic of the port's ``analysis/flops.py``, over
:class:`perfbench.reference.arch.Arch`), whatever implements it:

* a multiply-add is 2 FLOPs; a causal attention of S positions has
  ``S (S + 1) / 2`` query-key pairs, each ``2 (d_qk + d_v)`` FLOPs a head;
* a train step is 3 forward passes (the forward, and a backward of twice
  its products), with logits at every position; recomputation is not
  counted (model FLOPs, not the hardware's).

Kernel F's bound a call reads Q, K and V once and writes O once, in bf16.
"""
from __future__ import annotations

from perfbench.reference.arch import Arch

#: NVIDIA H100 SXM (data sheet, dense): bf16 tensor FLOP/s, HBM bytes/s
PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def attention_pairs(S: int) -> int:
    return S * (S + 1) // 2


def forward_flops(a: Arch, B: int, S: int, logit_positions: int) -> float:
    """Model FLOPs of a forward over B rows of S positions, with logits at
    ``logit_positions`` positions a row."""
    hd = a.head_dim
    proj = 2 * (a.d * a.heads * hd + 2 * a.d * a.kv_heads * hd + a.heads * hd * a.d)
    per_token = a.layers * (proj + 3 * 2 * a.d * a.ff)
    score = a.layers * a.heads * attention_pairs(S) * 2 * (hd + hd)
    head = 2 * a.d * a.vocab * logit_positions
    return B * (S * per_token + score + head)


def train_step_flops(a: Arch, B: int, S: int) -> float:
    return 3 * forward_flops(a, B, S, S)


def attention_call_bound_s(a: Arch, B: int, S: int, peak: dict) -> float:
    """The least time one causal attention call of a layer can take: the
    larger of its bytes at HBM bandwidth and its operations at the bf16
    peak."""
    H, Hkv, hd = a.heads, a.kv_heads, a.head_dim
    elems = B * S * hd * (2 * H + 2 * Hkv)
    ops = B * H * attention_pairs(S) * 2 * (hd + hd)
    return max(2 * elems / peak["hbm_bytes"], ops / peak["bf16_flops"])
