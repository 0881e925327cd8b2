"""Frozen FLOP and byte counts and the card's peaks: the yardstick.

Counts follow the model's mathematics from its configuration, whatever
implements it.  Each architecture's ``Arch`` (from its reference module's
``arch_from_config``) counts its own forward and its prefill's attention
calls by these rules, as frozen copies of the arithmetic of the port's
``analysis/flops.py``:

* a multiply-add is 2 FLOPs; a causal attention of S positions has
  ``S (S + 1) / 2`` query-key pairs, each ``2 (d_qk + d_v)`` FLOPs a head;
* a train step is 3 forward passes (the forward, and a backward of twice
  its products), with logits at every position; recomputation is not
  counted (model FLOPs, not the hardware's).

Kernel F's bound a call reads Q, K and V once and writes O once, in bf16.
"""
from __future__ import annotations

#: NVIDIA H100 SXM (data sheet, dense): bf16 tensor FLOP/s, HBM bytes/s
PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def attention_pairs(S: int) -> int:
    return S * (S + 1) // 2


def forward_flops(a, B: int, S: int, logit_positions: int) -> int:
    """Model FLOPs of a forward over B rows of S positions, with logits at
    ``logit_positions`` positions a row (``a``: an architecture's ``Arch``)."""
    return a.forward_flops(B, S, logit_positions)


def train_step_flops(a, B: int, S: int) -> int:
    return 3 * a.forward_flops(B, S, S)


def prefill_attention_bound_s(a, B: int, S: int, peak: dict) -> float:
    """The least time the attention calls of a prefill of B rows of S
    positions can take, summed over its calls."""
    return a.prefill_attention_bound_s(B, S, peak)
