"""How the plain references compute: f32 with TF32 off, or the control's
float8.

``prec="fp8"`` rounds every matrix product's inputs to float8 (e4m3 with
one scale a tensor; gradients e5m2), the benchmark's control.  Every
reference module takes its products from here.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """TF32 off for every f32 product inside (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _round(x, dtype, top: float):
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x.detach() / scale).to(dtype).to(torch.float32) * scale


def fp8(x):
    """``x`` rounded to float8 e4m3 under one scale (its largest value at
    448), with a straight-through gradient."""
    return x + (_round(x, torch.float8_e4m3fn, 448.0) - x).detach()


class _GradFp8(torch.autograd.Function):
    """Identity whose gradient is rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def mm(a, b, prec: str):
    """``a @ b`` in f32, or with both inputs (and in a backward the
    incoming gradient) rounded to float8."""
    if prec == "f32":
        return a @ b
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    out = fp8(a) @ fp8(b)
    return _GradFp8.apply(out) if out.requires_grad else out


def einsum(eq: str, a, b, prec: str):
    if prec == "fp8":
        a, b = fp8(a), fp8(b)
    return torch.einsum(eq, a, b)
