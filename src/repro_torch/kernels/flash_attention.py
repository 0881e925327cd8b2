"""Kernel F: causal or unmasked GQA flash attention.

Wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``,
the port of the TPU kernel ``repro.kernels.flash_attention.
flash_attention_tpu``.  On a CUDA tensor it launches the kernel (or
raises); on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The kernel has two routes, chosen by dtype: bf16 runs on the tensor
cores (``mma.sync``, p rounded to bf16 for P.V; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref_bf16p`), f32 on the
CUDA cores in full f32.  The bf16 route copies rows with 16-byte
``cp.async``, so on a card it refuses (``ValueError``) tensors whose
base address or strides are not multiples of 16 bytes.

The TPU kernel's ``q_block``/``k_block`` are its tiling, and it raises
when S does not divide them.  The port takes any ``Sq`` and ``Sk`` and
masks the ragged tile, so on every shape where the TPU kernel is defined
the two compute the same function.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref

#: launches of the CUDA kernel in this process (the main-path proof)
launches = 0

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535             # gridDim.y (heads) and gridDim.z (batch)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    return cuda_build.load("flash_attention", {
        "ciao_flash_attention": (
            [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I]
            + [_L] * 12 + [ctypes.c_float, _I, _P], _I),
    })


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, heads, S, d)")
    B, H, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {list(k.shape)} and v {list(v.shape)} do not "
                         f"fit q {list(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if k.shape[2] == 0:
        raise ValueError("attention over no keys")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _check_rows_aligned(**tensors: torch.Tensor) -> None:
    """Raise unless every row of each tensor starts on a 16-byte boundary:
    its base address and the strides of its leading dims (those longer
    than 1) are multiples of 16 bytes."""
    for name, t in tensors.items():
        es = t.element_size()
        if t.data_ptr() % 16 or any(
                st * es % 16 for n, st in zip(t.shape[:-1], t.stride()[:-1])
                if n > 1):
            raise ValueError(
                f"{name}: the bf16 route copies 16-byte rows, but the base "
                f"address {t.data_ptr():#x} or strides {list(t.stride())} "
                f"({t.dtype}) are not all multiples of 16 bytes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q (B, H, Sq, d)`` over ``k, v (B, Hkv, Sk, d)``.

    Query head ``h`` reads kv head ``h // (H // Hkv)``; the scale is
    ``d ** -0.5``; ``causal`` masks key ``j > i`` for query ``i``
    (positions 0..S-1).  f32 or bf16, q, k and v alike; scores, stats and
    the accumulator in f32 (on a card, bf16 rounds p to bf16 for P.V);
    the result ``(B, H, Sq, d)`` in q's type, laid out in memory as q is
    (views whose last dim is contiguous are read through their strides,
    without a copy).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    global launches
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if H > _GRID_LIMIT or B > _GRID_LIMIT:
        raise ValueError(f"B={B}, H={H}: at most {_GRID_LIMIT} each")
    out = torch.empty_like(q)     # q's strides where q is dense
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v, out=out)
    dev = q.device
    lib = _lib()
    err = lib.ciao_flash_attention(
        dev.index, _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Sk,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], d ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "flash_attention")
    with cuda_build.counter_lock:
        launches += 1
    return out
