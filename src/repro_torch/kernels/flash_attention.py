"""Kernel F: causal, banded (local) or unmasked GQA flash attention.

Wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``,
the port of the TPU kernel ``repro.kernels.flash_attention.
flash_attention_tpu``.  On a CUDA tensor it launches the kernel (or
raises); on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.

v has its own head dim ``dv`` (MLA: q and k at 192, v at 128); the
kernel has an instance for each ``(d, dv)`` in :data:`PAIRS` and the
wrapper refuses any other pair.  bf16 runs on the tensor cores, p
rounded to bf16 for P.V (its plain version, over each instance's key
tile, is :func:`repro_torch.kernels.ref.flash_attention_ref_bf16p`):
``wgmma`` fed by TMA (``flash_kernel_wgmma``) at (64, 64), (128, 128),
(192, 128), (192, 192) and (256, 256), ``mma.sync``
(``flash_kernel_mma``) at d 16 and 32, the widths of the small test
configs.  f32 runs on the CUDA cores in full f32.  The bf16 route
copies rows in 16-byte units (``cp.async``, TMA), so on a card it
refuses (``ValueError``) tensors whose base address or strides are not
multiples of 16 bytes.

The TPU kernel's ``q_block``/``k_block`` are its tiling, and it raises
when S does not divide them.  The port takes any ``Sq`` and ``Sk`` and
masks the ragged tile, so on every shape where the TPU kernel is defined
the two compute the same function.  ``window`` adds the causal band of
the JAX package's ``mask_mode="local"`` (the TPU kernel has none): key
``k`` is valid for query ``q`` iff ``0 <= q - k < window``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref

#: launches of the CUDA kernel in this process (the main-path proof)
launches = 0
#: the same launches by the source's kernel: f32 on the CUDA cores, bf16
#: by mma.sync (d 16 and 32) or by wgmma (d 64 and up)
route_launches = {"flash_kernel": 0, "flash_kernel_mma": 0,
                  "flash_kernel_wgmma": 0}

#: (qk head dim, v head dim) pairs the kernel is built for, on both dtypes
PAIRS = tuple(ref.FLASH_TILES)
#: qk head dims the kernel is built for
HEAD_DIMS = tuple(sorted({d for d, _ in PAIRS}))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535             # gridDim.y (heads) and gridDim.z (batch)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    return cuda_build.load("flash_attention", {
        "ciao_flash_attention": (
            [_I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
            + [_L] * 12 + [ctypes.c_float, _I, _I, _P], _I),
        "ciao_flash_smem_bytes": ([_I, _I, _I], _I),
    })


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, heads, S, d)")
    B, H, _, d = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != d):
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
    if (d, v.shape[3]) not in PAIRS:
        raise ValueError(f"head dims (q/k {d}, v {v.shape[3]}) not among "
                         f"the kernel's {PAIRS}")
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


def _empty_like_q(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An uninitialised ``(B, H, Sq, dv)`` tensor whose dims lie in memory
    in the order of q's (a ``(B, S, H, d)`` view in, one out)."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: -q.stride(i))
    out = q.new_empty([q.shape[i] for i in order] + [dv])
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q (B, H, Sq, d)`` over ``k (B, Hkv, Sk, d)`` and ``v
    (B, Hkv, Sk, dv)``, ``(d, dv)`` one of :data:`PAIRS`.

    Query head ``h`` reads kv head ``h // (H // Hkv)``; the scale is
    ``d ** -0.5``; ``causal`` masks key ``j > i`` for query ``i``
    (positions 0..S-1), and ``window > 0`` also key ``j <= i - window``
    (a band needs ``causal``; 0 is no band).  f32 or bf16, q, k and v
    alike; scores, stats and the accumulator in f32 (on a card, bf16
    rounds p to bf16 for P.V); the result ``(B, H, Sq, dv)`` in q's type,
    laid out in memory as q is (views whose last dim is contiguous are
    read through their strides, without a copy).
    """
    _check(q, k, v)
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window}: a band is causal with window "
                         f">= 1 (0 is no band)")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    global launches
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if H > _GRID_LIMIT or B > _GRID_LIMIT:
        raise ValueError(f"B={B}, H={H}: at most {_GRID_LIMIT} each")
    out = _empty_like_q(q, v.shape[3])
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v, out=out)
    dev = q.device
    lib = _lib()
    kernel = _kernel_name(q.dtype, d)
    # flash_kernel_wgmma's blocks take their work from a zeroed counter
    work = (torch.zeros(1, dtype=torch.int32, device=dev)
            if kernel == "flash_kernel_wgmma" else None)
    err = lib.ciao_flash_attention(
        dev.index, _DTYPES[q.dtype], d, v.shape[3], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, H, Hkv, Sq, Sk,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], d ** -0.5, int(bool(causal)), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "flash_attention")
    with cuda_build.counter_lock:
        launches += 1
        route_launches[kernel] += 1
    return out


def _kernel_name(dtype: torch.dtype, d: int) -> str:
    """The source's kernel that computes ``dtype`` at qk head dim ``d``."""
    if dtype == torch.float32:
        return "flash_kernel"
    return "flash_kernel_mma" if d <= 32 else "flash_kernel_wgmma"


def smem_bytes(dtype: torch.dtype, d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the ``(d, dv)`` instance on
    ``dtype``'s route, from the built library (needs ``nvcc``)."""
    return _lib().ciao_flash_smem_bytes(_DTYPES[dtype], d, dv)
