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

The backward (:func:`flash_attention_backward`) is a kernel of its own
at the pairs in :data:`BACKWARD_PAIRS`, bf16 on a card alone: from the
forward's row log-sum-exp, which the training instance of
``flash_kernel_wgmma`` stores when asked (``with_lse=True``), it runs
``flash_bwd_delta`` (delta = rowsum(dO o)), ``flash_bwd_dq_wgmma`` and
``flash_bwd_dkdv_wgmma`` (:func:`backward_on_kernel` is the route; its
plain version is
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref_bf16p`).  Every
other call's backward is the plain recompute under autograd in
:class:`repro_torch.models.attention.FlashAttention`, counted in
:data:`plain_backwards`.  The TPU kernel has no backward: the JAX
package differentiates its jnp attention.

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

#: launches of the CUDA kernel's forward in this process (the main-path
#: proof)
launches = 0
#: the same launches by the source's kernel: f32 on the CUDA cores, bf16
#: by mma.sync (d 16 and 32) or by wgmma (d 64 and up); and the backward's
#: three kernels, once each a backward on the kernel
route_launches = {"flash_kernel": 0, "flash_kernel_mma": 0,
                  "flash_kernel_wgmma": 0, "flash_bwd_delta": 0,
                  "flash_bwd_dq_wgmma": 0, "flash_bwd_dkdv_wgmma": 0}
#: backwards of F that took the plain recompute under autograd
#: (``FlashAttention.backward``) in this process
plain_backwards = 0

#: (qk head dim, v head dim) pairs the kernel is built for, on both dtypes
PAIRS = tuple(ref.FLASH_TILES)
#: pairs whose backward is a kernel (bf16 on a card): qwen3's, llama4's
#: and internvl2's head dims
BACKWARD_PAIRS = ((128, 128),)
_LSE_ROWS = 64                  # the lse rows of a (b, h) pad to this
#: qk head dims the kernel is built for
HEAD_DIMS = tuple(sorted({d for d, _ in PAIRS}))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535             # gridDim.y (heads) and gridDim.z (batch)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    return cuda_build.load("flash_attention", {
        "ciao_flash_attention": (
            [_I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
            + [_L] * 12 + [ctypes.c_float, _I, _I, _P, _I, _P], _I),
        "ciao_flash_smem_bytes": ([_I, _I, _I], _I),
        "ciao_flash_attention_bwd": (
            [_I, _I, _I] + [_P] * 11 + [_I] * 5 + [_L] * 24
            + [_I, ctypes.c_float, _I, _I, _P], _I),
        "ciao_flash_bwd_smem_bytes": ([_I, _I], _I),
    })


def backward_on_kernel(device: torch.device, dtype: torch.dtype, d: int,
                       dv: int) -> bool:
    """Whether F's backward at qk head dim ``d`` and v head dim ``dv`` runs
    the backward kernel: a bf16 call on a card at a pair of
    :data:`BACKWARD_PAIRS`.  Every other call (f32, the CPU, ``meta``,
    MLA's (192, 128), d 256, ...) takes the plain recompute."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and (d, dv) in BACKWARD_PAIRS)


def count_plain_backward() -> None:
    """One more backward of F on the plain recompute."""
    global plain_backwards
    with cuda_build.counter_lock:
        plain_backwards += 1


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
                    causal: bool = True, window: int = 0,
                    with_lse: bool = False):
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

    ``with_lse`` (training, where :func:`backward_on_kernel` holds, else
    ``ValueError``) returns ``(out, lse)``: also each row's log-sum-exp of
    the scaled scores, ``ln sum_k exp(q.k scale)`` over its valid keys,
    f32 ``(B, H, Sq)`` (a view of rows padded to a multiple of 64, which
    :func:`flash_attention_backward` reads), from the training instance.
    """
    _check(q, k, v)
    if with_lse and not backward_on_kernel(q.device, q.dtype, q.shape[3],
                                           v.shape[3]):
        raise ValueError(f"with_lse: F's backward kernel takes bf16 on a "
                         f"card at {BACKWARD_PAIRS}, not {q.dtype} on "
                         f"{q.device} at {(q.shape[3], v.shape[3])}")
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
    ld = -(-Sq // _LSE_ROWS) * _LSE_ROWS
    lse = (torch.empty((B, H, ld), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse[..., :Sq]) if with_lse else out
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
        None if lse is None else lse.data_ptr(), ld,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "flash_attention")
    with cuda_build.counter_lock:
        launches += 1
        route_launches[kernel] += 1
    return (out, lse[..., :Sq]) if with_lse else out


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0):
    """``(dq, dk, dv)`` of :func:`flash_attention` by the backward kernel,
    in the ``(B, heads, S, d)`` layout of q, k and v (each laid out in
    memory as its input), bf16.

    ``out`` is the forward's output and ``lse`` its log-sum-exp rows
    (``flash_attention(..., with_lse=True)``), ``dout`` the gradient of
    ``out``; the mask is the forward's.  Only where
    :func:`backward_on_kernel` holds (else ``ValueError``).
    """
    _check(q, k, v)
    B, H, Sq, d = q.shape
    Hkv, Sk, dv_ = k.shape[1], k.shape[2], v.shape[3]
    if not backward_on_kernel(q.device, q.dtype, d, dv_):
        raise ValueError(f"F's backward kernel takes bf16 on a card at "
                         f"{BACKWARD_PAIRS}, not {q.dtype} on {q.device} "
                         f"at {(d, dv_)}")
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window}: a band is causal with window "
                         f">= 1 (0 is no band)")
    if out.shape != (B, H, Sq, dv_) or dout.shape != out.shape:
        raise ValueError(f"out {list(out.shape)} and dout "
                         f"{list(dout.shape)} must be {[B, H, Sq, dv_]}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype}")
    ld = -(-Sq // _LSE_ROWS) * _LSE_ROWS
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or lse.stride() != (H * ld, ld, 1)):
        raise ValueError(f"lse must be the forward's f32 (B, H, Sq) rows "
                         f"padded to {ld}, got {lse.dtype} "
                         f"{list(lse.shape)} strides {list(lse.stride())}")
    if any(t.device != q.device for t in (out, dout, lse)):
        raise ValueError("q, k, v, out, dout and lse must be on one device")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    if any(t.stride(3) != 1 for t in (q, k, v, out)):
        raise ValueError("the head dim of q, k, v and out must be "
                         "contiguous")
    dq, dk, dv = (_empty_like_q(t, t.shape[3]) for t in (q, k, v))
    if q.numel() == 0:          # no query: no key gets a gradient
        return dq, dk.zero_(), dv.zero_()
    _check_rows_aligned(q=q, k=k, v=v, out=out, dout=dout, dq=dq, dk=dk,
                        dv=dv)
    dev = q.device
    lib = _lib()
    delta = torch.empty((B, H, ld), dtype=torch.float32, device=dev)
    work = torch.zeros(2, dtype=torch.int32, device=dev)
    err = lib.ciao_flash_attention_bwd(
        dev.index, d, dv_, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
        B, H, Hkv, Sq, Sk,
        *(st for t in (q, k, v, out, dout, dq, dk, dv)
          for st in t.stride()[:3]),
        ld, d ** -0.5, int(bool(causal)), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "flash_attention_bwd")
    with cuda_build.counter_lock:
        for name in ("flash_bwd_delta", "flash_bwd_dq_wgmma",
                     "flash_bwd_dkdv_wgmma"):
            route_launches[name] += 1
    return dq, dk, dv


def _kernel_name(dtype: torch.dtype, d: int) -> str:
    """The source's kernel that computes ``dtype`` at qk head dim ``d``."""
    if dtype == torch.float32:
        return "flash_kernel"
    return "flash_kernel_mma" if d <= 32 else "flash_kernel_wgmma"


def smem_bytes(dtype: torch.dtype, d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the ``(d, dv)`` instance on
    ``dtype``'s route, from the built library (needs ``nvcc``)."""
    return _lib().ciao_flash_smem_bytes(_DTYPES[dtype], d, dv)


def backward_smem_bytes(d: int) -> dict:
    """Dynamic shared memory of one block of the backward's dq and dk/dv
    kernels at ``(d, d)``, from the built library (needs ``nvcc``)."""
    lib = _lib()
    return {"flash_bwd_dq_wgmma": lib.ciao_flash_bwd_smem_bytes(d, 0),
            "flash_bwd_dkdv_wgmma": lib.ciao_flash_bwd_smem_bytes(d, 1)}
