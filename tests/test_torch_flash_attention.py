"""Kernel F's wrapper and the port's attention against the JAX package.

On the CPU the wrapper ``repro_torch.kernels.flash_attention.
flash_attention`` runs its plain version; it is held against the TPU
kernel ``flash_attention_tpu`` in interpret mode on the shapes of
``tests/test_kernels.py``, and against the JAX package's jnp
``flash_attention`` on shapes the TPU kernel refuses (S not a multiple of
its block).  The port's plain chunked attention and its decode attention
are held against their JAX counterparts in every mask mode.  Inputs are
N(0, 1) from numpy seeds.  Tolerances: 2e-5 in f32 (the TPU test's bound:
both sides sum in f32 in another order), 0.05 in bf16 (the TPU test's
bound: a few bf16 steps of outputs of about unit size).

The causal band (``window``, the JAX package's ``mask_mode="local"``)
is held against the jnp ``flash_attention`` at windows 1, 7, 64 and
beyond S, on ragged S, and its tile arithmetic (``_key_tiles``,
``_tile_needs_mask``: the source's ``first_key_tile``, ``k_end``, each
consumer's range and bf16 tile-mask expressions in Python), for the
tiles of each bf16 instance (``ref.FLASH_TILES``), against a numpy model
of the mask: every valid (q, k) pair lies in a tile its block and its
consumer visit, and every visited tile that holds an invalid pair for a
warp's rows is masked.

v may be narrower than q and k (MLA: 192 and 128): the wrapper takes v
at its own head dim where the kernel has an instance for the pair, and
its plain version equals the JAX package's jnp attention there.

On a card, bf16 runs the tensor-core routes, which round p to bf16 for
P.V.  Their plain numerics, ``ref.flash_attention_ref_bf16p`` over each
instance's key tile, are held against the TPU kernel (0.05) and against
the f32 plain version within the bound ``chip_smoke.py`` holds the
kernel to (2e-2: the output's rounding, up to 2^-7 at |o| < 4, plus
p's, at most 2^-9 |v| per unit of the other keys' weight).

F's backward kernel (bf16 on a card at (128, 128)) cannot run here: its
plain numerics, ``ref.flash_attention_bwd_ref_bf16p`` from the row
log-sum-exp (``ref.flash_attention_lse_ref``, held against
``torch.logsumexp``), are held against autograd through the f32 plain
version and, in f32, against ``jax.grad`` of the JAX package's
attention; its route, its source's tiles and its dk/dv tile plan (the
source's expressions in Python, against the numpy mask) are checked as
the forward's are.  The CPU keeps the plain recompute.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.kernels.flash_attention import flash_attention_tpu  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 0.05
BF16P_TOL = 2e-2     # the bf16 route against the f32 plain version


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _err(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else
                   jnp.asarray(a, jnp.float32))
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else
                   jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("shape", [
    (2, 4, 2, 128, 64, True, 64),
    (1, 8, 8, 256, 32, True, 128),
    (2, 4, 1, 64, 128, False, 32),
    (1, 2, 2, 96, 16, True, 32),   # non-power-of-two S
    (1, 4, 1, 128, 256, True, 64),  # recurrentgemma's head dim, MQA
])
def test_wrapper_matches_tpu_kernel_f32(shape):
    B, H, Hkv, S, d, causal, qb = shape
    rng = np.random.default_rng(B * S + d)
    q, k, v = (_normal(rng, (B, H, S, d)), _normal(rng, (B, Hkv, S, d)),
               _normal(rng, (B, Hkv, S, d)))
    want = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, q_block=qb, k_block=qb,
                               interpret=True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, d)
    assert _err(got, want) < F32_TOL


def test_wrapper_matches_tpu_kernel_bf16():
    rng = np.random.default_rng(5)
    B, H, S, d = 1, 2, 64, 32
    q, k, v = (_normal(rng, (B, H, S, d)) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_tpu(jq, jk, jv, causal=True, q_block=32,
                               k_block=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < BF16_TOL


@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (37, 90, False),
                                          (70, 70, False)])
def test_wrapper_ragged_s_matches_jnp_flash(sq, sk, causal):
    """Shapes the TPU kernel refuses: S not a multiple of any block."""
    B, H, Hkv, d = 2, 4, 2, 32
    rng = np.random.default_rng(sq * sk)
    q = _normal(rng, (B, H, sq, d))
    k, v = _normal(rng, (B, Hkv, sk, d)), _normal(rng, (B, Hkv, sk, d))
    want = j_attn.flash_attention(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), q_positions=jnp.arange(sq),
        k_positions=jnp.arange(sk), mask_mode="causal" if causal else "none",
        q_chunk=32, k_chunk=32).transpose(0, 2, 1, 3)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert _err(got, want) < F32_TOL


def test_wrapper_reads_strided_views():
    """(B, S, H, d) tensors handed over transposed: same result, and the
    output keeps q's memory layout."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, (2, 48, 4, 16)))
    k = torch.from_numpy(_normal(rng, (2, 48, 2, 16)))
    v = torch.from_numpy(_normal(rng, (2, 48, 2, 16)))
    got = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    want = ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                   k.transpose(1, 2).contiguous(),
                                   v.transpose(1, 2).contiguous())
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("q, k, v, what", [
    ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16), "dtype"),
    ((1, 3, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16), "heads"),
    ((1, 2, 8, 24), (1, 2, 8, 24), (1, 2, 8, 24), "head dim"),
    ((1, 2, 8, 16), (1, 2, 0, 16), (1, 2, 0, 16), "keys"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(q, k, v, what):
    args = [torch.zeros(s) for s in (q, k, v)]
    if what == "dtype":
        args[1] = args[1].to(torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(*args)


@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (37, 90, False),
                                          (130, 130, True), (70, 70, False)])
def test_wrapper_takes_v_at_its_own_head_dim(sq, sk, causal):
    """MLA's pair (q, k at 192, v at 128) on CPU tensors: the wrapper's
    result, (B, H, Sq, 128), equals the JAX package's jnp attention at
    qkd 192 and vd 128 within 1e-5 (f32), and equals bit for bit the
    first 128 columns of the route that zero-padded v to 192."""
    B, H, Hkv = 1, 4, 2
    rng = np.random.default_rng(sq + 3 * sk)
    q = _normal(rng, (B, H, sq, 192))
    k, v = _normal(rng, (B, Hkv, sk, 192)), _normal(rng, (B, Hkv, sk, 128))
    want = j_attn.flash_attention(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        q_positions=jnp.arange(sq), k_positions=jnp.arange(sk),
        mask_mode="causal" if causal else "none", q_chunk=32,
        k_chunk=32).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (B, H, sq, 128)
    assert _err(got, want) < 1e-5
    padded = fa.flash_attention(tq, tk, t_attn.pad_head_dim(tv, 192),
                                causal=causal)
    assert torch.equal(got, padded[..., :128])


def test_wrapper_checks_head_dim_pairs_on_meta():
    """On ``meta`` tensors (the card's route up to the launch): MLA's
    (192, 128) and every equal pair pass the wrapper's checks (the meta
    device itself is then refused, after the output is laid out as q);
    a v wider than q and k, and every pair without an instance, are
    refused."""
    for d, dv in fa.PAIRS:
        q = torch.empty(2, 40, 4, d, device="meta").transpose(1, 2)
        k = torch.empty(2, 40, 2, d, device="meta").transpose(1, 2)
        v = torch.empty(2, 40, 2, dv, device="meta").transpose(1, 2)
        with pytest.raises(ValueError, match="unsupported device meta"):
            fa.flash_attention(q, k, v)
    assert (192, 128) in fa.PAIRS
    for d, dv in ((128, 192), (192, 256), (64, 32), (128, 64), (256, 128),
                  (256, 192), (192, 64)):
        q = torch.empty(1, 4, 40, d, device="meta")
        v = torch.empty(1, 4, 40, dv, device="meta")
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention(q, q, v)
    # the output keeps q's layout at a narrower v: (B, S, H, dv) in memory
    q = torch.empty(2, 40, 4, 192).transpose(1, 2)
    out = fa._empty_like_q(q, 128)
    assert out.shape == (2, 4, 40, 128)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("mode,window,qkd,vd,pad", [
    ("causal", 0, 16, 16, 0),
    ("causal", 0, 16, 16, 5),
    ("local", 8, 16, 16, 0),
    ("local", 12, 16, 16, 3),
    ("none", 0, 16, 16, 0),
    ("none", 0, 16, 16, 7),
    ("causal", 0, 24, 16, 2),      # distinct qk and v head dims (MLA)
])
def test_plain_flash_attention_matches_jax(mode, window, qkd, vd, pad):
    """Every mask mode, ``-1``-padded k positions, several chunks."""
    B, S, H, Hkv = 2, 40, 4, 2
    rng = np.random.default_rng(S + qkd + vd + pad + window)
    q = _normal(rng, (B, S, H, qkd))
    k, v = _normal(rng, (B, S, Hkv, qkd)), _normal(rng, (B, S, Hkv, vd))
    kpos = np.arange(S, dtype=np.int32)
    if pad:
        kpos[-pad:] = -1
    qpos = np.arange(S, dtype=np.int32)
    scale = None if qkd == vd else 0.3
    kw = dict(mask_mode=mode, window=window, q_chunk=16, k_chunk=16,
              scale=scale)
    want = j_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos), **kw)
    got = t_attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos),
        **kw)
    assert _err(got, want) < F32_TOL


@pytest.mark.parametrize("window,n_empty,dtype", [
    (0, 0, "float32"), (0, 6, "float32"), (9, 4, "float32"),
    (0, 3, "bfloat16"),
])
def test_decode_attention_matches_jax(window, n_empty, dtype):
    """decode_attention_gqa + combine_partials against the JAX pair, with
    empty cache slots (position -1) and a local window."""
    B, S, H, Hkv, hd = 3, 24, 8, 2, 16
    rng = np.random.default_rng(window * 31 + n_empty)
    q = _normal(rng, (B, H, hd))
    kc, vc = _normal(rng, (B, S, Hkv, hd)), _normal(rng, (B, S, Hkv, hd))
    pos = np.arange(S, dtype=np.int32)
    if n_empty:
        pos[-n_empty:] = -1
    cur = S - n_empty
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpart = j_attn.decode_attention_gqa(
        jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(pos), window=window, q_position=cur)
    tpart = t_attn.decode_attention_gqa(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kc).to(tdt),
        torch.from_numpy(vc).to(tdt), torch.from_numpy(pos), window=window,
        q_position=cur)
    for a, b in zip(tpart, jpart):
        assert a.dtype == torch.float32
        assert _err(a, b) < 1e-4 * max(1.0, float(np.abs(np.asarray(b)).max()))
    assert _err(t_attn.combine_partials(tpart, None),
                j_attn.combine_partials(jpart, None)) < F32_TOL
    # across a mesh axis only on a mesh (tests/test_torch_dist.py merges
    # over one); with no mesh current it refuses
    with pytest.raises(RuntimeError, match="current mesh"):
        t_attn.combine_partials(tpart, "model")


@pytest.mark.parametrize("shape", [
    (1, 2, 2, 64, 32, True, 32),    # the bf16 test above
    (2, 4, 2, 128, 64, True, 64),
    (1, 4, 1, 128, 128, False, 128),
    (1, 2, 2, 96, 16, True, 32),
])
def test_bf16p_oracle_matches_tpu_kernel_bf16(shape):
    """The bf16 route's numerics against the TPU kernel's (f32 P.V)."""
    B, H, Hkv, S, d, causal, qb = shape
    rng = np.random.default_rng(7 * S + d)
    q, k, v = (_normal(rng, (B, H, S, d)), _normal(rng, (B, Hkv, S, d)),
               _normal(rng, (B, Hkv, S, d)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_tpu(jq, jk, jv, causal=causal, q_block=qb,
                               k_block=qb, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.flash_attention_ref_bf16p(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, d)
    assert _err(got, want) < BF16_TOL


@pytest.mark.parametrize("shape", [
    (1, 2, 1, 256, 192, 128, True, 128),   # MLA's pair
    (1, 2, 2, 192, 192, 128, False, 64),
    (1, 2, 2, 128, 192, 192, True, 64),
    (1, 2, 1, 256, 256, 256, True, 128),   # recurrentgemma's d
    (1, 2, 1, 128, 256, 256, False, 64),
    (1, 2, 1, 256, 128, 128, True, 128),   # qwen3's d, GQA
    (1, 2, 2, 192, 128, 128, False, 64),
    (1, 2, 2, 256, 64, 64, False, 128),    # seamless's d
])
def test_bf16p_oracle_at_the_wgmma_key_tiles_matches_tpu_kernel(shape):
    """The numerics of the wgmma instances (d 64, 128, 192 and 256), over
    their own key tiles (``ref.flash_key_tile``: 64 keys), against the TPU
    kernel in interpret mode within its bf16 bound; the
    TPU kernel takes v at q's head dim, so a narrower v is zero-padded
    for it and its output cut back (the zero columns change nothing
    else)."""
    B, H, Hkv, S, d, dv, causal, qb = shape
    rng = np.random.default_rng(11 * S + d + dv)
    q, k = _normal(rng, (B, H, S, d)), _normal(rng, (B, Hkv, S, d))
    v = _normal(rng, (B, Hkv, S, dv))
    vp = np.concatenate([v, np.zeros((B, Hkv, S, d - dv), np.float32)], -1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, vp))
    want = flash_attention_tpu(jq, jk, jv, causal=causal, q_block=qb,
                               k_block=qb, interpret=True)[..., :dv]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.flash_attention_ref_bf16p(tq, tk, tv, causal=causal)
    assert ref.flash_key_tile(d, dv) == 64
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, dv)
    assert _err(got, want) < BF16_TOL


@pytest.mark.parametrize("shape", [
    (1, 2, 1, 512, 512, 128, True),    # the serving head dim and length
    (2, 4, 2, 128, 128, 64, True),
    (1, 4, 2, 100, 300, 32, False),    # ragged tiles, Sq != Sk
    (2, 2, 2, 300, 100, 16, True),
])
def test_bf16p_oracle_within_bf16_tolerance_of_plain(shape):
    """On the same bf16 inputs, p rounded to bf16 stays within the stated
    bound of the f32 plain version, and does round: the two differ."""
    B, H, Hkv, Sq, Sk, d, causal = shape
    rng = np.random.default_rng(Sq + Sk + d)
    q, k, v = (torch.from_numpy(_normal(rng, (B, h, S, d))).to(torch.bfloat16)
               for h, S in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
    got = ref.flash_attention_ref_bf16p(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert 0 < _err(got, want) < BF16P_TOL


@pytest.mark.parametrize("sk", [1, 40, 64])
def test_bf16p_oracle_rounds_p_before_pv(sk):
    """One 64-key tile, worked by hand: o = sum(bf16(p) v) / sum(p)."""
    rng = np.random.default_rng(sk)
    q, k, v = (_normal(rng, (1, 1, n, 16)) for n in (1, sk, sk))
    s = (q[0, 0] @ k[0, 0].T)[0].astype(np.float32) * np.float32(0.25)
    p = torch.exp(torch.from_numpy(s - s.max()))
    pb = p.to(torch.bfloat16).double().numpy()
    want = (pb @ v[0, 0].astype(np.float64)) / p.sum().item()
    got = ref.flash_attention_ref_bf16p(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    assert got.dtype == torch.float32
    assert float(np.abs(got[0, 0, 0].numpy() - want).max()) < 1e-5


def test_kernel_source_runs_bf16_on_the_tensor_cores():
    """Kernel F's bf16 routes are hand-written PTX in its one source: at
    d 16 and 32, mma.sync (bf16 in, f32 accumulate) fed by ldmatrix from
    a cp.async ring; at (64, 64), (128, 128), (192, 128), (192, 192) and
    (256, 256), wgmma from shared-memory descriptors (P from registers)
    fed by TMA through mbarriers, with setmaxnreg moving registers from
    the producer to the consumers, each an instance in ``pick()`` on
    64-key tiles (the key tile of ``ref.FLASH_TILES``).  No header of its
    own and no library: the includes grow only by cuda.h,
    for the tensor map's type."""
    from repro_torch.kernels import cuda_build
    text = (cuda_build.CSRC / cuda_build.SOURCES["flash_attention"]
            ).read_text()
    pick = text[text.index("Instance pick("):]
    pick = pick[:pick.index("\n}\n")]
    for d, dv in fa.PAIRS:
        if d in (16, 32):
            assert (f"case {d * 1000 + dv}: return {{launch_mma<{d}>,"
                    in pick), d
            continue
        # each wgmma instance's q rows an item are 64 a consumer warpgroup
        m = re.search(rf"case {d * 1000 + dv}:\s*return wg_instance<"
                      rf"{d}, {dv}, {ref.flash_key_tile(d, dv)}, "
                      rf"WgDesign<(\d+),", pick)
        assert m, (d, dv)
        assert ref.FLASH_TILES[(d, dv)].q_rows == 64 * int(m.group(1)), (
            d, dv)
    assert "launch_mma<64>" not in pick and "launch_mma<128>" not in pick
    assert "wgmma_rs<64>" in text and "m64n64k16" in text
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global", "cp.async.commit_group",
                   "cp.async.wait_group", "flash_kernel_mma",
                   "wgmma.mma_async.sync.aligned.m64n", "wgmma.fence",
                   "wgmma.commit_group", "wgmma.wait_group",
                   "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                   "cp.async.bulk.tensor", "setmaxnreg.dec",
                   "setmaxnreg.inc", "__grid_constant__",
                   "cuTensorMapEncodeTiled", "flash_kernel_wgmma",
                   "src/repro/kernels/"):
        assert needle in text, needle
    includes = re.findall(r"#include\s*[<\"]([^>\"]+)", text)
    assert includes == ["cstdint", "cuda.h", "cuda_bf16.h",
                        "cuda_runtime.h"]
    assert not re.search(r"cutlass|cublas|cudnn|wmma", text, re.I)
    assert not list(Path(cuda_build.CSRC).glob("*.cuh"))


@pytest.mark.parametrize("d", sorted(fa.HEAD_DIMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_by_dtype_and_head_dim(dtype, d):
    """The source's kernel each launch goes to: f32 to ``flash_kernel``
    on the CUDA cores at every d; bf16 to ``flash_kernel_mma`` at 16 and
    32 (the small test configs' widths) and to ``flash_kernel_wgmma`` from
    d 64 on (seamless 64; qwen3, llama4, internvl2 128; MLA 192;
    recurrentgemma 256), whose instances take 128 or 192 q rows a work
    item in consumers of 64.  Every route counts its launches apart."""
    name = fa._kernel_name(dtype, d)
    assert name in fa.route_launches
    if dtype == torch.float32:
        assert name == "flash_kernel"
    elif d <= 32:
        assert name == "flash_kernel_mma"
    else:
        assert name == "flash_kernel_wgmma"
    dv = dict(fa.PAIRS).get(d) if d != 192 else 128
    tile = ref.FLASH_TILES[(d, dv)]
    assert (tile.key_tile, tile.consumer_rows) == (64, 64)
    if d <= 32:
        assert tile.q_rows == 64
    else:                   # two or three consumer warpgroups an item
        assert tile.q_rows in (128, 192)


def test_bf16_route_refuses_rows_off_16_byte_boundaries():
    """cp.async copies 16-byte rows: misaligned bases or strides raise;
    (B, S, H, d) views of dense tensors and odd strides of size-1 dims
    pass.  On the CPU the plain version takes any layout."""
    check = fa._check_rows_aligned
    dense = torch.zeros(2, 48, 4, 32, dtype=torch.bfloat16)
    check(q=dense.transpose(1, 2), out=dense)
    flat = torch.zeros(64 * 32 + 8, dtype=torch.bfloat16)
    check(q=flat[8:].view(1, 1, 64, 32))
    with pytest.raises(ValueError, match="16-byte"):
        check(q=flat[1:64 * 32 + 1].view(1, 1, 64, 32))
    wide = torch.zeros(1, 1, 64, 36, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        check(k=wide[..., :32])                  # rows 72 bytes apart
    check(v=torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16)[..., :16])
    q = flat[1:64 * 32 + 1].view(1, 1, 64, 32)
    got = fa.flash_attention(q, q, q)            # the CPU path: no refusal
    assert got.shape == q.shape


# ---------------------------------------------------------------------------
# the causal band (local attention) and d = 256
# ---------------------------------------------------------------------------

def _jnp_local(q, k, v, window, chunk=32):
    """The JAX package's jnp flash attention, mask_mode="local", in F's
    (B, H, S, d) layout."""
    S = q.shape[2]
    return j_attn.flash_attention(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        q_positions=jnp.arange(S), k_positions=jnp.arange(S),
        mask_mode="local", window=window, q_chunk=chunk,
        k_chunk=chunk).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("S,window", [
    (100, 1), (100, 7), (100, 64), (100, 105),    # window 1 .. past S
    (37, 7), (130, 64), (200, 37), (70, 70),
])
def test_band_plain_versions_match_jnp_local(S, window):
    """F's plain versions with a window against the JAX package's local
    attention: f32 within 2e-5; the bf16 route's numerics, on bf16
    inputs, within 0.05 of the JAX package's bf16."""
    B, H, Hkv, d = 1, 4, 2, 32
    rng = np.random.default_rng(S * 7 + window)
    q = _normal(rng, (B, H, S, d))
    k, v = _normal(rng, (B, Hkv, S, d)), _normal(rng, (B, Hkv, S, d))
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             window=window)
    assert _err(got, _jnp_local(q, k, v, window)) < F32_TOL
    bq, bk, bv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = _jnp_local(bq, bk, bv, window)
    got = ref.flash_attention_ref_bf16p(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        window=window)
    assert got.dtype == torch.bfloat16 and _err(got, want) < BF16_TOL


@pytest.mark.parametrize("S", [1, 64, 100])
def test_band_wider_than_s_is_causal(S):
    """A window at or past S masks nothing the causal mask keeps: the same
    arithmetic, the same bits, on both plain versions."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 2, S, 16)))
               for _ in range(3))
    for window in (S, S + 1, 4096):
        assert torch.equal(fa.flash_attention(q, k, v, window=window),
                           fa.flash_attention(q, k, v))
        assert torch.equal(ref.flash_attention_ref_bf16p(q, k, v,
                                                         window=window),
                           ref.flash_attention_ref_bf16p(q, k, v))


#: the distinct tiles of kernel F's bf16 instances
TILES = sorted(set(ref.FLASH_TILES.values()))


def _key_tiles(r0: int, n_rows: int, Sk: int, causal: bool, window: int,
               key_tile: int) -> range:
    """First keys of the K/V tiles that q rows ``[r0, r0 + n_rows)``
    reach: the source's ``first_key_tile`` up to ``k_end`` (a block's
    range; a consumer's, ``lo`` to ``hi``, in flash_kernel_wgmma)."""
    first = max(0, r0 - window + 1) // key_tile * key_tile if window else 0
    end = min(Sk, r0 + n_rows) if causal else Sk
    return range(first, end, key_tile)


def _tile_needs_mask(k0: int, wrow: int, Sk: int, causal: bool,
                     window: int, key_tile: int) -> bool:
    """The bf16 routes' test whether the tile of keys ``[k0, k0 +
    key_tile)`` is masked for the warp of rows ``[wrow, wrow + 16)`` (the
    f32 route masks every tile)."""
    return ((causal and k0 + key_tile - 1 > wrow)
            or (window > 0 and k0 <= wrow + 15 - window)
            or k0 + key_tile > Sk)


def _valid(rows, keys, Sk, causal, window):
    """bool[rows, keys]: the kernel's mask, in numpy."""
    diff = rows[:, None] - keys[None, :]
    ok = keys[None, :] < Sk
    if causal:
        ok = ok & (diff >= 0)
    if window:
        ok = ok & (diff < window)
    return ok


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "q{}-k{}-c{}".format(
    t.q_rows, t.key_tile, t.consumer_rows))
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (Sq, Sq, True, w)
    for Sq in (1, 15, 64, 65, 200, 700, 2560)
    for w in (1, 7, 16, 37, 63, 64, 65, 128, 2048, 5000)
] + [(300, 700, False, 0), (700, 300, True, 0), (130, 130, True, 0)])
def test_band_tile_plan_visits_every_valid_pair_and_masks_the_rest(
        Sq, Sk, causal, window, tile):
    """For each block of q rows (one instance's tiles): the tiles it
    visits cover every valid pair of its rows; each consumer's own range
    (none for a consumer past Sq) lies in the block's and covers every
    valid pair of its rows; and each 16-row warp masks every tile of its
    consumer's range that holds an invalid pair for one of its rows (keys
    past Sk included)."""
    T, BM, C = tile.key_tile, tile.q_rows, tile.consumer_rows
    keys = np.arange(Sk)
    for q0 in range(0, Sq, BM):
        tiles = list(_key_tiles(q0, BM, Sk, causal, window, T))
        assert tiles == sorted(set(tiles)) and all(t % T == 0 for t in tiles)
        for r0 in range(q0, min(q0 + BM, Sq), C):
            mine = list(_key_tiles(r0, C, Sk, causal, window, T))
            assert set(mine) <= set(tiles), (q0, r0, mine, tiles)
            rows = np.arange(r0, min(r0 + C, Sq))
            seen = np.zeros(Sk, bool)
            for k0 in mine:
                seen[k0:k0 + T] = True
            valid = _valid(rows, keys, Sk, causal, window)
            assert not (valid & ~seen[None, :]).any(), (q0, r0, mine)
            for wrow in range(r0, r0 + C, 16):
                wrows = np.arange(wrow, wrow + 16)
                for k0 in mine:
                    tile_keys = np.arange(k0, k0 + T)
                    if not _valid(wrows, tile_keys, Sk, causal,
                                  window).all():
                        assert _tile_needs_mask(k0, wrow, Sk, causal,
                                                window, T), \
                            (q0, wrow, k0)
        if window:      # the band visits about (window + q rows) / T tiles
            assert len(tiles) <= (window + BM + T - 2) // T + 1


def test_wrapper_checks_head_dim_256_and_window_on_meta():
    """On ``meta`` tensors (the card's route up to the launch): d = 256
    and a band pass the wrapper's checks (the meta device itself is then
    refused); a negative window, a band without ``causal`` and a head dim
    past 256 are refused; the model's local attention with window < 1
    raises, with window >= 1 it reaches the wrapper."""
    q = torch.empty(1, 16, 40, 256, device="meta")
    k = torch.empty(1, 1, 40, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fa.flash_attention(q, k, k, window=2048)
    for window, causal in ((-1, True), (8, False)):
        with pytest.raises(ValueError, match="window"):
            fa.flash_attention(q, k, k, causal=causal, window=window)
    wide = torch.empty(1, 1, 40, 320, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide)
    mq = q.transpose(1, 2)
    mk = k.transpose(1, 2)
    pos = torch.arange(40, dtype=torch.int32)
    call = dict(q_positions=pos, k_positions=pos, mask_mode="local")
    for window in (0, -3):
        with pytest.raises(ValueError, match="window"):
            t_attn.flash_attention(mq, mk, mk, window=window, **call)
    with pytest.raises(ValueError, match="unsupported device meta"):
        t_attn.flash_attention(mq, mk, mk, window=32, **call)


@pytest.mark.parametrize("window", [0, 9])
def test_autograd_function_carries_the_band(window):
    """``FlashAttention`` (F with a gradient) on CPU tensors: the forward
    within 2e-5 of the plain version under the same mask (the wrapper's
    plain version chunks by 1,024, this one by 16), and the gradients,
    which recompute it at the call's chunks, equal to autograd through
    it."""
    rng = np.random.default_rng(50 + window)
    B, S, H, Hkv, d = 1, 40, 4, 2, 16
    base = [torch.from_numpy(_normal(rng, (B, S, h, d))) for h in
            (H, Hkv, Hkv)]
    a = [t.clone().requires_grad_() for t in base]
    b = [t.clone().requires_grad_() for t in base]
    out = t_attn.FlashAttention.apply(*a, True, 16, 16, window)
    pos = torch.arange(S)
    want = t_attn.flash_attention_plain(
        *b, q_positions=pos, k_positions=pos,
        mask_mode="local" if window else "causal", window=window,
        q_chunk=16, k_chunk=16)
    assert _err(out.detach(), want.detach()) < F32_TOL
    g = torch.from_numpy(_normal(rng, tuple(out.shape)))
    for x, y in zip(torch.autograd.grad(out, a, g),
                    torch.autograd.grad(want, b, g)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# F's backward: its oracle, the forward's row log-sum-exp, the route, the
# tile plan of flash_bwd_dkdv_wgmma
# ---------------------------------------------------------------------------

#: the backward kernel's numerics (``ref.flash_attention_bwd_ref_bf16p``:
#: P and dS rounded to bf16 as the operands of their products) against
#: autograd through the f32 plain version, of each gradient's max |g|: a
#: bf16 step of P or dS is 2^-8 of it and the sums over keys and queries
#: average the steps down (0.0026 at worst on these shapes; the card's
#: products only reorder the f32 sums)
BWD_BF16P_TOL = 1e-2

#: (B, H, Hkv, Sq, Sk, d, mode, window): G 1, 2 and 8, ragged S, causal,
#: unmasked with Sq != Sk, the band
BWD_CASES = [
    (1, 2, 2, 64, 64, 32, "causal", 0),
    (2, 4, 2, 100, 100, 32, "causal", 0),
    (1, 8, 1, 70, 70, 16, "causal", 0),
    (2, 4, 2, 37, 90, 32, "none", 0),
    (1, 4, 2, 90, 37, 16, "none", 0),
    (1, 4, 2, 80, 80, 32, "local", 9),
    (1, 8, 1, 130, 130, 16, "local", 2),
    (1, 2, 1, 66, 66, 128, "causal", 0),
]


def _bwd_inputs(case, seed: int):
    """q, k, v and the output's gradient in the model's (B, S, heads, d)
    layout, f32 holding bf16 values."""
    B, H, Hkv, Sq, Sk, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_normal(rng, shape)).bfloat16().float()
            for shape in ((B, Sq, H, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d),
                          (B, Sq, H, d))]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _T(t):
    return t.transpose(1, 2)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_bwd_oracle_within_bf16_tolerance_of_plain_autograd(case):
    """The backward kernel's plain version, from the f32 lse and the
    bf16-rounded output and gradient (what the card hands it), within
    ``BWD_BF16P_TOL`` of each leaf's max |g| of autograd through the f32
    plain version, on every mask, G 1 to 8 and ragged S."""
    _, _, _, Sq, Sk, _, mode, window = case
    q, k, v, g = _bwd_inputs(case, 300 + BWD_CASES.index(case))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = t_attn.flash_attention_plain(
        *leaves, q_positions=torch.arange(Sq), k_positions=torch.arange(Sk),
        mask_mode=mode, window=window, q_chunk=32, k_chunk=32)
    want = torch.autograd.grad(out, leaves, g)
    causal = mode != "none"
    lse = ref.flash_attention_lse_ref(_T(q), _T(k), causal=causal,
                                      window=window)
    got = ref.flash_attention_bwd_ref_bf16p(
        _T(q), _T(k), _T(v), _T(out.detach()).bfloat16(), _T(g).bfloat16(),
        lse, causal=causal, window=window, q_rows=48)
    for name, x, y in zip("qkv", got, want):
        assert x.shape == _T(y).shape
        assert _rel(x, _T(y)) < BWD_BF16P_TOL, name


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_bwd_oracle_f32_matches_jax_autodiff(case):
    """The oracle's f32 form (``p_dtype=None``), from the lse oracle and
    the JAX package's output, against ``jax.grad`` of the reference,
    ``repro.models.attention.flash_attention``, within 2e-5 of each
    leaf's max |g| (f32 sums in another order)."""
    _, _, _, Sq, Sk, _, mode, window = case
    q, k, v, g = (t.numpy() for t in _bwd_inputs(case, 400 + BWD_CASES.index(
        case)))
    kw = dict(q_positions=jnp.arange(Sq, dtype=jnp.int32),
              k_positions=jnp.arange(Sk, dtype=jnp.int32), mask_mode=mode,
              window=window, q_chunk=32, k_chunk=32)

    def loss(q_, k_, v_):
        return jnp.sum(j_attn.flash_attention(q_, k_, v_, **kw) * g)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o = torch.from_numpy(np.array(j_attn.flash_attention(jq, jk, jv, **kw)))
    q, k, v, g = (torch.from_numpy(a) for a in (q, k, v, g))
    causal = mode != "none"
    lse = ref.flash_attention_lse_ref(_T(q), _T(k), causal=causal,
                                      window=window)
    got = ref.flash_attention_bwd_ref_bf16p(
        _T(q), _T(k), _T(v), _T(o), _T(g), lse, causal=causal,
        window=window, p_dtype=None, q_rows=32)
    for name, x, y in zip("qkv", got, want):
        y = _T(torch.from_numpy(np.array(y)))
        assert _rel(x, y) < F32_TOL, name


@pytest.mark.parametrize("key_tile", [16, 64])
@pytest.mark.parametrize("Sq,Sk,mode,window", [
    (64, 64, "causal", 0), (100, 100, "causal", 0), (37, 90, "none", 0),
    (90, 37, "none", 0), (80, 80, "local", 9), (70, 70, "local", 1),
    (100, 10, "local", 5),           # rows 14 on see no key
])
def test_lse_oracle_matches_logsumexp_of_plain_scores(Sq, Sk, mode, window,
                                                      key_tile):
    """The row log-sum-exp that F's training instance stores (its oracle,
    the online max and sum over key tiles) equals ``torch.logsumexp`` of
    the masked scaled scores within 2e-5, at any key tile; a row that sees
    no key reads 1e30 (its P is then 0)."""
    B, H, Hkv, d = 2, 4, 2, 32
    rng = np.random.default_rng(Sq + Sk + window + key_tile)
    q = torch.from_numpy(_normal(rng, (B, H, Sq, d)))
    k = torch.from_numpy(_normal(rng, (B, Hkv, Sk, d)))
    causal = mode != "none"
    got = ref.flash_attention_lse_ref(q, k, causal=causal, window=window,
                                      key_tile=key_tile)
    s = q @ k.repeat_interleave(H // Hkv, dim=1).transpose(-1, -2) * d ** -0.5
    valid = torch.from_numpy(np.broadcast_to(_valid(
        np.arange(Sq), np.arange(Sk), Sk, causal, window), (Sq, Sk)).copy())
    want = torch.logsumexp(torch.where(valid, s, -torch.inf), dim=-1)
    seen = valid.any(dim=1)
    assert got.shape == (B, H, Sq) and got.dtype == torch.float32
    assert float((got[..., seen] - want[..., seen]).abs().max()) < F32_TOL
    assert bool((got[..., ~seen] == 1e30).all())
    assert bool(seen.all()) == (window != 5)


@pytest.mark.parametrize("pair", fa.PAIRS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("device", ["cuda", "cpu", "meta"])
def test_backward_route_follows_device_dtype_and_pair(device, dtype, pair):
    """F's backward takes its kernel for bf16 on a card at (128, 128)
    (qwen3, llama4, internvl2) and the plain recompute for every other
    call: the CPU, ``meta``, f32, and every other pair (MLA's (192, 128),
    d 256, seamless's 64, the small configs' 16 and 32).  The route reads
    only what the call can observe."""
    want = (device == "cuda" and dtype == torch.bfloat16
            and pair in fa.BACKWARD_PAIRS)
    assert fa.backward_on_kernel(torch.device(device), dtype, *pair) == want
    assert fa.BACKWARD_PAIRS == ((128, 128),)


@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16),
                                     (128, torch.float32),
                                     (32, torch.bfloat16)])
def test_cpu_backward_takes_the_plain_recompute(d, dtype):
    """On CPU tensors ``FlashAttention``'s backward is the plain recompute
    at every pair and dtype: ``plain_backwards`` counts it, no backward
    kernel counts a launch, and the gradients equal autograd through the
    plain version bit for bit.  The wrapper refuses ``with_lse`` and the
    backward kernel on the CPU."""
    B, S, H, Hkv = 1, 24, 4, 2
    rng = np.random.default_rng(d)
    base = [torch.from_numpy(_normal(rng, (B, S, h, d))).to(dtype)
            for h in (H, Hkv, Hkv)]
    a = [t.clone().requires_grad_() for t in base]
    b = [t.clone().requires_grad_() for t in base]
    bwd = ("flash_bwd_delta", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    launches = [fa.route_launches[n] for n in bwd]
    plain = fa.plain_backwards
    out = t_attn.FlashAttention.apply(*a, True, 16, 16, 0)
    pos = torch.arange(S)
    want = t_attn.flash_attention_plain(*b, q_positions=pos, k_positions=pos,
                                        q_chunk=16, k_chunk=16)
    g = torch.from_numpy(_normal(rng, tuple(out.shape))).to(dtype)
    for x, y in zip(torch.autograd.grad(out, a, g),
                    torch.autograd.grad(want, b, g)):
        assert torch.equal(x, y)
    assert fa.plain_backwards == plain + 1
    assert [fa.route_launches[n] for n in bwd] == launches
    q, k, v = (_T(t.detach()) for t in a)
    with pytest.raises(ValueError, match="with_lse"):
        fa.flash_attention(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="backward kernel"):
        fa.flash_attention_backward(q, k, v, q, q[..., 0].float(), q)


def test_backward_source_matches_the_oracles_tiles():
    """The backward's tiles in its source are ``ref``'s: 64 rows a
    consumer, two consumers a block (so 128 keys a dk/dv item and 128 q
    rows a dq item); the forward stores lse only in its training instance
    (every ``store_lse`` under ``if constexpr (LSE)``, the flag off by
    default), and ``pick`` gives the training instance for (128, 128)
    alone."""
    from repro_torch.kernels import cuda_build
    text = (cuda_build.CSRC / cuda_build.SOURCES["flash_attention"]
            ).read_text()
    rows = int(re.search(r"constexpr int kBwdRows = (\d+);", text).group(1))
    nc = int(re.search(r"constexpr int kBwdNC = (\d+);", text).group(1))
    tile = ref.FLASH_BWD_DKDV_TILE
    assert (tile.key_rows, tile.q_tile, tile.consumer_keys) == (
        rows * nc, rows, rows)
    assert ref.FLASH_BWD_DQ_TILE == ref.FlashTile(rows * nc, rows, rows)
    calls = re.findall(r"(.*)store_lse\(r\);", text)
    assert len(calls) == 2 and all("if constexpr (LSE)" in c for c in calls)
    assert "class W, bool LSE = false>\n__global__" in text
    pick = text[text.index("Instance pick("):]
    lse_branch = pick[:pick.index("if (dtype == 0)")]
    assert lse_branch.count("wg_instance<") == 1
    assert "wg_instance<128, 128, 64, WgDesign<3, 4, 2, true, false>," \
           in lse_branch
    for needle in ("flash_bwd_delta", "flash_bwd_dq_wgmma",
                   "flash_bwd_dkdv_wgmma", "ciao_flash_attention_bwd",
                   "cp.async.bulk.shared::cluster.global"):
        assert needle in text, needle


def _dkdv_q_tiles(k0: int, Sq: int, causal: bool, window: int) -> range:
    """The q tiles flash_bwd_dkdv_wgmma's item of keys ``[k0, k0 +
    key_rows)`` walks for each query head of its group (the source's
    ``qtiles``)."""
    t = ref.FLASH_BWD_DKDV_TILE
    nq = -(-Sq // t.q_tile)
    first = k0 // t.q_tile if causal else 0
    end = (min(nq, (k0 + t.key_rows + window - 2) // t.q_tile + 1)
           if window else nq)
    return range(first, end)


def _dkdv_idle(q0: int, kc0: int, Sk: int, causal: bool, window: int):
    """The source's test that a consumer's keys from ``kc0`` hold no
    valid pair with the q tile from ``q0`` (it skips the tile)."""
    t = ref.FLASH_BWD_DKDV_TILE
    return (kc0 >= Sk or (causal and q0 + t.q_tile - 1 < kc0)
            or (window > 0 and q0 - (kc0 + t.consumer_keys - 1) >= window))


def _dkdv_needs_mask(q0: int, kw: int, Sq: int, Sk: int, causal: bool,
                     window: int) -> bool:
    """The source's test whether the q tile from ``q0`` is masked for the
    warp of keys ``[kw, kw + 16)``."""
    B = ref.FLASH_BWD_DKDV_TILE.q_tile
    return ((causal and q0 < kw + 15)
            or (window > 0 and q0 + B - 1 - kw >= window)
            or q0 + B > Sq or kw + 16 > Sk)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (Sq, Sq, True, w)
    for Sq in (1, 15, 64, 65, 200, 700, 2048)
    for w in (0, 1, 7, 37, 64, 65, 128, 2048, 5000)
] + [(300, 700, False, 0), (700, 300, False, 0), (100, 300, True, 0),
     (300, 100, True, 0), (130, 130, True, 0)])
def test_dkdv_tile_plan_visits_every_valid_pair_and_masks_the_rest(
        Sq, Sk, causal, window):
    """For each item of keys of flash_bwd_dkdv_wgmma: the q tiles it walks
    cover every valid pair of its keys; each consumer skips only tiles
    that hold no valid pair of its keys; and each 16-key warp masks every
    tile it computes that holds an invalid pair for one of its keys (q
    rows past Sq and keys past Sk included)."""
    t = ref.FLASH_BWD_DKDV_TILE
    rows = np.arange(Sq)
    for k0 in range(0, Sk, t.key_rows):
        tiles = list(_dkdv_q_tiles(k0, Sq, causal, window))
        seen = np.zeros(Sq, bool)
        for qt in tiles:
            seen[qt * t.q_tile:(qt + 1) * t.q_tile] = True
        keys = np.arange(k0, min(k0 + t.key_rows, Sk))
        valid = _valid(rows, keys, Sk, causal, window)
        assert not (valid & ~seen[:, None]).any(), (k0, tiles)
        for kc0 in range(k0, k0 + t.key_rows, t.consumer_keys):
            for qt in tiles:
                q0 = qt * t.q_tile
                q_rows = np.arange(q0, min(q0 + t.q_tile, Sq))
                mine = np.arange(kc0, kc0 + t.consumer_keys)
                if _dkdv_idle(q0, kc0, Sk, causal, window):
                    assert not _valid(q_rows, mine, Sk, causal,
                                      window).any(), (kc0, q0)
                    continue
                for kw in range(kc0, kc0 + t.consumer_keys, 16):
                    wkeys = np.arange(kw, kw + 16)
                    tile_rows = np.arange(q0, q0 + t.q_tile)
                    ok = (_valid(tile_rows, wkeys, Sk, causal, window)
                          & (tile_rows < Sq)[:, None])
                    if not ok.all():
                        assert _dkdv_needs_mask(q0, kw, Sq, Sk, causal,
                                                window), (kc0, kw, q0)
