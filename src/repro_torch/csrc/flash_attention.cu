// Kernel F: causal, banded (local) or unmasked GQA attention with an online
// softmax, over positions 0..S-1, scale d**-0.5 with d the qk head dim; v
// has its own head dim dv (MLA: qk 192, v 128).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _kernel).  Same function; the TPU's grid
// (B, H, nq, nk) carried m, l and the accumulator in VMEM scratch across
// its sequential kv steps.  Here blocks run in parallel and in no order,
// so one block (in flash_kernel_wgmma, one work item of a persistent
// block) owns one q tile of one (b, h) and walks the K/V tiles in a loop,
// keeping the running stats in registers.  Three routes, chosen by dtype
// and (d, dv) in pick():
//
// bf16, (d, dv) = (16, 16), (32, 32): flash_kernel_mma, on the tensor
// cores (FlashAttention-2's shape), for the widths of the small test
// configurations; no served model has them.
//  * 128 threads, 4 warps of 16 q rows, 64-row q tiles.  Q is loaded once;
//    K and V tiles of 64 keys go through a two-stage ring of cp.async
//    16-byte copies (tile t+1 is in flight while tile t is multiplied).
//    Tiles stay bf16 in shared memory, rows padded by 16 bytes so that the
//    eight row addresses of an ldmatrix land on eight distinct bank
//    groups.  Rows past Sq or Sk are zero-filled (src-size 0).
//  * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate); Q's
//    fragments come from ldmatrix once and stay in registers, K's from
//    ldmatrix per tile.  A thread holds parts of rows g and g + 8 of its
//    warp's 16, so a row max is two xor shuffles within a quad; the row
//    sums stay per thread and are reduced the same way once, at the end.
//  * P.V: the f32 scores become p in registers, are packed to bf16x2 and
//    serve directly as the A operand of the next mma (no shared-memory
//    round trip); V's fragments come from ldmatrix.trans.  O accumulates
//    in f32 and is rescaled by alpha per tile.
//  * d 64 and 128 ran on this kernel too until flash_kernel_wgmma took
//    them.  What held them there: mma.sync reaches a part of the
//    tensor-core rate, every warp reads the whole K and V tile from
//    shared memory, every thread spends registers and instructions on
//    cp.async addresses, and blocks that are not persistent load Q and
//    store O exposed.
//
// bf16, (d, dv) = (64, 64), (128, 128), (192, 128), (192, 192),
// (256, 256): flash_kernel_wgmma, designed for Hopper.  It replaces
// flash_kernel_mma at those widths; at d 192 and 256 that kernel used 255
// registers and spilled (8 and 64 bytes), fit one 4-warp block an SM
// (128,000 and 168,960 B of shared memory), read Q again from shared
// memory on every tile at d = 256, and had every warp read the whole K and
// V tile through ldmatrix; MLA's v was zero-padded to 192 by the caller, so
// a third of P.V and of o's bytes were zeros.
//  * Block: persistent, one an SM, a producer warpgroup and NC consumer
//    warpgroups of 64 q rows each (WgDesign).  The producer's one thread
//    takes the work items (a q tile of 64 NC rows of one (b, h)) from a
//    zeroed counter the wrapper passes, and issues every load; setmaxnreg
//    lowers the producer to 24 registers a thread, so that the consumers
//    rise to 240 (two consumers, 384 threads) or 160 (three, 512).  The
//    items go head by head (a head's q tiles at once, so their K/V tiles
//    meet in L2) where no item is more than a tenth of a block's share of
//    the work, else q tile by q tile; both take a head's heaviest q tiles
//    first (head_major_order).
//  * Loads: TMA (cp.async.bulk.tensor.4d) through tensor maps of the
//    (d, S, heads, B) operands, encoded on the host for each call
//    (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so the
//    library links the runtime alone) from the wrapper's strides: the
//    (B, S, H, d) views of the models and MLA's v, a column slice, need no
//    copy.  A box is 64 columns (128 bytes) by the tile's rows, stored with
//    the 128-byte swizzle, so a tile is width / 64 such chunks.  Q has QB
//    buffers (two: the next item's Q loads during this one); K and V a
//    ring of ST stages.  Each has a full mbarrier (completed by the
//    copies' byte count) and an empty one; K and V are freed apart, K once
//    S has landed, V once P.V has.  Rows past Sq or Sk are zero-filled by
//    the TMA unit.
//  * S = Q K^T: wgmma.mma_async m64nBNk16 with Q and K both read from
//    shared memory by descriptor (K-major, 128-byte swizzle), or (QR)
//    with Q's fragments loaded once an item by ldmatrix into registers.
//    P.V: wgmma m64nDVk16 with p packed to bf16 in registers as the A
//    operand (the accumulator's fragment is the A fragment) and V read by
//    descriptor as a transposed (MN-major) B.  Tile t's S is issued with
//    tile t - 1's P.V, which runs on while tile t's softmax is computed;
//    O is rescaled once it is done, and only where a row of the warp
//    moved its max.  The softmax takes the row max of the raw scores and
//    p = 2^(s scale - max) by one fused multiply-add and ex2.approx.ftz.
//  * Output: staged in the consumer's own Q rows with the 128-byte
//    swizzle and written by a TMA store (STAGE_O); at (192, 128) stored
//    from the fragments, Q freed as soon as the last S has landed (MLA's
//    items are short, and the next item's Q then loads during this one's
//    end).
//  * Designs, each timed on the card beside the others (PERF.md):
//    (128, 128): three consumers (192 q rows an item), four stages, two Q
//    buffers, O by a TMA store: 230,576 B of shared memory, 128
//    registers at launch and 160 a consumer, no spill.  (64, 64): the
//    same with Q in registers for S: 115,888 B.  (192, 128): two
//    consumers, two stages, one Q, O from the fragments: 132,184 B;
//    (256, 256) and (192, 192) the same with O by a TMA store, 197,720 and
//    148,568 B; 168 registers at launch, 240 a consumer, no spill.
//    Measured and not kept at d 128 and 64: two consumers (slower at
//    internvl2's shape), two or three stages, one Q buffer, O
//    from the fragments, the two consumers' products in turns, Q in
//    registers at d 128 (with three consumers it spills), and row max and
//    sum by a tree; at d 192 and 256 (earlier): 128-key tiles at
//    (192, 128), whose p rounding took deepseek-v3's bf16 gradient-route
//    check in chip_smoke.py from 0.017 to 0.0206 of a leaf's max |g|,
//    past its 2e-2 bound, a second Q buffer, 80-key tiles at d = 256,
//    turns between the two consumers' products.  Every instance keeps
//    64-key tiles, so ref.flash_attention_ref_bf16p is one function of
//    the inputs at every width.
//  * Bounds on this card (q, k, v and o once over 3.35 TB/s; 4 d
//    operations a (query, key) pair, half of Sq Sk when causal, over the
//    bf16 tensor-core rate, 989 TFLOP/s): qwen3's prefill (B 8, H 16/8,
//    S 512, d 128, causal) the bytes, 50 MB, 0.0150 ms; internvl2's (B 8,
//    H 64/8, S 1,536, d 128, causal) the operations, 309 GFLOP,
//    0.3127 ms; seamless-m4t-medium's at d 64 (B 4, H 16): the encoder
//    (1,024 frames, unmasked) the operations, 0.0174 ms, the decoder (128,
//    causal) the bytes, 0.0013 ms, cross attention (128 over 1,024) the
//    bytes, 0.0056 ms; MLA's prefill (B 8, H 128, S 512, causal) the bytes
//    (q and k at 192, v and o at 128: 671 MB, 0.200 ms); recurrentgemma's
//    band (B 2, H 16, S 2,560, window 2,048, d 256) the operations (4 B H
//    d per valid pair, 0.104 ms).  The design keeps the tensor cores fed
//    from shared memory without register copies, overlaps loads, products
//    and softmax, and hides the start and end of each item behind the
//    next one's loads; what holds it at d 128 is the per-tile work that a
//    64-key tile does not amortise: each consumer's chain of S, softmax
//    and P.V.
//
// f32: flash_kernel, on the CUDA cores, exact to f32 (no TF32).
//  * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns q rows
//    ty + 16 i (i < 4) and, for each 64-key tile, keys tx + 16 j (j < 4):
//    a 4 x 4 register tile of the scores, from Q and K tiles staged in
//    shared memory as f32 (rows padded so neither read conflicts on a
//    bank).  The 16 threads of a row are one half-warp, so the row max
//    and sum are xor shuffles within it.
//  * P.V: the same thread owns output columns tx + 16 c (c < dv / 16) of
//    its four rows, so dv = 128 needs 32 f32 accumulators per thread, not
//    128 in one.  p is broadcast from its owner by a half-warp shuffle;
//    V rows are read from shared memory.
//  * Scores, stats, p and the accumulator are f32, as the reference
//    computes them.
//
// The backward (bf16 at (128, 128)) is its own section below, before the
// C interface: flash_bwd_delta, flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma,
// from the row log-sum-exp that flash_kernel_wgmma's training instance
// (LSE) stores.
//
// Every route:
//  * m, l, alpha and p follow _kernel: the NEG_INF / 2 guards, p = 0 where
//    masked, alpha = 0 while a row has seen no key, and the final divide
//    by max(l, 1e-30).  Keys past Sk and rows past Sq are masked, so any
//    Sq and Sk work; the TPU kernel required S to divide its blocks.  The
//    output is rounded once to the input type.  The bf16 routes round p
//    to bf16 for P.V (l sums the f32 p), which the JAX kernel does not do
//    (its P.V is f32); the plain version of exactly this, over each
//    instance's key tile, is repro_torch.kernels.ref.flash_attention_ref_bf16p.
//  * Causal: a block stops at the K tile past its last row.  On such a
//    tile _kernel leaves m, l and acc unchanged (alpha = 1, p = 0), so
//    the skip is exact.  The heaviest q tiles are launched first.
//  * Band (window > 0, causal): key k is valid for query q iff
//    0 <= q - k < window, the JAX package's mask_mode="local"
//    (src/repro/models/attention.py::flash_attention; the TPU kernel has
//    no window).  A block starts at the key tile that holds key
//    q0 - window + 1 (q0 its first row), skipping the tiles below it
//    exactly as the causal skip above does.  In flash_kernel_wgmma each
//    consumer computes only the tiles its own 64 rows reach (it still
//    takes part in the ring on the others).  The bf16 routes mask a tile
//    for a warp's 16 rows only where it crosses their diagonal, the band's
//    lower edge or Sk; the f32 route masks every tile.
//    tests/test_torch_flash_attention.py holds these expressions, in
//    Python, for each instance's tiles, to a numpy model of the mask:
//    every valid pair is visited and every tile with an invalid pair
//    masked.  window = 0: no band.
//  * Instances, (d, dv): (16, 16), (32, 32), (64, 64), (128, 128),
//    (192, 128), (192, 192), (256, 256), on both dtypes.  d = 192 is MLA's
//    qk head dim (deepseek-v3: nope 128 + rope 64), d = 256
//    recurrentgemma's head dim.
//  * GQA: q head h reads kv head h / G, the (Hkv, G) grouping of the
//    JAX package.  q, k, v and o are read and written through strides
//    (last dim contiguous), so (B, S, H, d) tensors need no copy.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;               // q rows per block (f32, mma.sync)
constexpr int kBN = 64;               // keys per K/V tile (f32, mma.sync)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of a (B, heads, S, d) operand; its last dim is dense.
struct Strides {
  long long b, h, s;
};

// First key of the first BN-key tile that q rows from r0 on visit: 0, or
// with a band the tile that holds key r0 - window + 1.  (For rows [r0, r0 +
// n) the tiles end at min(Sk, r0 + n) when causal, at Sk otherwise.)
template <int BN>
__device__ __forceinline__ int first_key_tile(int r0, int window) {
  return window > 0 ? max(0, r0 - window + 1) / BN * BN : 0;
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr int smem_floats() {
  return kBM * (D + 4) + kBN * (D + 1) + kBN * DV;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int G,
             int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, bool causal, int window) {
  constexpr int QP = D + 4;           // Q row pitch: rows ty, ty+1 apart
  constexpr int KP = D + 1;           // K row pitch: 16 rows on 16 banks
  constexpr int CJ = DV / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBM][QP]
  float* Ks = Qs + kBM * QP;          // [kBN][KP]
  float* Vs = Ks + kBN * KP;          // [kBN][DV]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / G) * ks.h;
  const float* vb = v + b * vs.b + (h / G) * vs.h;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * QP + c] = q0 + r < Sq ? qb[(long long)(q0 + r) * qs.s + c] : 0.f;
  }

  float acc[4][CJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBM) : Sk;
  for (int k0 = first_key_tile<kBN>(q0, window); k0 < k_end; k0 += kBN) {
    __syncthreads();                  // Q stored; last tile's reads done
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Ks[r * KP + c] = k0 + r < Sk ? kb[(long long)(k0 + r) * ks.s + c] : 0.f;
    }
    for (int i = tid; i < kBN * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      Vs[r * DV + c] = k0 + r < Sk ? vb[(long long)(k0 + r) * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * KP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool valid[4];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < Sk && (!causal || qp >= kp) &&
                   (window == 0 || qp - kp < window);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float alpha = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - shift);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - shift) : 0.f;   // now p
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(kFull, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }

    // acc[i][c] += sum_n p[row i][n] * V[n][tx + 16 c]; key n is held by
    // lane n % 16 of the half-warp, as its score column n / 16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int src = 0; src < 16; ++src) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(kFull, s[i][j], src, 16);
        const float* vrow = Vs + (src + 16 * j) * DV + tx;
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const float vv = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + b * os.b + h * os.h + (long long)qp * os.s + tx;
#pragma unroll
    for (int c = 0; c < CJ; ++c) orow[16 * c] = acc[i][c] / denom;
  }
}

template <int D, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void*, int B, int H, int G, int Sq, int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, bool causal, int window, float*, int,
                       cudaStream_t stream) {
  const int smem = smem_floats<D, DV>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), G, Sq, Sk, qs,
      ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync, ldmatrix, cp.async in inline PTX)
// ---------------------------------------------------------------------------

constexpr int kWarpsMma = kBM / 16;          // 16 q rows per warp
constexpr int kThreadsMma = 32 * kWarpsMma;  // 128
constexpr int kStages = 2;                   // K/V ring depth

// Row pitch in bf16 elements: 16 bytes of padding, so 8 consecutive rows
// start on 8 distinct 16-byte bank groups for every d in {16, 32}
// (a pitch of 2d + 16 bytes is an odd number of 16-byte groups)
template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }

template <int D>
constexpr int smem_bytes_mma() {
  return (kBM + 2 * kStages * kBN) * pitch<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> bf16x2, lo in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy rows [r0, r0 + 64) of a (rows, D) bf16 operand (row stride `ld`
// elements) into a padded shared tile; rows >= n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int r0, int n_rows,
                                          int tid) {
  constexpr int kChunks = D / 8;              // 16-byte chunks per row
  static_assert(kBM == kBN && kBN * kChunks % kThreadsMma == 0,
                "Q and K/V tiles share this loader");
#pragma unroll
  for (int it = 0; it < kBN * kChunks / kThreadsMma; ++it) {
    const int i = tid + it * kThreadsMma;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n_rows;
    const __nv_bfloat16* g = in ? src + (long long)(r0 + r) * ld + c * 8 : src;
    cp_async_16(dst + (r * pitch<D>() + c * 8) * 2, g, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int G, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale_log2, bool causal, int window) {
  constexpr int P = pitch<D>();
  constexpr int KS = D / 16;          // k-steps of QK^T
  static_assert(D <= 32, "d 64 and up take flash_kernel_wgmma");
  constexpr int NT = kBN / 8;         // n8 tiles of a score row block
  constexpr int DT = D / 8;           // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t sQ = smem_addr(smem_mma);                 // [kBM][P]
  const uint32_t sK = sQ + kBM * P * 2;                    // [kStages][kBN][P]
  const uint32_t sV = sK + kStages * kBN * P * 2;          // [kStages][kBN][P]
  constexpr uint32_t kTileBytes = kBN * P * 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;            // fragment row (and row + 8)
  const int tig = lane & 3;           // fragment column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / G) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / G) * vs.h;

  const int k_end = causal ? min(Sk, q0 + kBM) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int t0 = first_key_tile<kBN>(q0, window) / kBN;   // 0 without a band

  load_tile<D>(sQ, qb, qs.s, q0, Sq, tid);
  cp_async_commit();
  load_tile<D>(sK, kb, ks.s, t0 * kBN, Sk, tid);
  load_tile<D>(sV, vb, vs.s, t0 * kBN, Sk, tid);
  cp_async_commit();

  // ldmatrix row addresses of this lane.  A (Q): rows lane % 16, column
  // half lane / 16.  B from K (keys x d, non-transposed): key lane % 8 of
  // the 8-key half (lane / 16), column half (lane / 8) % 2.  B from V
  // (keys x d, transposed): key lane % 8 of the half (lane / 8) % 2,
  // column half lane / 16.
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int v_col = (lane >> 4) * 8;

  cp_async_wait<1>();                 // Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks_ = 0; ks_ < KS; ++ks_)
    ldmatrix_x4(qf[ks_], sQ + (a_row * P + ks_ * 16 + a_col) * 2);

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};    // rows g, g + 8 (log2 domain)
  float l[2] = {0.f, 0.f};            // this thread's part of the row sums

  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8

  for (int t = t0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    const uint32_t stage = ((t - t0) & 1) * kTileBytes;
    if (t + 1 < n_tiles) {            // prefetch the next tile
      const uint32_t next = ((t - t0 + 1) & 1) * kTileBytes;
      load_tile<D>(sK + next, kb, ks.s, k0 + kBN, Sk, tid);
      load_tile<D>(sV + next, vb, vs.s, k0 + kBN, Sk, tid);
    }
    cp_async_commit();                // (empty on the last tile)
    cp_async_wait<1>();               // this tile has landed
    __syncthreads();

    // ---- S = Q K^T (raw dot products) ----
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_) {
      const uint32_t (&qa)[4] = qf[ks_];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + stage +
                            ((np * 16 + k_row) * P + ks_ * 16 + k_col) * 2);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // ---- scale to the log2 domain; mask only where a tile needs it: it
    // crosses the diagonal of this warp's 16 rows, the band's lower edge
    // (key row - window, for the warp's last row), or Sk ----
    const int wrow = q0 + warp * 16;
    const bool mask = (causal && k0 + kBN - 1 > wrow) ||
                      (window > 0 && k0 <= wrow + 15 - window) ||
                      k0 + kBN > Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    if (mask) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * tig + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row) ||
              (window > 0 && row - key >= window))
            s[j][e] = kNegInf;
        }
    }

    // ---- online softmax on the fragments ----
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[r] = m[r] <= kNegInf / 2 ? 0.f : exp2f(m[r] - shift);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float x = s[j][e];
          // p = 0 where masked (masked scores were set to NEG_INF)
          s[j][e] = mask && x <= kNegInf / 2 ? 0.f : exp2f(x - shift);
          rsum += s[j][e];
        }
      l[r] = l[r] * alpha[r] + rsum;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // ---- O += P V: p packed to bf16 as the A operand, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + stage +
                                  ((kk * 16 + v_row) * P + dp * 16 + v_col) *
                                      2);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                  // this stage is refilled next round
  }
  cp_async_wait<0>();                 // no copy in flight past the loop

  // ---- out = acc / max(l, 1e-30), rounded once to bf16 ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        o + b * os.b + h * os.h + (long long)row * os.s + 2 * tig;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void*, int B, int H, int G, int Sq, int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, bool causal, int window, float*, int,
                       cudaStream_t stream) {
  constexpr int smem = smem_bytes_mma<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_kernel_mma<D><<<grid, kThreadsMma, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      G, Sq, Sk, qs, ks, vs, os, scale * kLog2e, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route from d 64 on: wgmma, TMA, mbarriers, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;               // q rows per consumer warpgroup
constexpr int kSwCols = 64;               // bf16 columns of a 128-byte row

// A design of flash_kernel_wgmma: NC consumer warpgroups of 64 q rows
// (an item is BM = 64 NC q rows), a ring of ST K/V stages, QB Q buffers,
// O staged in the consumer's Q rows for a TMA store (STAGE_O) or stored
// from the fragments with Q freed after the last S, and (QR) Q's
// fragments held in registers for S (Q freed once loaded, unless O is
// staged there) rather than read from shared memory by every S.  The producer warpgroup
// drops to 24 registers a thread so that the consumers rise to kRegs.
template <int NC_, int ST_, int QB_, bool STAGE_O_, bool QR_>
struct WgDesign {
  static_assert(NC_ >= 2 && NC_ <= 3 && ST_ >= 2 && QB_ >= 1 && QB_ <= 2,
                "two or three consumers, a ring, one or two Qs");
  static constexpr int NC = NC_, ST = ST_, QB = QB_;
  static constexpr bool STAGE_O = STAGE_O_, QR = QR_;
  static constexpr int BM = NC * kWgRows;
  static constexpr int kThreads = (NC + 1) * 128;
  static constexpr int kRegs =
      (65536 - 128 * 24) / (128 * NC) / 8 * 8 > 240
          ? 240
          : (65536 - 128 * 24) / (128 * NC) / 8 * 8;
};

// Byte offsets in the (1,024-aligned) shared memory of a block: the QB Q
// buffers, then the ST K stages, the ST V stages, the barriers (full and
// empty Q, one each a Q buffer; full K and V, empty K and V, one each a
// stage) and each Q buffer's item.
// A tile of `rows` rows is width / 64 chunks of rows x 128 bytes.
template <int D, int DV, int BN, class W>
struct WgLayout {
  static_assert(D % kSwCols == 0 && DV % kSwCols == 0 && BN % 16 == 0,
                "tiles are whole 64-column chunks and 16-key steps");
  static constexpr uint32_t kQ = W::BM * D * 2;
  static constexpr uint32_t kK = BN * D * 2;
  static constexpr uint32_t kV = BN * DV * 2;
  static constexpr uint32_t kBars = W::QB * kQ + W::ST * (kK + kV);
  static constexpr int kSmem = 1024 + kBars + 8 * (3 * W::QB + 4 * W::ST);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at (c0, c1, c2, c3) into shared memory at dst,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// TMA: shared memory at src into the box of `map` at (c0, c1, c2, c3), in
// this thread's bulk group (rows past the tensor's end are not written)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warp are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous product (the asm statements name no register).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of wgmma, 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
// K-major (Q, K): rows 128 bytes apart, 8-row groups 1,024 apart (the
// stride offset), the leading offset unused; a 16-column step within a
// 64-column chunk moves the start by 32 bytes.  MN-major (V as the
// transposed B of P.V): the leading offset is the distance between
// 64-column chunks, the stride offset between groups of 8 keys.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

#define WG_ACC8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32_AT(d, i) \
  WG_ACC8(d, i), WG_ACC8(d, i + 8), WG_ACC8(d, i + 16), WG_ACC8(d, i + 24)
#define WG_ACC32(d) WG_ACC32_AT(d, 0)
#define WG_ACC64(d) WG_ACC32_AT(d, 0), WG_ACC32_AT(d, 32)
#define WG_ACC96(d) WG_ACC64(d), WG_ACC32_AT(d, 64)
#define WG_ACC128(d) WG_ACC64(d), WG_ACC32_AT(d, 64), WG_ACC32_AT(d, 96)

// d[64 x N] (+)= A[64 x 16] . B[16 x N], A and B from shared memory
// (K-major); scale_d = 0 overwrites d.  The accumulator's fragment: d[4 j +
// e] is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2
// of warp w of the warpgroup.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                         int scale_d);
// d[64 x N] += A[64 x 16] . B[16 x N], A from registers (mma.sync's A
// fragment for each warp's 16 rows), B from shared memory, MN-major
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b);

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers, B from
// shared memory, K-major (S = Q K^T with Q's fragments in registers)
__device__ __forceinline__ void wgmma_rs_kmajor64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_ACC96(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One work item: q tile qt (of nq) of head h of batch b.  `head_major`
// numbers the items head by head (a head's q tiles adjacent, so their K/V
// tiles meet in L2), else q tile by q tile; both put a head's heaviest q
// tiles first.
struct WgItem {
  int q0, h, b;
};
__device__ __forceinline__ WgItem wg_item(int item, int nq, int BM, int H,
                                          int B, bool head_major) {
  const int hb = head_major ? item / nq : item % (H * B);
  const int qt = nq - 1 - (head_major ? item % nq : item / (H * B));
  return {qt * BM, hb % H, hb / H};
}

// LSE (the training instance): also store each row's log-sum-exp of the
// scaled scores, ln sum_k exp(s scale), to lse[(b H + h) lse_ld + row] in
// f32 (0 for rows Sq..lse_ld - 1 of a consumer's range, +1e30 for a row
// that sees no key), for the backward (flash_bwd_*).  The serving instance
// (LSE false) compiles without it.
template <int D, int DV, int BN, class W, bool LSE = false>
__global__ void __launch_bounds__(W::kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   __nv_bfloat16* __restrict__ o, Strides os,
                   int* __restrict__ next, int H, int B, int G, int Sq,
                   int Sk, float scale_log2, bool causal, int window,
                   bool head_major, float* __restrict__ lse, int lse_ld) {
  using L = WgLayout<D, DV, BN, W>;
  constexpr int NC = W::NC, ST = W::ST, QB = W::QB, BM = W::BM;
  constexpr bool STAGE_O = W::STAGE_O, QR = W::QR;
  static_assert(!QR || BN == 64, "S from registers on 64-key tiles");
  // Q is freed after the last S (not staging O, read by every S)
  constexpr bool kFreeQAfterS = !STAGE_O && !QR;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const uint32_t sQ = (smem_addr(smem_wg) + 1023) & ~1023u;   // [QB]
  const uint32_t sK = sQ + QB * L::kQ;             // [ST]
  const uint32_t sV = sK + ST * L::kK;             // [ST]
  const uint32_t bar_q = sQ + L::kBars;            // full Q [QB]
  const uint32_t bar_eq = bar_q + 8 * QB;          // empty Q [QB]
  const uint32_t bar_k = bar_eq + 8 * QB;          // full K [ST]
  const uint32_t bar_v = bar_k + 8 * ST;           // full V [ST]
  const uint32_t bar_ek = bar_v + 8 * ST;          // empty K [ST]
  const uint32_t bar_ev = bar_ek + 8 * ST;         // empty V [ST]
  // the item whose Q is in flight or in place in each Q buffer (-1: no
  // more work), 8 bytes apart
  volatile int* item_slot = reinterpret_cast<volatile int*>(
      smem_wg + (bar_ev + 8 * ST - smem_addr(smem_wg)));

  const int nq = (Sq + BM - 1) / BM;
  const int n_items = nq * H * B;
  // the K/V tiles of a block of q rows from q0: [t0, n_tiles)
  auto tiles = [&](int q0, int& t0, int& n_tiles) {
    t0 = first_key_tile<BN>(q0, window) / BN;
    n_tiles = ((causal ? min(Sk, q0 + BM) : Sk) + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(bar_q + 8 * i, 1);
      // one arrival a consumer (STAGE_O) or a consumer warp
      mbar_init(bar_eq + 8 * i, STAGE_O ? NC : 4 * NC);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, 4 * NC);         // one arrival a consumer warp
      mbar_init(bar_ev + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread takes the items and keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0;                   // K/V tiles loaded so far
      for (int j = 0;; ++j) {
        const int qb = j % QB;        // item j's Q buffer
        const int item = atomicAdd(next, 1);
        // the Q buffer's last item (and its output staged there) is done
        mbar_wait(bar_eq + 8 * qb, ((j / QB) & 1) ^ 1);
        if (item >= n_items) {
          item_slot[2 * qb] = -1;
          mbar_arrive(bar_q + 8 * qb);
          break;
        }
        item_slot[2 * qb] = item;
        const WgItem w = wg_item(item, nq, BM, H, B, head_major);
        const int hk = w.h / G;
        mbar_expect_tx(bar_q + 8 * qb, L::kQ);
        for (int c = 0; c < D / kSwCols; ++c)
          tma_load(sQ + qb * L::kQ + c * BM * 128, &tq, bar_q + 8 * qb,
                   c * kSwCols, w.q0, w.h, w.b);
        int t0, n_tiles;
        tiles(w.q0, t0, n_tiles);
        for (int t = t0; t < n_tiles; ++t, ++ring) {
          const int s = ring % ST;
          const uint32_t free = ((ring / ST) & 1) ^ 1;
          mbar_wait(bar_ek + 8 * s, free);
          mbar_expect_tx(bar_k + 8 * s, L::kK);
          for (int c = 0; c < D / kSwCols; ++c)
            tma_load(sK + s * L::kK + c * BN * 128, &tk, bar_k + 8 * s,
                     c * kSwCols, t * BN, hk, w.b);
          mbar_wait(bar_ev + 8 * s, free);
          mbar_expect_tx(bar_v + 8 * s, L::kV);
          for (int c = 0; c < DV / kSwCols; ++c)
            tma_load(sV + s * L::kV + c * BN * 128, &tv, bar_v + 8 * s,
                     c * kSwCols, t * BN, hk, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each of every item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W::kRegs));
    const int cw = (threadIdx.x >> 7) - 1;
    const int ct = threadIdx.x & 127;  // thread of the consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;          // fragment row (and row + 8)
    const int tig = lane & 3;         // fragment column pair
    int ring = 0;                     // K/V tiles consumed so far

    // one arrival of this warp on an empty barrier (its reads are done)
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    for (int j = 0;; ++j) {
      const int qb = j % QB;          // item j's Q buffer
      mbar_wait(bar_q + 8 * qb, (j / QB) & 1);
      const int item = item_slot[2 * qb];
      const uint32_t sQw = sQ + qb * L::kQ + cw * kWgRows * 128;
      const uint32_t bar_eqj = bar_eq + 8 * qb;
      if (item < 0) {
        if (STAGE_O && ct == 0)
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        break;
      }
      const WgItem w = wg_item(item, nq, BM, H, B, head_major);
      int t0, n_tiles;
      tiles(w.q0, t0, n_tiles);
      // QR: this warp's 16 rows of Q as the A fragments of S, from the
      // 128-byte swizzled tile (16-byte group g of row r at (g ^ r % 8))
      uint32_t qf[QR ? D / 16 : 1][4];
      if constexpr (QR) {
        const int r = warp * 16 + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], sQw + (kk / 4) * BM * 128 + r * 128 +
                                  ((((kk % 4) * 2 + (lane >> 4)) ^ (r & 7))
                                   << 4));
        if (!STAGE_O) release(bar_eqj);   // Q is done
      }
      const int r0 = w.q0 + cw * kWgRows;
      const int wrow = r0 + warp * 16;  // this warp's 16 rows
      const int row0 = wrow + g;        // this thread's rows: row0, row0 + 8
      // the tiles this consumer's rows reach (none past Sq): [a, z); it
      // takes part in the ring on the block's others, [t0, a) and [z,
      // n_tiles)
      const int lo = first_key_tile<BN>(r0, window) / BN;
      const int hi =
          r0 >= Sq ? 0
                   : ((causal ? min(Sk, r0 + kWgRows) : Sk) + BN - 1) / BN;
      const int a = min(lo, n_tiles);
      const int z = max(a, hi);
      // ring position, stage and phase of the item's tile t
      const int base = ring - t0;
      auto stage = [&](int t) { return (base + t) % ST; };
      auto phase = [&](int t) {
        return (uint32_t)((base + t) / ST) & 1;
      };

      float acc[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};  // rows row0, row0 + 8 (log2 domain)
      float l[2] = {0.f, 0.f};          // this thread's part of the row sums
      uint32_t pa[BN / 16][4];          // p of a tile as bf16 A fragments

      // a tile no row of this consumer reaches: keep in step with the ring
      auto skip = [&](int t) {
        mbar_wait(bar_k + 8 * stage(t), phase(t));
        mbar_wait(bar_v + 8 * stage(t), phase(t));
        release(bar_ek + 8 * stage(t));
        release(bar_ev + 8 * stage(t));
      };
      // S = Q K^T (raw dot products) of tile t, one committed group (its K
      // has landed)
      auto issue_s = [&](int t, float (&sc)[BN / 2]) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;   // within the 64-column chunk
          const uint64_t kd = wg_desc(
              sK + stage(t) * L::kK + (kk / 4) * BN * 128 + col, 16, 1024);
          if constexpr (QR)
            wgmma_rs_kmajor64(sc, qf[kk], kd, kk > 0);
          else
            wgmma_ss<BN>(
                sc, wg_desc(sQw + (kk / 4) * BM * 128 + col, 16, 1024), kd,
                kk > 0);
        }
        wg_commit();
      };
      // O += P V of tile t (p in pa), one committed group (its V has landed)
      auto issue_pv = [&](int t) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<DV>(acc, pa[kk],
                       wg_desc(sV + stage(t) * L::kV + kk * 16 * 128,
                               BN * 128, 1024));
        wg_commit();
      };
      // tile t's scores in sc become p (masked, online softmax); alpha
      // rescales the rows' earlier sums
      auto softmax = [&](int t, float (&sc)[BN / 2], float (&alpha)[2]) {
        // mask only where the tile crosses the diagonal of this warp's
        // rows, the band's lower edge or Sk
        const int k0 = t * BN;
        const bool mask = (causal && k0 + BN - 1 > wrow) ||
                          (window > 0 && k0 <= wrow + 15 - window) ||
                          k0 + BN > Sk;
        if (mask) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 8 + 2 * tig + (e & 1);
              const int row = row0 + (e >> 1) * 8;
              if (key >= Sk || (causal && key > row) ||
                  (window > 0 && row - key >= window))
                sc[4 * j + e] = kNegInf;
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the row's max of the raw scores, then in the log2 domain
          // (NEG_INF while the row has seen no key)
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          const float m_new =
              fmaxf(m[r], mx <= kNegInf / 2 ? kNegInf : mx * scale_log2);
          const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
          alpha[r] = m[r] <= kNegInf / 2 ? 0.f
                     : m[r] == m_new     ? 1.f
                                         : ex2(m[r] - shift);
          // p = 2^(s scale - shift): 0 where masked (NEG_INF scaled is
          // far below any shift)
          float rsum = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -shift));
              rsum += sc[4 * j + e];
            }
          l[r] = l[r] * alpha[r] + rsum;
          m[r] = m_new;
        }
      };
      // O *= alpha (skipped where no row of the warp's max moved), and p
      // packed to bf16 as the A fragments of its P.V
      auto rescale_and_pack = [&](const float (&sc)[BN / 2],
                                  const float (&alpha)[2]) {
        if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            acc[4 * j] *= alpha[0];
            acc[4 * j + 1] *= alpha[0];
            acc[4 * j + 2] *= alpha[1];
            acc[4 * j + 3] *= alpha[1];
          }
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      // the block's tiles: [t0, a) and [z, n_tiles) skipped, [a, z) this
      // consumer's own range
      for (int t = t0; t < a; ++t) skip(t);
      if (a < z) {
        float alpha[2];
        {
          float sc[BN / 2];
          mbar_wait(bar_k + 8 * stage(a), phase(a));
          reg_fence(acc);
          if constexpr (QR) reg_fence(qf);
          wg_fence();
          issue_s(a, sc);
          wg_wait<0>();
          reg_fence(sc);
          release(bar_ek + 8 * stage(a));
          if (kFreeQAfterS && a + 1 == z) release(bar_eqj);   // Q is done
          softmax(a, sc, alpha);
          rescale_and_pack(sc, alpha);
        }
        // tile t's S, then tile t - 1's P.V, which runs on while tile t's
        // softmax is computed; O is rescaled once that P.V is done
        for (int t = a + 1; t < z; ++t) {
          float sc[BN / 2];
          mbar_wait(bar_k + 8 * stage(t), phase(t));
          mbar_wait(bar_v + 8 * stage(t - 1), phase(t - 1));
          reg_fence(acc);
          reg_fence(pa);
          if constexpr (QR) reg_fence(qf);
          wg_fence();
          issue_s(t, sc);
          issue_pv(t - 1);
          wg_wait<1>();
          reg_fence(sc);
          release(bar_ek + 8 * stage(t));
          if (kFreeQAfterS && t + 1 == z) release(bar_eqj);   // Q is done
          softmax(t, sc, alpha);
          wg_wait<0>();
          reg_fence(acc);
          reg_fence(pa);
          release(bar_ev + 8 * stage(t - 1));
          rescale_and_pack(sc, alpha);
        }
        mbar_wait(bar_v + 8 * stage(z - 1), phase(z - 1));
        reg_fence(acc);
        reg_fence(pa);
        wg_fence();
        issue_pv(z - 1);
        wg_wait<0>();
        reg_fence(acc);
        release(bar_ev + 8 * stage(z - 1));
      }
      for (int t = z; t < n_tiles; ++t) skip(t);
      if (n_tiles > t0) ring += n_tiles - t0;

      // row row0 + 8 r's log-sum-exp (l the whole row's sum), by the
      // quad's first thread
      auto store_lse = [&](int r) {
        const int row = row0 + r * 8;
        if (tig == 0 && row < lse_ld)
          lse[((long long)w.b * H + w.h) * lse_ld + row] =
              row >= Sq ? 0.f
              : l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f
                           : 1e30f;
      };
      // ---- out = acc / max(l, 1e-30), rounded once to bf16 ----
      if (!STAGE_O) {
        // stored from the fragments; Q was freed with the last S
        if (kFreeQAfterS && a == z) release(bar_eqj);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(kFull, l[r], 1);
          l[r] += __shfl_xor_sync(kFull, l[r], 2);
          if constexpr (LSE) store_lse(r);
          const int row = row0 + r * 8;
          if (row >= Sq) continue;
          const float inv = 1.f / fmaxf(l[r], 1e-30f);
          __nv_bfloat16* orow = o + w.b * os.b + w.h * os.h +
                                (long long)row * os.s + 2 * tig;
#pragma unroll
          for (int jj = 0; jj < DV / 8; ++jj)
            *reinterpret_cast<uint32_t*>(orow + jj * 8) = pack_bf16(
                acc[4 * jj + 2 * r] * inv, acc[4 * jj + 2 * r + 1] * inv);
        }
        continue;
      }
      // staged in this consumer's Q rows (done with: its last S has
      // landed) with the 128-byte swizzle and written by a TMA store; then
      // Q is free
      if (r0 < Sq) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(kFull, l[r], 1);
          l[r] += __shfl_xor_sync(kFull, l[r], 2);
          if constexpr (LSE) store_lse(r);
          l[r] = 1.f / fmaxf(l[r], 1e-30f);
        }
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + r * 8;   // row % 8 == g
            st_shared(sQw + (jj / 8) * BM * 128 + row * 128 +
                          (((jj % 8) ^ g) << 4) + 4 * tig,
                      pack_bf16(acc[4 * jj + 2 * r] * l[r],
                                acc[4 * jj + 2 * r + 1] * l[r]));
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        if (ct == 0) {
          for (int c = 0; c < DV / kSwCols; ++c)
            tma_store(&to, sQw + c * BM * 128, c * kSwCols, r0, w.h,
                      w.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
      }
      if (ct == 0) mbar_arrive(bar_eqj);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library links the runtime alone; nullptr where the driver has none
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a (B, heads, S, width) bf16 operand (strides in elements,
// the last dim dense), read in boxes of `rows` rows x 64 columns with the
// 128-byte swizzle.  TMA wants every stride a multiple of 16 bytes; the
// wrapper checks those of dims longer than 1, and a dim of size 1 (read at
// coordinate 0 alone) is given a dense stride here.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int B, int heads,
                       int S, int width, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                           (cuuint64_t)st.b * 2};
  if (S == 1) strides[0] = (cuuint64_t)width * 2;
  if (heads == 1) strides[1] = strides[0] * S;
  if (B == 1) strides[2] = strides[1] * heads;
  const cuuint32_t box[4] = {kSwCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether the items go head by head (a head's q tiles adjacent, their K/V
// shared in L2): where the heaviest item is at most a tenth of a block's
// share of the work, so that taking the items in that order leaves a tail
// of at most a tenth; else q tile by q tile, the heaviest of every head
// first.  An item costs its K/V tiles and one for its Q and output.
template <int BN, int BM>
bool head_major_order(int B, int H, int Sq, int Sk, bool causal, int window,
                      int n_blocks) {
  long long total = 0, heaviest = 0;
  for (int q0 = 0; q0 < Sq; q0 += BM) {
    const int t0 = window > 0 && q0 >= window ? (q0 - window + 1) / BN : 0;
    const int end = causal && q0 + BM < Sk ? q0 + BM : Sk;
    const int t1 = (end + BN - 1) / BN;
    const long long cost = t1 > t0 ? t1 - t0 + 1 : 1;
    total += cost;
    heaviest = cost > heaviest ? cost : heaviest;
  }
  return heaviest * n_blocks * 10 <= total * H * B;
}

// `work` is a zeroed int the blocks take their items from; `lse` (LSE
// alone) the (B, H, lse_ld) log-sum-exp rows.
template <int D, int DV, int BN, class W, bool LSE = false>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* work, int B, int H, int G, int Sq,
                         int Sk, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, bool causal, int window,
                         float* lse, int lse_ld, cudaStream_t stream) {
  if (work == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = tensor_map(&tq, q, B, H, Sq, D, qs, W::BM);
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, H / G, Sk, D, ks, BN);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, H / G, Sk, DV, vs, BN);
  if (err == cudaSuccess) err = tensor_map(&to, o, B, H, Sq, DV, os, kWgRows);
  if (err != cudaSuccess) return err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  constexpr int smem = WgLayout<D, DV, BN, W>::kSmem;
  err = cudaFuncSetAttribute(flash_kernel_wgmma<D, DV, BN, W, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((Sq + W::BM - 1) / W::BM) * H * B;
  const int blocks = items < sms ? (int)items : sms;   // one an SM
  flash_kernel_wgmma<D, DV, BN, W, LSE>
      <<<blocks, W::kThreads, smem, stream>>>(
          tq, tk, tv, to, static_cast<__nv_bfloat16*>(o), os,
          static_cast<int*>(work), H, B, G, Sq, Sk, scale * kLog2e, causal,
          window,
          head_major_order<BN, W::BM>(B, H, Sq, Sk, causal, window, blocks),
          lse, lse_ld);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               void*, int, int, int, int, int, Strides,
                               Strides, Strides, Strides, float, bool, int,
                               float*, int, cudaStream_t);

// an instance: its launch and its dynamic shared memory in bytes
struct Instance {
  Launch launch;
  int smem;
};

template <int D, int DV, int BN, class W, bool LSE = false>
Instance wg_instance() {
  return {launch_wgmma<D, DV, BN, W, LSE>, WgLayout<D, DV, BN, W>::kSmem};
}

// the instance for (dtype, d, dv): dtype 0 = f32 on the CUDA cores, 1 = bf16
// on the tensor cores; with `lse` the training instance that also stores
// the rows' log-sum-exp, for each pair the backward takes (bf16 (128,
// 128)); {nullptr, 0} where there is none
Instance pick(int dtype, int d, int dv, bool lse = false) {
  if (lse) {
    if (dtype == 1 && d == 128 && dv == 128)
      return wg_instance<128, 128, 64, WgDesign<3, 4, 2, true, false>,
                         true>();
    return {nullptr, 0};
  }
  if (dtype == 0) {
    switch (d * 1000 + dv) {
      case 16016: return {launch_f32<16, 16>, smem_floats<16, 16>() * 4};
      case 32032: return {launch_f32<32, 32>, smem_floats<32, 32>() * 4};
      case 64064: return {launch_f32<64, 64>, smem_floats<64, 64>() * 4};
      case 128128: return {launch_f32<128, 128>, smem_floats<128, 128>() * 4};
      case 192128: return {launch_f32<192, 128>, smem_floats<192, 128>() * 4};
      case 192192: return {launch_f32<192, 192>, smem_floats<192, 192>() * 4};
      case 256256: return {launch_f32<256, 256>, smem_floats<256, 256>() * 4};
    }
  } else if (dtype == 1) {
    switch (d * 1000 + dv) {
      case 16016: return {launch_mma<16>, smem_bytes_mma<16>()};
      case 32032: return {launch_mma<32>, smem_bytes_mma<32>()};
      case 64064:
        return wg_instance<64, 64, 64, WgDesign<3, 4, 2, true, true>>();
      case 128128:
        return wg_instance<128, 128, 64, WgDesign<3, 4, 2, true, false>>();
      case 192128:
        return wg_instance<192, 128, 64, WgDesign<2, 2, 1, false, false>>();
      case 192192:
        return wg_instance<192, 192, 64, WgDesign<2, 2, 1, true, false>>();
      case 256256:
        return wg_instance<256, 256, 64, WgDesign<2, 2, 1, true, false>>();
    }
  }
  return {nullptr, 0};
}


// ---------------------------------------------------------------------------
// The backward, bf16 at (d, dv) = (128, 128): flash_bwd_delta,
// flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX package's training differentiates its
// chunked jnp attention by autodiff, and flash_attention_tpu has no
// custom_vjp.  Until this backward the port did the same on the card (an
// f32 recompute under autograd, f32 products on the CUDA cores and a dozen
// elementwise passes over every score).  The design follows the public
// FlashAttention-2 and -3 backward (Dao; Shah et al.): from the forward's
// row log-sum-exp (lse, stored by its training instance) and delta =
// rowsum(dO o), in f32,
//   P = exp(S scale - lse), dP = dO V^T, dS = P (dP - delta),
//   dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K,
// with S, dP and the three gradients accumulated in f32 and P and dS
// rounded to bf16 only as the operands of their products (the rounding
// the bf16 forward makes for P.V).  Its plain version is
// repro_torch.kernels.ref.flash_attention_bwd_ref_bf16p.
//  * Bound: the five products (S, dP, dV, dK, dQ), 2 d operations each a
//    valid (query, key) pair, over the bf16 tensor-core rate; at qwen3's
//    train shape (B 8, H 16/8, S 2,048, causal) 343.6 GFLOP a layer,
//    0.347 ms.  The bytes (q, k, v, o, dO and the three gradients once)
//    are 0.40 GB, 0.120 ms.
//  * Split, deterministic: flash_bwd_dkdv_wgmma owns keys and walks the
//    queries (dK, dV in registers, no atomics), flash_bwd_dq_wgmma owns
//    queries and walks the keys (dQ in registers), recomputing S and dP:
//    seven products for five, and no f32 dQ workspace, no atomics, the
//    same bits on every run.
//  * Both kernels have F's forward shape: persistent blocks, one an SM, a
//    producer warpgroup whose one thread takes the items from a zeroed
//    counter and issues every TMA load into mbarrier rings, and two
//    consumer warpgroups (240 registers a thread) that run wgmma.
//  * flash_bwd_dkdv_wgmma: an item is 128 keys of one (b, kv head), 64 a
//    consumer; its K and V stay in shared memory while the block walks the
//    64-row q tiles of all G query heads of the kv head (a ring of four
//    stages of Q, dO, lse and delta), so dK and dV sum the group in
//    registers.  S^T = K Q^T and dP^T = V dO^T with keys as the wgmma
//    rows (both operands from shared memory), so P^T and dS^T come out as
//    accumulator fragments that serve as the register A operand of dV +=
//    P^T dO and dK += dS^T Q (Q and dO read MN-major, as the forward reads
//    V).  Items go key tile by key tile, the heaviest (the first, when
//    causal) first.
//  * flash_bwd_dq_wgmma: an item is 128 q rows of one (b, h), 64 a
//    consumer, Q and dO in one of two buffers; K/V tiles of 64 keys in a
//    ring of two.  S = Q K^T and dP = dO V^T from shared memory, dS packed
//    to bf16 in registers as the A operand of dQ += dS K (K MN-major).
//    Tile t's S and dP are issued with tile t - 1's dS K, which runs on
//    while tile t's dS is computed.
//  * Masks as the forward: tiles no valid pair reaches are skipped (each
//    consumer keeps its place in the ring), and only tiles that cross the
//    diagonal, the band's edge, Sq or Sk are masked, for a warp's 16 rows.
//  * flash_bwd_delta: delta = rowsum(dO o) in f32, d / 8 threads a row,
//    16 bytes each; rows Sq..ld - 1 of the padded (B, H, ld) rows get 0.
//  * Measured at qwen3's train shape (H100 SXM, 700 W): 1.244 ms, 276
//    TFLOP/s of the five products, 28% of the bound (delta 0.052, dq
//    0.572, dk/dv 0.593 ms); 240 registers a consumer, 197,744 and 199,768
//    B of shared memory, dk/dv spilling 24 bytes.

constexpr int kBwdRows = 64;              // rows of a consumer, keys or q
constexpr int kBwdNC = 2;                 // consumer warpgroups a block
constexpr int kBwdThreads = (kBwdNC + 1) * 128;
constexpr int kBwdRegs = 240;             // a consumer thread's registers
constexpr int kBwdDqQB = 2;               // dq: Q/dO buffers
constexpr int kBwdDqST = 2;               // dq: K/V stages
constexpr int kBwdKvST = 4;               // dkdv: Q/dO/lse/delta stages

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// delta[r] = sum_c dO[r, c] o[r, c] over the (B, H, ld) rows r, 0 past Sq
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, int H, int Sq, int ld, Strides os,
                Strides gs, long long rows) {
  constexpr int TPR = D / 8;          // threads a row, 16 bytes each
  constexpr int RPB = 256 / TPR;      // rows a block a step
  const int sub = threadIdx.x % TPR;
  // rows is a multiple of 64, so a warp's rows agree on the loop's end
  for (long long r = (long long)blockIdx.x * RPB + threadIdx.x / TPR;
       r < rows; r += (long long)gridDim.x * RPB) {
    const int i = (int)(r % ld);
    const long long bh = r / ld;
    const int h = (int)(bh % H), b = (int)(bh / H);
    float sum = 0.f;
    if (i < Sq) {
      const uint4 a = *reinterpret_cast<const uint4*>(
          o + b * os.b + h * os.h + (long long)i * os.s + sub * 8);
      const uint4 g = *reinterpret_cast<const uint4*>(
          dout + b * gs.b + h * gs.h + (long long)i * gs.s + sub * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(g2[e]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (sub == 0) delta[r] = sum;
  }
}

// Shared memory of flash_bwd_dq_wgmma: QB buffers of Q then dO (BM rows
// each), ST K stages, ST V stages of 64 keys, the barriers (full and empty
// Q/dO a buffer; full K, full V, empty K, empty V a stage) and each
// buffer's item.
template <int D>
struct DqLayout {
  static constexpr int BM = kBwdNC * kBwdRows;
  static constexpr int BN = kBwdRows;
  static constexpr uint32_t kQ = BM * D * 2;       // one of Q, dO
  static constexpr uint32_t kK = BN * D * 2;       // one of K, V
  static constexpr uint32_t kBars = kBwdDqQB * 2 * kQ + kBwdDqST * 2 * kK;
  static constexpr int kSmem = 1024 + kBars + 8 * (3 * kBwdDqQB + 4 * kBwdDqST);
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int ld,
                   __nv_bfloat16* __restrict__ dq, Strides dqs,
                   int* __restrict__ next, int H, int B, int G, int Sq,
                   int Sk, float scale, float scale_log2, bool causal,
                   int window, bool head_major) {
  using L = DqLayout<D>;
  constexpr int QB = kBwdDqQB, ST = kBwdDqST, BM = L::BM, BN = L::BN;
  extern __shared__ __align__(128) unsigned char smem_dq[];
  const uint32_t sQ = (smem_addr(smem_dq) + 1023) & ~1023u;   // [QB] Q, dO
  const uint32_t sK = sQ + QB * 2 * L::kQ;         // [ST]
  const uint32_t sV = sK + ST * L::kK;             // [ST]
  const uint32_t bar_q = sQ + L::kBars;            // full Q/dO [QB]
  const uint32_t bar_eq = bar_q + 8 * QB;          // empty Q/dO [QB]
  const uint32_t bar_k = bar_eq + 8 * QB;          // full K [ST]
  const uint32_t bar_v = bar_k + 8 * ST;           // full V [ST]
  const uint32_t bar_ek = bar_v + 8 * ST;          // empty K [ST]
  const uint32_t bar_ev = bar_ek + 8 * ST;         // empty V [ST]
  volatile int* item_slot = reinterpret_cast<volatile int*>(
      smem_dq + (bar_ev + 8 * ST - smem_addr(smem_dq)));

  const int nq = (Sq + BM - 1) / BM;
  const int n_items = nq * H * B;
  auto tiles = [&](int q0, int& t0, int& n_tiles) {
    t0 = first_key_tile<BN>(q0, window) / BN;
    n_tiles = ((causal ? min(Sk, q0 + BM) : Sk) + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(bar_q + 8 * i, 1);
      mbar_init(bar_eq + 8 * i, 4 * kBwdNC);     // one arrival a consumer warp
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, 4 * kBwdNC);
      mbar_init(bar_ev + 8 * s, 4 * kBwdNC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0;
      for (int j = 0;; ++j) {
        const int qb = j % QB;
        const int item = atomicAdd(next, 1);
        mbar_wait(bar_eq + 8 * qb, ((j / QB) & 1) ^ 1);
        if (item >= n_items) {
          item_slot[2 * qb] = -1;
          mbar_arrive(bar_q + 8 * qb);
          break;
        }
        item_slot[2 * qb] = item;
        const WgItem w = wg_item(item, nq, BM, H, B, head_major);
        const int hk = w.h / G;
        const uint32_t dst = sQ + qb * 2 * L::kQ;
        mbar_expect_tx(bar_q + 8 * qb, 2 * L::kQ);
        for (int c = 0; c < D / kSwCols; ++c) {
          tma_load(dst + c * BM * 128, &tq, bar_q + 8 * qb, c * kSwCols,
                   w.q0, w.h, w.b);
          tma_load(dst + L::kQ + c * BM * 128, &tg, bar_q + 8 * qb,
                   c * kSwCols, w.q0, w.h, w.b);
        }
        int t0, n_tiles;
        tiles(w.q0, t0, n_tiles);
        for (int t = t0; t < n_tiles; ++t, ++ring) {
          const int s = ring % ST;
          const uint32_t free = ((ring / ST) & 1) ^ 1;
          mbar_wait(bar_ek + 8 * s, free);
          mbar_expect_tx(bar_k + 8 * s, L::kK);
          for (int c = 0; c < D / kSwCols; ++c)
            tma_load(sK + s * L::kK + c * BN * 128, &tk, bar_k + 8 * s,
                     c * kSwCols, t * BN, hk, w.b);
          mbar_wait(bar_ev + 8 * s, free);
          mbar_expect_tx(bar_v + 8 * s, L::kK);
          for (int c = 0; c < D / kSwCols; ++c)
            tma_load(sV + s * L::kK + c * BN * 128, &tv, bar_v + 8 * s,
                     c * kSwCols, t * BN, hk, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each of every item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdRegs));
    const int cw = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    int ring = 0;

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    for (int j = 0;; ++j) {
      const int qb = j % QB;
      mbar_wait(bar_q + 8 * qb, (j / QB) & 1);
      const int item = item_slot[2 * qb];
      if (item < 0) break;
      const uint32_t sQw = sQ + qb * 2 * L::kQ + cw * kBwdRows * 128;
      const uint32_t sGw = sQw + L::kQ;
      const uint32_t bar_eqj = bar_eq + 8 * qb;
      const WgItem w = wg_item(item, nq, BM, H, B, head_major);
      int t0, n_tiles;
      tiles(w.q0, t0, n_tiles);
      const int r0 = w.q0 + cw * kBwdRows;
      const int wrow = r0 + warp * 16;
      const int row0 = wrow + g;        // this thread's rows: row0, row0 + 8
      const int lo = first_key_tile<BN>(r0, window) / BN;
      const int hi =
          r0 >= Sq ? 0
                   : ((causal ? min(Sk, r0 + kBwdRows) : Sk) + BN - 1) / BN;
      const int a = min(lo, n_tiles);
      const int z = max(a, hi);
      const int base = ring - t0;
      auto stage = [&](int t) { return (base + t) % ST; };
      auto phase = [&](int t) { return (uint32_t)((base + t) / ST) & 1; };

      // the rows' -lse log2(e) and delta (0 past Sq)
      float nl[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long at = ((long long)w.b * H + w.h) * ld + row;
        nl[r] = row < Sq ? -lse[at] * kLog2e : 0.f;
        dl[r] = row < Sq ? delta[at] : 0.f;
      }
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      uint32_t dsa[BN / 16][4];         // dS of a tile as bf16 A fragments

      auto skip = [&](int t) {
        mbar_wait(bar_k + 8 * stage(t), phase(t));
        mbar_wait(bar_v + 8 * stage(t), phase(t));
        release(bar_ek + 8 * stage(t));
        release(bar_ev + 8 * stage(t));
      };
      // S = Q K^T and dP = dO V^T of tile t, one committed group
      auto issue_sdp = [&](int t, float (&sc)[BN / 2], float (&dp)[BN / 2]) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk / 4) * BN * 128 + (kk % 4) * 32;
          wgmma_ss<BN>(sc,
                       wg_desc(sQw + (kk / 4) * BM * 128 + (kk % 4) * 32, 16,
                               1024),
                       wg_desc(sK + stage(t) * L::kK + col, 16, 1024),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk / 4) * BN * 128 + (kk % 4) * 32;
          wgmma_ss<BN>(dp,
                       wg_desc(sGw + (kk / 4) * BM * 128 + (kk % 4) * 32, 16,
                               1024),
                       wg_desc(sV + stage(t) * L::kK + col, 16, 1024),
                       kk > 0);
        }
        wg_commit();
      };
      // dQ += dS K of tile t (dS in dsa), one committed group
      auto issue_dq = [&](int t) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D>(acc, dsa[kk],
                      wg_desc(sK + stage(t) * L::kK + kk * 16 * 128,
                              BN * 128, 1024));
        wg_commit();
      };
      // tile t's S and dP become dS = P (dP - delta) in sc, P = exp(S
      // scale - lse), 0 where masked
      auto grad_scores = [&](int t, float (&sc)[BN / 2],
                             const float (&dp)[BN / 2]) {
        const int k0 = t * BN;
        const bool mask = (causal && k0 + BN - 1 > wrow) ||
                          (window > 0 && k0 <= wrow + 15 - window) ||
                          k0 + BN > Sk;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = ex2(fmaf(sc[4 * j + e], scale_log2, nl[r]));
            float ds = p * (dp[4 * j + e] - dl[r]);
            if (mask) {
              const int key = k0 + j * 8 + 2 * tig + (e & 1);
              const int row = row0 + r * 8;
              if (key >= Sk || (causal && key > row) ||
                  (window > 0 && row - key >= window))
                ds = 0.f;
            }
            sc[4 * j + e] = ds;
          }
      };
      auto pack = [&](const float (&sc)[BN / 2]) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          dsa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          dsa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          dsa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          dsa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      for (int t = t0; t < a; ++t) skip(t);
      if (a < z) {
        {
          float sc[BN / 2], dp[BN / 2];
          mbar_wait(bar_k + 8 * stage(a), phase(a));
          mbar_wait(bar_v + 8 * stage(a), phase(a));
          reg_fence(acc);
          wg_fence();
          issue_sdp(a, sc, dp);
          wg_wait<0>();
          reg_fence(sc);
          reg_fence(dp);
          release(bar_ev + 8 * stage(a));
          if (a + 1 == z) release(bar_eqj);       // Q and dO are done
          grad_scores(a, sc, dp);
          pack(sc);
        }
        for (int t = a + 1; t < z; ++t) {
          float sc[BN / 2], dp[BN / 2];
          mbar_wait(bar_k + 8 * stage(t), phase(t));
          mbar_wait(bar_v + 8 * stage(t), phase(t));
          reg_fence(acc);
          reg_fence(dsa);
          wg_fence();
          issue_sdp(t, sc, dp);
          issue_dq(t - 1);
          wg_wait<1>();
          reg_fence(sc);
          reg_fence(dp);
          release(bar_ev + 8 * stage(t));
          if (t + 1 == z) release(bar_eqj);
          grad_scores(t, sc, dp);
          wg_wait<0>();
          reg_fence(acc);
          reg_fence(dsa);
          release(bar_ek + 8 * stage(t - 1));
          pack(sc);
        }
        reg_fence(acc);
        reg_fence(dsa);
        wg_fence();
        issue_dq(z - 1);
        wg_wait<0>();
        reg_fence(acc);
        release(bar_ek + 8 * stage(z - 1));
      } else {
        release(bar_eqj);
      }
      for (int t = z; t < n_tiles; ++t) skip(t);
      if (n_tiles > t0) ring += n_tiles - t0;

      // ---- dq = scale acc, rounded once to bf16, from the fragments ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= Sq) continue;
        __nv_bfloat16* out = dq + w.b * dqs.b + w.h * dqs.h +
                             (long long)row * dqs.s + 2 * tig;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(out + jj * 8) =
              pack_bf16(acc[4 * jj + 2 * r] * scale,
                        acc[4 * jj + 2 * r + 1] * scale);
      }
    }
  }
}

// Shared memory of flash_bwd_dkdv_wgmma: the item's K and V (BN keys),
// ST stages of Q and dO (64 rows each), ST stages of lse and delta (64
// f32 each), the barriers (full and empty K/V; full and empty a stage)
// and the item.
template <int D>
struct DkvLayout {
  static constexpr int BN = kBwdNC * kBwdRows;     // keys an item
  static constexpr int BQ = kBwdRows;              // q rows a tile
  static constexpr uint32_t kKV = BN * D * 2;      // one of K, V
  static constexpr uint32_t kT = BQ * D * 2;       // one of Q, dO
  static constexpr uint32_t kStats = 2 * BQ * 4;   // lse and delta
  static constexpr uint32_t kBars =
      2 * kKV + kBwdKvST * (2 * kT + kStats);
  static constexpr int kSmem = 1024 + kBars + 8 * (2 + 2 * kBwdKvST) + 8;
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tg,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int ld,
                     __nv_bfloat16* __restrict__ dk, Strides dks,
                     __nv_bfloat16* __restrict__ dv, Strides dvs,
                     int* __restrict__ next, int Hkv, int B, int G, int Sq,
                     int Sk, float scale, float scale_log2, bool causal,
                     int window) {
  using L = DkvLayout<D>;
  constexpr int ST = kBwdKvST, BN = L::BN, BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem_kv[];
  const uint32_t sK = (smem_addr(smem_kv) + 1023) & ~1023u;
  const uint32_t sV = sK + L::kKV;
  const uint32_t sT = sV + L::kKV;                 // [ST] Q, dO
  const uint32_t sSt = sT + ST * 2 * L::kT;        // [ST] lse, delta
  const uint32_t bar_kv = sK + L::kBars;           // full K/V
  const uint32_t bar_ekv = bar_kv + 8;             // empty K/V
  const uint32_t bar_s = bar_ekv + 8;              // full stage [ST]
  const uint32_t bar_es = bar_s + 8 * ST;          // empty stage [ST]
  volatile int* item_slot = reinterpret_cast<volatile int*>(
      smem_kv + (bar_es + 8 * ST - smem_addr(smem_kv)));

  const int H = Hkv * G;
  const int nk = (Sk + BN - 1) / BN;
  const int nq = (Sq + BQ - 1) / BQ;
  const int n_items = nk * Hkv * B;
  // the q tiles [qa, qz) that keys [k0, k0 + BN) see
  auto qtiles = [&](int k0, int& qa, int& qz) {
    qa = causal ? k0 / BQ : 0;
    qz = window > 0 ? min(nq, (k0 + BN + window - 2) / BQ + 1) : nq;
  };
  // item: key tile by key tile (the first, the heaviest when causal, first)
  auto decode = [&](int item, int& kt, int& hk, int& b) {
    const int hb = item % (Hkv * B);
    kt = item / (Hkv * B);
    hk = hb % Hkv;
    b = hb / Hkv;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_ekv, 4 * kBwdNC);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_s + 8 * s, 1);
      mbar_init(bar_es + 8 * s, 4 * kBwdNC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0;
      for (int j = 0;; ++j) {
        const int item = atomicAdd(next, 1);
        mbar_wait(bar_ekv, (j & 1) ^ 1);
        if (item >= n_items) {
          *item_slot = -1;
          mbar_arrive(bar_kv);
          break;
        }
        *item_slot = item;
        int kt, hk, b;
        decode(item, kt, hk, b);
        const int k0 = kt * BN;
        mbar_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < D / kSwCols; ++c) {
          tma_load(sK + c * BN * 128, &tk, bar_kv, c * kSwCols, k0, hk, b);
          tma_load(sV + c * BN * 128, &tv, bar_kv, c * kSwCols, k0, hk, b);
        }
        int qa, qz;
        qtiles(k0, qa, qz);
        for (int gi = 0; gi < G; ++gi) {
          const int h = hk * G + gi;
          for (int qt = qa; qt < qz; ++qt, ++ring) {
            const int s = ring % ST;
            mbar_wait(bar_es + 8 * s, ((ring / ST) & 1) ^ 1);
            const uint32_t bar = bar_s + 8 * s;
            const uint32_t dst = sT + s * 2 * L::kT;
            mbar_expect_tx(bar, 2 * L::kT + L::kStats);
            for (int c = 0; c < D / kSwCols; ++c) {
              tma_load(dst + c * BQ * 128, &tq, bar, c * kSwCols, qt * BQ, h,
                       b);
              tma_load(dst + L::kT + c * BQ * 128, &tg, bar, c * kSwCols,
                       qt * BQ, h, b);
            }
            const long long at = ((long long)b * H + h) * ld + qt * BQ;
            bulk_load(sSt + s * L::kStats, lse + at, BQ * 4, bar);
            bulk_load(sSt + s * L::kStats + BQ * 4, delta + at, BQ * 4, bar);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each of every item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdRegs));
    const int cw = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    int ring = 0;

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    for (int j = 0;; ++j) {
      mbar_wait(bar_kv, j & 1);
      const int item = *item_slot;
      if (item < 0) break;
      int kt, hk, b;
      decode(item, kt, hk, b);
      const int k0 = kt * BN;
      const int kc0 = k0 + cw * kBwdRows;   // this consumer's keys
      const int kw = kc0 + warp * 16;       // this warp's 16
      const int key0 = kw + g;              // this thread's: key0, key0 + 8
      int qa, qz;
      qtiles(k0, qa, qz);

      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

      for (int gi = 0; gi < G; ++gi) {
        for (int qt = qa; qt < qz; ++qt, ++ring) {
          const int s = ring % ST;
          const int q0 = qt * BQ;
          mbar_wait(bar_s + 8 * s, (ring / ST) & 1);
          // no valid pair of this consumer's keys in the tile
          if (kc0 >= Sk || (causal && q0 + BQ - 1 < kc0) ||
              (window > 0 && q0 - (kc0 + kBwdRows - 1) >= window)) {
            release(bar_es + 8 * s);
            continue;
          }
          const uint32_t sQs = sT + s * 2 * L::kT;
          const uint32_t sGs = sQs + L::kT;
          const uint32_t stats = sSt + s * L::kStats;
          float st[BQ / 2], dpt[BQ / 2];
          reg_fence(dka);
          reg_fence(dva);
          wg_fence();
          // S^T = K Q^T, dP^T = V dO^T (keys as the rows)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t col = (kk % 4) * 32;
            wgmma_ss<BQ>(st,
                         wg_desc(sK + (kk / 4) * BN * 128 +
                                     cw * kBwdRows * 128 + col,
                                 16, 1024),
                         wg_desc(sQs + (kk / 4) * BQ * 128 + col, 16, 1024),
                         kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t col = (kk % 4) * 32;
            wgmma_ss<BQ>(dpt,
                         wg_desc(sV + (kk / 4) * BN * 128 +
                                     cw * kBwdRows * 128 + col,
                                 16, 1024),
                         wg_desc(sGs + (kk / 4) * BQ * 128 + col, 16, 1024),
                         kk > 0);
          }
          wg_commit();
          wg_wait<0>();
          reg_fence(st);
          reg_fence(dpt);
          // P^T and dS^T; mask only where the tile crosses the diagonal,
          // the band's edge, Sq or Sk for this warp's 16 keys
          const bool mask = (causal && q0 < kw + 15) ||
                            (window > 0 && q0 + BQ - 1 - kw >= window) ||
                            q0 + BQ > Sq || kw + 16 > Sk;
#pragma unroll
          for (int jq = 0; jq < BQ / 8; ++jq) {
            const int col = 8 * jq + 2 * tig;
            const float2 ls = ld_shared_f2(stats + col * 4);
            const float2 dl = ld_shared_f2(stats + BQ * 4 + col * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float l = (e & 1) ? ls.y : ls.x;
              const float d = (e & 1) ? dl.y : dl.x;
              float p = ex2(fmaf(st[4 * jq + e], scale_log2, -l * kLog2e));
              float ds = p * (dpt[4 * jq + e] - d);
              if (mask) {
                const int key = key0 + 8 * (e >> 1);
                const int qq = q0 + col + (e & 1);
                if (key >= Sk || qq >= Sq || (causal && qq < key) ||
                    (window > 0 && qq - key >= window))
                  p = ds = 0.f;
              }
              st[4 * jq + e] = p;
              dpt[4 * jq + e] = ds;
            }
          }
          uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
              dsa[kk][i] =
                  pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
            }
          }
          // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
          reg_fence(pa);
          reg_fence(dsa);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<D>(dva, pa[kk],
                        wg_desc(sGs + kk * 16 * 128, BQ * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<D>(dka, dsa[kk],
                        wg_desc(sQs + kk * 16 * 128, BQ * 128, 1024));
          wg_commit();
          wg_wait<0>();
          reg_fence(dka);
          reg_fence(dva);
          release(bar_es + 8 * s);
        }
      }
      release(bar_ekv);                 // this consumer's K and V are done

      // ---- dk = scale dka, dv = dva, rounded once to bf16 ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + r * 8;
        if (key >= Sk) continue;
        __nv_bfloat16* ok =
            dk + b * dks.b + hk * dks.h + (long long)key * dks.s + 2 * tig;
        __nv_bfloat16* ov =
            dv + b * dvs.b + hk * dvs.h + (long long)key * dvs.s + 2 * tig;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(ok + jj * 8) =
              pack_bf16(dka[4 * jj + 2 * r] * scale,
                        dka[4 * jj + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(ov + jj * 8) =
              pack_bf16(dva[4 * jj + 2 * r], dva[4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  float *lse, *delta;
  void *dq, *dk, *dv;
  int* work;                          // two zeroed ints: dq's and dkdv's
  int B, H, G, Sq, Sk, ld;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  float scale;
  bool causal;
  int window;
};

// delta, then dq, then dk and dv, on `stream`
template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int Hkv = a.H / a.G;
  const long long rows = (long long)a.B * a.H * a.ld;
  constexpr int kRowsPerBlock = 256 / (D / 8);
  const long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  flash_bwd_delta<D><<<(int)(want < 16LL * sms ? want : 16LL * sms), 256, 0,
                       stream>>>(
      static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout), a.delta, a.H, a.Sq, a.ld,
      a.os, a.gs, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using LQ = DqLayout<D>;
  CUtensorMap tq, tg, tk, tv;
  err = tensor_map(&tq, a.q, a.B, a.H, a.Sq, D, a.qs, LQ::BM);
  if (err == cudaSuccess)
    err = tensor_map(&tg, a.dout, a.B, a.H, a.Sq, D, a.gs, LQ::BM);
  if (err == cudaSuccess)
    err = tensor_map(&tk, a.k, a.B, Hkv, a.Sk, D, a.ks, LQ::BN);
  if (err == cudaSuccess)
    err = tensor_map(&tv, a.v, a.B, Hkv, a.Sk, D, a.vs, LQ::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LQ::kSmem);
  if (err != cudaSuccess) return err;
  const long long dq_items =
      (long long)((a.Sq + LQ::BM - 1) / LQ::BM) * a.H * a.B;
  const int dq_blocks = dq_items < sms ? (int)dq_items : sms;
  flash_bwd_dq_wgmma<D><<<dq_blocks, kBwdThreads, LQ::kSmem, stream>>>(
      tq, tg, tk, tv, a.lse, a.delta, a.ld,
      static_cast<__nv_bfloat16*>(a.dq), a.dqs, a.work, a.H, a.B, a.G, a.Sq,
      a.Sk, a.scale, a.scale * kLog2e, a.causal, a.window,
      head_major_order<LQ::BN, LQ::BM>(a.B, a.H, a.Sq, a.Sk, a.causal,
                                       a.window, dq_blocks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using LK = DkvLayout<D>;
  err = tensor_map(&tk, a.k, a.B, Hkv, a.Sk, D, a.ks, LK::BN);
  if (err == cudaSuccess)
    err = tensor_map(&tv, a.v, a.B, Hkv, a.Sk, D, a.vs, LK::BN);
  if (err == cudaSuccess)
    err = tensor_map(&tq, a.q, a.B, a.H, a.Sq, D, a.qs, LK::BQ);
  if (err == cudaSuccess)
    err = tensor_map(&tg, a.dout, a.B, a.H, a.Sq, D, a.gs, LK::BQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LK::kSmem);
  if (err != cudaSuccess) return err;
  const long long kv_items =
      (long long)((a.Sk + LK::BN - 1) / LK::BN) * Hkv * a.B;
  const int kv_blocks = kv_items < sms ? (int)kv_items : sms;
  flash_bwd_dkdv_wgmma<D><<<kv_blocks, kBwdThreads, LK::kSmem, stream>>>(
      tk, tv, tq, tg, a.lse, a.delta, a.ld,
      static_cast<__nv_bfloat16*>(a.dk), a.dks,
      static_cast<__nv_bfloat16*>(a.dv), a.dvs, a.work + 1, Hkv, a.B, a.G,
      a.Sq, a.Sk, a.scale, a.scale * kLog2e, a.causal, a.window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o[b, h, :Sq, :dv] = attention of q[b, h] over k[b, h / G], v[b, h / G]
// with G = H / Hkv.  dtype 0 = f32, 1 = bf16 (q, k, v and o alike); (d, dv)
// one of (16, 16), (32, 32), (64, 64), (128, 128), (192, 128), (192, 192),
// (256, 256), d the head dim of q and k, dv that of v and o; strides in
// elements, the last dim contiguous.  window > 0 (with causal) keeps keys
// 0 <= q - k < window; 0 is no band.
// bf16 needs 16-byte aligned rows (base addresses and strides), which the
// wrapper checks.  `device` is the CUDA ordinal the tensors and `stream`
// belong to.  `work` is a zeroed int32 on that device, where the bf16
// wgmma route takes its blocks' work from (unused by the others).  `lse`
// (null on the serving path) asks for the training instance, which also
// stores each row's log-sum-exp to the f32 (B, H, lse_ld) rows at `lse`,
// lse_ld >= Sq a multiple of 64 (bf16 (128, 128) alone).
// Returns the cudaError_t of the launch.
int ciao_flash_attention(int device, int dtype, int d, int dv, const void* q,
                         const void* k, const void* v, void* o, void* work,
                         int B, int H, int Hkv, int Sq, int Sk, long long qsb,
                         long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb,
                         long long vsh, long long vss, long long osb,
                         long long osh, long long oss, float scale,
                         int causal, int window, void* lse, int lse_ld,
                         void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && !causal)) return cudaErrorInvalidValue;
  if (lse != nullptr && (lse_ld < Sq || lse_ld % 64))
    return cudaErrorInvalidValue;
  const Launch launch = pick(dtype, d, dv, lse != nullptr).launch;
  if (launch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  return launch(q, k, v, o, work, B, H, H / Hkv, Sq, Sk, qs, ks, vs, os,
                scale, causal != 0, window, static_cast<float*>(lse),
                lse_ld, (cudaStream_t)stream);
}

// dynamic shared memory of one block of the (dtype, d, dv) instance in
// bytes; 0 where there is none
int ciao_flash_smem_bytes(int dtype, int d, int dv) {
  return pick(dtype, d, dv).smem;
}

// The backward of the bf16 (d, dv) = (128, 128) attention above: dq
// (B, H, Sq, d), dk and dv (B, Hkv, Sk, d) in bf16 from q, k, v, the
// forward's output o, its gradient dout (B, H, Sq, d), and lse, the
// training forward's f32 (B, H, ld) log-sum-exp rows (ld >= Sq, a
// multiple of 64).  `delta` is f32 (B, H, ld) scratch, `work` two zeroed
// int32; every tensor on `device`, strides in elements with the last dim
// contiguous and rows 16-byte aligned (the wrapper checks).  Three
// launches on `stream`; returns the cudaError_t of the first that fails.
int ciao_flash_attention_bwd(
    int device, int d, int dv, const void* q, const void* k, const void* v,
    const void* o, const void* dout, void* lse, void* delta, void* dq,
    void* dk, void* dvp, void* work, int B, int H, int Hkv, int Sq, int Sk,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    long long gsb, long long gsh, long long gss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss, int ld,
    float scale, int causal, int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return 0;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && !causal)) return cudaErrorInvalidValue;
  if (ld < Sq || ld % 64 || work == nullptr) return cudaErrorInvalidValue;
  if (d != 128 || dv != 128) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const BwdArgs a{q, k, v, o, dout, static_cast<float*>(lse),
                  static_cast<float*>(delta), dq, dk, dvp,
                  static_cast<int*>(work), B, H, H / Hkv, Sq, Sk, ld,
                  Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
                  Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
                  Strides{gsb, gsh, gss}, Strides{dqsb, dqsh, dqss},
                  Strides{dksb, dksh, dkss}, Strides{dvsb, dvsh, dvss},
                  scale, causal != 0, window};
  return launch_bwd<128>(a, (cudaStream_t)stream);
}

// dynamic shared memory of one block of the backward's dq (which 0) or
// dk/dv (which 1) kernel at (d, d), in bytes; 0 where there is none
int ciao_flash_bwd_smem_bytes(int d, int which) {
  if (d != 128) return 0;
  return which == 0 ? DqLayout<128>::kSmem : DkvLayout<128>::kSmem;
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
