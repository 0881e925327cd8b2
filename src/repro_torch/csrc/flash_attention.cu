// Kernel F: causal, banded (local) or unmasked GQA attention with an online
// softmax, over positions 0..S-1, scale d**-0.5.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _kernel).  Same function; the TPU's grid
// (B, H, nq, nk) carried m, l and the accumulator in VMEM scratch across
// its sequential kv steps.  Here blocks run in parallel and in no order,
// so one block owns one 64-row q tile of one (b, h) and walks the K/V
// tiles in a loop, keeping the running stats in registers.  Two routes,
// chosen by dtype in ciao_flash_attention:
//
// bf16: flash_kernel_mma, on the tensor cores (FlashAttention-2's shape).
//  * 128 threads, 4 warps of 16 q rows.  Q is loaded once; K and V tiles
//    of 64 keys go through a two-stage ring of cp.async 16-byte copies
//    (tile t+1 is in flight while tile t is multiplied).  Tiles stay
//    bf16 in shared memory, rows padded by 16 bytes so that the eight
//    row addresses of an ldmatrix land on eight distinct bank groups.
//    Rows past Sq or Sk are zero-filled (src-size 0).
//  * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate); Q's
//    fragments come from ldmatrix once and stay in registers, K's from
//    ldmatrix per tile.  A thread holds parts of rows g and g + 8 of its
//    warp's 16, so a row max is two xor shuffles within a quad; the row
//    sums stay per thread and are reduced the same way once, at the end.
//  * The causal mask is applied only on tiles that cross the diagonal,
//    the key-past-Sk mask only on the last tile.
//  * P.V: the f32 scores become p in registers, are packed to bf16x2 and
//    serve directly as the A operand of the next mma (no shared-memory
//    round trip); V's fragments come from ldmatrix.trans.  O accumulates
//    in f32 and is rescaled by alpha per tile.
//  * Numerics: p is rounded to bf16 for P.V (l sums the f32 p), which
//    the JAX kernel does not do (its P.V is f32).  The plain version of
//    exactly this is repro_torch.kernels.ref.flash_attention_ref_bf16p.
//  * Bound on this card: at the serving shape (B 8, H 16, Hkv 8, S 512,
//    d 128, causal) the bytes (q, k, v, o once: 50 MB, 0.015 ms at
//    3.35 TB/s) bound it, the 8.6 GFLOP at the bf16 tensor-core rate
//    taking 0.009 ms.  mma.sync reaches a part of that rate; each warp
//    also reads the whole K and V tile from shared memory, which sets
//    the pace next.  wgmma, TMA and warp specialisation are the next
//    redesign's work.
//
// f32: flash_kernel, on the CUDA cores, exact to f32 (no TF32).
//  * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns q rows
//    ty + 16 i (i < 4) and, for each 64-key tile, keys tx + 16 j (j < 4):
//    a 4 x 4 register tile of the scores, from Q and K tiles staged in
//    shared memory as f32 (rows padded so neither read conflicts on a
//    bank).  The 16 threads of a row are one half-warp, so the row max
//    and sum are xor shuffles within it.
//  * P.V: the same thread owns output columns tx + 16 c (c < d / 16) of
//    its four rows, so d = 128 needs 32 f32 accumulators per thread, not
//    128 in one.  p is broadcast from its owner by a half-warp shuffle;
//    V rows are read from shared memory.
//  * Scores, stats, p and the accumulator are f32, as the reference
//    computes them.
//
// Both routes:
//  * m, l, alpha and p follow _kernel: the NEG_INF / 2 guards, p = 0 where
//    masked, alpha = 0 while a row has seen no key, and the final divide
//    by max(l, 1e-30).  Keys past Sk and rows past Sq are masked, so any
//    Sq and Sk work; the TPU kernel required S to divide its blocks.  The
//    output is rounded once to the input type.
//  * Causal: a block stops at the K tile past its last row.  On such a
//    tile _kernel leaves m, l and acc unchanged (alpha = 1, p = 0), so
//    the skip is exact.  The heaviest q tiles are launched first.
//  * Band (window > 0, causal): key k is valid for query q iff
//    0 <= q - k < window, the JAX package's mask_mode="local"
//    (src/repro/models/attention.py::flash_attention; the TPU kernel has
//    no window).  A block starts at the 64-key tile that holds key
//    q0 - window + 1 (q0 its first row), skipping the tiles below it
//    exactly as the causal skip above does, and masks the tiles that
//    cross the band's lower edge as well as those that cross the
//    diagonal.  tests/test_torch_flash_attention.py holds these
//    expressions, in Python, to a numpy model of the mask: every valid
//    pair is visited and every tile with an invalid pair masked.
//    window = 0: no band.
//  * Head dims 16, 32, 64, 128, 192 and 256, one template instance each
//    per route.  d = 192 is MLA's qk head dim (deepseek-v3: nope 128 + rope
//    64); its v head dim of 128 is zero-padded to 192 by the caller
//    (repro_torch.models.attention.flash_kernel_padded_v), which leaves
//    o's first 128 columns exact and the others 0.  Shared memory per
//    block at d = 192: 128,000 B (bf16), 148,736 B (f32), both under the
//    227 KB a block may opt into; the bf16 accumulator is 96 f32 a thread
//    (64 at d = 128), which sets its register count.
//  * d = 256 is recurrentgemma's head dim.  Shared memory: 168,960 B
//    (bf16; pitch 528 B, still an odd number of 16-byte groups), 197,888 B
//    (f32).  The bf16 accumulator is 128 f32 a thread; Q's fragments
//    (another 64 registers at d = 256) are not kept in registers there but
//    read again from shared memory by ldmatrix on every tile (kQRegs).
//    ptxas still reports 255 registers and 64 bytes of spill, and one
//    block fits an SM.  At recurrentgemma's prefill (B 2, H 16, Hkv 1,
//    S 2,560, window 2,048) the band's operations bound it (4 B H d per
//    valid pair: 0.104 ms at the bf16 tensor-core rate; q, k, v and o
//    once: 0.027 ms); there the band skips 28 of the 820 causal tiles of
//    a head.
//  * GQA: q head h reads kv head h / G, the (Hkv, G) grouping of the
//    JAX package.  q, k, v and o are read and written through strides
//    (last dim contiguous), so (B, S, H, d) tensors need no copy.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;               // q rows per block
constexpr int kBN = 64;               // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Element strides of a (B, heads, S, d) operand; its last dim is dense.
struct Strides {
  long long b, h, s;
};

// First key of the first K/V tile a block of q rows [q0, q0 + kBM) visits:
// 0, or with a band the 64-key tile that holds key q0 - window + 1.  (The
// tiles end at min(Sk, q0 + kBM) when causal, at Sk otherwise.)
__device__ __forceinline__ int first_key_tile(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
constexpr int smem_floats() {
  return kBM * (D + 4) + kBN * (D + 1) + kBN * D;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int G,
             int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, bool causal, int window) {
  constexpr int QP = D + 4;           // Q row pitch: rows ty, ty+1 apart
  constexpr int KP = D + 1;           // K row pitch: 16 rows on 16 banks
  constexpr int CJ = D / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBM][QP]
  float* Ks = Qs + kBM * QP;          // [kBN][KP]
  float* Vs = Ks + kBN * KP;          // [kBN][D]

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
  for (int k0 = first_key_tile(q0, window); k0 < k_end; k0 += kBN) {
    __syncthreads();                  // Q stored; last tile's reads done
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      const long long row = k0 + r;
      Ks[r * KP + c] = in ? kb[row * ks.s + c] : 0.f;
      Vs[r * D + c] = in ? vb[row * vs.s + c] : 0.f;
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
        const float* vrow = Vs + (src + 16 * j) * D + tx;
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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int G, int Sq, int Sk, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       bool causal, int window, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
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
constexpr float kLog2e = 1.4426950408889634f;

// Row pitch in bf16 elements: 16 bytes of padding, so 8 consecutive rows
// start on 8 distinct 16-byte bank groups for every d in {16, 32, 64, 128,
// 192, 256} (a pitch of 2d + 16 bytes is an odd number of 16-byte groups)
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
  // Q's fragments stay in registers up to d = 192; at d = 256 they are
  // read again from shared memory on every tile (see the note above)
  constexpr bool kQRegs = D <= 192;
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
  const int t0 = first_key_tile(q0, window) / kBN;   // 0 without a band

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
  uint32_t qf[kQRegs ? KS : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_)
      ldmatrix_x4(qf[ks_], sQ + (a_row * P + ks_ * 16 + a_col) * 2);
  }

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
      if constexpr (!kQRegs)
        ldmatrix_x4(qf[0], sQ + (a_row * P + ks_ * 16 + a_col) * 2);
      const uint32_t (&qa)[4] = qf[kQRegs ? ks_ : 0];
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
                       int B, int H, int G, int Sq, int Sk, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       bool causal, int window, cudaStream_t stream) {
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

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               int, int, int, int, int, Strides, Strides,
                               Strides, Strides, float, bool, int,
                               cudaStream_t);

// the instance for (dtype, d): 0 = f32 on the CUDA cores, 1 = bf16 on the
// tensor cores; nullptr where there is none
Launch pick(int dtype, int d) {
  switch (dtype * 1000 + d) {
    case 16: return launch_f32<16>;
    case 32: return launch_f32<32>;
    case 64: return launch_f32<64>;
    case 128: return launch_f32<128>;
    case 192: return launch_f32<192>;
    case 256: return launch_f32<256>;
    case 1016: return launch_mma<16>;
    case 1032: return launch_mma<32>;
    case 1064: return launch_mma<64>;
    case 1128: return launch_mma<128>;
    case 1192: return launch_mma<192>;
    case 1256: return launch_mma<256>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// o[b, h, :Sq, :d] = attention of q[b, h] over k[b, h / G], v[b, h / G]
// with G = H / Hkv.  dtype 0 = f32, 1 = bf16 (q, k, v and o alike); d one
// of 16, 32, 64, 128, 192, 256; strides in elements, the last dim
// contiguous.  window > 0 (with causal) keeps keys 0 <= q - k < window;
// 0 is no band.
// bf16 needs 16-byte aligned rows (base addresses and strides), which the
// wrapper checks.  `device` is the CUDA ordinal the tensors and `stream`
// belong to.  Returns the cudaError_t of the launch.
int ciao_flash_attention(int device, int dtype, int d, const void* q,
                         const void* k, const void* v, void* o, int B,
                         int H, int Hkv, int Sq, int Sk, long long qsb,
                         long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb,
                         long long vsh, long long vss, long long osb,
                         long long osh, long long oss, float scale,
                         int causal, int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && !causal)) return cudaErrorInvalidValue;
  const Launch launch = pick(dtype, d);
  if (launch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  return launch(q, k, v, o, B, H, H / Hkv, Sq, Sk, qs, ks, vs, os, scale,
                causal != 0, window, (cudaStream_t)stream);
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
