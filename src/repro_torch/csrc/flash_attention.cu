// Kernel F: causal or unmasked GQA self-attention with an online softmax,
// over positions 0..S-1, scale d**-0.5.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _kernel).  Same function; the TPU's grid
// (B, H, nq, nk) carried m, l and the accumulator in VMEM scratch across
// its sequential kv steps.  Here blocks run in parallel and in no order,
// so one block owns one 64-row q tile of one (b, h) and walks the K/V
// tiles in a loop, keeping the running stats in registers:
//
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
//  * m, l, alpha and p follow _kernel: the NEG_INF / 2 guards, p = 0 where
//    masked, alpha = 0 while a row has seen no key, and the final divide
//    by max(l, 1e-30).  Keys past Sk and rows past Sq are masked, so any
//    Sq and Sk work; the TPU kernel required S to divide its blocks.
//  * Causal: a block stops at the K tile past its last row.  On such a
//    tile _kernel leaves m, l and acc unchanged (alpha = 1, p = 0), so
//    the skip is exact.  The heaviest q tiles are launched first.
//  * GQA: q head h reads kv head h / G, the (Hkv, G) grouping of the
//    JAX package.  q, k, v and o are read and written through strides
//    (last dim contiguous), so (B, S, H, d) tensors need no copy.
//
// Precision: q, k and v are converted to f32 on load; scores, stats,
// p and the accumulator are f32, as the reference computes them; the
// output is rounded once to the input type (f32 or bf16).
//
// Bound on this card: at the serving shape (B 8, H 16, Hkv 8, S 512,
// d 128, bf16, causal) the bytes (q, k, v, o once: 50 MB, 0.015 ms at
// 3.35 TB/s) bound it, the 8.6 GFLOP at the bf16 tensor-core rate taking
// 0.009 ms.  This kernel uses the f32 CUDA cores (67 TFLOP/s), so it is
// bound by operations far above either; tensor cores (mma / wgmma), TMA
// and a bf16 P.V are the redesign's work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;               // q rows per block
constexpr int kBN = 64;               // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Element strides of a (B, heads, S, d) operand; its last dim is dense.
struct Strides {
  long long b, h, s;
};

template <int D>
constexpr int smem_floats() {
  return kBM * (D + 4) + kBN * (D + 1) + kBN * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int G, int Sq,
             int Sk, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, bool causal) {
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * QP + c] =
        q0 + r < Sq ? to_f32(qb[(long long)(q0 + r) * qs.s + c]) : 0.f;
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
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();                  // Q stored; last tile's reads done
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      const long long row = k0 + r;
      Ks[r * KP + c] = in ? to_f32(kb[row * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[row * vs.s + c]) : 0.f;
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
        valid[j] = kp < Sk && (!causal || qp >= kp);
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
    T* orow = o + b * os.b + h * os.h + (long long)qp * os.s + tx;
#pragma unroll
    for (int c = 0; c < CJ; ++c) store(orow + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int G, int Sq, int Sk, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   bool causal, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), G, Sq, Sk, qs, ks, vs,
      os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int G, int Sq, int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, bool causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, G, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, G, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, G, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o[b, h, :Sq, :d] = attention of q[b, h] over k[b, h / G], v[b, h / G]
// with G = H / Hkv.  dtype 0 = f32, 1 = bf16 (q, k, v and o alike); d one
// of 16, 32, 64, 128; strides in elements, the last dim contiguous.
// `device` is the CUDA ordinal the tensors and `stream` belong to.
// Returns the cudaError_t of the launch.
int ciao_flash_attention(int device, int dtype, int d, const void* q,
                         const void* k, const void* v, void* o, int B,
                         int H, int Hkv, int Sq, int Sk, long long qsb,
                         long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb,
                         long long vsh, long long vss, long long osb,
                         long long osh, long long oss, float scale,
                         int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const int G = H / Hkv;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, B, H, G, Sq, Sk, qs, ks, vs, os,
                             scale, causal != 0, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                                     vs, os, scale, causal != 0, st);
  return cudaErrorInvalidValue;
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
