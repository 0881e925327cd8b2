// AND and OR over the rows of packed bitvectors, and the popcount of the
// AND: the split path's load mask and the host scanner's AND-reduce hook.
//
// Replaces the TPU kernel src/repro/kernels/bitvector_ops.py::
// bitvector_reduce (body _reduce_kernel).  Same function, other shape.
//
// Bound on this card: bytes.  It reads P*W*4 and writes 2*W*4 + 4 bytes
// once each at 3.35 TB/s.  At the path's shapes (P 1-12 rows of about
// 256 words) that is well under a microsecond, so the launch and the
// calls around it set the time.  So the design spends as little as it
// can around the work:
//
//  * one launch per call and no memset: up to the one-block width (the
//    wrapper's ONE_BLOCK_WORDS, 8,192 words) a single block does the
//    whole reduction and stores the count itself; nobody adds into a
//    count that someone else zeroed;
//  * one output buffer, uint32[2W + 1] = [AND words | OR words | count],
//    so the host brings the result back in one copy;
//  * above the one-block width, where bytes set the time, a grid of
//    blocks (grid-stride; the wrapper sizes it) writes one partial count
//    per block after the buffer's count word, and a second one-block
//    launch sums them: exact in any block order, safe on any stream,
//    no ticket to reset and no atomics at all;
//  * a block's count: __popc per thread, __reduce_add_sync per warp, the
//    warp sums in shared memory, one store;
//  * 16-byte loads: when every row shares the base's alignment (P == 1
//    or W % 4 == 0) a thread reads one uint4 per row, after a scalar
//    head of 0-3 words up to the first 16-byte boundary of row 0 (any
//    4-byte-aligned base, e.g. the row slice t[1:] of a contiguous
//    tensor), and a scalar tail of 0-3 words; otherwise four words a
//    thread, a block's width apart, with scalar loads (that route alone
//    takes 45% longer at P=12, W=256; PERF.md, kernel C);
//  * each thread issues the loads of G rows (G = 2, 4, 8, 16 by P) before
//    it combines any, so their latencies overlap.
//
// The TPU kernel's 128-word tiles and its per-tile counts summed outside
// the kernel are not carried over; W needs no padding.
//
// The wrapper (kernels/bitvector_ops.py) picks the block size and the
// number of blocks; the kernel reads both from its launch.
//
// ciao_noop launches an empty kernel of a given block size: the launch
// floor C is measured against (chip_smoke.py).  No path launches it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The widest block a launch may use.  Two such blocks per SM cap the
// registers at 128 a thread.
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void combine(uint4 v, uint4& a, uint4& o) {
  a.x &= v.x; a.y &= v.y; a.z &= v.z; a.w &= v.w;
  o.x |= v.x; o.y |= v.y; o.z |= v.z; o.w |= v.w;
}

__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// AND and OR over the P rows of x[0], x[stride], ... (uint4 elements);
// G loads in flight before the first is combined.
template <int G>
__device__ __forceinline__ void rows_vec(const uint4* __restrict__ x,
                                         size_t stride, int P, uint4& a,
                                         uint4& o) {
  a = make_uint4(kFull, kFull, kFull, kFull);
  o = make_uint4(0, 0, 0, 0);
  for (int p0 = 0; p0 < P; p0 += G) {
    uint4 v[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (p0 + g < P) v[g] = __ldg(x + (size_t)(p0 + g) * stride);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (p0 + g < P) combine(v[g], a, o);
  }
}

// The same over four words of each row, `step` words apart.
template <int G>
__device__ __forceinline__ void rows_words(const uint32_t* __restrict__ x,
                                           size_t stride, int P, int step,
                                           int n, uint4& a, uint4& o) {
  a = make_uint4(kFull, kFull, kFull, kFull);
  o = make_uint4(0, 0, 0, 0);
  for (int p0 = 0; p0 < P; p0 += G) {
    uint32_t v[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[g][j] = (p0 + g < P && j < n)
                      ? __ldg(x + (size_t)(p0 + g) * stride + j * step)
                      : 0u;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (p0 + g < P) combine(make_uint4(v[g][0], v[g][1], v[g][2], v[g][3]),
                              a, o);
  }
}

__device__ __forceinline__ void store4(uint32_t* p, uint4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

// Sum of `bits` over the block (whole warps), valid in thread 0.
__device__ __forceinline__ unsigned block_sum(unsigned bits) {
  __shared__ unsigned warp_bits[kMaxThreads / 32];
  bits = __reduce_add_sync(kFull, bits);        // every lane reaches this
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  unsigned total = 0;
  if (threadIdx.x < 32) {
    total = __reduce_add_sync(
        kFull, threadIdx.x < (blockDim.x >> 5) ? warp_bits[threadIdx.x] : 0u);
  }
  return total;
}

// out = [AND W | OR W | count | partials, one per block when gridDim.x > 1].
// kVec: rows share the base's alignment; `head` words (0-3, <= W) precede
// row 0's first 16-byte boundary.
template <int G, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
bitvector_reduce_kernel(const uint32_t* __restrict__ bv, int P, int W,
                        int head, uint32_t* __restrict__ out) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  uint32_t* and_w = out;
  uint32_t* or_w = out + W;
  const size_t stride = (size_t)W;              // words between rows
  unsigned bits = 0;
  uint4 a, o;
  if constexpr (kVec) {
    const int nvec = (W - head) >> 2;
    const uint4* body = reinterpret_cast<const uint4*>(bv + head);
    const bool and_vec = (reinterpret_cast<uintptr_t>(and_w + head) & 15) == 0;
    const bool or_vec = (reinterpret_cast<uintptr_t>(or_w + head) & 15) == 0;
    for (int c = blockIdx.x * nt + t; c < nvec; c += gridDim.x * nt) {
      rows_vec<G>(body + c, stride >> 2, P, a, o);
      store4(and_w + head + 4 * c, a, and_vec);
      store4(or_w + head + 4 * c, o, or_vec);
      bits += popc4(a);
    }
    // the head (threads 0-3) and the tail (threads 4-7), block 0 alone
    const int w = t < 4 ? t : head + 4 * nvec + (t - 4);
    if (blockIdx.x == 0 && t < 8 && (t < 4 ? t < head : w < W)) {
      rows_words<G>(bv + w, stride, P, 0, 1, a, o);
      and_w[w] = a.x;
      or_w[w] = o.x;
      bits += __popc(a.x);
    }
  } else {
    for (int s = blockIdx.x * 4 * nt; s < W; s += gridDim.x * 4 * nt) {
      const int w = s + t;
      const int n = w >= W ? 0 : min(4, (W - w + nt - 1) / nt);
      if (n == 0) continue;
      rows_words<G>(bv + w, stride, P, nt, n, a, o);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < n) {
          and_w[w + j * nt] = av[j];
          or_w[w + j * nt] = ov[j];
          bits += __popc(av[j]);
        }
      }
    }
  }
  const unsigned total = block_sum(bits);
  if (t == 0)
    out[2 * (size_t)W + (gridDim.x > 1 ? 1 + blockIdx.x : 0)] = total;
}

// out[2W] = the sum of the n partial counts after it.
__global__ void __launch_bounds__(kMaxThreads)
bitvector_partials_sum_kernel(uint32_t* __restrict__ out, int W, int n) {
  const uint32_t* partials = out + 2 * (size_t)W + 1;
  unsigned bits = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) bits += partials[i];
  const unsigned total = block_sum(bits);
  if (threadIdx.x == 0) out[2 * (size_t)W] = total;
}

__global__ void noop_kernel() {}

template <int G>
cudaError_t launch(bool vec, const uint32_t* bv, int P, int W, int head,
                   int blocks, int threads, uint32_t* out,
                   cudaStream_t stream) {
  if (vec)
    bitvector_reduce_kernel<G, true><<<blocks, threads, 0, stream>>>(
        bv, P, W, head, out);
  else
    bitvector_reduce_kernel<G, false><<<blocks, threads, 0, stream>>>(
        bv, P, W, head, out);
  return cudaGetLastError();
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

extern "C" {

// bv: uint32[P, W] row-major at any 4-byte-aligned address, P >= 1.
// out: uint32[2W + 1 + (blocks > 1 ? blocks : 0)], written in full by
// the launch(es); [AND | OR | count] are its first 2W + 1 words.  A block
// is `threads` threads, whole warps, at most 256.  One launch when
// blocks == 1, two otherwise.  Returns the cudaError_t of the launches.
int ciao_bitvector_reduce(int device, const uint32_t* bv, int P, int W,
                          int blocks, int threads, uint32_t* out,
                          void* stream) {
  if (P < 1 || W < 0 || blocks < 1 || !valid_threads(threads))
    return cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(bv);
  if (addr & 3) return cudaErrorMisalignedAddress;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const bool vec = P == 1 || W % 4 == 0;
  const int lead = (int)((16 - (addr & 15)) & 15) / 4;   // words to 16 B
  const int head = vec ? (lead < W ? lead : W) : 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = threads;
  err = P <= 2   ? launch<2>(vec, bv, P, W, head, blocks, n, out, s)
        : P <= 4 ? launch<4>(vec, bv, P, W, head, blocks, n, out, s)
        : P <= 8 ? launch<8>(vec, bv, P, W, head, blocks, n, out, s)
                 : launch<16>(vec, bv, P, W, head, blocks, n, out, s);
  if (err != cudaSuccess || blocks == 1) return err;
  bitvector_partials_sum_kernel<<<1, threads, 0, s>>>(out, W, blocks);
  return cudaGetLastError();
}

// The launch floor: an empty kernel, one block of `threads` threads.
int ciao_noop(int device, int threads, void* stream) {
  if (!valid_threads(threads)) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  noop_kernel<<<1, threads, 0, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
