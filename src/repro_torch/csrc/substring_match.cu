// The split pushdown path's two matchers: one pattern set over a chunk
// (kernel D) and one key-value predicate over a chunk (kernel E).
//
// Replace the TPU kernels src/repro/kernels/substring_match.py::
// multi_match_any (body _multi_match_kernel) and ::key_value_match (body
// _key_value_kernel).  Same functions, other shape:
//
//  * one warp per record, kWarps records per block, each record staged in
//    shared memory (read in place when kWarps rows of the stride do not
//    fit); the lanes stride over window start positions and __any_sync
//    reduces the verdict, so a window is a direct compare at j, not the
//    TPU's chain of static shifts;
//  * D keeps the pattern table in shared memory; the first pattern byte
//    rejects almost every start, as the TPU's block-level prefilter did;
//  * E walks from the end of each key window to the nearest value window
//    and stops at ',' or '}', instead of the TPU's flip + segmented
//    associative scan; the key and value lengths and the unbounded flag
//    are runtime arguments, not compile-time ones.  The walk is the one of
//    the pushdown kernel (pushdown.cu), written out again: shared with it
//    through one inline function, it slowed that kernel down (PERF.md).
//
// Bound on this card: each reads the chunk once (R*L bytes) and writes one
// byte per (pattern, record), a few microseconds at 3.35 TB/s for a
// 3 MB chunk.  The compares, not the bytes, set the time: every start
// position of every record is tested, which staging keeps on shared
// memory.
//
// Semantics held to the JAX package: bytes past the stride read as zero;
// the first pattern byte is always compared, so an empty pattern (length
// 0) matches exactly the records that hold a zero byte; a pattern longer
// than the table's width M is compared on its first M bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // records per block
constexpr unsigned kFull = 0xFFFFFFFFu;

// rec[j, j + m) == pat[0, m), where bytes past the stride read as zero
// (the TPU kernels' zero-filled shifts).
__device__ __forceinline__ bool window_eq_fill(const uint8_t* rec, int L,
                                               int j, const uint8_t* pat,
                                               int m) {
  for (int i = 0; i < m; ++i) {
    const uint8_t b = j + i < L ? rec[j + i] : 0;
    if (b != pat[i]) return false;
  }
  return true;
}

__device__ __forceinline__ bool is_delim(uint8_t b) {
  return b == ',' || b == '}';
}

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

__global__ void __launch_bounds__(kWarps * 32)
multi_match_kernel(const uint8_t* __restrict__ data, int R, int L,
                   const uint8_t* __restrict__ patterns, int M,
                   const int32_t* __restrict__ plens, int P,
                   uint8_t* __restrict__ out, bool staged) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* pats = smem;                                   // [P][M]
  int32_t* lens = reinterpret_cast<int32_t*>(smem + align4(P * M));
  uint8_t* recs = reinterpret_cast<uint8_t*>(lens + P);   // [kWarps][L]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  const bool valid = r < R;                               // warp-uniform

  for (int i = threadIdx.x; i < P * M; i += blockDim.x) pats[i] = patterns[i];
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    lens[i] = min(max(plens[i], 1), M);
  const uint8_t* rec = data + (size_t)r * L;
  if (staged) {
    uint8_t* dst = recs + (size_t)warp * L;
    if (valid)
      for (int i = lane; i < L; i += 32) dst[i] = rec[i];
    rec = dst;
  }
  __syncthreads();
  if (!valid) return;

  for (int p = 0; p < P; ++p) {
    const uint8_t* pat = pats + p * M;
    const int m = lens[p];
    bool mine = false;
    for (int j = lane; j < L && !mine; j += 32)
      mine = rec[j] == pat[0] && window_eq_fill(rec, L, j, pat, m);
    mine = __any_sync(kFull, mine);
    if (lane == 0) out[(size_t)p * R + r] = mine;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
key_value_kernel(const uint8_t* __restrict__ data, int R, int L,
                 const uint8_t* __restrict__ key, int mk,
                 const uint8_t* __restrict__ val, int mv, bool unbounded,
                 uint8_t* __restrict__ out, bool staged) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  const bool valid = r < R;                               // warp-uniform

  const uint8_t* rec = data + (size_t)r * L;
  if (staged) {
    uint8_t* dst = smem + (size_t)warp * L;
    if (valid)
      for (int i = lane; i < L; i += 32) dst[i] = rec[i];
    rec = dst;
  }
  __syncthreads();
  if (!valid) return;

  // a key window at j needs j + mk < L: its value region starts inside
  bool mine = false;
  for (int j = lane; j + mk < L && !mine; j += 32) {
    if (!window_eq_fill(rec, L, j, key, mk)) continue;
    for (int v = j + mk; v < L; ++v) {
      if (!unbounded && is_delim(rec[v])) break;
      if (window_eq_fill(rec, L, v, val, mv)) {
        mine = true;
        break;
      }
    }
  }
  mine = __any_sync(kFull, mine);
  if (lane == 0) out[r] = mine;
}

// Opt in to `smem` bytes of dynamic shared memory for `kernel` and say
// whether kWarps records of the stride fit beside `fixed` bytes.
template <typename K>
cudaError_t prepare(K kernel, int device, int fixed, int L, int* smem,
                    bool* staged) {
  int limit = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (fixed > limit) return cudaErrorInvalidValue;
  *staged = (long long)fixed + (long long)kWarps * L <= limit;
  *smem = fixed + (*staged ? kWarps * L : 0);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

}  // namespace

extern "C" {

// Shared memory of kernel D's pattern table; the wrapper refuses a table
// that exceeds the card's per-block limit.
int ciao_match_smem_bytes(int P, int M) { return align4(P * M) + 4 * P; }

// out uint8[P, R]; `device` is the CUDA ordinal the tensors and `stream`
// belong to.  Returns the cudaError_t of the launch.
int ciao_multi_match(int device, const uint8_t* data, int R, int L,
                     const uint8_t* patterns, int M, const int32_t* plens,
                     int P, uint8_t* out, void* stream) {
  if (R == 0 || P == 0) return 0;
  int smem = 0;
  bool staged = false;
  cudaError_t err = prepare(multi_match_kernel, device,
                            ciao_match_smem_bytes(P, M), L, &smem, &staged);
  if (err != cudaSuccess) return err;
  multi_match_kernel<<<(R + kWarps - 1) / kWarps, kWarps * 32, smem,
                       (cudaStream_t)stream>>>(data, R, L, patterns, M, plens,
                                               P, out, staged);
  return cudaGetLastError();
}

// out uint8[R]; mk, mv >= 1 (the wrapper refuses empty patterns).
int ciao_key_value(int device, const uint8_t* data, int R, int L,
                   const uint8_t* key, int mk, const uint8_t* val, int mv,
                   int unbounded, uint8_t* out, void* stream) {
  if (R == 0) return 0;
  int smem = 0;
  bool staged = false;
  cudaError_t err = prepare(key_value_kernel, device, 0, L, &smem, &staged);
  if (err != cudaSuccess) return err;
  key_value_kernel<<<(R + kWarps - 1) / kWarps, kWarps * 32, smem,
                     (cudaStream_t)stream>>>(data, R, L, key, mk, val, mv,
                                             unbounded != 0, out, staged);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
