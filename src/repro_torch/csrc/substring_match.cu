// The split pushdown path's pattern-set matcher: one pattern set over a
// chunk (kernel D).  The key-value matcher, kernel E, is key_value.cu.
//
// Replaces the TPU kernel src/repro/kernels/substring_match.py::
// multi_match_any (body _multi_match_kernel).  Same function, other shape:
//
//  * one warp per record, kWarps records per block, each record staged in
//    shared memory (read in place when kWarps rows of the stride do not
//    fit); the lanes stride over window start positions and __any_sync
//    reduces the verdict, so a window is a direct compare at j, not the
//    TPU's chain of static shifts;
//  * the pattern table sits in shared memory; the first pattern byte
//    rejects almost every start, as the TPU's block-level prefilter did.
//
// Bound on this card: it reads the chunk once (R*L bytes) and writes one
// byte per (pattern, record), a few microseconds at 3.35 TB/s for a 3 MB
// chunk.  The compares, not the bytes, set the time: every start position
// of every record is tested, which staging keeps on shared memory.
//
// Semantics held to the JAX package: bytes past the stride read as zero;
// the first pattern byte is always compared, so an empty pattern (length
// 0) matches exactly the records that hold a zero byte; a pattern longer
// than the table's width M is compared on its first M bytes.

#include <cstdint>
#include <mutex>
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

constexpr int kMaxDevices = 64;
std::mutex g_mutex;
int g_limit[kMaxDevices];           // opt-in shared memory per block
int g_opted[kMaxDevices];           // dynamic shared memory opted in so far

// Make `device` current, opt in to `smem` bytes of dynamic shared memory
// for kernel D (the limit is queried, and the attribute set, once per
// device and larger size) and say whether kWarps records of the stride
// fit beside `fixed` bytes.
cudaError_t prepare(int device, int fixed, int L, int* smem, bool* staged) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_limit[device]) {
    err = cudaDeviceGetAttribute(
        &g_limit[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
  }
  const int limit = g_limit[device];
  if (fixed > limit) return cudaErrorInvalidValue;
  *staged = (long long)fixed + (long long)kWarps * L <= limit;
  *smem = fixed + (*staged ? kWarps * L : 0);
  if (*smem <= g_opted[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      multi_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess) g_opted[device] = *smem;
  return err;
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
  cudaError_t err =
      prepare(device, ciao_match_smem_bytes(P, M), L, &smem, &staged);
  if (err != cudaSuccess) return err;
  multi_match_kernel<<<(R + kWarps - 1) / kWarps, kWarps * 32, smem,
                       (cudaStream_t)stream>>>(data, R, L, patterns, M, plens,
                                               P, out, staged);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
