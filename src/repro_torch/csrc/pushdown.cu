// Fused pushdown pass: dense JSON chunk -> packed per-clause bitvectors,
// the OR'd load mask and per-clause popcounts, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::clause_bitvectors_fused
// (body _clause_bitvectors_kernel).  Same function, other shape:
//
//  * one block covers 32 consecutive records = one output word; warp w
//    takes record 32*blockIdx.x + w, staged in shared memory (read in
//    place from device memory when 32 records of the stride do not fit);
//  * the lanes of a warp stride over window start positions and
//    __any_sync reduces the hit, so a window is a direct compare at j,
//    not the TPU's chain of static shifts and selects;
//  * a key-value hit walks from the end of a key window to the nearest
//    value hit and stops at the first ',' or '}' (none for an unbounded
//    value), instead of the TPU's flip + associative scan;
//  * per-(clause, record) bits go to shared memory; lane i of a warp
//    holds record 32*word + i, so __ballot_sync IS the little-endian word.
//    The block owns its word of `words` and `or_words` and writes them
//    without atomics; counts[c] gets one atomicAdd(__popc(word)) per
//    block, exact in any block order (the TPU carried the count across
//    its sequential grid steps, which GPU blocks do not have).
//
// Bound on this card: the chunk is read once (R*L bytes, a few MB per
// chunk) at 3.35 TB/s, i.e. a few microseconds.  The kernel is far from
// it: every predicate compares bytes at every start position of every
// record, so its time grows with P*L per record.  Staging each record in
// shared memory keeps those compares off device memory; the first byte
// of a pattern rejects almost every position after one compare.
//
// Semantics held to the JAX package: an empty simple pattern matches
// every valid row; a window or value region that runs past L is false;
// rows >= n_valid are zero; R need not be a multiple of 32; patterns hold
// no zero byte, and 0xFF (a neutralised tier row) never occurs in a chunk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;          // records per block (one output word)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool window_eq(const uint8_t* rec, int j,
                                          const uint8_t* pat, int m) {
  for (int i = 0; i < m; ++i)
    if (rec[j + i] != __ldg(pat + i)) return false;
  return true;
}

__device__ __forceinline__ bool is_delim(uint8_t b) {
  return b == ',' || b == '}';
}

__global__ void __launch_bounds__(kWarps * 32)
pushdown_kernel(const uint8_t* __restrict__ data, int R, int L, int n_valid,
                const uint8_t* __restrict__ keys, int Mk,
                const int32_t* __restrict__ klens,
                const uint8_t* __restrict__ vals, int Mv,
                const int32_t* __restrict__ vlens,
                const int32_t* __restrict__ kinds,
                const int32_t* __restrict__ unbounded,
                const uint8_t* __restrict__ membership, int C, int P,
                uint32_t* __restrict__ words, uint32_t* __restrict__ or_words,
                int32_t* __restrict__ counts, bool staged) {
  extern __shared__ uint8_t smem[];
  uint8_t* cbits = smem;                              // [C][32] clause bits
  uint8_t* recs = smem + C * kWarps;                  // [32][L] if staged
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x;
  const int W = (R + 31) / 32;
  const int r = word * kWarps + warp;
  const bool valid = r < R && r < n_valid;            // warp-uniform

  for (int i = threadIdx.x; i < C * kWarps; i += blockDim.x) cbits[i] = 0;
  const uint8_t* src = data + (size_t)r * L;
  const uint8_t* rec = src;
  if (staged) {
    uint8_t* dst = recs + (size_t)warp * L;
    if (valid)
      for (int i = lane; i < L; i += 32) dst[i] = src[i];
    rec = dst;
  }
  __syncthreads();

  if (valid) {
    for (int p = 0; p < P; ++p) {
      const int mk = klens[p];
      const uint8_t* key = keys + (size_t)p * Mk;
      bool mine = false;
      if (kinds[p] == 0) {
        if (mk == 0) {
          mine = true;
        } else {
          for (int j = lane; j + mk <= L && !mine; j += 32)
            mine = window_eq(rec, j, key, mk);
        }
      } else {
        const int mv = vlens[p];
        const uint8_t* val = vals + (size_t)p * Mv;
        const bool unb = unbounded[p] != 0;
        for (int j = lane; j + mk < L && !mine; j += 32) {
          if (!window_eq(rec, j, key, mk)) continue;
          for (int v = j + mk; v < L; ++v) {
            if (!unb && is_delim(rec[v])) break;
            if (v + mv <= L && window_eq(rec, v, val, mv)) {
              mine = true;
              break;
            }
          }
        }
      }
      if (__any_sync(kFull, mine)) {
        for (int c = lane; c < C; c += 32)
          if (membership[(size_t)c * P + p]) cbits[c * kWarps + warp] = 1;
      }
    }
  }
  __syncthreads();

  for (int c = warp; c < C; c += kWarps) {
    const unsigned w = __ballot_sync(kFull, cbits[c * kWarps + lane] != 0);
    if (lane == 0) {
      words[(size_t)c * W + word] = w;
      if (w) atomicAdd(counts + c, __popc(w));
    }
  }
  if (warp == 0) {
    bool any = false;
    for (int c = 0; c < C; ++c) any |= cbits[c * kWarps + lane] != 0;
    const unsigned w = __ballot_sync(kFull, any);
    if (lane == 0) or_words[word] = w;
  }
}

}  // namespace

extern "C" {

// Shared memory for the clause bits alone; the wrapper refuses a plan
// whose bits exceed the card's per-block limit.
int ciao_pushdown_smem_bytes(int C) { return C * kWarps; }

// `counts` must arrive zeroed; `device` is the CUDA ordinal the tensors
// and `stream` belong to.  Returns the cudaError_t of the launch.
int ciao_pushdown(int device, const uint8_t* data, int R, int L, int n_valid,
                  const uint8_t* keys, int Mk, const int32_t* klens,
                  const uint8_t* vals, int Mv, const int32_t* vlens,
                  const int32_t* kinds, const int32_t* unbounded,
                  const uint8_t* membership, int C, int P, uint32_t* words,
                  uint32_t* or_words, int32_t* counts, void* stream) {
  const int W = (R + 31) / 32;
  if (W == 0 || C == 0) return 0;
  int limit = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  int smem = ciao_pushdown_smem_bytes(C);
  if (smem > limit) return cudaErrorInvalidValue;
  const bool staged = (long long)smem + (long long)kWarps * L <= limit;
  if (staged) smem += kWarps * L;
  err = cudaFuncSetAttribute(
      pushdown_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pushdown_kernel<<<W, kWarps * 32, smem, (cudaStream_t)stream>>>(
      data, R, L, n_valid, keys, Mk, klens, vals, Mv, vlens, kinds, unbounded,
      membership, C, P, words, or_words, counts, staged);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
