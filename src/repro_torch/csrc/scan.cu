// Fused multi-query COUNT scan over the device-resident segment plane.
//
// Replaces the TPU kernel src/repro/kernels/scan_fused.py::_scan_core_pallas
// (body _scan_kernel).  Per row and term it evaluates PRESENCE, EXACT,
// SUBSTRING (LUT probed by string code) or KEY_VALUE (repr code, numeric
// repr codes, null, bool compatibility); terms OR into clauses, clauses
// AND into queries, then the pushed-bit test (cw & ptab) == ptab and the
// zone verdict `active` apply; counts and pushed candidates are summed
// per (query, slot).
//
// What the TPU shape needed and this one drops: the f32 one-hot matmuls
// that stood in for gathers on the matrix unit, and the 16-bit split of
// the pushed words that kept them exact in f32.  Here:
//
//  * one thread per row (grid-stride), reading plane[key_ids[t], row]
//    directly — consecutive threads read consecutive rows, so the plane
//    loads coalesce; the per-(term, slot) parameters are direct gathers;
//  * term bits live in registers; membership and query_clause arrive as
//    bit masks (packed on the host) held in shared memory; a clause is
//    (termbits & mem[c]) != 0, a query (qc[q] & ~clausebits) == 0;
//  * counts: rows of a segment are contiguous, so a warp mostly holds one
//    slot.  __match_any_sync groups lanes by slot, __popc of a ballot
//    counts each group, and one atomicAdd per (warp, query, slot) adds it
//    (the TPU summed across its sequential grid steps instead).  Integer
//    atomics are exact in any order.
//
// Bound on this card: the bytes of the plane rows the batch's terms read
// (1-4 bytes per row per term, plus the row's slot id and clause word)
// over 3.35 TB/s.  Per row the kernel reads each needed plane cell once
// and does O(T + C*T/32 + Q*C/32) register work, so at large query
// batches the per-row query loop, not the bytes, sets its time.
//
// Padding rows (sid < 0) count toward slot S1-1, whose `active` is 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;        // T, C <= 256: 8 words of 32 bits each
constexpr unsigned kFull = 0xFFFFFFFFu;

enum { kPresence = 0, kExact = 1, kSubstring = 2, kKeyValue = 3 };

struct Plane {
  const uint8_t *pres, *notn, *isb, *numv;
  const int32_t *scod, *rcod, *sid;
  const uint32_t* cw;
  long long N;
};

struct Params {
  const int32_t *key_ids, *kinds, *code_a, *num_codes, *lut_off;
  const uint8_t *lut_flat, *is_null, *is_boolv;
  const uint32_t *mem_bits, *qc_bits, *pushed_tbl;
  const uint8_t* active;
  int T, C, Q, S1, L;
};

__device__ __forceinline__ bool term_hit(const Plane& pl, const Params& pm,
                                         int t, int kind, int key,
                                         long long row, int s) {
  const long long off = (long long)key * pl.N + row;
  const int ts = t * pm.S1 + s;
  switch (kind) {
    case kPresence:
      return pl.notn[off] != 0;
    case kExact:
      return pl.scod[off] == __ldg(pm.code_a + ts);
    case kSubstring: {
      const int lo = __ldg(pm.lut_off + ts);
      int idx = lo + 1 + pl.scod[off];
      idx = idx < 0 ? 0 : (idx > pm.L - 1 ? pm.L - 1 : idx);
      return lo >= 0 && __ldg(pm.lut_flat + idx) != 0;
    }
    case kKeyValue: {
      const bool tp = pl.pres[off] != 0, tn = pl.notn[off] != 0;
      const bool tb = pl.isb[off] != 0, tv = pl.numv[off] != 0;
      const int tr = pl.rcod[off];
      const int base = t * 3 * pm.S1 + s;
      const bool m_num = tv && (__ldg(pm.num_codes + base) == tr ||
                                __ldg(pm.num_codes + base + pm.S1) == tr ||
                                __ldg(pm.num_codes + base + 2 * pm.S1) == tr);
      const bool m_null = pm.is_null[t] && tp && !tn;
      const bool compat = pm.is_boolv[t] ? tb : (tp && !tb);
      return (tr == __ldg(pm.code_a + ts) || m_num || m_null) && compat;
    }
    default:
      return false;                 // bucket padding: inert
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(Plane pl, Params pm, int32_t* __restrict__ counts,
            int32_t* __restrict__ cands) {
  extern __shared__ uint32_t smem[];
  const int TW = (pm.T + 31) / 32, CW = (pm.C + 31) / 32;
  uint32_t* mem = smem;                         // [C][TW]
  uint32_t* qc = mem + pm.C * TW;               // [Q][CW]
  int32_t* key = (int32_t*)(qc + pm.Q * CW);    // [T]
  int32_t* kind = key + pm.T;                   // [T]
  for (int i = threadIdx.x; i < pm.C * TW; i += blockDim.x)
    mem[i] = pm.mem_bits[i];
  for (int i = threadIdx.x; i < pm.Q * CW; i += blockDim.x)
    qc[i] = pm.qc_bits[i];
  for (int i = threadIdx.x; i < pm.T; i += blockDim.x) {
    key[i] = pm.key_ids[i];
    kind[i] = pm.kinds[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  for (long long base = (long long)blockIdx.x * kThreads; base < pl.N;
       base += (long long)gridDim.x * kThreads) {
    const long long row = base + threadIdx.x;
    const bool in = row < pl.N;
    int s = in ? pl.sid[row] : -1;
    if (s < 0) s = pm.S1 - 1;
    const uint32_t w = in ? pl.cw[row] : 0u;

    uint32_t tb[kMaxWords];
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      uint32_t bits = 0;
      if (in && k < TW) {
        const int n = min(32, pm.T - k * 32);
        for (int b = 0; b < n; ++b) {
          const int t = k * 32 + b;
          if (term_hit(pl, pm, t, kind[t], key[t], row, s)) bits |= 1u << b;
        }
      }
      tb[k] = bits;
    }
    uint32_t cb[kMaxWords];
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      uint32_t bits = 0;
      if (k < CW) {
        const int n = min(32, pm.C - k * 32);
        for (int b = 0; b < n; ++b) {
          const uint32_t* m = mem + (k * 32 + b) * TW;
          uint32_t any = 0;
#pragma unroll
          for (int j = 0; j < kMaxWords; ++j)
            if (j < TW) any |= tb[j] & m[j];
          if (any) bits |= 1u << b;
        }
      }
      cb[k] = bits;
    }

    const unsigned peers = __match_any_sync(kFull, s);
    const bool leader = (__ffs(peers) - 1) == lane;
    for (int q = 0; q < pm.Q; ++q) {
      const uint32_t* need = qc + q * CW;
      uint32_t viol = 0;
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k)
        if (k < CW) viol |= need[k] & ~cb[k];
      const int qs = q * pm.S1 + s;
      const uint32_t ptab = __ldg(pm.pushed_tbl + qs);
      const bool pa = in && (w & ptab) == ptab && __ldg(pm.active + qs) != 0;
      const bool hit = pa && viol == 0;
      const unsigned hb = __ballot_sync(kFull, hit);
      const unsigned pb = __ballot_sync(kFull, pa);
      if (leader) {
        const int nh = __popc(hb & peers), np = __popc(pb & peers);
        if (nh) atomicAdd(counts + qs, nh);
        if (np) atomicAdd(cands + qs, np);
      }
    }
  }
}

}  // namespace

extern "C" {

int ciao_scan_max_words() { return kMaxWords; }

int ciao_scan_smem_bytes(int T, int C, int Q) {
  const int TW = (T + 31) / 32, CW = (C + 31) / 32;
  return 4 * (C * TW + Q * CW + 2 * T);
}

// `counts` and `cands` (int32[Q, S1]) must arrive zeroed; `mem_bits` is
// uint32[C, ceil(T/32)] and `qc_bits` uint32[Q, ceil(C/32)], little-endian
// bit masks; `device` is the CUDA ordinal the tensors and `stream` belong
// to.  Returns the cudaError_t of the launch.
int ciao_scan(int device, const uint8_t* pres, const uint8_t* notn, const uint8_t* isb,
              const uint8_t* numv, const int32_t* scod, const int32_t* rcod,
              const int32_t* sid, const uint32_t* cw, long long N,
              const int32_t* key_ids, const int32_t* kinds,
              const int32_t* code_a, const int32_t* num_codes,
              const int32_t* lut_off, const uint8_t* lut_flat, int L,
              const uint8_t* is_null, const uint8_t* is_boolv,
              const uint32_t* mem_bits, const uint32_t* qc_bits,
              const uint32_t* pushed_tbl, const uint8_t* active, int T, int C,
              int Q, int S1, int n_blocks, int32_t* counts, int32_t* cands,
              void* stream) {
  if (N == 0 || Q == 0) return 0;
  if (T > 32 * kMaxWords || C > 32 * kMaxWords) return cudaErrorInvalidValue;
  Plane pl{pres, notn, isb, numv, scod, rcod, sid, cw, N};
  Params pm{key_ids, kinds, code_a, num_codes, lut_off, lut_flat, is_null,
            is_boolv, mem_bits, qc_bits, pushed_tbl, active, T, C, Q, S1, L};
  const long long need = (N + kThreads - 1) / kThreads;
  const int grid = (int)(need < n_blocks ? need : n_blocks);
  const int smem = ciao_scan_smem_bytes(T, C, Q);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(pl, pm, counts,
                                                              cands);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
