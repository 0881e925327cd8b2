// The split pushdown path's key-value matcher: one key-value predicate over
// a chunk (kernel E).
//
// Replaces the TPU kernel src/repro/kernels/substring_match.py::
// key_value_match (body _key_value_kernel, whose _segmented_suffix_any is
// a flip + segmented associative scan).  Same function, other shape:
//
//  * a block of 16 warps takes 32 records, one per warp at a time, staged
//    in shared memory with 16-byte loads where the rows allow it (4-byte
//    or 1-byte loads otherwise; any stride runs), each followed by zeros,
//    so bytes past the stride read as zero; rows too wide to stage are
//    read in place.  The key and value go to shared memory as 32-bit words
//    once per block;
//  * the key search: lane i covers positions base + 4i .. base + 4i + 3 of
//    each 128-position block; the key's first 4 bytes, each repeated
//    across a word, flag candidate starts 4 at a time, and only they run
//    the full compare (4 bytes per compare, sliding words);
//  * the TPU's suffix scan becomes a carry chain.  From a key end e, 32
//    positions a ballot, M = positions that are not ',' or '}' (all of
//    them when unbounded) and reach[x] = M[x] & (x == e | reach[x - 1]),
//    the carry out of bit x of M + (bit e & M): reach = ((M + S) ^ M ^ S)
//    >> 1, one carry bit handed to the next word.  The record matches iff
//    a value window starts on a reach position (the first value start
//    after a key end comes before the first delimiter), so the value is
//    tested there alone.  Key ends are walked in position order and one
//    inside a stretch already walked is skipped: O(L) per record however
//    many keys it holds.
//
// This is the search and the carry chain of the pushdown kernel
// (pushdown.cu), written out again: shared through one inline function, a
// walk of the earlier kernels slowed the pushdown kernel down 3x
// (PERF.md).
//
// Bound on this card: the chunk is read once (R*L bytes) and one byte per
// record written, about a microsecond for a 3 MB chunk; the launch,
// staging and the key search set the time.
//
// Semantics held to the plain version (ref.key_value_match_ref): bytes
// past the stride read as zero; a key end lies below L; mk, mv >= 1 (the
// wrapper refuses empty patterns).

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kRecs = 32;           // records per block, two per warp
// zero bytes staged past the last 128-position block of each record
constexpr int kPad = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// the record in shared memory, 4-byte aligned, zero from L to Lp
struct Staged {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t word(int at) const {  // at % 4 == 0
    return w[at >> 2];
  }
  __device__ __forceinline__ uint32_t bytes4(int x) const {
    return __funnelshift_r(w[x >> 2], w[(x >> 2) + 1], (x & 3) * 8);
  }
  __device__ __forceinline__ uint32_t byte(int x) const {
    return reinterpret_cast<const uint8_t*>(w)[x];
  }
};

// the record read in place from device memory, zeros from L on
struct InPlace {
  const uint8_t* p;
  int L;
  __device__ __forceinline__ uint32_t byte(int x) const {
    return x < L ? __ldg(p + x) : 0u;
  }
  __device__ __forceinline__ uint32_t bytes4(int x) const {
    return byte(x) | byte(x + 1) << 8 | byte(x + 2) << 16 | byte(x + 3) << 24;
  }
  __device__ __forceinline__ uint32_t word(int at) const { return bytes4(at); }
};

// rec[x, x + m) == pattern, 4 bytes per compare; 0 <= x < L, m >= 1.
// Inside the row the words slide (one load per 4 bytes); a window that
// runs past L compares zeros there.
template <class Rd>
__device__ __forceinline__ bool window_eq(const Rd& rd, int x, int L,
                                          const uint32_t* pw, int m) {
  if (x + m <= L) {
    const int sh = (x & 3) * 8;
    int at = x & ~3;
    uint32_t lo = rd.word(at);
    int c = 0;
    for (; c + 4 <= m; c += 4) {
      const uint32_t hi = rd.word(at += 4);
      if (__funnelshift_r(lo, hi, sh) != pw[c >> 2]) return false;
      lo = hi;
    }
    return c == m || ((__funnelshift_r(lo, rd.word(at + 4), sh) ^ pw[c >> 2]) &
                      ((1u << (8 * (m - c))) - 1u)) == 0;
  }
  for (int c = 0; c < m; c += 4) {
    const uint32_t s = x + c < L ? rd.bytes4(x + c) : 0u;
    const uint32_t mask = m - c >= 4 ? kFull : (1u << (8 * (m - c))) - 1u;
    if ((s ^ pw[c >> 2]) & mask) return false;
  }
  return true;
}

// The walk from one key end e, 32 positions a ballot: reach (the header
// comment's carry chain) runs from e through positions that are not
// delimiters, and the value is tested where reach is set.  Returns the
// first position at or after e that reach did not get to (a delimiter or
// L), or -1 once the value hit.
template <class Rd>
__device__ int walk(const Rd& rd, int L, int e, const uint32_t* val, int mv,
                    bool unbounded, int lane) {
  uint32_t carry = 0;
  for (int w = e >> 5; 32 * w < L; ++w) {
    const int x = 32 * w + lane;
    bool open = x < L;
    if (!unbounded && open) {
      const uint32_t b = rd.byte(x);
      open = b != ',' && b != '}';
    }
    const uint32_t M = __ballot_sync(kFull, open);
    const uint32_t from = w == (e >> 5) ? (e & 31) : 0;
    const uint32_t S = w == (e >> 5) ? (1u << from) & M : 0u;
    const uint64_t sum = (uint64_t)M + S + carry;
    const uint32_t reach = (uint32_t)((sum ^ M ^ S) >> 1);
    if (reach && __any_sync(kFull, ((reach >> lane) & 1u) &&
                                       window_eq(rd, x, L, val, mv)))
      return -1;
    carry = reach >> 31;
    if (!carry) return 32 * w + __ffs(~reach & (kFull << from)) - 1;
  }
  return L;
}

// Lane i covers positions base + 4i .. base + 4i + 3 of each 128-position
// block: the key's first N = min(mk, 4) bytes, each repeated across a word,
// give 0x80 in byte k where a key may start at base + 4i + k (exact where
// none does; a byte just above a true one may be flagged too), and only
// those run the full compare.  Key ends are then walked in position order;
// an end inside a stretch already walked adds nothing (its reach is a
// suffix of the earlier one), so each position is walked at most once and
// a record costs O(L) however many keys it holds.
template <int N, class Rd>
__device__ bool key_value(const Rd& rd, int L, const uint32_t* key, int mk,
                          const uint32_t* val, int mv, bool unbounded,
                          int lane) {
  const uint32_t b0 = __byte_perm(key[0], 0, 0x0000);
  const uint32_t b1 = __byte_perm(key[0], 0, 0x1111);
  const uint32_t b2 = __byte_perm(key[0], 0, 0x2222);
  const uint32_t b3 = __byte_perm(key[0], 0, 0x3333);
  int done = 0;                     // positions below were walked already
  for (int base = 0; base < L; base += 128) {
    const int at = base + 4 * lane;
    const uint32_t lo = rd.word(at), hi = rd.word(at + 4);
    uint32_t x = lo ^ b0;
    if (N > 1) x |= __funnelshift_r(lo, hi, 8) ^ b1;
    if (N > 2) x |= __funnelshift_r(lo, hi, 16) ^ b2;
    if (N > 3) x |= __funnelshift_r(lo, hi, 24) ^ b3;
    uint32_t c = (x - 0x01010101u) & ~x & 0x80808080u;
    uint32_t starts = 0;            // bit k: a key starts at at + k
    while (c) {
      const int k = (__ffs(c) - 1) >> 3;
      c &= c - 1;
      if (at + k + mk < L && window_eq(rd, at + k, L, key, mk))
        starts |= 1u << k;
    }
    for (uint32_t lanes = __ballot_sync(kFull, starts != 0); lanes;
         lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (uint32_t h = __shfl_sync(kFull, starts, src); h; h &= h - 1) {
        const int e = base + 4 * src + __ffs(h) - 1 + mk;
        if (e < done) continue;
        done = walk(rd, L, e, val, mv, unbounded, lane);
        if (done < 0) return true;
      }
    }
  }
  return false;
}

template <class Rd>
__device__ bool match_record(const Rd& rd, int L, const uint32_t* key, int mk,
                             const uint32_t* val, int mv, bool unbounded,
                             int lane) {
  switch (mk) {
    case 1: return key_value<1>(rd, L, key, mk, val, mv, unbounded, lane);
    case 2: return key_value<2>(rd, L, key, mk, val, mv, unbounded, lane);
    case 3: return key_value<3>(rd, L, key, mk, val, mv, unbounded, lane);
    default: return key_value<4>(rd, L, key, mk, val, mv, unbounded, lane);
  }
}

// rows [r0, r0 + n) of the chunk into `recs` (stride Lp), zero-filled from
// L; `vec` is the widest load the rows' alignment allows (16, 4 or 1)
__device__ void stage_rows(const uint8_t* data, int L, int r0, int n,
                           uint8_t* recs, int Lp, int vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec == 16) {
    const int u = L / 16, up = Lp / 16;
    const uint4* src = reinterpret_cast<const uint4*>(data + (size_t)r0 * L);
    for (int i = tid; i < n * up; i += nt) {
      const int row = i / up, col = i - row * up;
      reinterpret_cast<uint4*>(recs)[i] =
          col < u ? __ldg(src + (size_t)row * u + col) : make_uint4(0, 0, 0, 0);
    }
  } else if (vec == 4) {
    const int u = L / 4, up = Lp / 4;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(data + (size_t)r0 * L);
    for (int i = tid; i < n * up; i += nt) {
      const int row = i / up, col = i - row * up;
      reinterpret_cast<uint32_t*>(recs)[i] =
          col < u ? __ldg(src + (size_t)row * u + col) : 0u;
    }
  } else {
    const uint8_t* src = data + (size_t)r0 * L;
    for (int i = tid; i < n * Lp; i += nt) {
      const int row = i / Lp, col = i - row * Lp;
      recs[i] = col < L ? __ldg(src + (size_t)row * L + col) : 0;
    }
  }
}

// bytes [0, m) of `src` as little-endian words, zero-padded
__device__ void stage_pattern(const uint8_t* src, int m, uint32_t* dst) {
  for (int i = threadIdx.x; 4 * i < m; i += blockDim.x) {
    uint32_t w = 0;
    for (int b = 0; b < 4 && 4 * i + b < m; ++b)
      w |= (uint32_t)__ldg(src + 4 * i + b) << (8 * b);
    dst[i] = w;
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2)
key_value_kernel(const uint8_t* __restrict__ data, int R, int L,
                 const uint8_t* __restrict__ key, int mk,
                 const uint8_t* __restrict__ val, int mv, bool unbounded,
                 uint8_t* __restrict__ out, int vec, int Lp) {
  extern __shared__ uint4 smem[];
  uint32_t* kw = reinterpret_cast<uint32_t*>(smem);
  uint32_t* vw = kw + (mk + 3) / 4;
  const int pat_words = ((mk + 3) / 4 + (mv + 3) / 4 + 3) & ~3;
  uint8_t* recs = reinterpret_cast<uint8_t*>(kw + pat_words);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kRecs;
  const int n = min(kRecs, R - r0);

  stage_pattern(key, mk, kw);
  stage_pattern(val, mv, vw);
  if (vec) stage_rows(data, L, r0, n, recs, Lp, vec);
  __syncthreads();

  for (int j = warp; j < n; j += kWarps) {
    const bool hit =
        vec ? match_record(
                  Staged{reinterpret_cast<const uint32_t*>(recs + j * Lp)}, L,
                  kw, mk, vw, mv, unbounded, lane)
            : match_record(InPlace{data + (size_t)(r0 + j) * L, L}, L, kw, mk,
                           vw, mv, unbounded, lane);
    if (lane == 0) out[r0 + j] = hit;
  }
}

constexpr int kMaxDevices = 64;
std::mutex g_mutex;
int g_limit[kMaxDevices];           // opt-in shared memory per block
int g_opted[kMaxDevices];           // dynamic shared memory opted in so far

// Make `device` current; its opt-in limit into *limit (queried once).
cudaError_t use_device(int device, int* limit) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_limit[device])
    err = cudaDeviceGetAttribute(
        &g_limit[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *limit = g_limit[device];
  return err;
}

// Opt in to `smem` bytes of dynamic shared memory, once per larger size.
cudaError_t opt_in(int device, int smem) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (smem <= g_opted[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      key_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g_opted[device] = smem;
  return err;
}

}  // namespace

extern "C" {

// out uint8[R]; mk, mv >= 1 (the wrapper refuses empty patterns).
// `device` is the CUDA ordinal the tensors and `stream` belong to.
// Returns the cudaError_t of the launch.
int ciao_key_value(int device, const uint8_t* data, int R, int L,
                   const uint8_t* key, int mk, const uint8_t* val, int mv,
                   int unbounded, uint8_t* out, void* stream) {
  if (R == 0) return 0;
  int limit = 0;
  cudaError_t err = use_device(device, &limit);
  if (err != cudaSuccess) return err;
  int smem = 4 * (((mk + 3) / 4 + (mv + 3) / 4 + 3) & ~3);
  if (smem > limit) return cudaErrorInvalidValue;
  const int Lp = ((L + 127) & ~127) + kPad;
  int vec = 0;                      // 0: rows read in place
  if ((long long)smem + (long long)kRecs * Lp <= limit) {
    smem += kRecs * Lp;
    const uintptr_t a = reinterpret_cast<uintptr_t>(data);
    vec = (a % 16 == 0 && L % 16 == 0) ? 16 : (a % 4 == 0 && L % 4 == 0) ? 4 : 1;
  }
  err = opt_in(device, smem);
  if (err != cudaSuccess) return err;
  key_value_kernel<<<(R + kRecs - 1) / kRecs, kWarps * 32, smem,
                     (cudaStream_t)stream>>>(data, R, L, key, mk, val, mv,
                                             unbounded != 0, out, vec, Lp);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
