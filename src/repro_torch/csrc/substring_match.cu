// The split pushdown path's pattern-set matcher: one pattern set over a
// chunk (kernel D).  The key-value matcher, kernel E, is key_value.cu.
//
// Replaces the TPU kernel src/repro/kernels/substring_match.py::
// multi_match_any (body _multi_match_kernel).  Same function, other shape:
//
//  * one block covers 32 consecutive records; its 16 warps take one
//    record each at a time.  The block stages the records in shared memory
//    with 16-byte loads where the rows allow it (4-byte or 1-byte loads
//    otherwise; any stride and base offset run), each followed by zeros to
//    the next 128-position block and 16 bytes on.  Rows too wide to stage
//    are read in place;
//  * the pattern table sits in shared memory, patterns packed 4 bytes to a
//    word in rows of ceil(M / 4) words, zero-padded;
//  * search: lane i covers positions base + 4i .. base + 4i + 3 of each
//    128-position block.  The pattern's first min(m, 4) bytes, each
//    repeated across a word, are XORed with the record word and its three
//    funnel-shifted neighbours, and a zero-byte test flags the candidate
//    starts 4 at a time; only candidates run the full compare, 4 bytes per
//    compare with sliding words.  A pattern's search stops as soon as the
//    warp finds it.  This replaces the TPU's chain of static shifts and its
//    block-level first-byte prefilter;
//  * the verdicts of a block collect in shared memory, [P][32] bytes, and
//    leave in 32-byte runs of out[p, r0 .. r0 + 32).
//
// Bound on this card: it reads the chunk once (R*L bytes) and writes one
// byte per (pattern, record), a few microseconds at 3.35 TB/s for a 3 MB
// chunk.  With one pattern, the launch and the staging take most of the
// time; with a pool, the compares, about 25 instructions per 128
// positions per pattern without candidates.
//
// Semantics held to the JAX package: bytes past the stride read as zero,
// so a window that starts below L may run past it for up to M - 1 bytes
// (staged rows hold zeros there; rows read in place check bounds); the
// first pattern byte is always compared, so an empty pattern (length 0)
// is one byte long, the padding byte, and matches exactly the records
// that hold a zero byte within L; a pattern longer than the table's width
// M is compared on its first M bytes.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kRecs = 32;           // records per block
constexpr int kWarps = 16;          // two records per warp
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

// A pattern's first N = min(m, 4) bytes, each repeated across a word, so
// one XOR compares a byte at 4 positions.  candidates() gives 0x80 in byte
// k where a window at `at + k` may start: exact where none does (a byte
// just above a true one may be flagged too, and the full compare sorts
// it out); at % 4 == 0.
template <int N>
struct Prefix {
  uint32_t b0, b1, b2, b3;
  template <class Rd>
  __device__ __forceinline__ uint32_t candidates(const Rd& rd, int at) const {
    const uint32_t lo = rd.word(at), hi = rd.word(at + 4);
    uint32_t x = lo ^ b0;
    if (N > 1) x |= __funnelshift_r(lo, hi, 8) ^ b1;
    if (N > 2) x |= __funnelshift_r(lo, hi, 16) ^ b2;
    if (N > 3) x |= __funnelshift_r(lo, hi, 24) ^ b3;
    return (x - 0x01010101u) & ~x & 0x80808080u;
  }
};

template <int N>
__device__ __forceinline__ Prefix<N> prefix(const uint32_t* pw) {
  const uint32_t w = pw[0];
  return Prefix<N>{__byte_perm(w, 0, 0x0000), __byte_perm(w, 0, 0x1111),
                   __byte_perm(w, 0, 0x2222), __byte_perm(w, 0, 0x3333)};
}

// Lane i covers positions base + 4i .. base + 4i + 3 of each 128-position
// block: the prefix flags candidates 4 at a time, and only they run the
// full compare.  Returns (warp-uniform) as soon as a lane finds the
// pattern.
template <int N, class Rd>
__device__ bool occurs(const Rd& rd, int L, const uint32_t* pw, int m,
                       int lane) {
  const Prefix<N> pre = prefix<N>(pw);
  for (int base = 0; base < L; base += 128) {
    const int at = base + 4 * lane;
    uint32_t c = pre.candidates(rd, at);
    bool hit = false;
    while (c && !hit) {
      const int x = at + ((__ffs(c) - 1) >> 3);
      c &= c - 1;
      hit = x < L && window_eq(rd, x, L, pw, m);
    }
    if (__any_sync(kFull, hit)) return true;
  }
  return false;
}

template <class Rd>
__device__ void match_record(const Rd& rd, int L, const uint32_t* pat,
                             int MW, const int32_t* lens, int P,
                             uint8_t* hits, int j, int lane) {
  for (int p = 0; p < P; ++p) {
    const uint32_t* pw = pat + p * MW;
    const int m = lens[p];
    const bool hit = m == 1   ? occurs<1>(rd, L, pw, m, lane)
                     : m == 2 ? occurs<2>(rd, L, pw, m, lane)
                     : m == 3 ? occurs<3>(rd, L, pw, m, lane)
                              : occurs<4>(rd, L, pw, m, lane);
    if (lane == 0) hits[p * kRecs + j] = hit;
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

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// shared memory ahead of the staged records: pattern words, lengths and
// the block's verdicts
__host__ __device__ constexpr int fixed_bytes(int P, int M) {
  return align16(P * 4 * ((M + 3) / 4)) + align16(4 * P) + align16(P * kRecs);
}

__global__ void __launch_bounds__(kWarps * 32, 2)
multi_match_kernel(const uint8_t* __restrict__ data, int R, int L,
                   const uint8_t* __restrict__ patterns, int M,
                   const int32_t* __restrict__ plens, int P,
                   uint8_t* __restrict__ out, int vec, int Lp, int pvec) {
  extern __shared__ uint4 smem[];
  const int MW = (M + 3) / 4;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint32_t* pat = reinterpret_cast<uint32_t*>(base);                // [P][MW]
  int32_t* lens = reinterpret_cast<int32_t*>(base + align16(P * 4 * MW));
  uint8_t* hits = reinterpret_cast<uint8_t*>(lens) + align16(4 * P);  // [P][32]
  uint8_t* recs = base + fixed_bytes(P, M);                         // [32][Lp]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kRecs;
  const int n = min(kRecs, R - r0);

  if (pvec) {                       // rows of M % 4 == 0 bytes, 4-aligned
    const uint32_t* src = reinterpret_cast<const uint32_t*>(patterns);
    for (int i = tid; i < P * MW; i += blockDim.x) pat[i] = __ldg(src + i);
  } else {
    uint8_t* dst = reinterpret_cast<uint8_t*>(pat);
    for (int i = tid; i < P * 4 * MW; i += blockDim.x) {
      const int p = i / (4 * MW), c = i - p * 4 * MW;
      dst[i] = c < M ? __ldg(patterns + (size_t)p * M + c) : 0;
    }
  }
  for (int i = tid; i < P; i += blockDim.x)
    lens[i] = min(max(__ldg(plens + i), 1), M);
  if (vec) stage_rows(data, L, r0, n, recs, Lp, vec);
  __syncthreads();

  for (int j = warp; j < n; j += kWarps) {
    if (vec)
      match_record(Staged{reinterpret_cast<const uint32_t*>(recs + j * Lp)},
                   L, pat, MW, lens, P, hits, j, lane);
    else
      match_record(InPlace{data + (size_t)(r0 + j) * L, L}, L, pat, MW, lens,
                   P, hits, j, lane);
  }
  __syncthreads();

  for (int i = tid; i < P * kRecs; i += blockDim.x) {
    const int p = i / kRecs, j = i - p * kRecs;
    if (j < n) out[(size_t)p * R + r0 + j] = hits[i];
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
      multi_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g_opted[device] = smem;
  return err;
}

}  // namespace

extern "C" {

// Shared memory of kernel D's pattern table and verdicts; the wrapper
// refuses a table that exceeds the card's per-block limit.
int ciao_match_smem_bytes(int P, int M) { return fixed_bytes(P, M); }

// out uint8[P, R]; `device` is the CUDA ordinal the tensors and `stream`
// belong to.  Returns the cudaError_t of the launch.
int ciao_multi_match(int device, const uint8_t* data, int R, int L,
                     const uint8_t* patterns, int M, const int32_t* plens,
                     int P, uint8_t* out, void* stream) {
  if (R == 0 || P == 0) return 0;
  int limit = 0;
  cudaError_t err = use_device(device, &limit);
  if (err != cudaSuccess) return err;
  int smem = fixed_bytes(P, M);
  if (smem > limit) return cudaErrorInvalidValue;
  const int Lp = ((L + 127) & ~127) + kPad;
  int vec = 0;                      // 0: rows read in place
  if ((long long)smem + (long long)kRecs * Lp <= limit) {
    smem += kRecs * Lp;
    const uintptr_t a = reinterpret_cast<uintptr_t>(data);
    vec = (a % 16 == 0 && L % 16 == 0) ? 16 : (a % 4 == 0 && L % 4 == 0) ? 4 : 1;
  }
  const int pvec =
      reinterpret_cast<uintptr_t>(patterns) % 4 == 0 && M % 4 == 0;
  err = opt_in(device, smem);
  if (err != cudaSuccess) return err;
  multi_match_kernel<<<(R + kRecs - 1) / kRecs, kWarps * 32, smem,
                       (cudaStream_t)stream>>>(data, R, L, patterns, M, plens,
                                               P, out, vec, Lp, pvec);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
