// Fused pushdown pass: dense JSON chunk -> packed per-clause bitvectors,
// the OR'd load mask and per-clause popcounts, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::clause_bitvectors_fused
// (body _clause_bitvectors_kernel).  Same function, other shape:
//
//  * one block covers 32 consecutive records = one output word; its 16
//    warps take one record each at a time.  The block stages the records
//    in shared memory with 16-byte loads where the rows allow it (4-byte
//    or 1-byte loads otherwise; any stride runs), each followed by zeros,
//    so a window that runs past the stride reads zeros as the TPU kernel's
//    zero-filled shifts do.  Rows too wide to stage are read in place;
//  * the plan is one table of 32-bit words (kernels/plan.py::kernel_table),
//    staged once per block: patterns packed 4 bytes to a word, each
//    predicate's clause list (CSR, not the dense membership column), and
//    the key-value predicates grouped by key, so a key is searched once
//    for all its values.  Predicates no clause reads (a tier's neutralised
//    rows) are not in the table;
//  * search: lane i covers positions base + 4i .. base + 4i + 3 of each
//    128-position block.  The pattern's first 4 bytes, each repeated
//    across a word, are XORed with the record word and its three
//    funnel-shifted neighbours, and a zero-byte test flags the candidate
//    starts 4 at a time; only candidates run the full compare, 4 bytes per
//    compare with sliding words.  This replaces the TPU's chain of static
//    shifts and selects;
//  * key-value: the TPU's flip + segmented suffix scan becomes a carry
//    chain.  From a key end e, 32 positions a ballot, M = positions that
//    are not ',' or '}' (all, when unbounded) and reach[x] = M[x] & (x == e
//    | reach[x - 1]), which is the carry out of bit x of M + (bit e & M):
//    reach = ((M + S) ^ M ^ S) >> 1, one carry bit handed to the next
//    word.  The predicate hits iff a value window starts on a reach
//    position (the first value start after a key end comes before the
//    first delimiter), so values are tested there alone.  Key ends are
//    walked in position order and an end inside a stretch already walked
//    is skipped, so every position is walked at most once: O(L) per
//    record however many keys it holds;
//  * per-clause bits go to shared memory (atomicOr of the record's bit);
//    the block owns its word of `words` and `or_words` and writes them
//    without atomics; counts[c] gets one atomicAdd(__popc(word)) per
//    block, exact in any block order.
//
// Bound on this card: the chunk is read once (R*L bytes, 3 MB per 8,192
// records of 384 bytes) at 3.35 TB/s, about a microsecond.  At the main
// path's shape the launch and staging take half the time and the
// compares the rest; with many predicates the compares set it, about 25
// instructions per 128 positions per pattern without candidates.
//
// Semantics held to the plain version (ref.clause_bitvectors_ref): an
// empty simple pattern matches every valid row; other windows compare
// max(1, min(len, width)) bytes, zeros past L; a key end lies below L;
// rows >= n_valid are zero; R need not be a multiple of 32.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kRecs = 32;           // records per block (one output word)
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

// the record's bit into every clause of the predicate's list
__device__ __forceinline__ void mark(const uint32_t* csr, int beg, int end,
                                     uint32_t* cw, uint32_t bit, int lane) {
  for (int e = beg + lane; e < end; e += 32) atomicOr(cw + csr[e], bit);
}

// Lane i covers positions base + 4i .. base + 4i + 3 of each 128-position
// block: the prefix flags candidates 4 at a time, and only they run the
// full compare.
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

// The walk from one key end e, 32 positions a ballot: reach (the header
// comment's carry chain) runs from e through positions that are not
// delimiters, and each value is tested where reach is set.  Returns the
// first position at or after e that reach did not get to (a delimiter or
// L), or -1 once the group's only predicate hit.
template <class Rd>
__device__ int walk(const Rd& rd, int L, int e, bool unbounded,
                    const uint4* preds, int beg, int end, const uint32_t* csr,
                    const uint32_t* pat, uint32_t* cw, uint32_t bit, int lane) {
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
    if (reach) {
      const bool mine = (reach >> lane) & 1u;
      for (int q = beg; q < end; ++q) {
        const uint4 pd = preds[q];
        if (__any_sync(kFull, mine && window_eq(rd, x, L, pat + pd.x, pd.y))) {
          mark(csr, pd.z, pd.w, cw, bit, lane);
          if (end - beg == 1) return -1;
        }
      }
    }
    carry = reach >> 31;
    if (!carry) return 32 * w + __ffs(~reach & (kFull << from)) - 1;
  }
  return L;
}

// One key (compare kc bytes; its end is its start + ks) and its values
// preds[beg, end).  Key starts are found as in `occurs`, then walked in
// position order; a key end inside a stretch already walked adds nothing
// (its reach is a suffix of the earlier one), so every position is walked
// at most once and a record costs O(L) however many keys it holds.
template <int N, class Rd>
__device__ void key_value_group(const Rd& rd, int L, const uint32_t* key,
                                int kc, int ks, bool unbounded,
                                const uint4* preds, int beg, int end,
                                const uint32_t* csr, const uint32_t* pat,
                                uint32_t* cw, uint32_t bit, int lane) {
  const Prefix<N> pre = prefix<N>(key);
  int done = 0;                     // positions below were walked already
  for (int base = 0; base < L; base += 128) {
    const int at = base + 4 * lane;
    uint32_t c = pre.candidates(rd, at);
    uint32_t starts = 0;            // bit k: a key starts at at + k
    while (c) {
      const int k = (__ffs(c) - 1) >> 3;
      c &= c - 1;
      if (at + k + ks < L && window_eq(rd, at + k, L, key, kc))
        starts |= 1u << k;
    }
    for (uint32_t lanes = __ballot_sync(kFull, starts != 0); lanes;
         lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (uint32_t h = __shfl_sync(kFull, starts, src); h; h &= h - 1) {
        const int e = base + 4 * src + __ffs(h) - 1 + ks;
        if (e < done) continue;
        done = walk(rd, L, e, unbounded, preds, beg, end, csr, pat, cw, bit,
                    lane);
        if (done < 0) return;
      }
    }
  }
}

// header words of the table (kernels/plan.py::kernel_table)
enum { kNSimple, kNGroups, kOffPred, kOffGroup, kOffCsr, kOffPat };

template <class Rd>
__device__ void eval_record(const Rd& rd, int L, const uint32_t* tab,
                            uint32_t* cw, uint32_t bit, int lane) {
  const uint4* preds = reinterpret_cast<const uint4*>(tab + tab[kOffPred]);
  const uint4* groups = reinterpret_cast<const uint4*>(tab + tab[kOffGroup]);
  const uint32_t* csr = tab + tab[kOffCsr];
  const uint32_t* pat = tab + tab[kOffPat];
  const int n_simple = tab[kNSimple], n_groups = tab[kNGroups];
  for (int p = 0; p < n_simple; ++p) {
    const uint4 pd = preds[p];          // pattern word, length, clause list
    const int m = pd.y;
    const uint32_t* pw = pat + pd.x;
    const bool hit = m == 0   ? true
                     : m == 1 ? occurs<1>(rd, L, pw, m, lane)
                     : m == 2 ? occurs<2>(rd, L, pw, m, lane)
                     : m == 3 ? occurs<3>(rd, L, pw, m, lane)
                              : occurs<4>(rd, L, pw, m, lane);
    if (hit) mark(csr, pd.z, pd.w, cw, bit, lane);
  }
  for (int g = 0; g < n_groups; ++g) {
    const uint4 a = groups[2 * g];      // key word, compare, shift, unbounded
    const uint4 b = groups[2 * g + 1];  // its predicates [b.x, b.y)
    const int kc = a.y;
    const uint32_t* key = pat + a.x;
    if (kc >= 4)
      key_value_group<4>(rd, L, key, kc, a.z, a.w != 0, preds, b.x, b.y, csr,
                         pat, cw, bit, lane);
    else if (kc == 3)
      key_value_group<3>(rd, L, key, kc, a.z, a.w != 0, preds, b.x, b.y, csr,
                         pat, cw, bit, lane);
    else if (kc == 2)
      key_value_group<2>(rd, L, key, kc, a.z, a.w != 0, preds, b.x, b.y, csr,
                         pat, cw, bit, lane);
    else
      key_value_group<1>(rd, L, key, kc, a.z, a.w != 0, preds, b.x, b.y, csr,
                         pat, cw, bit, lane);
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

__global__ void __launch_bounds__(kWarps * 32, 2)
pushdown_kernel(const uint8_t* __restrict__ data, int R, int L, int n_valid,
                const uint4* __restrict__ table, int table_vec, int C,
                uint32_t* __restrict__ words, uint32_t* __restrict__ or_words,
                int32_t* __restrict__ counts, int vec, int Lp) {
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* cw = tab + 4 * table_vec;                 // [C] clause bits
  uint8_t* recs = reinterpret_cast<uint8_t*>(cw + ((C + 3) & ~3));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int word = blockIdx.x;
  const int W = (R + 31) / 32;
  const int r0 = word * kRecs;
  const int n = min(kRecs, min(R, n_valid) - r0);     // rows to evaluate

  for (int i = tid; i < table_vec; i += blockDim.x) smem[i] = __ldg(table + i);
  for (int i = tid; i < C; i += blockDim.x) cw[i] = 0;
  if (vec && n > 0) stage_rows(data, L, r0, n, recs, Lp, vec);
  __syncthreads();

  for (int j = warp; j < n; j += kWarps) {
    if (vec)
      eval_record(Staged{reinterpret_cast<const uint32_t*>(recs + j * Lp)}, L,
                  tab, cw, 1u << j, lane);
    else
      eval_record(InPlace{data + (size_t)(r0 + j) * L, L}, L, tab, cw,
                  1u << j, lane);
  }
  __syncthreads();

  for (int c = tid; c < C; c += blockDim.x) {
    const uint32_t w = cw[c];
    words[(size_t)c * W + word] = w;
    if (w) atomicAdd(counts + c, __popc(w));
  }
  if (warp == 0) {
    uint32_t any = 0;
    for (int c = lane; c < C; c += 32) any |= cw[c];
    any = __reduce_or_sync(kFull, any);
    if (lane == 0) or_words[word] = any;
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
      pushdown_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g_opted[device] = smem;
  return err;
}

}  // namespace

extern "C" {

// Shared memory for the plan table and the clause bits alone; the wrapper
// refuses a plan that exceeds the card's per-block limit.
int ciao_pushdown_smem_bytes(int table_vec, int C) {
  return 16 * table_vec + 4 * ((C + 3) & ~3);
}

// `table` is kernels/plan.py::kernel_table, 16-byte aligned, `table_vec`
// 16-byte units long; `counts` must arrive zeroed; `device` is the CUDA
// ordinal the tensors and `stream` belong to.  Returns the cudaError_t of
// the launch.
int ciao_pushdown(int device, const uint8_t* data, int R, int L, int n_valid,
                  const void* table, int table_vec, int C, uint32_t* words,
                  uint32_t* or_words, int32_t* counts, void* stream) {
  const int W = (R + 31) / 32;
  if (W == 0 || C == 0) return 0;
  int limit = 0;
  cudaError_t err = use_device(device, &limit);
  if (err != cudaSuccess) return err;
  int smem = ciao_pushdown_smem_bytes(table_vec, C);
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
  pushdown_kernel<<<W, kWarps * 32, smem, (cudaStream_t)stream>>>(
      data, R, L, n_valid, static_cast<const uint4*>(table), table_vec, C,
      words, or_words, counts, vec, Lp);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
