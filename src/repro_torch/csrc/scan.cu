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
// the pushed words that kept them exact in f32.  Here the work is
// bit-sliced over tiles of 32 consecutive rows, one tile per warp, one row
// per lane:
//
//  * terms: the batch's live terms (kernels/scan_fused.py::scan_table)
//    arrive sorted by plane key, then kind, and grouped by key, so each
//    plane cell a group needs is read once per row for all of its terms,
//    the next group's cells load while this group's terms are evaluated,
//    and each kind runs its own loop (what a key's key-value terms share,
//    presence, null and bool compatibility, is computed once).  tw[i] =
//    __ballot_sync(term i holds) is one word per term per tile, kept in
//    the warp's slice of shared memory, not in registers, so T is limited
//    by shared memory alone;
//  * slot parameters: the warp stages one slot's (term, slot) and (query,
//    slot) parameters in its slice, lanes loading independent words in
//    parallel, and restages only when the slot changes; a term then costs
//    no global load of its own.  A tile runs its terms, clauses and
//    queries once per slot group of its live rows (one, unless it
//    straddles segments), so every lane of a pass reads one slot's
//    parameters (reading them per lane from global memory, as a first
//    version did for straddling tiles, slowed every tile);
//  * clauses: lanes split the clauses; a clause word is the OR of its
//    terms' words (a clause -> term list staged in shared memory);
//  * pushed bits: the rows' clause words `cw` are transposed by one ballot
//    per pushed bit that some query uses;
//  * queries: lanes split the queries.  For each slot group of the tile
//    (__match_any_sync on the slot), pa = group & the AND of the
//    pushed-bit words of ptab[q, s], gated by active[q, s], and hit = pa &
//    the AND of q's clause words; an empty AND is all ones.  Per row the
//    query work is about Q/32 times the clauses per query, not Q steps;
//  * counts: each block takes a contiguous run of tiles (so the slot
//    changes rarely) and adds __popc(pa) and __popc(hit) into a [Q][S1]
//    table in shared memory, flushed with one global atomic per nonzero
//    entry; when that table does not fit, into the global counts
//    directly.  Integer sums are exact in any order.
//
// Bound on this card: the bytes of the plane cells the batch's terms read
// (1-4 bytes per row per key and field, plus the row's slot id and clause
// word) over 3.35 TB/s.  Each tile runs about ten instructions and one
// ballot per live term, so the instructions, not the bytes, set the time
// (evaluating every kind's test for every term, to keep the substring
// probes in flight together, costs several times more).  At the main
// path's shapes every tile has a warp of its own, so the kernel lasts as
// long as its slowest warp, and a tile that straddles two segments runs
// its terms twice; rows of each segment aligned to 32 in the device cache
// would remove that.
//
// Padding rows (sid < 0) count toward slot S1-1, whose `active` is 0
// (the table says when it is 0 for every query, and tiles of padding rows
// alone are then skipped); rows past N contribute nothing.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;          // terms evaluated between ballots
constexpr unsigned kFull = 0xFFFFFFFFu;

enum { kPresence = 0, kExact = 1, kSubstring = 2, kKeyValue = 3 };
// plane fields a key group reads (scan_fused.py FIELD_*)
enum { kPres = 1, kNotn = 2, kIsb = 4, kNumv = 8, kScod = 16, kRcod = 32 };
// header words of the table (scan_fused.py TABLE_*)
enum { kNLive, kNGroups, kNClauses, kNQueries, kOffTerm, kOffGroup,
       kOffCBeg, kOffCTerm, kOffQBeg, kOffQClause, kPushedMask,
       kSkipPadding };

struct Plane {
  const uint8_t *pres, *notn, *isb, *numv;
  const int32_t *scod, *rcod, *sid;
  const uint32_t* cw;
  long long N;
};

struct Params {
  const int32_t *code_a, *num_codes, *lut_off;
  const uint8_t* lut_flat;
  const uint32_t* pushed_tbl;
  const uint8_t* active;
  int S1, L;
};

// one row's plane cells of one key
struct Cells {
  uint32_t pres, notn, isb, numv;
  int32_t scod, rcod;
};

__device__ __forceinline__ Cells load_cells(const Plane& pl, int key,
                                            uint32_t fields, long long row,
                                            bool in) {
  const long long off = (long long)key * pl.N + row;
  Cells v{0, 0, 0, 0, -1, -1};
  if (in) {
    if (fields & kPres) v.pres = __ldg(pl.pres + off);
    if (fields & kNotn) v.notn = __ldg(pl.notn + off);
    if (fields & kIsb) v.isb = __ldg(pl.isb + off);
    if (fields & kNumv) v.numv = __ldg(pl.numv + off);
    if (fields & kScod) v.scod = __ldg(pl.scod + off);
    if (fields & kRcod) v.rcod = __ldg(pl.rcod + off);
  }
  return v;
}

// a term's (term, slot) parameters: code_a, or the substring LUT base; the
// three numeric repr codes of a key-value term
struct TermParams {
  int a, n0, n1, n2;
};

// term record: bits 0-15 the term's row in the (term, slot) tables, 16-18
// its kind, 19 its value is null, 20 its value is a bool
__device__ __forceinline__ TermParams load_params(const Params& pm,
                                                  uint32_t rec, int s) {
  const int t = rec & 0xFFFFu, kind = (rec >> 16) & 7u;
  TermParams p{0, 0, 0, 0};
  if (kind == kExact || kind == kKeyValue)
    p.a = __ldg(pm.code_a + t * pm.S1 + s);
  else if (kind == kSubstring)
    p.a = __ldg(pm.lut_off + t * pm.S1 + s);
  if (kind == kKeyValue) {
    const int base = t * 3 * pm.S1 + s;
    p.n0 = __ldg(pm.num_codes + base);
    p.n1 = __ldg(pm.num_codes + base + pm.S1);
    p.n2 = __ldg(pm.num_codes + base + 2 * pm.S1);
  }
  return p;
}

// Slot s's parameters into the warp's slice: every live term's, and each
// query's (active, pushed) pair.  Lanes load independent words, four in
// flight at a time, so the latency is paid a few times, not once per term.
__device__ __forceinline__ void stage_slot(const Params& pm,
                                           const uint32_t* terms, int n_live,
                                           int Q, int s, int4* sp,
                                           uint2* qp, int lane) {
#pragma unroll 4
  for (int i = lane; i < n_live; i += 32) {
    const TermParams p = load_params(pm, terms[i], s);
    sp[i] = make_int4(p.a, p.n0, p.n1, p.n2);
  }
#pragma unroll 4
  for (int q = lane; q < Q; q += 32)
    qp[q] = make_uint2(__ldg(pm.active + q * pm.S1 + s),
                       __ldg(pm.pushed_tbl + q * pm.S1 + s));
}

// The words of up to kUnroll consecutive terms i.. (below `end`): the
// predicates were all computed first, so their loads were in flight
// together.
__device__ __forceinline__ void ballots(const bool (&hit)[kUnroll],
                                        uint32_t i, uint32_t end,
                                        uint32_t* tw, int lane) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (i + k >= end) break;
    const uint32_t b = __ballot_sync(kFull, hit[k]);
    if (lane == 0) tw[i + k] = b;
  }
}

// The tile's term words: key groups in order, the next group's cells
// loading while this group's terms are evaluated (a row's cells outside
// the live rows are don't-cares).
__device__ __forceinline__ void term_words(const Plane& pl, const Params& pm,
                                           const uint4* groups, int n_groups,
                                           const uint32_t* terms,
                                           const int4* sp, uint32_t* tw,
                                           Cells cur, long long row, bool in,
                                           int lane) {
  for (int g = 0; g < n_groups; ++g) {
    // key, fields, then the runs of presence, exact, substring and
    // key-value terms: [z, w), [w, b.x), [b.x, b.y), [b.y, b.z)
    const uint4 ga = groups[2 * g], gb = groups[2 * g + 1];
    Cells nxt = cur;
    if (g + 1 < n_groups)
      nxt = load_cells(pl, groups[2 * g + 2].x, groups[2 * g + 2].y, row,
                       in);
    if (ga.z < ga.w) {            // presence: the key is there, not null
      const uint32_t b = __ballot_sync(kFull, in && cur.notn != 0);
      for (uint32_t i = ga.z; i < ga.w; ++i)
        if (lane == 0) tw[i] = b;
    }
    for (uint32_t i = ga.w; i < gb.x; i += kUnroll) {  // exact code
      bool hit[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const uint32_t j = i + k < gb.x ? i + k : i;
        hit[k] = in && cur.scod == sp[j].x;
      }
      ballots(hit, i, gb.x, tw, lane);
    }
    // substring: LUT probes by string code
    for (uint32_t i = gb.x; i < gb.y; i += kUnroll) {
      bool hit[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const uint32_t j = i + k < gb.y ? i + k : i;
        const int4 p = sp[j];
        int idx = p.x + 1 + cur.scod;
        idx = idx < 0 ? 0 : (idx > pm.L - 1 ? pm.L - 1 : idx);
        hit[k] = (__ldg(pm.lut_flat + idx) != 0) & (p.x >= 0) & in;
      }
      ballots(hit, i, gb.y, tw, lane);
    }
    if (gb.y < gb.z) {            // key-value: repr code, numeric, null
      const bool tp = cur.pres != 0, tn = cur.notn != 0;
      const bool tb = cur.isb != 0, tv = cur.numv != 0;
      const bool null_ok = in & tp & !tn;
      const bool bool_ok = in & tb, other_ok = in & tp & !tb;
      const int r = cur.rcod;
      for (uint32_t i = gb.y; i < gb.z; i += kUnroll) {
        bool hit[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const uint32_t j = i + k < gb.z ? i + k : i;
          const uint32_t rec = terms[j];
          const int4 p = sp[j];
          const bool num = (r == p.y) | (r == p.z) | (r == p.w);
          const bool m = (r == p.x) | (tv & num) |
                         (((rec >> 19) & 1u) != 0 & null_ok);
          hit[k] = m & (((rec >> 20) & 1u) ? bool_ok : other_ok);
        }
        ballots(hit, i, gb.z, tw, lane);
      }
    }
    cur = nxt;
  }
}

// One slot group's counts: lanes split the queries; pa = the group's
// rows that pass the pushed bits of ptab[q, sg] (an empty AND is all
// ones), gated by active[q, sg]; hit = pa & the AND of q's clause words.
// (active, ptab) come from the staged slot.
__device__ __forceinline__ void query_counts(
    const uint2* qp, const uint32_t* qbeg, const uint32_t* qcl,
    const uint32_t* cwd, const uint32_t* pw, int Q, int S1, int sg,
    uint32_t group, int32_t* cnt, int32_t* cnd, int lane) {
  for (int q = lane; q < Q; q += 32) {
    const uint2 ap = qp[q];
    if (!ap.x) continue;
    uint32_t pa = group;
    for (uint32_t m = ap.y; m && pa; m &= m - 1) pa &= pw[__ffs(m) - 1];
    if (!pa) continue;
    uint32_t hit = pa;
    for (uint32_t e = qbeg[q]; e < qbeg[q + 1] && hit; ++e)
      hit &= cwd[qcl[e]];
    const int qs = q * S1 + sg;
    atomicAdd(cnd + qs, __popc(pa));
    if (hit) atomicAdd(cnt + qs, __popc(hit));
  }
}

__global__ void scan_kernel(Plane pl, Params pm, const uint4* __restrict__ table,
            int table_vec, int warp_words, int local_acc, int tiles_per_block,
            int32_t* __restrict__ counts, int32_t* __restrict__ cands) {
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;      // tiles of 32 rows in flight
  for (int i = tid; i < table_vec; i += blockDim.x) smem[i] = __ldg(table + i);
  __syncthreads();
  const int n_live = tab[kNLive], n_groups = tab[kNGroups];
  const int C = tab[kNClauses], Q = tab[kNQueries];
  const int S1 = pm.S1;
  const uint32_t* terms = tab + tab[kOffTerm];
  const uint4* groups = reinterpret_cast<const uint4*>(tab + tab[kOffGroup]);
  const uint32_t* cbeg = tab + tab[kOffCBeg];
  const uint32_t* cterm = tab + tab[kOffCTerm];
  const uint32_t* qbeg = tab + tab[kOffQBeg];
  const uint32_t* qcl = tab + tab[kOffQClause];
  const uint32_t pmask = tab[kPushedMask];
  const bool skip_padding = tab[kSkipPadding] != 0;
  int32_t* acc = reinterpret_cast<int32_t*>(tab + 4 * table_vec);
  const int n_acc = local_acc ? Q * S1 : 0;           // per table
  // the warp's slice: slot parameters [n_live] int4 and [Q] uint2 first
  // (16-byte aligned), then term, clause and pushed-bit words
  int4* sp = reinterpret_cast<int4*>(acc + ((2 * n_acc + 3) & ~3)) +
             (size_t)warp * (warp_words / 4);
  uint2* qp = reinterpret_cast<uint2*>(sp + n_live);
  uint32_t* tw = reinterpret_cast<uint32_t*>(qp + ((Q + 1) & ~1));
  uint32_t* cwd = tw + n_live;                        // [C] clause words
  uint32_t* pw = cwd + C;                             // [32] pushed-bit words
  int32_t* cnt = local_acc ? acc : counts;
  int32_t* cnd = local_acc ? acc + n_acc : cands;
  for (int i = tid; i < 2 * n_acc; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  int staged = -1;                  // the slot whose parameters sp/qp hold
  const long long n_tiles = (pl.N + 31) / 32;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block
                                                      : n_tiles;
  for (long long tile = t0 + warp; tile < t1; tile += n_warps) {
    const long long row = tile * 32 + lane;
    const bool in = row < pl.N;
    int s = in ? __ldg(pl.sid + row) : -1;
    const uint32_t w = in ? __ldg(pl.cw + row) : 0u;
    Cells cur = n_groups ? load_cells(pl, groups[0].x, groups[0].y, row, in)
                         : Cells{0, 0, 0, 0, -1, -1};
    // rows whose counts can be nonzero: with no query active on slot S1-1,
    // padding rows add 0, and a tile of them alone is skipped
    const bool live = in && (s >= 0 || !skip_padding);
    const uint32_t valid = __ballot_sync(kFull, live);
    if (!valid) continue;
    if (s < 0) s = S1 - 1;
    for (uint32_t m = pmask; m; m &= m - 1) {
      const int bit = __ffs(m) - 1;
      const uint32_t b = __ballot_sync(kFull, (w >> bit) & 1u);
      if (lane == 0) pw[bit] = b;
    }
    // once per slot group of the tile (one unless it straddles segments):
    // that slot's parameters staged (once per slot change), the term and
    // clause words for all lanes (the group's rows are the ones that
    // count), then the group's query counts
    const uint32_t peers = __match_any_sync(kFull, s);
    for (uint32_t todo = valid; todo;) {
      const int lead = __ffs(todo) - 1;
      const int sg = __shfl_sync(kFull, s, lead);
      const uint32_t group = __shfl_sync(kFull, peers, lead) & valid;
      todo &= ~group;
      if (sg != staged) {
        __syncwarp();
        stage_slot(pm, terms, n_live, Q, sg, sp, qp, lane);
        staged = sg;
      }
      __syncwarp();
      term_words(pl, pm, groups, n_groups, terms, sp, tw, cur, row, in, lane);
      __syncwarp();
      for (int c = lane; c < C; c += 32) {
        uint32_t x = 0;
        for (uint32_t e = cbeg[c]; e < cbeg[c + 1]; ++e) x |= tw[cterm[e]];
        cwd[c] = x;
      }
      __syncwarp();
      query_counts(qp, qbeg, qcl, cwd, pw, Q, S1, sg, group, cnt, cnd, lane);
    }
    __syncwarp();                   // the slice is rewritten by the next tile
  }

  if (local_acc) {
    __syncthreads();
    for (int i = tid; i < n_acc; i += blockDim.x) {
      if (acc[i]) atomicAdd(counts + i, acc[i]);
      if (acc[n_acc + i]) atomicAdd(cands + i, acc[n_acc + i]);
    }
  }
}

constexpr int kMaxDevices = 64;
std::mutex g_mutex;
int g_limit[kMaxDevices];           // opt-in shared memory per block
int g_opted[kMaxDevices];           // dynamic shared memory opted in so far

// Make `device` current and opt in to `smem` bytes of dynamic shared memory
// (the limit is queried, and the attribute set, once per device and larger
// size).
cudaError_t prepare(int device, int smem) {
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
  if (smem > g_limit[device]) return cudaErrorInvalidValue;
  if (smem <= g_opted[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g_opted[device] = smem;
  return err;
}

}  // namespace

extern "C" {

// `table` is kernels/scan_fused.py::scan_table, 16-byte aligned and
// `table_vec` 16-byte units long; `smem` the dynamic shared memory the
// wrapper sized (table, [2][Q][S1] counters when `local_acc`, `warps`
// slices of `warp_words` words; a block is `warps` warps); `counts` and `cands` (int32[Q, S1]) must
// arrive zeroed; `device` is the CUDA ordinal the tensors and `stream`
// belong to.  Returns the cudaError_t of the launch.
int ciao_scan(int device, const uint8_t* pres, const uint8_t* notn,
              const uint8_t* isb, const uint8_t* numv, const int32_t* scod,
              const int32_t* rcod, const int32_t* sid, const uint32_t* cw,
              long long N, const int32_t* code_a, const int32_t* num_codes,
              const int32_t* lut_off, const uint8_t* lut_flat, int L,
              const uint32_t* pushed_tbl, const uint8_t* active, int S1,
              const void* table, int table_vec, int warp_words, int local_acc,
              int smem, int warps, int n_blocks, int32_t* counts, int32_t* cands,
              void* stream) {
  const long long n_tiles = (N + 31) / 32;
  if (n_tiles == 0) return 0;
  if (warps < 1 || warps > 32) return cudaErrorInvalidValue;
  cudaError_t err = prepare(device, smem);
  if (err != cudaSuccess) return err;
  Plane pl{pres, notn, isb, numv, scod, rcod, sid, cw, N};
  Params pm{code_a, num_codes, lut_off, lut_flat, pushed_tbl, active, S1, L};
  long long grid = (n_tiles + warps - 1) / warps;
  if (grid > n_blocks) grid = n_blocks;
  const long long per_block = (n_tiles + grid - 1) / grid;
  scan_kernel<<<(int)grid, warps * 32, smem, (cudaStream_t)stream>>>(
      pl, pm, static_cast<const uint4*>(table), table_vec, warp_words,
      local_acc, (int)per_block, counts, cands);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
