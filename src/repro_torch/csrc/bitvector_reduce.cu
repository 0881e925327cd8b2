// AND and OR over the rows of packed bitvectors, and the popcount of the
// AND: the split path's load mask and the host scanner's AND-reduce hook.
//
// Replaces the TPU kernel src/repro/kernels/bitvector_ops.py::
// bitvector_reduce (body _reduce_kernel).  Same function, other shape:
//
//  * one thread per word column; it walks the P rows (row-major, so a
//    warp's loads are coalesced) and keeps AND and OR in registers;
//  * the TPU wrote one count per 128-word block and summed them on the
//    host side of the call; here each warp sums its __popc with
//    __reduce_add_sync and adds it to the single count with one integer
//    atomicAdd, exact in any block order.  W needs no padding.
//
// Bound on this card: bytes.  It reads P*W*4 and writes 2*W*4 + 4 bytes
// once each at 3.35 TB/s; at the path's shapes (a few rows of a few
// hundred words) that is well under a microsecond, so the launch sets
// the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
bitvector_reduce_kernel(const uint32_t* __restrict__ bv, int P, int W,
                        uint32_t* __restrict__ and_w,
                        uint32_t* __restrict__ or_w,
                        int32_t* __restrict__ count) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  unsigned bits = 0;
  if (w < W) {
    uint32_t a = bv[w];
    uint32_t o = a;
    for (int p = 1; p < P; ++p) {
      const uint32_t x = bv[(size_t)p * W + w];
      a &= x;
      o |= x;
    }
    and_w[w] = a;
    or_w[w] = o;
    bits = __popc(a);
  }
  bits = __reduce_add_sync(kFull, bits);     // every lane reaches this
  if ((threadIdx.x & 31) == 0 && bits) atomicAdd(count, (int)bits);
}

}  // namespace

extern "C" {

// `count` must arrive zeroed; P >= 1.  Returns the cudaError_t of the
// launch.
int ciao_bitvector_reduce(int device, const uint32_t* bv, int P, int W,
                          uint32_t* and_w, uint32_t* or_w, int32_t* count,
                          void* stream) {
  if (W == 0) return 0;
  if (P < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bitvector_reduce_kernel<<<(W + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(bv, P, W, and_w, or_w,
                                                    count);
  return cudaGetLastError();
}

const char* ciao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
