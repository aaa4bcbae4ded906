// Point gather for Hopper (sm_90a): out[g, p, :] = src[g, idx[g, p], :] for
// (x, y) pairs.
//
// Replaces combo_avs_tpu/ops/gather_pallas.py::_gather_kernel (via
// gather_lanes), which the JAX criterion reaches in PointRend's point
// selection when the stratified chunk does not divide the candidate count:
// the coordinates of the top-k most uncertain candidates (S4 training:
// candidates [120, 37632, 2] -> [120, 9408, 2] per decoder output).
//
// What bounds it on this card: memory. One output point costs one index
// read, one 8-byte source read and one 8-byte store; there is no arithmetic
// to speak of.
//
// Design, for that bound: one thread per output point, a grid of row g by
// blocks of 256 consecutive p, so the index reads and the output stores are
// coalesced, and the source reads of a warp fall within one row (the indices
// come from a top-k of that row). The point's x and y move together as one
// float2, so the [M, NS, 2] layout is read as it lies: no split into x and y
// rows before the launch, and one index read per point. Four points per
// thread, to keep more random loads in flight, measured no faster. The TPU
// kernel gathered flattened [2M, NS] x and y rows, its one-hot row selection
// on the MXU and lane-select reduction existing because TPU gathers were
// serial dynamic slices; the card loads directly. The indices are taken as given,
// 0 <= idx < NS, as gather_lanes takes them: they come from torch.topk, and
// a check on the device would cost a synchronisation per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float2* __restrict__ src,  // [G, NS] points
              const I* __restrict__ idx,       // [G, P]
              float2* __restrict__ out,        // [G, P] points
              int NS, int P) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int64_t g = blockIdx.y;
  out[g * P + p] = __ldg(src + g * NS + (int64_t)__ldg(idx + g * P + p));
}

}  // namespace

// src [G, NS, 2] float32 (8-byte aligned), idx [G, P] int64 (index_bytes = 8)
// or int32 (index_bytes = 4), out [G, P, 2] float32; all contiguous on the
// current device; G <= 65535 (the grid's second dimension).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gather_points(const void* src, const void* idx, void* out, int G, int NS, int P,
                             int index_bytes, void* stream) {
  if (G < 1 || G > 65535 || NS < 1 || P < 1 || (index_bytes != 4 && index_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads), (unsigned)G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) {
    gather_kernel<int64_t><<<grid, kThreads, 0, s>>>(
        static_cast<const float2*>(src), static_cast<const int64_t*>(idx),
        static_cast<float2*>(out), NS, P);
  } else {
    gather_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const float2*>(src), static_cast<const int32_t*>(idx),
        static_cast<float2*>(out), NS, P);
  }
  return (int)cudaGetLastError();
}
