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
// to speak of. At the criterion's shape that is 9 MB of index, 9 MB of
// output and the 9 MB of points the indices select, scattered over a 36 MB
// source (a top-k keeps a quarter of each row, so about 2 in 3 of the
// source's 32-byte sectors hold a selected point).
//
// Design, for that bound (the first design was one thread per point on a
// (P / 256, G) grid: 0.0203-0.0208 ms against a 0.0081 ms bound on an H100
// at 700 W; this one 0.0195-0.0198 in the same calls; PERF.md, K6
// findings, has the floors and the sweep):
//  * the grid is flat over the G x P points, so no row ends in a part-full
//    block, and each thread takes V consecutive points: their indices in
//    one or two 16-byte loads, their V gathers all issued before any store,
//    and their outputs in 16-byte stores; the point's x and y move together
//    as one float2, the [G, NS, 2] layout read as it lies;
//  * the index and the output, read and written once, stream past L2
//    (ld.global.cs / st.global.cs, evict first) so that the source keeps L2
//    for the random reads, which go through the read-only path.
// V comes from ops/gather_cuda.py::points_per_thread: 4 points a thread,
// or 1 where a pointer is not aligned for the vectors (1, 2 or 8 points a
// thread, or no streaming hints, timed slower at the criterion's shape;
// PERF.md, K6 findings). What holds it at that time, from its floors on the card
// (scripts/bench_gather_plans.py): an empty kernel on its grid takes
// 0.0012-0.0014 ms and a streaming copy of the index into the output
// 0.0074-0.0076, so about 0.012 ms of the 0.019-0.020 go to the 1.1 M
// dependent random 8-byte reads of the source, a 32-byte sector each, even
// with the source in L2 (0.0230-0.0234 with it flushed). Tried and dropped:
// a block per part of a source row, the part copied to shared memory and
// every index of the row read against it (the source read once, streamed),
// slower at every part count, warm and cold. `gather_floor` runs the two
// floors the design is measured against (an empty kernel on the same grid;
// a streaming copy of the index into the output); no caller of the gather
// runs them. The TPU kernel gathered flattened [2M, NS] x and
// y rows, its one-hot row selection on the MXU and lane-select reduction
// existing because TPU gathers were serial dynamic slices; the card loads
// directly. The indices are taken as given, 0 <= idx < NS, as gather_lanes
// takes them: they come from torch.topk, and a check on the device would
// cost a synchronisation per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // points a thread where the pointers allow vectors

// V indices from p, streamed: 16 bytes at a time for V = 4 (p then aligned
// to min(16, 4 * sizeof(I)) bytes); only the first n - f0 where the thread's
// points run past the end (their indices read as 0).
template <int V>
__device__ __forceinline__ void load_indices(const long long* p, long long (&id)[V], int64_t left) {
  if constexpr (V == 4) {
    if (left >= V) {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
      const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p + 2));
      id[0] = a.x;
      id[1] = a.y;
      id[2] = b.x;
      id[3] = b.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) id[j] = j < left ? __ldcs(p + j) : 0;
}
template <int V>
__device__ __forceinline__ void load_indices(const int* p, long long (&id)[V], int64_t left) {
  if constexpr (V == 4) {
    if (left >= V) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
      id[0] = v.x;
      id[1] = v.y;
      id[2] = v.z;
      id[3] = v.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) id[j] = j < left ? __ldcs(p + j) : 0;
}

// V points to p, streamed: two a 16-byte store for V = 4 (p aligned to 16
// bytes); only the first `left` at the end.
template <int V>
__device__ __forceinline__ void store_points(float2* p, const float2 (&v)[V], int64_t left) {
  if constexpr (V == 4) {
    if (left >= V) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(v[0].x, v[0].y, v[1].x, v[1].y));
      __stcs(reinterpret_cast<float4*>(p + 2), make_float4(v[2].x, v[2].y, v[3].x, v[3].y));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < left) __stcs(p + j, v[j]);
}

// Thread t takes the flat points [V t, V t + V) of the n = G x P; point f
// is (g, r) = (f / P, f % P). I is the index type, long long or int.
template <typename I, int V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float2* __restrict__ src,  // [G, NS] points
              const I* __restrict__ idx,       // [G, P]
              float2* __restrict__ out,        // [G, P] points
              int NS, int P, int64_t n) {
  const int64_t f0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (f0 >= n) return;
  const int64_t left = n - f0;
  long long id[V];
  float2 v[V];
  load_indices<V>(idx + f0, id, left);
  int64_t g = f0 / P;
  int r = (int)(f0 - g * P);
#pragma unroll
  for (int j = 0; j < V; ++j) {  // every gather issued before the first store
    if (j < left) v[j] = __ldg(src + g * NS + id[j]);
    if (++r == P) {
      r = 0;
      ++g;
    }
  }
  store_points<V>(out + f0, v, left);
}

// The floors, on the gather's grid at kVec points a thread: with kCopy the
// index's bits streamed into the output (an int64 index fills a point, an
// int32 one its x), else nothing (the kernel returns at once).
template <typename I, bool kCopy>
__global__ void __launch_bounds__(kThreads)
floor_kernel(const I* __restrict__ idx, float2* __restrict__ out, int64_t n) {
  const int64_t f0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (!kCopy || f0 >= n) return;
  const int64_t left = n - f0;
  long long id[kVec];
  float2 v[kVec];
  load_indices<kVec>(idx + f0, id, left);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    v[j] = make_float2(__int_as_float((int)id[j]),
                       sizeof(I) == 8 ? __int_as_float((int)(id[j] >> 32)) : 0.f);
  store_points<kVec>(out + f0, v, left);
}

unsigned grid_for(int64_t n, int V) { return (unsigned)(((n + V - 1) / V + kThreads - 1) / kThreads); }

// Whether idx and out take kVec-point vectors: the index aligned to
// min(16, kVec * index_bytes) bytes, the output to 16.
bool vector_aligned(const void* idx, const void* out, int index_bytes) {
  const int need = kVec * index_bytes < 16 ? kVec * index_bytes : 16;
  return (uintptr_t)idx % need == 0 && (uintptr_t)out % 16 == 0;
}

// The grid's block count fits gridDim.x at one point a thread.
bool sizes_ok(int G, int NS, int P, int index_bytes) {
  return G >= 1 && NS >= 1 && P >= 1 && (index_bytes == 4 || index_bytes == 8) &&
         ((int64_t)G * P + kThreads - 1) / kThreads < ((int64_t)1 << 31);
}

}  // namespace

// src [G, NS, 2] float32 (8-byte aligned), idx [G, P] int64 (index_bytes = 8)
// or int32 (index_bytes = 4), out [G, P, 2] float32; all contiguous on the
// current device. vec points a thread: 4 (the index aligned to min(16, 4 *
// index_bytes) bytes and the output to 16) or 1, as
// ops/gather_cuda.py::points_per_thread gives it. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int gather_points(const void* src, const void* idx, void* out, int G, int NS, int P,
                             int index_bytes, int vec, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if ((vec != 1 && vec != kVec) || !sizes_ok(G, NS, P, index_bytes) ||
      (vec == kVec && !vector_aligned(idx, out, index_bytes)))
    return bad;
  const int64_t n = (int64_t)G * P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* sp = static_cast<const float2*>(src);
  float2* op = static_cast<float2*>(out);
  const unsigned grid = grid_for(n, vec);
  if (index_bytes == 8) {
    const long long* ip = static_cast<const long long*>(idx);
    if (vec == kVec) gather_kernel<long long, kVec><<<grid, kThreads, 0, s>>>(sp, ip, op, NS, P, n);
    else gather_kernel<long long, 1><<<grid, kThreads, 0, s>>>(sp, ip, op, NS, P, n);
  } else {
    const int* ip = static_cast<const int*>(idx);
    if (vec == kVec) gather_kernel<int, kVec><<<grid, kThreads, 0, s>>>(sp, ip, op, NS, P, n);
    else gather_kernel<int, 1><<<grid, kThreads, 0, s>>>(sp, ip, op, NS, P, n);
  }
  return (int)cudaGetLastError();
}

// The gather's floors on its grid at 4 points a thread, for measurement:
// mode 0 a streaming copy of idx's bits into out (idx and out as
// gather_points takes them at vec 4), mode 1 an empty kernel. Returns as
// gather_points does.
extern "C" int gather_floor(const void* idx, void* out, int G, int P, int index_bytes, int mode,
                            void* stream) {
  if ((mode != 0 && mode != 1) || !sizes_ok(G, 1, P, index_bytes) ||
      !vector_aligned(idx, out, index_bytes))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)G * P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* op = static_cast<float2*>(out);
  const unsigned grid = grid_for(n, kVec);
  if (index_bytes == 8) {
    const long long* ip = static_cast<const long long*>(idx);
    if (mode == 0) floor_kernel<long long, true><<<grid, kThreads, 0, s>>>(ip, op, n);
    else floor_kernel<long long, false><<<grid, kThreads, 0, s>>>(ip, op, n);
  } else {
    const int* ip = static_cast<const int*>(idx);
    if (mode == 0) floor_kernel<int, true><<<grid, kThreads, 0, s>>>(ip, op, n);
    else floor_kernel<int, false><<<grid, kThreads, 0, s>>>(ip, op, n);
  }
  return (int)cudaGetLastError();
}
