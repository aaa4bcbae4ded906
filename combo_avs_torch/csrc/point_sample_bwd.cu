// PointRend bilinear point sampling, backward (the VJP of point_sample_fwd.cu),
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of combo_avs_tpu/ops/point_sample_pallas.py::_backward:
//   * _dimg_kernel -> point_sample_bwd_dimg: the gradient of the image,
//       dfeat[n, corner, c] += w_corner * dout[n, p, c];
//   * _dxy_kernel  -> point_sample_bwd_dxy: the gradient of the points,
//       dpoints[n, p] = (W * dx, H * dy), with
//       dx = sum_c dout[n,p,c] * ((v10 - v00) * (1 - fy) + (v11 - v01) * fy),
//       dy = sum_c dout[n,p,c] * ((v01 - v00) * (1 - fx) + (v11 - v10) * fx),
//     the floor-based corner derivative (at a fractional part of exactly 0 the
//     point takes the slope towards the next corner, as autograd of the plain
//     version and the TPU kernel's _tent_grad do), corners outside the image
//     reading zero.
// Same function as autograd of combo_avs_torch/ops/grid_sample.py::
// point_sample_plain.
//
// What bounds it on this card. dxy: memory; it reads the four corners of
// every channel and dout once, and writes two floats per point. dimg: by
// bytes, each point (8 bytes) and its C gradients read once and the image
// written once, 19.6 MB at the criterion's shape (points [120, 12544, 2],
// dout [120, 12544, 1] into [120, 56, 56, 1]), 0.0058 ms at 3.35 TB/s; in
// practice its 4 x C adds a point at random addresses of the image: 6.0 M a
// call. Adds to random shared addresses took about the same time whether
// fp32 compare-and-swap loops or native integer adds, and whether the lanes'
// addresses fell in distinct banks or not (scripts/bench_point_bwd_plans.py
// and earlier trees of it): about 1.5 a clock per SM, some 16 us a call.
//
// dimg has two kernels; ops/point_sample_cuda.py::dimg_launch_plan picks one
// from the shapes, the inputs' alignment and the card's SM count and opt-in
// shared-memory limit, and this file only executes the plan it is given.
//  * "global" (the first design): a group of G lanes per (n, p) (G = the
//    smallest power of two >= C, at most 32) computes the corner offsets and
//    weights once and loops over the channels, adding four weighted values
//    per element into a zeroed dfeat with fp32 atomicAdd, resolved in L2
//    (REDG): about 6.0 M global atomics a call at the criterion's shape, and
//    the caller's zeroing launch. It serves C > 4, images whose accumulator
//    does not fit, and fewer than 8 images (at 132 SMs), whose staged
//    blocks would leave most SMs idle.
//  * "staged" (C <= 4 and an fp32 accumulator of the image within the opt-in
//    shared memory: 12.5 KB at 56^2): a cluster of 1, 2 or 4 blocks per
//    image (sm_90 thread-block clusters; the most whose 1024-thread blocks
//    fit one wave at two an SM, so two at the criterion's 120 images and
//    four at 8-66 images), each block summing
//    its share of the image's points in its own shared accumulator. Its
//    threads stream 4 consecutive points at a time (two float4 of points and
//    C float4 of gradients through the streaming cache path; scalar loads
//    where an image's points are not 16-byte aligned or at its ragged end)
//    and add each of the four in-image weighted corners with shared fp32
//    atomicAdd. After a cluster barrier each block sums an interleaved part
//    of the image over the cluster's accumulators in rank order, reading its
//    peers' shared memory directly (distributed shared memory), and stores
//    it once. No global atomics, no zeroing launch.
//
// Repeatability: both kernels' fp32 atomics land in a run-dependent order,
// so two calls may differ by a few fp32 roundings of each sum.
//
// What the sweep found (scripts/bench_point_bwd_plans.py, device ms, NVIDIA
// H100 80GB HBM3, 700.00 W, all in one call). At the criterion's shape:
// staged 0.0191 at two blocks an image of 1024 threads against global 0.0625
// and grid_sampler_2d_backward 0.0787 (the library's image gradient); one /
// two / four blocks an image at 256 threads 0.0562 / 0.0340 / 0.0230, at 512
// 0.0331 / 0.0238 / 0.0192, at 1024 0.0230 / 0.0191 / 0.0222: the best use
// about 2048 threads an image, one full wave. At 1 / 4 / 8 / 12 / 16 / 30 /
// 60 images of 12544 points: global 0.0041 / 0.0062 / 0.0090 / 0.0107 /
// 0.0144 / 0.0210 / 0.0346, staged at four blocks an image 0.0092 / 0.0087
// / 0.0089 / 0.0089 / 0.0090 / 0.0098 / 0.0120, so the plan stages from 8
// images. At 300 images of 2000 points one block an image 0.0161, two
// 0.0230, global 0.0252. The shared adds are ATOMS.CAST.SPIN loops in the
// SASS; they set the pace, not the 19.6 MB of loads. Measured on earlier
// trees and not kept: fixed-point sums with native integer atomics (ATOMS.ADD,
// two 32-bit words an element), bitwise repeatable and no faster (0.0210 at
// one block an image, where fp32 then took 0.0205-0.0234); a 64-bit
// atomicAdd, 1.6x slower; 4 to 16 copies of the image a block, lane l
// adding into copy l % copies, 1.1-1.5x slower; red.shared::cluster.add.f32
// (generic atomics, a compare-and-swap loop), no faster.
// The TPU kernel computes dimg as a product rowselT @ (colwT * dout)^T per
// image to feed its matrix unit; on this card that is 9.4 GFLOP of mostly
// zeros at the criterion's shape, so the corners are added directly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // the global kernel and dxy
constexpr int kMaxStagedThreads = 1024;  // the staged kernel
constexpr int kPointsPerThread = 4;     // the staged kernel
constexpr int kMaxCluster = 8;          // the portable cluster size limit
constexpr int kGridRows = 65535;
constexpr int kMaxDevices = 64;

// as point_sample_fwd.cu: the corner rows (-1 outside the image), the
// fractional parts, and the bilinear weights
__device__ __forceinline__ void point_corners(const float* __restrict__ pt, int H, int W,
                                              int* row, float* w, float* fx, float* fy) {
  const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(pt[0], (float)W), 0.5f), -2.f), (float)W + 1.f);
  const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(pt[1], (float)H), 0.5f), -2.f), (float)H + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  *fx = x - x0f;
  *fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float wx[2] = {1.f - *fx, *fx};
  const float wy[2] = {1.f - *fy, *fy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
    const bool valid = xi >= 0 && xi < W && yi >= 0 && yi < H;
    row[k] = valid ? yi * W + xi : -1;
    w[k] = wx[k & 1] * wy[k >> 1];
  }
}

__global__ void __launch_bounds__(kThreads)
point_sample_dimg_kernel(const float* __restrict__ pts,   // [N, P, 2]
                         const float* __restrict__ dout,  // [N, P, C]
                         float* __restrict__ dfeat,       // [N, H, W, C], zeroed
                         int N, int H, int W, int C, int P, int log2_group) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t np = t >> log2_group;
  if (np >= (int64_t)N * P) return;
  const int group = 1 << log2_group;
  const int sub = (int)(t & (group - 1));
  const int64_t n = np / P;
  int row[4];
  float w[4], fx, fy;
  point_corners(pts + 2 * np, H, W, row, w, &fx, &fy);
  float* base = dfeat + n * H * W * (int64_t)C;
  const float* g = dout + np * C;
  for (int c = sub; c < C; c += group) {
    const float gc = g[c];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (row[k] >= 0) atomicAdd(base + (int64_t)row[k] * C + c, w[k] * gc);
    }
  }
}

// Add one point's C gradients g, weighted, into its in-image corners of
// the block's shared accumulator (fp32 atomicAdd: a compare-and-swap loop,
// ATOMS.CAST.SPIN, on this card).
template <int C>
__device__ __forceinline__ void scatter_point(float* acc, float px, float py, const float* g,
                                              int H, int W) {
  int row[4];
  float w[4], fx, fy;
  const float pt[2] = {px, py};
  point_corners(pt, H, W, row, w, &fx, &fy);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (row[k] >= 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(acc + row[k] * C + c, w[k] * g[c]);
    }
  }
}

// C <= 4, one cluster of gridDim.x blocks per image (grid rows loop over the
// images when N exceeds them): block `rank` adds points [rank *
// points_per_block, + points_per_block) of image n into its shared
// accumulator, then sums elements rank, rank + cluster, ... over the
// cluster's accumulators in rank order and stores them. VEC: each thread
// reads its 4 points as two float4 and their 4 x C gradients as C float4 (the
// plan sets it only when every image's points and gradients are 16-byte
// aligned; points_per_block is a multiple of 4).
template <int C, bool VEC>
__global__ void __launch_bounds__(kMaxStagedThreads)
point_sample_dimg_staged(const float* __restrict__ pts,   // [N, P, 2]
                         const float* __restrict__ dout,  // [N, P, C]
                         float* __restrict__ dfeat,       // [N, H, W, C]
                         int N, int H, int W, int P, int points_per_block) {
  extern __shared__ float4 smem4[];  // the accumulator, in whole float4
  float* acc = reinterpret_cast<float*>(smem4);
  const int hwc = H * W * C;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int p_begin = rank * points_per_block;
  const int p_end = min(P, p_begin + points_per_block);
  const int step = blockDim.x * kPointsPerThread;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    for (int i = threadIdx.x; i < (hwc + 3) / 4; i += blockDim.x)
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const float* pn = pts + (int64_t)n * P * 2;
    const float* gn = dout + (int64_t)n * P * C;
    for (int p0 = p_begin + threadIdx.x * kPointsPerThread; p0 < p_end; p0 += step) {
      if (VEC && p0 + kPointsPerThread <= p_end) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(pn + 2 * p0));
        const float4 b = __ldcs(reinterpret_cast<const float4*>(pn + 2 * p0) + 1);
        float g[kPointsPerThread * C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float4 q = __ldcs(reinterpret_cast<const float4*>(gn + p0 * C) + i);
          g[4 * i] = q.x; g[4 * i + 1] = q.y; g[4 * i + 2] = q.z; g[4 * i + 3] = q.w;
        }
        scatter_point<C>(acc, a.x, a.y, g, H, W);
        scatter_point<C>(acc, a.z, a.w, g + C, H, W);
        scatter_point<C>(acc, b.x, b.y, g + 2 * C, H, W);
        scatter_point<C>(acc, b.z, b.w, g + 3 * C, H, W);
      } else {  // scalar: misaligned or odd-P points, an image's last points
#pragma unroll
        for (int j = 0; j < kPointsPerThread; ++j) {
          const int p = p0 + j;
          if (p < p_end) {
            float g[C];
#pragma unroll
            for (int c = 0; c < C; ++c) g[c] = __ldcs(gn + p * C + c);
            scatter_point<C>(acc, __ldcs(pn + 2 * p), __ldcs(pn + 2 * p + 1), g, H, W);
          }
        }
      }
    }
    cluster.sync();  // every block's adds are done
    float* out = dfeat + (int64_t)n * hwc;
    for (int e = rank * blockDim.x + threadIdx.x; e < hwc; e += blocks * blockDim.x) {
      float s = acc[e];
      if (blocks > 1) {
        s = 0.f;
        for (int r = 0; r < blocks; ++r) s += cluster.map_shared_rank(acc, r)[e];
      }
      __stcs(out + e, s);
    }
    cluster.sync();  // the peers' accumulators are read before they are zeroed again or exit
  }
}

__global__ void __launch_bounds__(kThreads)
point_sample_dxy_kernel(const float* __restrict__ feat,  // [N, H, W, C]
                        const float* __restrict__ pts,   // [N, P, 2]
                        const float* __restrict__ dout,  // [N, P, C]
                        float* __restrict__ dpts,        // [N, P, 2]
                        int N, int H, int W, int C, int P, int log2_group) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t np = t >> log2_group;
  // no early return: every lane of the warp takes part in the shuffles below
  const bool active = np < (int64_t)N * P;
  const int group = 1 << log2_group;
  const int sub = (int)(t & (group - 1));
  float dx = 0.f, dy = 0.f;
  if (active) {
    const int64_t n = np / P;
    int row[4];
    float w[4], fx, fy;
    point_corners(pts + 2 * np, H, W, row, w, &fx, &fy);
    const float* base = feat + n * H * W * (int64_t)C;
    const float* g = dout + np * C;
    for (int c = sub; c < C; c += group) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = row[k] >= 0 ? base[(int64_t)row[k] * C + c] : 0.f;
      const float gc = g[c];
      dx = fmaf(gc, (v[1] - v[0]) * (1.f - fy) + (v[3] - v[2]) * fy, dx);
      dy = fmaf(gc, (v[2] - v[0]) * (1.f - fx) + (v[3] - v[1]) * fx, dy);
    }
  }
  for (int s = group >> 1; s > 0; s >>= 1) {
    dx += __shfl_xor_sync(0xffffffffu, dx, s);
    dy += __shfl_xor_sync(0xffffffffu, dy, s);
  }
  if (active && sub == 0) {
    dpts[2 * np] = dx * (float)W;
    dpts[2 * np + 1] = dy * (float)H;
  }
}

int blocks_for(int N, int P, int log2_group, unsigned* blocks) {
  if (log2_group < 0 || log2_group > 5 || N < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const int64_t threads = ((int64_t)N * P) << log2_group;
  const int64_t b = (threads + kThreads - 1) / kThreads;
  if (b > 0x7fffffff) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return 0;
}

// Raise the staged kernel's dynamic shared-memory limit to `bytes` on the
// current device, once per device and size.
template <int C, bool VEC>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(point_sample_dimg_staged<C, VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

template <int C, bool VEC>
int launch_staged(const float* pts, const float* dout, float* dfeat, int N, int H, int W, int P,
                  int threads, int cluster, int points_per_block, int grid_y, int smem,
                  cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<C, VEC>(smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises, and later launches start clean
      return (int)e;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)grid_y);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, point_sample_dimg_staged<C, VEC>, pts, dout,
                                           dfeat, N, H, W, P, points_per_block);
  const cudaError_t last = cudaGetLastError();  // read (and cleared) whatever happened
  return (int)(e != cudaSuccess ? e : last);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Execute one launch plan of ops/point_sample_cuda.py::dimg_launch_plan.
// pts [N, P, 2], dout [N, P, C] and dfeat [N, H, W, C] are float32,
// contiguous, on the current device; dfeat is zeroed by the caller for the
// global kernel (the staged kernel writes every element). plan holds 14
// ints: N, H, W, C, P, the kernel (0 global, 1 staged), threads per block,
// blocks per image (the cluster), points per block, grid x, grid y, vec,
// dynamic shared-memory bytes, log2 of the global kernel's lanes per point.
// Returns cudaGetLastError() after the launch (0 = launched), the error that
// stopped it, or cudaErrorInvalidValue for a plan this function cannot
// execute.
extern "C" int point_sample_bwd_dimg(const void* pts, const void* dout, void* dfeat,
                                     const int* plan, void* stream) {
  const int N = plan[0], H = plan[1], W = plan[2], C = plan[3], P = plan[4];
  const int kernel = plan[5], threads = plan[6], cluster = plan[7], points_per_block = plan[8];
  const int grid_x = plan[9], grid_y = plan[10], vec = plan[11], smem = plan[12];
  const int log2_group = plan[13];
  const int bad = (int)cudaErrorInvalidValue;
  if (N < 1 || P < 1 || C < 1 || H < 1 || W < 1 || (int64_t)H * W * C >= (1ll << 31) ||
      (int64_t)P * (C > 2 ? C : 2) >= (1ll << 31))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const float* g = static_cast<const float*>(dout);
  float* d = static_cast<float*>(dfeat);
  if (kernel == 0) {
    unsigned blocks;
    if (int err = blocks_for(N, P, log2_group, &blocks)) return err;
    if (threads != kThreads || cluster != 1 || grid_x != (int)blocks || grid_y != 1 || smem != 0)
      return bad;
    point_sample_dimg_kernel<<<blocks, kThreads, 0, s>>>(p, g, d, N, H, W, C, P, log2_group);
    return (int)cudaGetLastError();
  }
  const int hwc = H * W * C;
  if (kernel != 1 || C > 4 || threads < 32 || threads > kMaxStagedThreads || threads % 32 != 0 ||
      cluster < 1 || cluster > kMaxCluster || grid_x != cluster || grid_y < 1 ||
      grid_y > kGridRows || grid_y > N || points_per_block < 1 ||
      points_per_block % kPointsPerThread != 0 || (int64_t)cluster * points_per_block < P ||
      smem != (hwc + 3) / 4 * 16)
    return bad;
  if (vec && !(aligned(pts, 16) && aligned(dout, 16) && P % 2 == 0 && (P * C) % 4 == 0))
    return bad;
#define LAUNCH_STAGED(c, v) \
  launch_staged<c, v>(p, g, d, N, H, W, P, threads, cluster, points_per_block, grid_y, smem, s)
#define LAUNCH_C(v)                         \
  switch (C) {                              \
    case 1: return LAUNCH_STAGED(1, v);     \
    case 2: return LAUNCH_STAGED(2, v);     \
    case 3: return LAUNCH_STAGED(3, v);     \
    default: return LAUNCH_STAGED(4, v);    \
  }
  if (vec) LAUNCH_C(true)
  LAUNCH_C(false)
#undef LAUNCH_STAGED
#undef LAUNCH_C
}

// feat, pts, dout and dpts float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int point_sample_bwd_dxy(const void* feat, const void* pts, const void* dout,
                                    void* dpts, int N, int H, int W, int C, int P,
                                    int log2_group, void* stream) {
  unsigned blocks;
  if (int err = blocks_for(N, P, log2_group, &blocks)) return err;
  point_sample_dxy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const float*>(pts),
      static_cast<const float*>(dout), static_cast<float*>(dpts), N, H, W, C, P, log2_group);
  return (int)cudaGetLastError();
}
