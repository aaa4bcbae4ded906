// PointRend bilinear point sampling, forward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of combo_avs_tpu/ops/point_sample_pallas.py, which
// compute one function in two layouts:
//   * _fwd_kernel (via _forward / point_sample_pallas): one point set per
//     channel (the criterion's [M, h, w, 1] masks);
//   * _shared_kernel (via point_sample_shared): C channels sharing one point
//     set (the matcher's [N, 56, 56, 100] predicted masks).
// Same function as combo_avs_tpu/ops/grid_sample.py::point_sample and its
// PyTorch twin combo_avs_torch/ops/grid_sample.py::point_sample_plain:
//
//   out[n, p, c] = bilinear(feat[n, :, :, c], x = px * W - 0.5, y = py * H - 0.5)
//
// with corners outside the image contributing zero (F.grid_sample zero
// padding, align_corners=False) and the floor-based corner split of the plain
// version.
//
// What bounds it on this card: memory. Each output element costs four corner
// reads and one FMA each. At the criterion's C = 1 shapes the points dominate
// the bytes (8 read and 4 written per point; [120, 37632, 2] is 36 MB) and a
// 56^2 mask is 12.5 KB; at the matcher's C = 100 shape the 200 MB output
// dominates.
//
// The first design gave every (n, p) a group of lanes (one at C = 1, four at
// C = 3 with one idle, 32 at C = 100), one 64-bit division n = np / P per
// thread, the point as two 4-byte loads and every corner a global gather.
// Timed alone (CUDA graph replay, H100 at 700 W) it took 34-50% of the bound
// at C <= 3 and 27% at C = 100: a warp's 4 x 32 random corner gathers in a
// 56^2 mask touch ~30 L1 lines each, and at C = 100 each lane redid the
// point's corners and its 64-bit division for 4 channels. Two kernels now,
// with a launch plan chosen in Python (ops/point_sample_cuda.py::launch_plan)
// and only executed here:
//  * no division: the image comes from blockIdx.y (a grid-stride loop over
//    images when N exceeds the grid's 65535 rows), the points from
//    blockIdx.x; one 64-bit base pointer per image, 32-bit offsets inside it;
//  * "staged" (C <= 4 and H*W*C*4 <= 48 KB: every 56^2 mask at C <= 3): the
//    block copies its image into shared memory with 16-byte cp.async (4-byte
//    when the image is not 16-byte aligned) and gathers the corners there,
//    where 32 random addresses cost a few bank replays, not ~30 L1 lines. A
//    block covers 2048 points, so the copy (from L2: the masks are small)
//    is a fraction of its traffic. One thread takes 4 consecutive
//    points with their C channels in registers (no idle lane at C = 3),
//    loads all their corners before the first FMA, reads the 4 points as two
//    float4 and stores the 4 x C outputs as C float4, both through the
//    streaming cache path (touched once); corners are float2 / float4 at
//    C = 2 / 4. Odd P, misaligned points or an image's last points take
//    scalar loads and stores;
//  * "channels" (everything else: C > 4, and the 224^2 masks, too big to
//    stage): a block takes up to 256 consecutive points of one image, their
//    corner offsets and weights are computed once into shared memory, then
//    the threads walk the block's contiguous [points, C] output in float4
//    (C % 4 == 0 and a 16-byte aligned image) or float units, so every store
//    is coalesced and no lane idles on a channel remainder; corners are
//    gathered through the read-only cache.
// Tried and measured slower (scripts/bench_point_plans.py, H100 at 700 W):
// the staged kernel's 4-points-a-thread scheme on the 224^2 masks, gathering
// from L2, 1.38x the channels kernel's time at C = 1 and 1.09x at C = 3,
// even with every load issued before the first FMA; the 56^2 masks gathered
// from L1/L2 instead of staged, 1.5x with 4 points a thread and 2.4-2.9x in
// the channels kernel; scalar instead of vector accesses, 1.5-2.0x; 4096 or
// 8192 points a staged block, up to 1.3x (1024: 5% slower at 37632 points,
// 3% faster at 12544); 64 or 128 points a channels block at 224^2, up to
// 1.5x.
// The coordinate arithmetic is the first design's: a multiply, then a
// subtract, never contracted into an FMA (as the plain version rounds them),
// floorf, and the corners' fmaf chain in the same order, so both designs give
// the same bits. The TPU kernels' row-selection matmuls, tent matrices and
// point blocking existed because TPU gathers were serial; the card gathers
// directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 4;     // the staged kernel
constexpr int kStageBytes = 48 * 1024;  // static limit: no opt-in attribute
constexpr int kMaxChannelPoints = 256;  // the channels kernel's corner table
constexpr int kGridRows = 65535;

// The four corners (x0,y0), (x1,y0), (x0,y1), (x1,y1) of one point: the
// pixel of each in the [H*W] plane (-1 when outside the image) and its weight.
__device__ __forceinline__ void point_corners(float px, float py, int H, int W, int* row,
                                              float* w) {
  // clamping keeps the float->int conversion defined; every corner of a
  // coordinate beyond [-1, W] is outside the image either way
  const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(px, (float)W), 0.5f), -2.f), (float)W + 1.f);
  const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(py, (float)H), 0.5f), -2.f), (float)H + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float wx[2] = {1.f - fx, fx};
  const float wy[2] = {1.f - fy, fy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
    const bool valid = xi >= 0 && xi < W && yi >= 0 && yi < H;
    row[k] = valid ? yi * W + xi : -1;
    w[k] = wx[k & 1] * wy[k >> 1];
  }
}

// The C channels of pixel `row` of the staged image, as one float2 or
// float4 when VEC and C is 2 or 4 (shared memory is aligned for both).
template <int C, bool VEC>
__device__ __forceinline__ void load_pixel(const float* simg, int row, float* v) {
  const float* p = simg + row * C;
  if constexpr (VEC && C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VEC && C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

// NP points: acc[j][c] = the fmaf chain over point j's in-image corners, in
// corner order, every corner loaded before the first FMA.
template <int C, bool VEC, int NP>
__device__ __forceinline__ void sample_points(const float* simg, const float* xs,
                                              const float* ys, int H, int W, float (*acc)[C]) {
  int row[NP][4];
  float w[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j) point_corners(xs[j], ys[j], H, W, row[j], w[j]);
  float v[NP][4][C];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (row[j][k] >= 0) {
        load_pixel<C, VEC>(simg, row[j][k], v[j][k]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[j][k][c] = 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (row[j][k] >= 0) a = fmaf(w[j][k], v[j][k][c], a);
      }
      acc[j][c] = a;
    }
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Copy `count` floats of one image into shared memory and wait for them.
__device__ __forceinline__ void stage_image(const float* __restrict__ img, float* simg,
                                            int count, bool by16) {
  if (by16) {
    for (int i = threadIdx.x; i < count / 4; i += kThreads)
      cp_async16(simg + 4 * i, img + 4 * i);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) cp_async4(simg + i, img + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// C <= 4, the image staged: each thread samples kPointsPerThread consecutive
// points of image n, its block the points [blockIdx.x * points_per_block,
// + points_per_block). VEC: the points and the outputs move as float4, the
// corners of C = 2, 4 as float2 / float4; the launch plan sets it only when
// every image's points and outputs are 16-byte aligned.
template <int C, bool VEC>
__global__ void __launch_bounds__(kThreads)
point_sample_fwd_staged(const float* __restrict__ feat,  // [N, H, W, C]
                        const float* __restrict__ pts,   // [N, P, 2]
                        float* __restrict__ out,         // [N, P, C]
                        int N, int H, int W, int P, int points_per_block, int stage16) {
  extern __shared__ float4 smem4[];
  float* simg = reinterpret_cast<float*>(smem4);
  const int hwc = H * W * C;
  const int p_begin = blockIdx.x * points_per_block;
  const int p_end = min(P, p_begin + points_per_block);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const float* pn = pts + (int64_t)n * P * 2;
    float* on = out + (int64_t)n * P * C;
    stage_image(feat + (int64_t)n * hwc, simg, hwc, stage16 != 0);
    for (int p0 = p_begin + threadIdx.x * kPointsPerThread; p0 < p_end;
         p0 += kThreads * kPointsPerThread) {
      float acc[kPointsPerThread][C];
      if (VEC && p0 + kPointsPerThread <= p_end) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(pn + 2 * p0));
        const float4 b = __ldcs(reinterpret_cast<const float4*>(pn + 2 * p0) + 1);
        const float xs[4] = {a.x, a.z, b.x, b.z}, ys[4] = {a.y, a.w, b.y, b.w};
        sample_points<C, VEC, kPointsPerThread>(simg, xs, ys, H, W, acc);
        const float* r = &acc[0][0];
        float4* o = reinterpret_cast<float4*>(on + p0 * C);
#pragma unroll
        for (int i = 0; i < C; ++i)
          __stcs(o + i, make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]));
      } else {  // scalar: odd P, misaligned points, an image's last points
#pragma unroll
        for (int j = 0; j < kPointsPerThread; ++j) {
          const int p = p0 + j;
          if (p < p_end) {
            const float x = __ldcs(pn + 2 * p), y = __ldcs(pn + 2 * p + 1);
            sample_points<C, false, 1>(simg, &x, &y, H, W, &acc[j]);
#pragma unroll
            for (int c = 0; c < C; ++c) __stcs(on + p * C + c, acc[j][c]);
          }
        }
      }
    }
    __syncthreads();  // every read of this image is done before the next copy
  }
}

// Any C: a block takes up to points_per_block (<= kMaxChannelPoints)
// consecutive points of image n. Their corners go to shared memory, then the
// threads walk the block's [points, C] output, contiguous in `out`, in units
// of V floats (V = 4 when C % 4 == 0 and the image is 16-byte aligned).
template <int V>
__global__ void __launch_bounds__(kThreads)
point_sample_fwd_channels(const float* __restrict__ feat, const float* __restrict__ pts,
                          float* __restrict__ out, int N, int H, int W, int C, int P,
                          int points_per_block) {
  __shared__ int s_row[kMaxChannelPoints][4];
  __shared__ float s_w[kMaxChannelPoints][4];
  const int p_begin = blockIdx.x * points_per_block;
  const int count = min(P - p_begin, points_per_block);
  const int units_per_point = C / V;
  const int units = count * units_per_point;
  const int hwc = H * W * C;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const float* img = feat + (int64_t)n * hwc;
    const float* pn = pts + ((int64_t)n * P + p_begin) * 2;
    float* ob = out + ((int64_t)n * P + p_begin) * C;
    for (int i = threadIdx.x; i < count; i += kThreads)
      point_corners(__ldcs(pn + 2 * i), __ldcs(pn + 2 * i + 1), H, W, s_row[i], s_w[i]);
    __syncthreads();
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int j = u / units_per_point;
      const int c = (u - j * units_per_point) * V;
      float v[4][V];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = s_row[j][k];
        if (row >= 0) {
          const float* p = img + row * C + c;
          if constexpr (V == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p));
            v[k][0] = q.x; v[k][1] = q.y; v[k][2] = q.z; v[k][3] = q.w;
          } else {
            v[k][0] = __ldg(p);
          }
        }
      }
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (s_row[j][k] >= 0) {
          const float wk = s_w[j][k];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(wk, v[k][e], acc[e]);
        }
      }
      if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(ob + u * V),
               make_float4(acc[0], acc[1], acc[2], acc[3]));
      } else {
        __stcs(ob + u, acc[0]);
      }
    }
    __syncthreads();  // the corner table is rewritten for the next image
  }
}

template <int C>
void launch_staged(const float* feat, const float* pts, float* out, int N, int H, int W, int P,
                   bool vec, int stage16, int points_per_block, dim3 grid, cudaStream_t s) {
  const int smem = H * W * C * 4;
  if (vec) {
    point_sample_fwd_staged<C, true><<<grid, kThreads, smem, s>>>(feat, pts, out, N, H, W, P,
                                                                  points_per_block, stage16);
  } else {
    point_sample_fwd_staged<C, false><<<grid, kThreads, smem, s>>>(feat, pts, out, N, H, W, P,
                                                                   points_per_block, stage16);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Execute one launch plan of ops/point_sample_cuda.py::launch_plan.
// feat [N, H, W, C], pts [N, P, 2] and out [N, P, C] are float32, contiguous,
// on the current device. plan holds 11 ints: N, H, W, C, P, the kernel
// (0 staged, 1 channels), vec, stage16, points_per_block, grid_x, grid_y.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan this function cannot execute.
extern "C" int point_sample_fwd(const void* feat, const void* pts, void* out, const int* plan,
                                void* stream) {
  const int N = plan[0], H = plan[1], W = plan[2], C = plan[3], P = plan[4];
  const int kernel = plan[5], vec = plan[6], stage16 = plan[7], points_per_block = plan[8];
  const int grid_x = plan[9], grid_y = plan[10];
  const int bad = (int)cudaErrorInvalidValue;
  if (N < 1 || P < 1 || C < 1 || H < 1 || W < 1 || grid_x < 1 || grid_y < 1 ||
      grid_y > kGridRows || grid_y > N || points_per_block < 1 ||
      (int64_t)grid_x * points_per_block < P || (int64_t)H * W * C >= (1ll << 31) ||
      (int64_t)P * (C > 2 ? C : 2) >= (1ll << 31))
    return bad;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const float* p = static_cast<const float*>(pts);
  float* o = static_cast<float*>(out);
  if (kernel == 0) {
    if (C > 4 || points_per_block % (kThreads * kPointsPerThread) != 0 ||
        H * W * C * 4 > kStageBytes)
      return bad;
    if (vec && !(aligned(pts, 16) && aligned(out, 16) && P % 2 == 0 && (P * C) % 4 == 0))
      return bad;
    if (stage16 && !(aligned(feat, 16) && (H * W * C) % 4 == 0)) return bad;
    const bool v = vec != 0;
    switch (C) {
      case 1: launch_staged<1>(f, p, o, N, H, W, P, v, stage16, points_per_block, grid, s); break;
      case 2: launch_staged<2>(f, p, o, N, H, W, P, v, stage16, points_per_block, grid, s); break;
      case 3: launch_staged<3>(f, p, o, N, H, W, P, v, stage16, points_per_block, grid, s); break;
      default: launch_staged<4>(f, p, o, N, H, W, P, v, stage16, points_per_block, grid, s);
    }
    return (int)cudaGetLastError();
  }
  if (kernel != 1 || points_per_block > kMaxChannelPoints) return bad;
  if (vec) {
    if (C % 4 != 0 || !aligned(feat, 16) || !aligned(out, 16)) return bad;
    point_sample_fwd_channels<4><<<grid, kThreads, 0, s>>>(f, p, o, N, H, W, C, P,
                                                            points_per_block);
  } else {
    point_sample_fwd_channels<1><<<grid, kThreads, 0, s>>>(f, p, o, N, H, W, C, P,
                                                            points_per_block);
  }
  return (int)cudaGetLastError();
}
