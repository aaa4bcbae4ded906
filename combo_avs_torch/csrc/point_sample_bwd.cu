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
// What bounds it on this card: memory, and for dimg the atomics. dimg reads
// dout once and adds four weighted values per element into dfeat (fp32
// atomicAdd, resolved in L2); at the criterion's shape ([120, 56, 56, 1] at
// 12544 points) a mask's 3136 pixels take 4 x 12544 adds. dxy reads the four
// corners of every channel and dout once, and writes two floats per point.
//
// Design: the forward's layout, a group of G lanes per (n, p) (G = the
// smallest power of two >= C, at most 32) that computes the corner offsets
// and weights once and loops over the channels, so the reads of a group are
// contiguous channel runs. dxy reduces the group's partial sums with warp
// shuffles. Atomic order varies from run to run, so dimg's sums are not
// bitwise reproducible; the error is a few fp32 roundings of each sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

}  // namespace

// All tensors float32, contiguous, on the current device; dfeat zeroed by the
// caller. Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int point_sample_bwd_dimg(const void* pts, const void* dout, void* dfeat, int N,
                                     int H, int W, int C, int P, int log2_group, void* stream) {
  unsigned blocks;
  if (int err = blocks_for(N, P, log2_group, &blocks)) return err;
  point_sample_dimg_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(dout),
      static_cast<float*>(dfeat), N, H, W, C, P, log2_group);
  return (int)cudaGetLastError();
}

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
