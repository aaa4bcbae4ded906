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
// reads and one FMA each, so the arithmetic is negligible; at the matcher's
// shape ([40, 56, 56, 100] at 12544 points) the 200 MB output dominates the
// bytes, and the 50 MB input fits in the 50 MB L2 only in part.
//
// Design, for that bound:
//  * a group of G lanes per (n, p), G = the smallest power of two >= C, at
//    most 32: the group computes the point's four corner offsets and weights
//    once and loops over the channels, so every corner read and every output
//    store of a group is one contiguous run of channels (channels-last);
//  * C = 1 (the criterion) is one lane per point: neighbouring lanes read
//    neighbouring points and write neighbouring outputs;
//  * the pixel coordinates are rounded as the plain version rounds them
//    (a multiply, then a subtract, never contracted into an FMA), so both
//    split a coordinate at the same corner.
// The TPU kernels' row-selection matmuls, tent matrices and point blocking
// existed because TPU gathers were serial; the card gathers directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The four corners (x0,y0), (x1,y0), (x0,y1), (x1,y1) of one point: the row
// of each in the [H*W] plane (-1 when outside the image) and its weight.
__device__ __forceinline__ void point_corners(const float* __restrict__ pt, int H, int W,
                                              int* row, float* w) {
  // clamping keeps the float->int conversion defined; every corner of a
  // coordinate beyond [-1, W] is outside the image either way
  const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(pt[0], (float)W), 0.5f), -2.f), (float)W + 1.f);
  const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(pt[1], (float)H), 0.5f), -2.f), (float)H + 1.f);
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

__global__ void __launch_bounds__(kThreads)
point_sample_fwd_kernel(const float* __restrict__ feat,  // [N, H, W, C]
                        const float* __restrict__ pts,   // [N, P, 2]
                        float* __restrict__ out,         // [N, P, C]
                        int N, int H, int W, int C, int P, int log2_group) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t np = t >> log2_group;  // flat (n, p)
  if (np >= (int64_t)N * P) return;
  const int group = 1 << log2_group;
  const int sub = (int)(t & (group - 1));
  const int64_t n = np / P;
  int row[4];
  float w[4];
  point_corners(pts + 2 * np, H, W, row, w);
  const float* base = feat + n * H * W * (int64_t)C;
  float* o = out + np * C;
  for (int c = sub; c < C; c += group) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (row[k] >= 0) acc = fmaf(w[k], base[(int64_t)row[k] * C + c], acc);
    }
    o[c] = acc;
  }
}

}  // namespace

// feat [N, H, W, C], pts [N, P, 2] and out [N, P, C] are float32, contiguous,
// on the current device. log2_group: lanes per point, log2 (0..5).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int point_sample_fwd(const void* feat, const void* pts, void* out, int N, int H,
                                int W, int C, int P, int log2_group, void* stream) {
  if (log2_group < 0 || log2_group > 5 || N < 1 || P < 1 || C < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = ((int64_t)N * P) << log2_group;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  point_sample_fwd_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const float*>(pts), static_cast<float*>(out),
      N, H, W, C, P, log2_group);
  return (int)cudaGetLastError();
}
