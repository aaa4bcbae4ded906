// Fused semantic inference for Hopper (sm_90a): bilinear mask upsample,
// sigmoid and the per-class contraction over queries, in one pass.
//
// Replaces combo_avs_tpu/ops/seminf_pallas.py::_kernel (via seminf_pallas),
// the eval tail of meta_arch.semantic_inference for C <= 8 classes:
//
//   out[n, c, y, x] = scale[n] * sum_q cls[n, q, c] * sigmoid(up(mask[n, q])(y, x))
//
// where up() is F.interpolate(mode="bilinear", align_corners=False,
// antialias=False) to (H, W) >= (h, w): half-pixel centres, a source
// coordinate below 0 clamped to 0, the far corner clamped to the last row or
// column (jax.image.resize's edge renormalisation gives the same weights when
// upsampling). `cls` is already softmaxed with the no-object column dropped;
// `scale` is the optional per-frame temporal mask (1 when absent).
//
// What bounds it on this card: operations. At the S4 eval shape (mask
// [20, 100, 56, 56] -> [20, 2, 224, 224]) the kernel must read 25 MB of mask
// logits and write 8 MB, about 0.01 ms at 3.35 TB/s, but it evaluates a
// bilinear sample, a sigmoid and C multiply-adds for each of 100 million
// (pixel, query) pairs, about 1.6 GFLOP, 0.024 ms at the fp32 peak. The plain
// composition instead writes the [N, Q, H, W] upsampled masks (401 MB at
// fp32), reads and rewrites them for the sigmoid and reads them again for the
// contraction.
//
// Design, for that bound:
//  * one thread per output pixel, a block over 256 pixels of one frame n;
//    the block stages cls[n] ([Q, C] floats) in shared memory once;
//  * each thread computes its four source offsets and bilinear weights once
//    and reuses them for every query, so the loop body is four loads (the
//    56^2 planes of a frame stay in L1/L2), the interpolation, one sigmoid
//    and C FMAs into C fp32 registers (C is a template parameter);
//  * bf16 masks are read as bf16 and interpolated in fp32, as
//    combo_avs_tpu/ops/seminf_pallas.py computes them.
// The TPU kernel's separable resize matmuls and fori-loop accumulators were
// there to feed the MXU; the card interpolates each pixel directly and never
// writes the [N, Q, H, W] intermediate either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// Source index and weights along one axis, as PyTorch's upsample_bilinear2d
// computes them for align_corners=False.
__device__ __forceinline__ void axis(int dst, int n_in, float ratio, int* i0, int* step,
                                     float* l0, float* l1) {
  const float src = fmaxf(ratio * (dst + 0.5f) - 0.5f, 0.f);
  const int i = min((int)src, n_in - 1);
  *i0 = i;
  *step = (i < n_in - 1) ? 1 : 0;
  *l1 = src - (float)i;
  *l0 = 1.f - *l1;
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
seminf_kernel(const float* __restrict__ cls,    // [N, Q, C]
              const T* __restrict__ mask,       // [N, Q, h, w]
              const float* __restrict__ scale,  // [N] or nullptr
              float* __restrict__ out,          // [N, C, H, W]
              int Q, int h, int w, int H, int W, float ratio_h, float ratio_w) {
  extern __shared__ float cls_s[];  // [Q * C]
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < Q * C; i += kThreads) cls_s[i] = cls[(int64_t)n * Q * C + i];
  __syncthreads();

  const int64_t HW = (int64_t)H * W;
  const int64_t pix = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= HW) return;
  const int y = (int)(pix / W), x = (int)(pix - (int64_t)y * W);
  int y0, dy, x0, dx;
  float ly0, ly1, lx0, lx1;
  axis(y, h, ratio_h, &y0, &dy, &ly0, &ly1);
  axis(x, w, ratio_w, &x0, &dx, &lx0, &lx1);
  const int o00 = y0 * w + x0, o01 = o00 + dx, o10 = o00 + dy * w, o11 = o10 + dx;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  const int64_t plane = (int64_t)h * w;
  const T* m = mask + (int64_t)n * Q * plane;
  for (int q = 0; q < Q; ++q, m += plane) {
    // PyTorch's order: rows blended along x first, then the two rows along y
    const float v = ly0 * (lx0 * load(m, o00) + lx1 * load(m, o01)) +
                    ly1 * (lx0 * load(m, o10) + lx1 * load(m, o11));
    const float s = 1.f / (1.f + expf(-v));
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(cls_s[q * C + c], s, acc[c]);
  }
  const float k = scale ? scale[n] : 1.f;
  float* o = out + (int64_t)n * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * HW] = acc[c] * k;
}

template <int C, typename T>
int launch(const void* cls, const void* mask, const void* scale, void* out, int N, int Q, int h,
           int w, int H, int W, cudaStream_t stream) {
  const int64_t blocks = ((int64_t)H * W + kThreads - 1) / kThreads;
  const size_t smem = (size_t)Q * C * sizeof(float);
  if (blocks > 0x7fffffff || N > 65535 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)N);
  seminf_kernel<C, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(cls), static_cast<const T*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(out), Q, h, w, H, W,
      (float)h / (float)H, (float)w / (float)W);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int C, const void* cls, const void* mask, const void* scale, void* out, int N, int Q,
             int h, int w, int H, int W, cudaStream_t s) {
  switch (C) {
    case 1: return launch<1, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 2: return launch<2, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 3: return launch<3, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 4: return launch<4, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 5: return launch<5, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 6: return launch<6, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 7: return launch<7, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    case 8: return launch<8, T>(cls, mask, scale, out, N, Q, h, w, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cls [N, Q, C] float32, mask [N, Q, h, w] float32 (bf16 = 0) or bfloat16
// (bf16 = 1), scale [N] float32 or NULL, out [N, C, H, W] float32; all
// contiguous on the current device. 1 <= C <= 8, H >= h, W >= w.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int seminf_fwd(const void* cls, const void* mask, const void* scale, void* out, int N,
                          int Q, int C, int h, int w, int H, int W, int bf16, void* stream) {
  if (N < 1 || Q < 1 || h < 1 || w < 1 || H < h || W < w) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(C, cls, mask, scale, out, N, Q, h, w, H, W, s)
              : dispatch<float>(C, cls, mask, scale, out, N, Q, h, w, H, W, s);
}
