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
// Two kernels; ops/seminf_cuda.py::launch_plan picks one from the shapes and
// this file only executes the plan it is given. Both stage cls[n] ([Q, C]
// floats) in shared memory once per block, keep C fp32 accumulators per
// pixel (C is a template parameter), and read bf16 masks as bf16 and
// interpolate in fp32, as combo_avs_tpu/ops/seminf_pallas.py computes them.
//  * "pixel" (the first design; any upsampling): one thread per output
//    pixel, its four source offsets and bilinear weights computed once; per
//    query four loads through L1, the blend, expf, an IEEE divide and C FMAs.
//    About four times the cost of any one pipe at the eval shape: the loads
//    (4 a pair), the MUFU ops (2) and some 16 FP32 instructions a pair.
//  * "patch" (integer ratios H / h and W / w of at least 2, the shipped 4x
//    among them):
//    with half-pixel centres the output rows of an integer ratio r fall in
//    bands of r rows, offset by r / 2, that share one pair of source rows;
//    columns alike. A thread computes a P x P patch (P = 4 or 2) of one
//    band cell: per query it loads the cell's 2 x 2 source values once
//    (through L1), blends P values along each of its two source rows and
//    each output pixel along y from them (PyTorch's x-then-y order, so fp32
//    agrees to a few roundings), then takes the sigmoid as 1 / (1 + 2^(-v
//    log2 e)) with the special-function unit's ex2 and reciprocal
//    approximations, one reciprocal shared by two pixels (1 / a = b / (a b);
//    the exponent capped at 63 so that a b stays finite). Per pair: 0.25
//    loads, 1.5 MUFU ops and about 12 instructions issued, against the
//    pixel kernel's 4 loads and some 20.
//
// What the sweep found (scripts/bench_seminf_plans.py, device ms at the eval
// shape, NVIDIA H100 80GB HBM3, 700.00 W): patch 0.0750 fp32 / 0.0707 bf16
// against pixel 0.1941 / 0.1882; 4 x 4 patches at 128 / 256 / 512 threads
// 0.0744 / 0.0750 / 0.1380 fp32 (512: 140 blocks on 132 SMs), 2 x 2 patches
// 0.0978-0.1004. Measured on earlier trees and not kept: 1 x 1 patches,
// 0.2305-0.2352 (slower than the pixel kernel, so a ratio below 2 takes
// the pixel kernel); the block staging 4-32 queries of its source rows in
// shared memory, 0.0991-0.1087 at 4 x 4 (32-45% slower than L1: one 2 x 2
// window per 16 pixels leaves the loads far from the limit); one reciprocal
// for each pixel instead of one for two, 0.0758 / 0.0750 against 0.0748 /
// 0.0706-0.0711 in the same call.
// Errors against the plain version (chip_smoke.py): 3.0e-7 of max |plain| in
// fp32 (bound 1e-5), 7.6e-4 in bf16 (bound 8e-3, as the pixel kernel's: the
// plain version's bf16 roundings dominate). What bounds the patch kernel now
// is instruction issue with the MUFU pipe beside it (about 47 us of issue at
// 1.755 GHz against the measured 0.075 ms).
//
// The TPU kernel's separable resize matmuls and fori-loop accumulators were
// there to feed the MXU; the card interpolates directly and never writes the
// [N, Q, H, W] intermediate either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // the pixel kernel
constexpr int kMaxThreads = 512;  // the patch kernel

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

constexpr float kLog2e = 1.4426950408889634f;
// the largest exponent 1 + 2^t is taken at, so that a product of two stays
// finite; sigmoid(v) below 2^-63 (v < -43.6) comes out as 2^-63
constexpr float kMaxExponent = 63.f;

__device__ __forceinline__ float ex2_approx(float t) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return e;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1 + exp(-v) = 1 + 2^(-v log2 e) by the special-function unit's ex2, the
// exponent capped (a NaN stays a NaN)
__device__ __forceinline__ float one_plus_exp_neg(float v) {
  const float t = -kLog2e * v;
  return 1.f + ex2_approx(t > kMaxExponent ? kMaxExponent : t);
}

// Two sigmoids, 1 / (1 + exp(-v)), from one ex2 each and one fast
// reciprocal: 1 / a = b / (a b), 1 / b = a / (a b) (three MUFU ops for two;
// expf and an IEEE divide take about 10 more FP32 instructions each)
__device__ __forceinline__ void fast_sigmoid2(float v0, float v1, float* s0, float* s1) {
  const float a = one_plus_exp_neg(v0), b = one_plus_exp_neg(v1);
  const float r = rcp_approx(a * b);
  *s0 = b * r;
  *s1 = a * r;
}

__device__ __forceinline__ float load_l1(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float load_l1(const __nv_bfloat16* p, int i) {
  return __bfloat162float(__ldg(p + i));
}

// The source row (or column) and the weights of output row `dst` of band
// `band` (0..n_in): every output row of band b reads source rows b - 1 and b
// (clamped), as PyTorch's align_corners=False bilinear upsample by an
// integer ratio puts them.
__device__ __forceinline__ void band_axis(int band, int dst, int n_in, float ratio, int* i0,
                                          int* step, float* l0, float* l1) {
  const int i = min(max(band - 1, 0), n_in - 1);
  const float src = fmaxf(ratio * (dst + 0.5f) - 0.5f, 0.f);
  *i0 = i;
  *step = (i < n_in - 1) ? 1 : 0;
  *l1 = src - (float)i;
  *l0 = 1.f - *l1;
}

// Integer ratios ry = H / h, rx = W / w. Output rows fall in bands of ry
// rows that share one pair of source rows: band b (0..h) covers rows
// [ry * (b - 1) + ry / 2, ry * b + ry / 2) of [0, H); columns alike. A thread
// computes a P x P patch of one band cell (a cell has ceil(ry / P) x
// ceil(rx / P) patches): per query it loads the cell's 2 x 2 source values
// once through L1, blends P x-values along each of the two source rows, then
// each output pixel along y (PyTorch's x-then-y order), takes the sigmoid
// and adds cls x sigmoid into its C accumulators. The block's patches are
// consecutive in (patch row, patch column) order within frame n.
template <int C, typename T, int P>
__global__ void __launch_bounds__(kMaxThreads)
seminf_patch_kernel(const float* __restrict__ cls,    // [N, Q, C]
                    const T* __restrict__ mask,       // [N, Q, h, w]
                    const float* __restrict__ scale,  // [N] or nullptr
                    float* __restrict__ out,          // [N, C, H, W]
                    int Q, int h, int w, int H, int W, float ratio_h, float ratio_w) {
  extern __shared__ float cls_s[];  // [Q * C]
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < Q * C; i += blockDim.x) cls_s[i] = cls[(int64_t)n * Q * C + i];

  const int ry = H / h, rx = W / w;
  const int py = (ry + P - 1) / P, px = (rx + P - 1) / P;  // patches per band cell
  const int cols = (w + 1) * px, patches = (h + 1) * py * cols;
  const int first = blockIdx.x * blockDim.x;
  const int patch = min(first + (int)threadIdx.x, patches - 1);  // the tail recomputes the last
  const bool active = first + (int)threadIdx.x < patches;
  const int prow = patch / cols, pcol = patch - prow * cols;
  const int by = prow / py, bx = pcol / px;
  const int y_begin = ry * (by - 1) + ry / 2 + (prow - by * py) * P;
  const int x_begin = rx * (bx - 1) + rx / 2 + (pcol - bx * px) * P;
  const int y_end = min(H, ry * by + ry / 2), x_end = min(W, rx * bx + rx / 2);

  int y0, dy, x0, dx;
  float ly0[P], ly1[P], lx0[P], lx1[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    band_axis(by, y_begin + i, h, ratio_h, &y0, &dy, &ly0[i], &ly1[i]);
    band_axis(bx, x_begin + i, w, ratio_w, &x0, &dx, &lx0[i], &lx1[i]);
  }

  float acc[P][P][C];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][j][c] = 0.f;

  const int plane = h * w;
  const T* m = mask + (int64_t)n * Q * plane;
  const int o00 = y0 * w + x0, o01 = o00 + dx, o10 = o00 + dy * w, o11 = o10 + dx;
  __syncthreads();
#pragma unroll 2
  for (int q = 0; q < Q; ++q) {
    const T* mq = m + (int64_t)q * plane;
    const float v00 = load_l1(mq, o00), v01 = load_l1(mq, o01);
    const float v10 = load_l1(mq, o10), v11 = load_l1(mq, o11);
    float top[P], bot[P], cq[C];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      top[j] = lx0[j] * v00 + lx1[j] * v01;
      bot[j] = lx0[j] * v10 + lx1[j] * v11;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) cq[c] = cls_s[q * C + c];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float sg[P];
#pragma unroll
      for (int j = 0; j < P; j += 2)
        fast_sigmoid2(ly0[i] * top[j] + ly1[i] * bot[j],
                      ly0[i] * top[j + 1] + ly1[i] * bot[j + 1], &sg[j], &sg[j + 1]);
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][j][c] = fmaf(cq[c], sg[j], acc[i][j][c]);
    }
  }
  if (!active) return;
  const float k = scale ? scale[n] : 1.f;
  const int64_t HW = (int64_t)H * W;
  float* o = out + (int64_t)n * C * HW;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = y_begin + i;
    if (y < 0 || y >= y_end) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int x = x_begin + j;
      if (x < 0 || x >= x_end) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) __stcs(o + c * HW + (int64_t)y * W + x, acc[i][j][c] * k);
    }
  }
}

template <int C, typename T>
int launch_pixel(const void* cls, const void* mask, const void* scale, void* out, int N, int Q,
                 int h, int w, int H, int W, int blocks, int smem, cudaStream_t stream) {
  seminf_kernel<C, T><<<dim3((unsigned)blocks, (unsigned)N), kThreads, smem, stream>>>(
      static_cast<const float*>(cls), static_cast<const T*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(out), Q, h, w, H, W,
      (float)h / (float)H, (float)w / (float)W);
  return (int)cudaGetLastError();
}

template <int C, typename T>
int launch_patch(const void* cls, const void* mask, const void* scale, void* out, int N, int Q,
                 int h, int w, int H, int W, int patch, int threads, int blocks, int smem,
                 cudaStream_t stream) {
  const dim3 grid((unsigned)blocks, (unsigned)N);
  const float rh = (float)h / (float)H, rw = (float)w / (float)W;
  const float* c = static_cast<const float*>(cls);
  const T* m = static_cast<const T*>(mask);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (patch == 2)
    seminf_patch_kernel<C, T, 2><<<grid, threads, smem, stream>>>(c, m, sc, o, Q, h, w, H, W, rh, rw);
  else
    seminf_patch_kernel<C, T, 4><<<grid, threads, smem, stream>>>(c, m, sc, o, Q, h, w, H, W, rh, rw);
  return (int)cudaGetLastError();
}

// One plan: C selects the instantiation; the rest are arguments.
struct Plan {
  int N, Q, C, h, w, H, W, bf16, kernel, threads, patch, blocks, smem;
};

template <typename T, int C>
int run(const Plan& p, const void* cls, const void* mask, const void* scale, void* out,
        cudaStream_t s) {
  if (p.kernel == 0)
    return launch_pixel<C, T>(cls, mask, scale, out, p.N, p.Q, p.h, p.w, p.H, p.W, p.blocks,
                              p.smem, s);
  return launch_patch<C, T>(cls, mask, scale, out, p.N, p.Q, p.h, p.w, p.H, p.W, p.patch,
                            p.threads, p.blocks, p.smem, s);
}

template <typename T>
int dispatch(const Plan& p, const void* cls, const void* mask, const void* scale, void* out,
             cudaStream_t s) {
  switch (p.C) {
    case 1: return run<T, 1>(p, cls, mask, scale, out, s);
    case 2: return run<T, 2>(p, cls, mask, scale, out, s);
    case 3: return run<T, 3>(p, cls, mask, scale, out, s);
    case 4: return run<T, 4>(p, cls, mask, scale, out, s);
    case 5: return run<T, 5>(p, cls, mask, scale, out, s);
    case 6: return run<T, 6>(p, cls, mask, scale, out, s);
    case 7: return run<T, 7>(p, cls, mask, scale, out, s);
    case 8: return run<T, 8>(p, cls, mask, scale, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Execute one launch plan of ops/seminf_cuda.py::launch_plan. cls [N, Q, C]
// float32, mask [N, Q, h, w] float32 or bfloat16, scale [N] float32 or NULL,
// out [N, C, H, W] float32; all contiguous on the current device. plan holds
// 13 ints: N, Q, C, h, w, H, W, bf16 (mask type), the kernel (0 pixel, 1
// patch), threads per block, the patch side (2 or 4), blocks per frame (the
// grid has N rows), dynamic shared-memory bytes (cls[n], Q x C floats).
// 1 <= C <= 8, H >= h, W >= w; the patch kernel needs H % h == 0 and
// W % w == 0. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan this function cannot execute.
extern "C" int seminf_fwd(const void* cls, const void* mask, const void* scale, void* out,
                          const int* plan, void* stream) {
  const Plan p = {plan[0], plan[1], plan[2], plan[3],  plan[4],  plan[5], plan[6],
                  plan[7], plan[8], plan[9], plan[10], plan[11], plan[12]};
  const int bad = (int)cudaErrorInvalidValue;
  if (p.N < 1 || p.N > 65535 || p.Q < 1 || p.C < 1 || p.C > 8 || p.h < 1 || p.w < 1 ||
      p.H < p.h || p.W < p.w || (int64_t)p.H * p.W >= (1ll << 31) || p.blocks < 1 ||
      p.smem > 48 * 1024 || p.smem != p.Q * p.C * 4)
    return bad;
  if (p.kernel == 0) {
    if (p.threads != kThreads || (int64_t)p.blocks * kThreads < (int64_t)p.H * p.W) return bad;
  } else {
    const int ry = p.H / p.h, rx = p.W / p.w;
    if (p.kernel != 1 || p.H % p.h != 0 || p.W % p.w != 0 ||
        (p.patch != 2 && p.patch != 4) || p.threads < 32 ||
        p.threads > kMaxThreads || p.threads % 32 != 0 ||
        (int64_t)p.blocks * p.threads <
            (int64_t)(p.h + 1) * ((ry + p.patch - 1) / p.patch) * (p.w + 1) *
                ((rx + p.patch - 1) / p.patch))
      return bad;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.bf16 ? dispatch<__nv_bfloat16>(p, cls, mask, scale, out, s)
                : dispatch<float>(p, cls, mask, scale, out, s);
}
