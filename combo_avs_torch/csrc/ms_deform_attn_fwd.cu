// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel combo_avs_tpu/ops/deform_attn_pallas.py::_kernel_hfuse
// (called through _forward_hfuse / ms_deform_attn_pallas). Same function as
// combo_avs_tpu/ops/deform_attn.py::ms_deform_attn and its PyTorch twin
// combo_avs_torch/ops/deform_attn.py::ms_deform_attn_plain:
//
//   out[b, q, m*D + c] = sum_l sum_p w[b,q,m,l,p] *
//       bilinear(value[b, start_l : start_l + H_l*W_l, m, c],
//                x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5)
//
// with corners outside a level contributing zero (grid_sample zero padding,
// align_corners=False) and the same floor-based corner split as the plain
// version.
//
// What bounds it on this card, by estimate (no profiler counter has been
// read): the corner reads. At the main-path shape (20 frames x 1029 queries
// x 8 heads x 32 channels, 3 levels x 4 points) one call reads at most
// 20*1029*8*12*4 corners of 32 channels, about 1 GB at fp32 (fewer, since
// out-of-level corners are skipped), from a value tensor of about 1 MB per
// frame (21 MB for the batch). That tensor fits in the 50 MB L2, so the
// reads should be served by L2, not HBM; the arithmetic (one FMA per read
// element) is negligible.
//
// Design, for that bound:
//  * one warp per (query, head), lanes over the D channels: each corner read
//    is one contiguous D-element row of value, so neighbouring lanes read
//    neighbouring addresses (128 B per warp-read at fp32, D = 32);
//  * lanes 0..L*P-1 each load one sampling point's location and weight
//    (coalesced) and compute its 4 corner offsets and weights, with the
//    attention weight and validity folded in, once; the corner loop then
//    broadcasts them with warp shuffles, so no lane repeats that arithmetic;
//  * a corner outside its level has weight 0 and is skipped by the whole
//    warp at once (the branch is warp-uniform), so it costs no read;
//  * accumulation is fp32, the store is in value's type (fp32 or bf16);
//  * D is looped in chunks of 32 lanes, so D = 16 (lanes 16..31 idle) and
//    D > 32 work.
// The TPU kernel's tent matrices, one-hot matmuls, 128-lane level padding,
// query blocks and output chunking were workarounds for the TPU's serial
// gathers and scoped VMEM; none of them is needed here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_fwd_kernel(const T* __restrict__ value,     // [B, S, M, D]
                          const float* __restrict__ loc,   // [B, Lq, M, L, P, 2]
                          const float* __restrict__ attw,  // [B, Lq, M, L, P]
                          T* __restrict__ out,             // [B, Lq, M * D]
                          int S, int Lq, int M, int D, int L, int P,
                          Levels lv) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);  // q * M + m
  const int b = blockIdx.y;
  if (pair >= Lq * M) return;  // whole warp leaves together
  const int q = pair / M;
  const int m = pair - q * M;
  const int LP = L * P;

  // per-point corner offsets (rows of value) and weights, one point per lane
  int off[4] = {0, 0, 0, 0};
  float cw[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < LP) {
    const int l = lane / P;
    const int H = lv.h[l], W = lv.w[l];
    const int64_t pt = ((int64_t)(b * Lq + q) * M + m) * LP + lane;
    const float a = attw[pt];
    // clamping keeps the float->int conversion defined; every corner of a
    // coordinate beyond [-1, W] is outside the level either way
    const float x = fminf(fmaxf(loc[2 * pt] * W - 0.5f, -2.f), (float)W + 1.f);
    const float y = fminf(fmaxf(loc[2 * pt + 1] * H - 0.5f, -2.f), (float)H + 1.f);
    const float x0f = floorf(x), y0f = floorf(y);
    const float fx = x - x0f, fy = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float wx[2] = {1.f - fx, fx};
    const float wy[2] = {1.f - fy, fy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
      const bool valid = xi >= 0 && xi < W && yi >= 0 && yi < H;
      off[k] = valid ? lv.start[l] + yi * W + xi : 0;
      cw[k] = valid ? a * (wx[k & 1] * wy[k >> 1]) : 0.f;
    }
  }

  const int64_t row_stride = (int64_t)M * D;  // elements between value rows
  const T* vbase = value + (int64_t)b * S * row_stride + (int64_t)m * D;
  T* obase = out + ((int64_t)b * Lq + q) * row_stride + (int64_t)m * D;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < D;
    float acc = 0.f;
    for (int i = 0; i < LP; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float w = __shfl_sync(0xffffffffu, cw[k], i);
        const int o = __shfl_sync(0xffffffffu, off[k], i);
        if (w != 0.f && active) acc = fmaf(w, to_float(vbase[o * row_stride + c]), acc);
      }
    }
    if (active) store(obase + c, acc);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attw, void* out,
                   int B, int S, int Lq, int M, int D, int L, int P, const Levels& lv,
                   cudaStream_t stream) {
  const int pairs = Lq * M;
  dim3 grid((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  ms_deform_attn_fwd_kernel<T><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<T*>(out), S, Lq, M, D, L, P, lv);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out. loc and attw are
// float32. hw holds (H_l, W_l) for the L <= 4 levels, in value's level order.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* attw,
                                  void* out, int dtype, int B, int S, int Lq, int M,
                                  int D, int L, int P, const int* hw, void* stream) {
  if (L < 1 || L > kMaxLevels || L * P > 32 || P < 1) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(value, loc, attw, out, B, S, Lq, M, D, L, P, lv, s)
      : launch<float>(value, loc, attw, out, B, S, Lq, M, D, L, P, lv, s);
  return (int)err;
}
