// Multi-scale deformable attention, backward (the VJP of ms_deform_attn_fwd.cu),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel combo_avs_tpu/ops/deform_attn_pallas.py::
// _bwd_kernel_hfuse (called through _backward_hfuse, the custom VJP of
// ms_deform_attn_pallas) and its per-head twin _bwd_kernel. Same function as
// autograd of combo_avs_torch/ops/deform_attn.py::ms_deform_attn_plain. With
// g = dout[b, q, m*D : (m+1)*D], for every sampling point (l, p) of
// (b, q, m), attention weight a, fractional parts (fx, fy) and corner values
// v_k of its four corners (zero outside the level):
//
//   dvalue[b, corner_k, m, :] += a * w_k * g            (w_k: bilinear weight)
//   dweights[b, q, m, l, p]    = sum_k w_k <g, v_k>
//   dloc[b, q, m, l, p]        = a * (W_l * sum_k dwx_k wy_k <g, v_k>,
//                                     H_l * sum_k wx_k dwy_k <g, v_k>)
//
// where dwx_k is -1 on the floor corner and +1 on the next one (so at a
// fractional part of exactly 0 the slope is towards the next corner, as
// autograd of the plain version and the TPU kernel's tent derivative give),
// and corners outside a level contribute to no gradient.
//
// What bounds it on this card: memory traffic through L2. Per (b, q, m) the
// kernel reads up to 4 corner rows per point and adds 4 rows into dvalue with
// fp32 atomics; value and dvalue (42 MB each at the training shape, 40 frames
// x 1029 tokens x 8 heads x 32 channels) do not both fit in the 50 MB L2.
// The arithmetic (a few FMAs per element read) is negligible.
//
// Design, mirroring the forward:
//  * one warp per (b, q, m), lanes over the D channels, so each corner read
//    and each atomic add is one contiguous D-float row;
//  * lanes 0..L*P-1 compute one sampling point's corner rows and weights once;
//    the point loop broadcasts them with shuffles;
//  * per point, each lane forms its channel's products g * v_k, the warp
//    reduces the three sums (dweights, dx, dy) with shuffles, and the lane
//    that owns the point keeps them; dloc and dweights are stored once per
//    point, coalesced;
//  * dvalue is accumulated in a zeroed fp32 buffer with atomicAdd. Atomic
//    order varies from run to run, so dvalue is not bitwise reproducible
//    (a few fp32 roundings of each sum).
// fp32 value only; the TPU kernel's tent matrices, GV = g V^T matmuls and
// query blocking were workarounds for serial TPU gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_bwd_kernel(const float* __restrict__ value,  // [B, S, M, D]
                          const float* __restrict__ loc,    // [B, Lq, M, L, P, 2]
                          const float* __restrict__ attw,   // [B, Lq, M, L, P]
                          const float* __restrict__ grad,   // [B, Lq, M * D]
                          float* __restrict__ dvalue,       // [B, S, M, D], zeroed
                          float* __restrict__ dloc,         // [B, Lq, M, L, P, 2]
                          float* __restrict__ dattw,        // [B, Lq, M, L, P]
                          int S, int Lq, int M, int D, int L, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);  // q * M + m
  const int b = blockIdx.y;
  if (pair >= Lq * M) return;  // whole warp leaves together
  const int q = pair / M;
  const int m = pair - q * M;
  const int LP = L * P;

  // this lane's sampling point: corner rows (-1 outside the level), fractional
  // parts and attention weight
  int row[4] = {-1, -1, -1, -1};
  float fx = 0.f, fy = 0.f, a = 0.f;
  const int64_t pt = ((int64_t)(b * Lq + q) * M + m) * LP + lane;
  if (lane < LP) {
    const int l = lane / P;
    const int H = lv.h[l], W = lv.w[l];
    a = attw[pt];
    // rounded as the plain version rounds (multiply, then subtract; no FMA),
    // so both split a coordinate at the same corner and take the same slope;
    // the same clamp as the forward: beyond [-1, W] every corner is outside
    const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt], (float)W), 0.5f), -2.f),
                          (float)W + 1.f);
    const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt + 1], (float)H), 0.5f), -2.f),
                          (float)H + 1.f);
    const float x0f = floorf(x), y0f = floorf(y);
    fx = x - x0f;
    fy = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
      const bool valid = xi >= 0 && xi < W && yi >= 0 && yi < H;
      row[k] = valid ? lv.start[l] + yi * W + xi : -1;
    }
  }

  const int64_t row_stride = (int64_t)M * D;  // elements between value rows
  const int64_t vofs = (int64_t)b * S * row_stride + (int64_t)m * D;
  const float* vbase = value + vofs;
  float* dvbase = dvalue + vofs;
  const float* gbase = grad + ((int64_t)b * Lq + q) * row_stride + (int64_t)m * D;

  float my_dw = 0.f, my_dx = 0.f, my_dy = 0.f;  // kept by the lane that owns the point
  for (int i = 0; i < LP; ++i) {
    int r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = __shfl_sync(0xffffffffu, row[k], i);
    const float pfx = __shfl_sync(0xffffffffu, fx, i);
    const float pfy = __shfl_sync(0xffffffffu, fy, i);
    const float pa = __shfl_sync(0xffffffffu, a, i);
    const float wx[2] = {1.f - pfx, pfx};
    const float wy[2] = {1.f - pfy, pfy};
    float sw = 0.f, sx = 0.f, sy = 0.f;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < D;
      const float g = active ? gbase[c] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r[k] < 0) continue;  // warp-uniform: the row is the point's
        const float w = wx[k & 1] * wy[k >> 1];
        const float s = active ? g * vbase[r[k] * row_stride + c] : 0.f;
        sw = fmaf(w, s, sw);
        sx = fmaf((k & 1) ? wy[k >> 1] : -wy[k >> 1], s, sx);
        sy = fmaf((k >> 1) ? wx[k & 1] : -wx[k & 1], s, sy);
        if (active) atomicAdd(dvbase + r[k] * row_stride + c, pa * w * g);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sw += __shfl_xor_sync(0xffffffffu, sw, o);
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
    }
    if (lane == i) {
      my_dw = sw;
      my_dx = pa * sx;
      my_dy = pa * sy;
    }
  }
  if (lane < LP) {
    const int l = lane / P;
    dattw[pt] = my_dw;
    dloc[2 * pt] = my_dx * (float)lv.w[l];
    dloc[2 * pt + 1] = my_dy * (float)lv.h[l];
  }
}

}  // namespace

// value, loc, attw, grad float32; dvalue float32 and zeroed by the caller;
// dloc, dattw float32. hw holds (H_l, W_l) for the L <= 4 levels, in value's
// level order. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc, const void* attw,
                                  const void* grad, void* dvalue, void* dloc, void* dattw,
                                  int B, int S, int Lq, int M, int D, int L, int P,
                                  const int* hw, void* stream) {
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
  dim3 grid((Lq * M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  ms_deform_attn_bwd_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<const float*>(grad),
      static_cast<float*>(dvalue), static_cast<float*>(dloc), static_cast<float*>(dattw),
      S, Lq, M, D, L, P, lv);
  return (int)cudaGetLastError();
}
