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
// Two kernels; ops/deform_attn_cuda.py::bwd_launch_plan picks one from the
// shapes and the card's opt-in shared-memory limit, and this file only
// executes the plan it is given.
//
//  * "global" (the first design): one warp per (b, q, m), its lanes over the
//    D channels, so each corner read and each add into dvalue is one
//    contiguous D-float row; the lanes that own a sampling point compute its
//    corner rows and weights once and the point loop broadcasts them with
//    shuffles; per point the warp reduces the three sums (dweights, dx, dy)
//    with shuffles. dvalue is summed in a zeroed buffer with global fp32
//    atomicAdd. What bounds it: L2 atomic traffic, about 506 M atomics into
//    a 42 MB dvalue at the training shape (value [40, 1029, 8, 32]), which
//    with value does not fit the 50 MB L2: 1.05-1.09 ms against a 0.066 ms
//    bound (H100 at 700 W).
//  * "level_slice": every sampling point belongs to one level, so
//    dvalue[b, start_l : start_l + H_l * W_l, m, :] receives only the points
//    of level l of head m in frame b. One block per (b, m, l) owns that
//    slice. It copies the level's value rows of head m into dynamic shared
//    memory (cp.async) and zeroes a dvalue slice beside them (2 x 100,352 B
//    for the 28^2 level at D = 32, above 48 KB, so the launcher raises the
//    function's opt-in limit). Its warps then walk the level's Lq * P
//    sampling points, one lane per point (32 / P queries a warp at a time,
//    their grad rows staged per warp): each lane loops over the D channels
//    starting at its own lane index, so the warp's 32 accesses to rows of
//    the value, dvalue and grad slices fall in distinct banks; it sums
//    <g, v_k> per corner in registers (no shuffles: dweights and dloc come
//    from the four corner sums), and adds a * w_k * g_c into the shared
//    dvalue slice with atomicAdd. After a barrier the block stores the
//    slice to dvalue once, a coalesced row at a time. Every dvalue, dloc and
//    dweights element has exactly one owning block: no global atomics, and
//    dvalue needs no zeroing. Each block walks Lq * P points whatever its
//    level, so the blocks take about the same time; all reserve the largest
//    level's shared memory, one block per SM at the training shape.
//    What bounds it: the shared-memory adds. A shared float atomicAdd is a
//    compare-and-swap loop on this card (ATOMS.CAST.SPIN in the SASS), and
//    the compiler puts each add's loop in series with the next, so a warp
//    waits out about one load and one swap for each of its 4 x D adds per
//    point; more warps hide more of it (scripts/bench_deform_bwd_plans.py:
//    1.69, 1.01 and 0.77 ms at 8, 16 and 24 warps; 32 do not fit beside the
//    grad rows). Variants of this kernel timed once with the same script:
//    with plain, racy adds 0.45 ms, with no adds 0.29 ms. Also tried: the
//    first level-slice design, one warp per query with lanes over D (the
//    global kernel's layout) and value gathered through L1, 1.11-2.30 ms at
//    32-8 warps; the adds as batched 32-bit compare-and-swaps (ATOMS.CAS),
//    3.45 ms; grad read through L1 instead of staged, which lets 32 warps
//    fit, 0.80 ms.
//
// Atomic order (global atomics in one, shared ones in the other) varies from
// run to run, so dvalue is not bitwise reproducible (a few fp32 roundings of
// each sum). The TPU kernel's tent matrices, GV = g V^T matmuls and query
// blocking were workarounds for serial TPU gathers, and its dval block
// resident across the query grid axis is what the level-slice kernel's
// shared slice keeps.
//
// Element types: value and grad are both float32 or both bfloat16 (the bf16
// AMP training step), as the TPU kernel reads either (deform_attn_pallas.py:
// 507, 511). Loads convert to fp32, and every product and sum stays fp32, in
// registers and in the dvalue accumulator (the shared slice, or the global
// kernel's zeroed fp32 buffer). The level-slice kernel converts dvalue to
// the value's type in its one final store, as the TPU kernel casts its fp32
// dval (:595, :617); the global kernel leaves its fp32 sums to the caller,
// which casts them. In bf16 the staged value rows take 2 bytes an element;
// the dvalue rows and the staged grad rows stay fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kGlobalWarps = 8;  // the global kernel's warps per block
constexpr int kMaxDevices = 64;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One sampling point, as the lane that owns it sees it: its corner rows (-1
// outside the level), fractional parts and attention weight.
struct Point {
  int row[4];
  float fx, fy, a;
};

// The point at flat index pt of an H x W level whose first row is row0.
__device__ __forceinline__ Point setup_point(const float* __restrict__ loc,
                                             const float* __restrict__ attw, int64_t pt, int H,
                                             int W, int row0) {
  Point p;
  p.a = attw[pt];
  // rounded as the plain version rounds (multiply, then subtract; no FMA),
  // so both split a coordinate at the same corner and take the same slope;
  // the same clamp as the forward: beyond [-1, W] every corner is outside
  const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt], (float)W), 0.5f), -2.f),
                        (float)W + 1.f);
  const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt + 1], (float)H), 0.5f), -2.f),
                        (float)H + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  p.fx = x - x0f;
  p.fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
    const bool valid = xi >= 0 && xi < W && yi >= 0 && yi < H;
    p.row[k] = valid ? row0 + yi * W + xi : -1;
  }
  return p;
}

// "global": one warp per (b, q, m), all L * P points, dvalue by global
// atomics into a zeroed fp32 buffer.
template <typename T>
__global__ void __launch_bounds__(kGlobalWarps * 32)
ms_deform_attn_bwd_global(const T* __restrict__ value,      // [B, S, M, D]
                          const float* __restrict__ loc,    // [B, Lq, M, L, P, 2]
                          const float* __restrict__ attw,   // [B, Lq, M, L, P]
                          const T* __restrict__ grad,       // [B, Lq, M * D]
                          float* __restrict__ dvalue,       // [B, S, M, D] fp32, zeroed
                          float* __restrict__ dloc,         // [B, Lq, M, L, P, 2]
                          float* __restrict__ dattw,        // [B, Lq, M, L, P]
                          int S, int Lq, int M, int D, int L, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kGlobalWarps + (threadIdx.x >> 5);  // q * M + m
  const int b = blockIdx.y;
  if (pair >= Lq * M) return;  // whole warp leaves together
  const int q = pair / M;
  const int m = pair - q * M;
  const int LP = L * P;
  const int64_t pt = ((int64_t)(b * Lq + q) * M + m) * LP + lane;
  const int l = lane < LP ? lane / P : 0;
  Point me = {{-1, -1, -1, -1}, 0.f, 0.f, 0.f};
  if (lane < LP) me = setup_point(loc, attw, pt, lv.h[l], lv.w[l], lv.start[l]);

  const int64_t row_stride = (int64_t)M * D;  // elements between value rows
  const int64_t vofs = (int64_t)b * S * row_stride + (int64_t)m * D;
  const T* vbase = value + vofs;
  float* dvbase = dvalue + vofs;
  const T* gbase = grad + ((int64_t)b * Lq + q) * row_stride + (int64_t)m * D;

  float my_dw = 0.f, my_dx = 0.f, my_dy = 0.f;  // kept by the lane that owns the point
  for (int i = 0; i < LP; ++i) {
    int r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = __shfl_sync(0xffffffffu, me.row[k], i);
    const float pfx = __shfl_sync(0xffffffffu, me.fx, i);
    const float pfy = __shfl_sync(0xffffffffu, me.fy, i);
    const float pa = __shfl_sync(0xffffffffu, me.a, i);
    const float wx[2] = {1.f - pfx, pfx};
    const float wy[2] = {1.f - pfy, pfy};
    float sw = 0.f, sx = 0.f, sy = 0.f;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < D;
      const float g = active ? to_float(gbase[c]) : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r[k] < 0) continue;  // warp-uniform: the row is the point's
        const float w = wx[k & 1] * wy[k >> 1];
        const float s = active ? g * to_float(vbase[r[k] * row_stride + c]) : 0.f;
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
    dattw[pt] = my_dw;
    dloc[2 * pt] = my_dx * (float)lv.w[l];
    dloc[2 * pt + 1] = my_dy * (float)lv.h[l];
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Copies one value element into the staged slice: cp.async for fp32, a plain
// 2-byte load and store for bf16 (cp.async moves 4, 8 or 16 bytes).
__device__ __forceinline__ void stage(float* smem, const float* gmem) { cp_async4(smem, gmem); }
__device__ __forceinline__ void stage(__nv_bfloat16* smem, const __nv_bfloat16* gmem) {
  *smem = *gmem;
}

// The staged value slice's bytes, rounded up to 16 so that the fp32 dvalue
// slice after it is aligned.
__host__ __device__ __forceinline__ int value_slice_bytes(int slice, int esize) {
  return (slice * esize + 15) / 16 * 16;
}

// "level_slice": one block per (b, m, l), blockIdx.x = m * L + l and
// blockIdx.y = b. Dynamic shared memory holds the level's value rows of head
// m ([H_l * W_l, D] of T, `slice` elements reserved for the largest level),
// its fp32 dvalue rows (`slice` floats) and each warp's fp32 grad rows
// ([32 / P, D]).
template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
ms_deform_attn_bwd_level(const T* __restrict__ value, const float* __restrict__ loc,
                         const float* __restrict__ attw, const T* __restrict__ grad,
                         T* __restrict__ dvalue,  // [B, S, M, D], every element written
                         float* __restrict__ dloc, float* __restrict__ dattw, int S, int Lq,
                         int M, int D, int L, int P, Levels lv, int slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x / L, l = blockIdx.x - m * L, b = blockIdx.y;
  const int H = lv.h[l], W = lv.w[l], HW = H * W;
  const int per_warp = 32 / P;  // queries a warp takes at a time, all P points each
  T* vs = reinterpret_cast<T*>(smem_raw);
  float* ds = reinterpret_cast<float*>(smem_raw + value_slice_bytes(slice, sizeof(T)));
  float* gs = ds + slice + warp * per_warp * D;

  const int64_t row_stride = (int64_t)M * D;
  // the level's first value row of head m in frame b
  const int64_t lofs = ((int64_t)b * S + lv.start[l]) * row_stride + (int64_t)m * D;
  for (int r = warp; r < HW; r += kWarps)
    for (int c = lane; c < D; c += 32) {
      stage(vs + r * D + c, value + lofs + r * row_stride + c);
      ds[r * D + c] = 0.f;
    }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int LP = L * P;
  const int p = lane % P, ql = lane / P;  // this lane's point, and its query in the warp's group
  const T* gsrc = grad + (int64_t)b * Lq * row_stride + (int64_t)m * D;
  const float* grow = gs + (ql < per_warp ? ql : 0) * D;
  for (int q0 = warp * per_warp; q0 < Lq; q0 += kWarps * per_warp) {
    for (int i = lane; i < per_warp * D; i += 32) {
      const int qi = i / D, q = q0 + qi;
      gs[i] = q < Lq ? to_float(gsrc[q * row_stride + (i - qi * D)]) : 0.f;
    }
    __syncwarp();
    const int q = q0 + ql;
    const bool mine = ql < per_warp && q < Lq;
    const int64_t pt = ((int64_t)(b * Lq + (mine ? q : 0)) * M + m) * LP + l * P + p;
    Point me = {{-1, -1, -1, -1}, 0.f, 0.f, 0.f};
    if (mine) me = setup_point(loc, attw, pt, H, W, 0);
    const float wx[2] = {1.f - me.fx, me.fx};
    const float wy[2] = {1.f - me.fy, me.fy};
    int ofs[4];
    float aw[4], sum[4];  // a * w_k, and <g, v_k> summed over the channels
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ofs[k] = (me.row[k] < 0 ? 0 : me.row[k]) * D;  // an outside corner reads row 0, unused
      aw[k] = me.a * (wx[k & 1] * wy[k >> 1]);
      sum[k] = 0.f;
    }
    // each lane starts at its own channel and wraps around, so at D = 32
    // the warp's 32 accesses to a row of each fp32 array fall in distinct banks
    int c = lane % D;
#pragma unroll 4
    for (int i = 0; i < D; ++i) {
      const float g = grow[c];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sum[k] = fmaf(g, to_float(vs[ofs[k] + c]), sum[k]);
        if (me.row[k] >= 0) atomicAdd(ds + ofs[k] + c, aw[k] * g);
      }
      c = c + 1 == D ? 0 : c + 1;
    }
    __syncwarp();  // every lane has read gs before the next group overwrites it
    if (mine) {
      float dw = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float s = me.row[k] >= 0 ? sum[k] : 0.f;
        dw = fmaf(wx[k & 1] * wy[k >> 1], s, dw);
        sx = fmaf((k & 1) ? wy[k >> 1] : -wy[k >> 1], s, sx);
        sy = fmaf((k >> 1) ? wx[k & 1] : -wx[k & 1], s, sy);
      }
      dattw[pt] = dw;
      dloc[2 * pt] = me.a * sx * (float)W;
      dloc[2 * pt + 1] = me.a * sy * (float)H;
    }
  }
  __syncthreads();
  T* out = dvalue + lofs;
  for (int r = warp; r < HW; r += kWarps)
    for (int c = lane; c < D; c += 32) store(out + r * row_stride + c, ds[r * D + c]);
}

// Raise kernel's dynamic shared-memory limit to `bytes` on the current device,
// once per device and size.
template <typename T, int kWarps>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(ms_deform_attn_bwd_level<T, kWarps>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

template <typename T, int kWarps>
int launch_level(const void* value, const float* loc, const float* attw, const void* grad,
                 void* dvalue, float* dloc, float* dattw, int B, int S, int Lq, int M, int D,
                 int L, int P, const Levels& lv, int largest, int grid_x, int smem,
                 cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<T, kWarps>(smem);
    if (e != cudaSuccess) return (int)e;
  }
  ms_deform_attn_bwd_level<T, kWarps><<<dim3(grid_x, B), kWarps * 32, smem, s>>>(
      static_cast<const T*>(value), loc, attw, static_cast<const T*>(grad),
      static_cast<T*>(dvalue), dloc, dattw, S, Lq, M, D, L, P, lv, largest * D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_level_warps(int threads, const void* value, const float* loc, const float* attw,
                       const void* grad, void* dvalue, float* dloc, float* dattw, int B, int S,
                       int Lq, int M, int D, int L, int P, const Levels& lv, int largest,
                       int grid_x, int smem, cudaStream_t s) {
#define LAUNCH_LEVEL(warps)                                                                 \
  launch_level<T, warps>(value, loc, attw, grad, dvalue, dloc, dattw, B, S, Lq, M, D, L, P, \
                         lv, largest, grid_x, smem, s)
  switch (threads) {
    case 256: return LAUNCH_LEVEL(8);
    case 512: return LAUNCH_LEVEL(16);
    case 768: return LAUNCH_LEVEL(24);
    case 1024: return LAUNCH_LEVEL(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_LEVEL
}

}  // namespace

// value and grad float32 (dtype 0) or bfloat16 (dtype 1), both the same;
// loc, attw, dloc and dattw float32. dvalue: for the global kernel a float32
// buffer zeroed by the caller, which casts it to the value's type; for the
// level-slice kernel the value's type, every element written. plan holds B,
// S, Lq, M, D, L, P, dtype, the kernel (0 global, 1 level_slice), threads
// per block, grid x (blocks per frame; the grid has B rows), dynamic
// shared-memory bytes, then (H_l, W_l) for the L <= 4 levels in value's
// level order (ops/deform_attn_cuda.py::plan_args). Returns
// cudaGetLastError() after the launch (0 = launched), or the error that
// stopped it.
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc, const void* attw,
                                  const void* grad, void* dvalue, void* dloc, void* dattw,
                                  const int* plan, void* stream) {
  const int B = plan[0], S = plan[1], Lq = plan[2], M = plan[3], D = plan[4], L = plan[5],
            P = plan[6], dtype = plan[7], kernel = plan[8], threads = plan[9],
            grid_x = plan[10], smem = plan[11];
  const int bad = (int)cudaErrorInvalidValue;
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > 32 || B < 1 || B > 65535 || Lq < 1 ||
      M < 1 || D < 1 || grid_x < 1 || (dtype != 0 && dtype != 1))
    return bad;
  Levels lv = {};
  int start = 0, largest = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = plan[12 + 2 * l];
    lv.w[l] = plan[13 + 2 * l];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
    largest = lv.h[l] * lv.w[l] > largest ? lv.h[l] * lv.w[l] : largest;
  }
  if (start != S) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattw);
  if (kernel == 0) {
    if (threads != kGlobalWarps * 32 || (int64_t)grid_x * kGlobalWarps < (int64_t)Lq * M ||
        smem != 0)
      return bad;
    float* dv = static_cast<float*>(dvalue);
    if (dtype == 1)
      ms_deform_attn_bwd_global<__nv_bfloat16><<<dim3(grid_x, B), threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(value), lc, a,
          static_cast<const __nv_bfloat16*>(grad), dv, dl, da, S, Lq, M, D, L, P, lv);
    else
      ms_deform_attn_bwd_global<float><<<dim3(grid_x, B), threads, 0, s>>>(
          static_cast<const float*>(value), lc, a, static_cast<const float*>(grad), dv, dl, da,
          S, Lq, M, D, L, P, lv);
    return (int)cudaGetLastError();
  }
  // shared memory: the value slice (rounded up to 16 bytes), the fp32 dvalue
  // slice, and each warp's fp32 grad rows
  const int esize = dtype == 1 ? 2 : 4;
  if (kernel != 1 || grid_x != M * L ||
      (int64_t)value_slice_bytes(largest * D, esize) +
              ((int64_t)largest + (int64_t)threads / 32 * (32 / P)) * D * 4 !=
          smem)
    return bad;
  if (dtype == 1)
    return launch_level_warps<__nv_bfloat16>(threads, value, lc, a, grad, dvalue, dl, da, B, S,
                                             Lq, M, D, L, P, lv, largest, grid_x, smem, s);
  return launch_level_warps<float>(threads, value, lc, a, grad, dvalue, dl, da, B, S, Lq, M, D,
                                   L, P, lv, largest, grid_x, smem, s);
}
