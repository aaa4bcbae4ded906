// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel combo_avs_tpu/ops/deform_attn_pallas.py::_kernel_hfuse
// (called through _forward_hfuse / ms_deform_attn_pallas) and its per-head
// twin _kernel. Same function as combo_avs_tpu/ops/deform_attn.py::
// ms_deform_attn and its PyTorch twin
// combo_avs_torch/ops/deform_attn.py::ms_deform_attn_plain:
//
//   out[b, q, m*D + c] = sum_l sum_p w[b,q,m,l,p] *
//       bilinear(value[b, start_l : start_l + H_l*W_l, m, c],
//                x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5)
//
// with corners outside a level contributing zero (grid_sample zero padding,
// align_corners=False) and the same floor-based corner split as the plain
// version. Every kernel here sums a query's terms in the same order (level,
// point, corner), in fp32, and stores in value's type (fp32 or bf16).
//
// Two kernels and three plans; ops/deform_attn_cuda.py::fwd_launch_plan
// picks one, and the staged kernel's query chunk, block size and channel
// groups, from the shapes, the dtype and the card's opt-in shared-memory
// limit and SM count, and this file only executes the plan it is given.
//
//  * "global" (the first design): one warp per (b, q, m), lanes over the D
//    channels, each corner a D-element row gathered from global memory (L2:
//    the value tensor of a batch, 21 MB at [20, 1029, 8, 32] fp32, fits the
//    50 MB L2). Lanes 0..L*P-1 each compute one sampling point's 4 corner
//    rows and weights, and the corner loop broadcasts them with warp
//    shuffles. At the main-path shape a call gathers about 7.9 M rows, 1 GB,
//    about 48 times the value tensor, at L2 gather rate: 0.247 ms against a
//    0.0197 ms bound (H100 at 700 W), and 8 shuffles a point on the pipe the
//    loads use.
//  * "staged": every sampling point of head m in frame b reads only the
//    S x D value slice value[b, :, m, :] (131,712 B at S = 1029, D = 32 fp32;
//    65,856 B in bf16). One block per (b, m, query chunk) copies that slice
//    into dynamic shared memory with 16-byte cp.async (the launcher raises
//    the function's opt-in limit above 48 KB) and then computes its chunk of
//    queries from it, so each corner is a shared-memory row read instead of
//    an L2 gather. A lane takes 4 channels (a float4, or 4 bf16 values) when
//    D % 4 == 0, so a query takes G = D / 4 lanes (8 at D = 32) and a warp
//    32 / G queries (4): each corner read is one 16-byte load a lane, a
//    quarter-warp reading one whole 128-byte row. The lane that owns a point
//    computes its 4 corner offsets and weights once and writes them to its
//    query's table in shared memory; the corner loop reads them with one
//    broadcast 16-byte load for the offsets and one for the weights, no
//    shuffles. Each output row has one owning warp and is stored once: no
//    atomics. The query chunk trades re-staging the slice (from L2) against
//    the blocks left for the last wave on the card's SMs (3 chunks at 20
//    frames x 8 heads, 2 at 40, on 132 SMs). What bounds it, by
//    estimate (no profiler counter can be read): the shared-memory
//    wavefronts, 4 row reads and 2 table reads a point, and the staging,
//    which one fp32 block an SM cannot hide
//    (scripts/bench_deform_fwd_plans.py has the sweep; PERF.md the numbers).
//    Tried (PERF.md, K1 findings): one channel a lane (one fp32 query or two bf16
//    queries a warp), 1.5x slower; each query's table padded by 16 bytes,
//    5% faster in fp32 but 14% slower in bf16, whose block then no longer
//    fits twice in an SM's shared memory; the tables interleaved by point or
//    rotated by query, no faster; one level staged at a time (the largest
//    level's rows, so two fp32 blocks share an SM, partial sums in shared
//    memory between levels), 1.4-1.5x slower everywhere.
//  * "grouped": the staged kernel where the whole slice and 32 warps' tables
//    do not fit one block (TTA's 384^2 branch: S = 3024, 193,536 B of bf16
//    slice, 387,072 B of fp32). A block of 24-32 warps stages the whole
//    slice (the staged kernel as it is, at fewer warps) or, in fp32, one of
//    `groups` channel groups of it, [S, D / groups], and computes those
//    channels of its chunk's queries; the groups of a (b, m, chunk) are
//    neighbours in the grid, so the second reads the locations and weights
//    from L2, and each output row is still stored once, a group's channels
//    by its block. A query keeps the whole slice's G lanes, each taking D /
//    (groups * G) channels (2 at D = 32 and 2 groups: a float2), so the
//    tables a warp stay those of the staged plan. The plan takes the fewest
//    groups whose block holds 24 warps or more: the whole bf16 slice at 24
//    warps, 2 fp32 groups at 24 warps (230,400 B each), in 4 and 2 query
//    chunks. Measured against the other layouts
//    (scripts/bench_deform_fwd_plans.py; PERF.md, K1 findings): 2 bf16
//    groups at 32 warps 13% slower than the whole slice at 24 (so bf16 has
//    no channel groups), 4 groups or 16-20 warps slower still. Tried and
//    dropped: D / groups / 4 lanes a query (more queries a warp, so the
//    tables grow as the rows shrink), slower at every count; the first
//    queries' tables made while the staging copies land, slower.
//  * corners outside their level have weight 0 and are skipped (no read), as
//    in the plain version's zero padding.
// The TPU kernel's tent matrices, one-hot matmuls, 128-lane level padding,
// query blocks and output chunking were workarounds for the TPU's serial
// gathers and scoped VMEM; none of them is needed here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarpsPerBlock = 8;  // the global kernel's
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
    // rounded as the plain version rounds (multiply, then subtract; no FMA)
    const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt], (float)W), 0.5f), -2.f),
                          (float)W + 1.f);
    const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt + 1], (float)H), 0.5f), -2.f),
                          (float)H + 1.f);
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

// ---- the staged kernel --------------------------------------------------

// One sampling point in a warp's table: its 4 corners' element offsets into
// the staged rows and their weights (attention weight times bilinear weight,
// 0 outside the level).
struct Corners {
  int4 off;
  float4 w;
};

// kVec channels a lane, read and written as one vector: fp32 one float or a
// float4 (D % 4 == 0), bf16 one element, one __nv_bfloat162 or two of them
// (D % 4 == 0).
template <typename T, int kVec>
struct Row;

template <>
struct Row<float, 1> {
  static __device__ __forceinline__ void fma(float (&acc)[1], float w, const float* p) {
    acc[0] = fmaf(w, *p, acc[0]);
  }
  static __device__ __forceinline__ void put(float* p, const float (&acc)[1]) { *p = acc[0]; }
};

template <>
struct Row<float, 2> {
  static __device__ __forceinline__ void fma(float (&acc)[2], float w, const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
  }
  static __device__ __forceinline__ void put(float* p, const float (&acc)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  }
};

template <>
struct Row<float, 4> {
  static __device__ __forceinline__ void fma(float (&acc)[4], float w, const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
  static __device__ __forceinline__ void put(float* p, const float (&acc)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Row<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void fma(float (&acc)[1], float w, const __nv_bfloat16* p) {
    acc[0] = fmaf(w, __bfloat162float(*p), acc[0]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float (&acc)[1]) {
    *p = __float2bfloat16(acc[0]);
  }
};

template <>
struct Row<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void fma(float (&acc)[2], float w, const __nv_bfloat16* p) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float (&acc)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[0], acc[1]);
  }
};

template <>
struct Row<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void fma(float (&acc)[4], float w, const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    acc[0] = fmaf(w, a.x, acc[0]);
    acc[1] = fmaf(w, a.y, acc[1]);
    acc[2] = fmaf(w, b.x, acc[2]);
    acc[3] = fmaf(w, b.y, acc[3]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float (&acc)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(acc[0], acc[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy `rows` value rows of one head (D elements each, `row_stride` elements
// apart in global memory) into dst as [rows, D], all threads of the block.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int D,
                                           int64_t row_stride, bool vec16) {
  if (vec16) {  // rows of a multiple of 16 bytes, 16-byte aligned
    const int cpr = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
    const int n = rows * cpr;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / cpr, part = i - r * cpr;
      cp_async16(reinterpret_cast<char*>(dst) + (int64_t)i * 16,
                 reinterpret_cast<const char*>(src + r * row_stride) + part * 16);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      dst[i] = src[r * row_stride + (i - r * D)];
    }
  }
}

// blockIdx.x = (m * chunks + chunk) * groups + cg, blockIdx.y = b;
// blockDim.x / 32 warps. The block stages and computes the channels
// [cg * Dg, (cg + 1) * Dg) of head m: the whole slice, Dg = D, in the
// staged plan, a channel group of it, Dg = D / groups, in the grouped plan
// (fp32 only). groups is not a parameter: the grouped kernel reads it from
// the grid (gridDim.x = M * chunks * groups), and with kGrouped false it is
// the constant 1, so the staged plan's kernel takes the parameters and
// compiles to the code it had before groups existed. The groups
// of one (head, chunk) are neighbours in the grid, so the locations and
// weights that each reads in turn come from L2.
// Dynamic shared memory: the rows ([S, Dg] of T, `slice_bytes` reserved, a
// multiple of 16), then each warp's corner table (32 / G queries x L * P
// points).
template <typename T, int kVec, bool kGrouped>
__global__ void __launch_bounds__(1024)
ms_deform_attn_fwd_staged(const T* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ attw, T* __restrict__ out, int S, int Lq,
                          int M, int D, int L, int P, Levels lv, int chunk, int chunks, int G,
                          int slice_bytes, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = reinterpret_cast<T*>(smem);
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qpw = 32 / G;  // queries a warp takes at a time
  const int LP = L * P;
  const int slot = lane / G;  // this lane's query in the warp's group
  Corners* table = reinterpret_cast<Corners*>(smem + slice_bytes);
  Corners* mine_tab = table + (warp * qpw + slot) * LP;  // this lane's query's points

  // the block's (head, chunk) and channel group; unsigned as blockIdx is, so
  // that with kGrouped false this is the staged kernel's own arithmetic (as
  // signed ints the bf16 kernel took 32 registers instead of 30 and ran 3%
  // slower at 224^2)
  const unsigned groups = kGrouped ? gridDim.x / (M * chunks) : 1;
  const unsigned mc = kGrouped ? blockIdx.x / groups : blockIdx.x;
  const int cg = kGrouped ? blockIdx.x - mc * groups : 0;
  const int Dg = kGrouped ? D / (int)groups : D;  // the channels staged
  const int m = mc / chunks, b = blockIdx.y;
  const int q_begin = (mc - m * chunks) * chunk;
  const int q_end = min(Lq, q_begin + chunk);
  const int gl = lane & (G - 1);  // this lane's place in its query's group
  const int64_t row_stride = (int64_t)M * D;
  const T* vslice = value + (int64_t)b * S * row_stride + (int64_t)m * D + cg * Dg;

  // rows [row0, S) are staged, row0 = lv.start[0] = 0, and corner offsets
  // are taken from row0. Written with the literal 0 instead, the fp32 kernel
  // compiled to another schedule that ran 8-10% slower
  // (scripts/bench_deform_fwd_plans.py; PERF.md, K1 findings).
  const int row0 = lv.start[0];
  stage_rows(vs, vslice + row0 * row_stride, S - row0, Dg, row_stride, vec16 != 0);
  __syncthreads();

  for (int qb = q_begin + warp * qpw; qb < q_end; qb += warps * qpw) {
    const int q = qb + slot;
    const bool mine = q < q_end;
    if (mine) {
      const int64_t pt0 = ((int64_t)(b * Lq + q) * M + m) * LP;
      for (int i = gl; i < LP; i += G) {
        const int l = i / P;
        const int H = lv.h[l], W = lv.w[l], base = lv.start[l] - row0;
        const int64_t pt = pt0 + i;
        const float a = attw[pt];
        // rounded as the plain version rounds (multiply, then subtract; no
        // FMA), so both split a coordinate at the same corner; clamped so
        // the float->int conversion is defined (beyond [-1, W] every corner
        // is outside the level either way)
        const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt], (float)W), 0.5f), -2.f),
                              (float)W + 1.f);
        const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(loc[2 * pt + 1], (float)H), 0.5f), -2.f),
                              (float)H + 1.f);
        const float x0f = floorf(x), y0f = floorf(y);
        const float fx = x - x0f, fy = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float wx[2] = {1.f - fx, fx};
        const float wy[2] = {1.f - fy, fy};
        int o[4];
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
          const bool valid = xi >= 0 && xi < W && yi >= 0 && yi < H;
          o[k] = valid ? (base + yi * W + xi) * Dg : 0;
          w[k] = valid ? a * (wx[k & 1] * wy[k >> 1]) : 0.f;
        }
        mine_tab[i] = Corners{make_int4(o[0], o[1], o[2], o[3]),
                              make_float4(w[0], w[1], w[2], w[3])};
      }
    }
    __syncwarp();
    if (mine) {
      T* orow = out + ((int64_t)b * Lq + q) * row_stride + (int64_t)m * D + cg * Dg;
      for (int c = gl * kVec; c < Dg; c += G * kVec) {
        float acc[kVec];
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
#pragma unroll 4
        for (int i = 0; i < LP; ++i) {
          const Corners cr = mine_tab[i];  // one broadcast load a half
          if (cr.w.x != 0.f) Row<T, kVec>::fma(acc, cr.w.x, vs + cr.off.x + c);
          if (cr.w.y != 0.f) Row<T, kVec>::fma(acc, cr.w.y, vs + cr.off.y + c);
          if (cr.w.z != 0.f) Row<T, kVec>::fma(acc, cr.w.z, vs + cr.off.z + c);
          if (cr.w.w != 0.f) Row<T, kVec>::fma(acc, cr.w.w, vs + cr.off.w + c);
        }
        Row<T, kVec>::put(orow + c, acc);
      }
    }
    __syncwarp();  // the table is read before the warp's next queries overwrite it
  }
}

// Raise kernel's dynamic shared-memory limit to `bytes` on the current
// device, once per device and size.
template <typename T, int kVec, bool kGrouped>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(ms_deform_attn_fwd_staged<T, kVec, kGrouped>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();  // so that the next launch does not report it
  else if (dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

template <typename T, int kVec, bool kGrouped>
int launch_staged(const void* value, const void* loc, const void* attw, void* out, int B, int S,
                  int Lq, int M, int D, int L, int P, const Levels& lv, int threads, int chunk,
                  int grid_x, int groups, int G, int slice_bytes, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<T, kVec, kGrouped>(smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte copies need 16-byte staged rows (then the row stride and every
  // group's first channel are 16-byte multiples too) and a 16-byte aligned value
  const int vec16 = (D / groups * (int)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(value) % 16 == 0;
  ms_deform_attn_fwd_staged<T, kVec, kGrouped><<<dim3(grid_x, B), threads, smem, s>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<T*>(out), S, Lq, M, D, L, P, lv, chunk,
      grid_x / (M * groups), G, slice_bytes, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// value and out float32 (dtype 0) or bfloat16 (dtype 1); loc and attw
// float32. plan holds B, S, Lq, M, D, L, P, dtype, the kernel (0 global, 1
// staged, 2 grouped), threads per block, the query chunk (queries a
// block; 0 for global), grid x (blocks per frame; the grid has B rows),
// dynamic shared-memory bytes, the channel groups a (frame, head) (1 for
// staged, global and bf16), then (H_l, W_l) for the L <= 4 levels in value's level
// order (ops/deform_attn_cuda.py::fwd_plan_args). Returns
// cudaGetLastError() after the launch (0 = launched), or the error that
// stopped it.
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* attw, void* out,
                                  const int* plan, void* stream) {
  const int B = plan[0], S = plan[1], Lq = plan[2], M = plan[3], D = plan[4], L = plan[5],
            P = plan[6], dtype = plan[7], kernel = plan[8], threads = plan[9], chunk = plan[10],
            grid_x = plan[11], smem = plan[12], groups = plan[13];
  const int bad = (int)cudaErrorInvalidValue;
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > 32 || B < 1 || B > 65535 || Lq < 1 || M < 1 ||
      D < 1 || grid_x < 1 || (dtype != 0 && dtype != 1) || groups < 1 || D % groups)
    return bad;
  Levels lv = {};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = plan[14 + 2 * l];
    lv.w[l] = plan[15 + 2 * l];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    if (threads != kWarpsPerBlock * 32 || (int64_t)grid_x * kWarpsPerBlock < (int64_t)Lq * M ||
        smem != 0 || groups != 1)
      return bad;
    if (dtype == 1)
      ms_deform_attn_fwd_kernel<__nv_bfloat16><<<dim3(grid_x, B), threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
          static_cast<const float*>(attw), static_cast<__nv_bfloat16*>(out), S, Lq, M, D, L, P,
          lv);
    else
      ms_deform_attn_fwd_kernel<float><<<dim3(grid_x, B), threads, 0, s>>>(
          static_cast<const float*>(value), static_cast<const float*>(loc),
          static_cast<const float*>(attw), static_cast<float*>(out), S, Lq, M, D, L, P, lv);
    return (int)cudaGetLastError();
  }
  if (kernel < 1 || kernel > 2 || (kernel == 1 && groups != 1)) return bad;
  // the staged kernel's layout, as fwd_launch_plan computes it: G lanes a
  // query, each taking vec channels a step, the staged plan's for the whole
  // D; a grouped block keeps those G lanes over its Dg = D / groups channels
  // (vec = Dg / G of them a lane), so its corner tables are the staged
  // plan's at the same warps
  const int esize = dtype == 1 ? 2 : 4;
  const int Dg = D / groups;
  int vec = D % 4 == 0 ? 4 : dtype == 1 && D % 2 == 0 ? 2 : 1;
  const int lanes = (D + vec - 1) / vec;
  int G = 1;
  while (G < lanes && G < 32) G *= 2;
  if (groups > 1) {  // channel groups are fp32's (the bf16 plan stages whole slices)
    if (dtype != 0 || Dg % G) return bad;
    vec = Dg / G;
    if (vec != 1 && vec != 2 && vec != 4) return bad;
  }
  const int64_t slice_bytes = ((int64_t)S * Dg * esize + 15) / 16 * 16;
  const int64_t want = slice_bytes + (int64_t)threads / 32 * (32 / G) * L * P * 32;
  if (threads < 32 || threads > 1024 || threads % 32 || chunk < 1 ||
      (int64_t)grid_x != (int64_t)M * groups * ((Lq + chunk - 1) / chunk) || want != smem)
    return bad;
#define LAUNCH_STAGED(T, V, GR)                                                             \
  launch_staged<T, V, GR>(value, loc, attw, out, B, S, Lq, M, D, L, P, lv, threads, chunk,  \
                          grid_x, groups, G, (int)slice_bytes, smem, s)
  if (groups == 1) {  // whole rows, vec channels a lane as D gives them
    if (dtype == 0) return vec == 4 ? LAUNCH_STAGED(float, 4, false)
                                    : LAUNCH_STAGED(float, 1, false);
    if (vec == 4) return LAUNCH_STAGED(__nv_bfloat16, 4, false);
    if (vec == 2) return LAUNCH_STAGED(__nv_bfloat16, 2, false);
    return LAUNCH_STAGED(__nv_bfloat16, 1, false);
  }
  if (vec == 4) return LAUNCH_STAGED(float, 4, true);
  if (vec == 2) return LAUNCH_STAGED(float, 2, true);
  return LAUNCH_STAGED(float, 1, true);
#undef LAUNCH_STAGED
}
