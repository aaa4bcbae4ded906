// The Hungarian matcher's cost matrix, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel alone. It fuses K5, the shared-points sampling of
// the predicted masks (combo_avs_tpu/ops/point_sample_pallas.py:371
// `_shared_kernel`; on the card the channels kernel of
// csrc/point_sample_fwd.cu), with the sums of the matching cost that
// combo_avs_tpu/losses/matcher.py (and its port, losses/matcher.py::
// HungarianMatcher.cost_matrix) leaves to XLA and cuBLAS. Per frame n, query
// q and target slot k, with x[p] the bilinear sample of mask (n, q) at the
// frame's shared point p (K5's arithmetic) and t[k][p] the target mask's
// sample there:
//
//   ce   = (sum_p softplus(-x) t[k] + sum_p softplus(x) (1 - t[k])) / P
//   dice = 1 - (2 sum_p sigmoid(x) t[k] + 1) / (sum_p sigmoid(x) + sum_p t[k] + 1)
//   C    = w_class * -softmax(logits[n, q])[label[n, k]] + w_mask * ce + w_dice * dice
//
// then BIG_COST for an invalid slot and nan_to_num (nan and +inf to
// BIG_COST, -inf to -BIG_COST), as HungarianMatcher.match_layers applies it
// to the composition. softplus(+-x) = max(+-x, 0) + log1p(e) and sigmoid(x)
// come from one e = exp(-|x|): torch.logaddexp(x, 0)'s form, with no
// cut-off.
//
// What bounds it on this card: at the training cells' shape (40 frames x 100
// queries x 12544 points, K = 3) 50 M (frame, query, point) triples, each an
// exp, a log1p and a reciprocal (MUFU, 0.036 ms at 16 a clock an SM) and
// about 40 fp32 operations (0.028 ms); bytes (the 50 MB of masks read once)
// come third. The composition it replaces wrote the [N, P, Q] samples (200
// MB) and three full-size temporaries of them, then ran three batched
// products with N = K: 2.25 ms a call on an H100, 1.6% of the bound. Here
// nothing of size P x Q leaves the SM:
//  * a block takes one frame and QB consecutive queries (8 with 3 slots at
//    K <= 3, the S4 and MS3 cells; 2 with 16 slots at K <= 16, AVSS's 12),
//    so that a thread's QB x (3 KC + 1) fp32 accumulators stay in
//    registers (121 registers with 3 slots, two blocks an SM), and
//    stages their maps in shared memory interleaved, [pixel][query], with
//    4-byte cp.async (the transpose needs 4-byte granules); one corner then
//    gives all QB queries' values in one or two 16-byte loads, not QB
//    gathers into banks at random;
//  * a thread strides over the frame's points: a point's corners and
//    weights are computed once (K5's code: the same bits) and serve every
//    query of the block; the K target samples are read once per point (from
//    one K3 call, [N, P, K]: L2 serves the other blocks of the frame);
//  * warp shuffles, then shared memory, reduce each accumulator over the
//    block; the block's first QB warps then compute their query's softmax
//    and write its K costs. One launch per decoder output, in place of
//    about 30.
// The sums run in fp32 in another order than the composition's (a thread's
// points in turn, then the block's tree): the result differs from it by
// rounding only (tests/test_torch_matchcost_card.py states the tolerance).
// Measured at the cells' shape (H100 at 700 W, CUDA graph replay): 0.225 ms,
// 16% of the MUFU bound. Tried: 4 queries a block at K = 3 (78 registers,
// three blocks an SM), 0.232 ms; the approximate __logf(1 + e) and
// __fdividef in place of log1pf and __frcp_rn, 0.156 ms with the same
// largest error against the composition, left out to keep the accurate
// functions the composition uses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBigCost = 1e4f;  // losses/matcher.py::BIG_COST
constexpr int kMaxDevices = 64;

// K5's corners (csrc/point_sample_fwd.cu::point_corners), the same
// arithmetic: the pixel of each of the four corners in the [H*W] plane (-1
// outside the image) and its weight.
__device__ __forceinline__ void point_corners(float px, float py, int H, int W, int* row,
                                              float* w) {
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

// The QB interleaved values of one staged pixel.
template <int QB>
__device__ __forceinline__ void load_queries(const float* s, int row, float* v) {
  const float* p = s + row * QB;
  if constexpr (QB == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    static_assert(QB == 2, "QB is 2 or 8");
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Accumulators a query: sum softplus(-x) t[k], sum softplus(x) (1 - t[k]),
// sum sigmoid(x) t[k] for each of KC slots, and sum sigmoid(x).
template <int KC>
__host__ __device__ constexpr int per_query() { return 3 * KC + 1; }

// The blocks an SM the registers must allow: 2 (as many as the staged maps
// of 56^2 masks allow) where a thread's accumulators leave room, else 1.
template <int KC, int QB>
__host__ __device__ constexpr int min_blocks() {
  return per_query<KC>() * QB <= 80 ? 2 : 1;
}

// One block: frame n = blockIdx.x / chunks, queries [q0, q0 + QB) of it
// (the last chunk may hold fewer). KC is the slots the accumulators hold,
// 3 or 16, with K <= KC: the slots past K sum zeros.
template <int KC, int QB>
__global__ void __launch_bounds__(kThreads, (min_blocks<KC, QB>()))
match_cost_kernel(const float* __restrict__ masks,     // [N, Q, H, W]
                  const float* __restrict__ pts,       // [N, P, 2]
                  const float* __restrict__ tgt,       // [N, P, K]
                  const float* __restrict__ logits,    // [N, Q, C1]
                  const int64_t* __restrict__ labels,  // [N, K]
                  const uint8_t* __restrict__ valid,   // [N, K]
                  float* __restrict__ out,             // [N, Q, K]
                  int Q, int H, int W, int P, int K, int C1, int chunks, float w_class,
                  float w_mask, float w_dice) {
  constexpr int NA = per_query<KC>();
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x / chunks;
  const int q0 = (blockIdx.x - n * chunks) * QB;
  const int nq = min(QB, Q - q0);
  const int HW = H * W;

  // stage the chunk's maps as [pixel][query], zeros past the last query
  const float* src = masks + ((int64_t)n * Q + q0) * HW;
  for (int e = threadIdx.x; e < HW * QB; e += kThreads) {
    const int q = e % QB, pix = e / QB;
    if (q < nq) {
      cp_async4(s + e, src + q * HW + pix);
    } else {
      s[e] = 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc[QB][NA];
  float tsum[KC];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[j][i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) tsum[k] = 0.f;

  const float* pn = pts + (int64_t)n * P * 2;
  const float* tn = tgt + (int64_t)n * P * K;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    int row[4];
    float w[4];
    point_corners(__ldg(pn + 2 * p), __ldg(pn + 2 * p + 1), H, W, row, w);
    float t[KC], u[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      t[k] = k < K ? __ldg(tn + (int64_t)p * K + k) : 0.f;
      u[k] = 1.f - t[k];
      tsum[k] += t[k];
    }
    // K5's fmaf chain over the in-image corners, for every query at once
    float x[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) x[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (row[c] >= 0) {
        float v[QB];
        load_queries<QB>(s, row[c], v);
#pragma unroll
        for (int j = 0; j < QB; ++j) x[j] = fmaf(w[c], v[j], x[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const float e = expf(-fabsf(x[j]));
      const float l = log1pf(e);
      const float sp_pos = fmaxf(x[j], 0.f) + l;   // softplus(x)
      const float sp_neg = fmaxf(-x[j], 0.f) + l;  // softplus(-x)
      const float r = __frcp_rn(1.f + e);
      const float sig = x[j] >= 0.f ? r : e * r;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        acc[j][k] = fmaf(sp_neg, t[k], acc[j][k]);
        acc[j][KC + k] = fmaf(sp_pos, u[k], acc[j][KC + k]);
        acc[j][2 * KC + k] = fmaf(sig, t[k], acc[j][2 * KC + k]);
      }
      acc[j][3 * KC] += sig;
    }
  }

  // the block's sums: each warp's by shuffles into red[warp][.], then
  // tot[.] over the warps (the staged maps are read no more)
  constexpr int NV = QB * NA + KC;
  float* red = s;
  float* tot = s + kWarps * NV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < QB; ++j) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float v = warp_sum(acc[j][i]);
      if (lane == 0) red[warp * NV + j * NA + i] = v;
    }
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float v = warp_sum(tsum[k]);
    if (lane == 0) red[warp * NV + QB * NA + k] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NV; i += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) v += red[wp * NV + i];
    tot[i] = v;
  }
  __syncthreads();

  // epilogue: warp j computes query q0 + j's softmax and its K costs
  if (warp >= nq) return;
  const int q = q0 + warp;
  const float* lg = logits + ((int64_t)n * Q + q) * C1;
  float m = -INFINITY;
  for (int c = lane; c < C1; c += 32) m = fmaxf(m, __ldg(lg + c));
  m = warp_max(m);
  float z = 0.f;
  for (int c = lane; c < C1; c += 32) z += expf(__ldg(lg + c) - m);
  z = warp_sum(z);
  const float* a = tot + warp * NA;
  const float sig_sum = a[3 * KC];
  for (int k = lane; k < K; k += 32) {
    const int64_t label = labels[(int64_t)n * K + k];
    if (label < 0 || label >= C1) __trap();  // as torch.gather's device assert in the composition
    const float prob = expf(__ldg(lg + label) - m) / z;
    const float ce = __fdiv_rn(__fadd_rn(a[k], a[KC + k]), (float)P);
    const float num = __fadd_rn(__fmul_rn(2.f, a[2 * KC + k]), 1.f);
    const float den = __fadd_rn(__fadd_rn(sig_sum, tot[QB * NA + k]), 1.f);
    const float dice = __fsub_rn(1.f, __fdiv_rn(num, den));
    float cost = __fadd_rn(__fadd_rn(__fmul_rn(w_class, -prob), __fmul_rn(w_mask, ce)),
                           __fmul_rn(w_dice, dice));
    if (!valid[(int64_t)n * K + k] || isnan(cost)) {
      cost = kBigCost;
    } else if (isinf(cost)) {
      cost = cost > 0.f ? kBigCost : -kBigCost;
    }
    out[((int64_t)n * Q + q) * K + k] = cost;
  }
}

// Raise the kernel's dynamic shared-memory limit to `bytes` on the current
// device, once per device and size.
template <int KC, int QB>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(match_cost_kernel<KC, QB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

template <int KC, int QB>
int launch(const float* masks, const float* pts, const float* tgt, const float* logits,
           const int64_t* labels, const uint8_t* valid, float* out, int N, int Q, int H, int W,
           int P, int K, int C1, int chunks, int smem, float w_class, float w_mask,
           float w_dice, cudaStream_t s) {
  if (smem < (kWarps + 1) * (QB * per_query<KC>() + KC) * 4 || smem < H * W * QB * 4)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<KC, QB>(smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises, and later launches start clean
      return (int)e;
    }
  }
  match_cost_kernel<KC, QB><<<(unsigned)(N * chunks), kThreads, smem, s>>>(
      masks, pts, tgt, logits, labels, valid, out, Q, H, W, P, K, C1, chunks, w_class, w_mask,
      w_dice);
  return (int)cudaGetLastError();
}

}  // namespace

// Execute one launch plan of ops/match_cost_cuda.py::launch_plan.
// masks [N, Q, H, W], pts [N, P, 2], tgt [N, P, K], logits [N, Q, C1] and
// out [N, Q, K] are float32, labels [N, K] int64 and valid [N, K] bool (one
// byte), all contiguous on the current device. plan holds 11 ints: N, Q, H,
// W, P, K, C1, the slots KC (3 up to K = 3, else 16), the queries a block QB
// (8 and 2 for those), chunks (ceil(Q / QB)), the dynamic shared bytes.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan this function cannot execute.
extern "C" int match_cost(const void* masks, const void* pts, const void* tgt, const void* logits,
                          const void* labels, const void* valid, void* out, const int* plan,
                          float w_class, float w_mask, float w_dice, void* stream) {
  const int N = plan[0], Q = plan[1], H = plan[2], W = plan[3], P = plan[4], K = plan[5];
  const int C1 = plan[6], KC = plan[7], QB = plan[8], chunks = plan[9], smem = plan[10];
  const int bad = (int)cudaErrorInvalidValue;
  if (N < 1 || Q < 1 || H < 1 || W < 1 || P < 1 || K < 1 || C1 < 1 || K > KC || QB < 1 ||
      chunks != (Q + QB - 1) / QB ||
      (int64_t)N * chunks > 0x7fffffffll || (int64_t)H * W * QB * 4 > 0x7fffffffll ||
      (int64_t)Q * H * W >= (1ll << 31) || (int64_t)P * K >= (1ll << 31))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(masks);
  const float* p = static_cast<const float*>(pts);
  const float* t = static_cast<const float*>(tgt);
  const float* lg = static_cast<const float*>(logits);
  const int64_t* lb = static_cast<const int64_t*>(labels);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
#define MATCH_COST_LAUNCH(KC_, QB_)                                                            \
  if (KC == KC_ && QB == QB_)                                                                  \
    return launch<KC_, QB_>(m, p, t, lg, lb, v, o, N, Q, H, W, P, K, C1, chunks, smem,         \
                            w_class, w_mask, w_dice, s);
  MATCH_COST_LAUNCH(3, 8)
  MATCH_COST_LAUNCH(16, 2)
#undef MATCH_COST_LAUNCH
  return bad;
}
