// Fused bottleneck-segment GEMMs with a BatchNorm-statistics epilogue in
// f32, for the inputs csrc/fused_block.cu (bf16, TMA + wgmma) does not
// take: f32 operands, at any K >= 1 and N >= 1. sm_90a, f32 FMA on the
// CUDA cores (no TF32: the JAX f32 path keeps full f32 products).
//
// Replaces the Pallas TPU kernel
// distributeddeeplearning_tpu/ops/pallas/fused_block.py (`_kernel`, run by
// `_run` behind `matmul_stats` and `bn_relu_matmul_stats`) for f32. Same
// contract as csrc/fused_block.cu, in f32:
//   a  [M, K], w [N, K] row-major (the 1x1 conv's [out, in] weight)
//   prologue none:    z = a
//   prologue bn_relu: z = relu(a * scale[k] + shift[k]), the affine folded
//                     from mean, var, gamma, beta and eps as
//                     ops/fused_block._affine_rows folds it:
//                     scale = rsqrt(var + eps) * gamma, shift = beta - mean * scale
//   y [M, N] = z @ w^T; sum [N] = column sums of y, sumsq [N] of y^2
//
// What bounds it on an H100: at ResNet-50's stage 1 (M = 200,704, K 64,
// N 256) the bytes (a 51 MB, y 206 MB: 77 us at 3.35 TB/s) and the
// operations (6.6 GFLOP: 98 us at 67 TFLOP/s of f32 FMA) about equally.
//
// Design (simple, SIMT): items of 128 rows x 64 columns; a block of 256
// threads (16 x 16) keeps one 64-column panel and takes the row tiles g,
// g + G, g + 2G, ... of it (G = `groups`, from the wrapper's plan: about
// four blocks an SM in all). K goes through shared memory 32 columns at
// a time (a's and w's rows of 32 + 4 floats: 16-byte loads of 8 rows by
// a quarter warp meet no bank twice), the prologue applied as a's values
// land. Thread (ty, tx) sums rows ty + 16 i (i < 8) against columns
// tx + 16 e (e < 4), stores y, and adds its y and y^2 to its columns'
// running sums. At the end the block sums its 16 row lanes in order into
// one row of the partials [panels][G][2][64]; the last block of a panel
// (an int counter, ops/_counters.py) sums the G rows in order. No float
// atomics: y, sum and sumsq repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // rows an item
constexpr int kCols = 64;   // columns a panel
constexpr int kDepth = 32;  // K a stage
constexpr int kLd = kDepth + 4;

struct Params {
  const float* a;
  const float* w;
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
  float* y;
  float* sum;
  float* sumsq;
  float* part;    // [panels][groups][2][kCols]
  int* counters;  // [panels] zeros, left zero
  int M, K, N, groups, drop_last;
};

__host__ __device__ constexpr int smem_bytes_fixed() {
  return ((kRows + kCols) * kLd + 2 * 16 * kCols) * 4 + 16;
}

template <bool kBn>
__global__ void __launch_bounds__(kThreads) matmul_stats_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [kRows][kLd]
  float* ws = as + kRows * kLd;                 // [kCols][kLd]
  float* red = ws + kCols * kLd;                // [2][16][kCols]
  int* flag = reinterpret_cast<int*>(red + 2 * 16 * kCols);
  float* aff = reinterpret_cast<float*>(flag + 4);  // scale [K], shift [K]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int pn = blockIdx.x, g = blockIdx.y, n0 = pn * kCols;
  if constexpr (kBn) {
    // The folded affine, operation for operation as _affine_rows.
    for (int k = threadIdx.x; k < p.K; k += kThreads) {
      const float sc = __fmul_rn(rsqrtf(__fadd_rn(p.var[k], p.eps)), p.gamma[k]);
      aff[k] = sc;
      aff[p.K + k] = __fsub_rn(p.beta[k], __fmul_rn(p.mean[k], sc));
    }
  }
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, cq[4] = {0.f, 0.f, 0.f, 0.f};
  const int tiles = (p.M + kRows - 1) / kRows;
  for (int tile = g; tile < tiles; tile += p.groups) {
    const int m0 = tile * kRows;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int k0 = 0; k0 < p.K; k0 += kDepth) {
      __syncthreads();  // the last stage's readers are done (and the affine is whole)
      for (int i = threadIdx.x; i < kRows * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth, row = m0 + r, k = k0 + c;
        float v = 0.f;
        if (row < p.M && k < p.K) {
          v = p.a[(long long)row * p.K + k];
          if constexpr (kBn) v = fmaxf(__fadd_rn(__fmul_rn(v, aff[k]), aff[p.K + k]), 0.f);
        }
        as[r * kLd + c] = v;
      }
      for (int i = threadIdx.x; i < kCols * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth, n = n0 + r, k = k0 + c;
        ws[r * kLd + c] = n < p.N && k < p.K ? p.w[(long long)n * p.K + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kDepth; c += 4) {
        float4 av[8], wv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kLd + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = *reinterpret_cast<const float4*>(ws + (tx + 16 * e) * kLd + c);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float s = acc[i][e];
            s = fmaf(av[i].x, wv[e].x, s);
            s = fmaf(av[i].y, wv[e].y, s);
            s = fmaf(av[i].z, wv[e].z, s);
            acc[i][e] = fmaf(av[i].w, wv[e].w, s);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= p.M) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + tx + 16 * e;
        if (n >= p.N) continue;
        p.y[(long long)row * p.N + n] = acc[i][e];
        cs[e] += acc[i][e];
        cq[e] += __fmul_rn(acc[i][e], acc[i][e]);
      }
    }
  }

  // The block's row of partials: its 16 row lanes in order.
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    red[ty * kCols + tx + 16 * e] = cs[e];
    red[(16 + ty) * kCols + tx + 16 * e] = cq[e];
  }
  __syncthreads();
  float* mine = p.part + ((long long)pn * p.groups + g) * 2 * kCols;
  if (threadIdx.x < 2 * kCols) {
    const int half = threadIdx.x / kCols, col = threadIdx.x % kCols;
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[(16 * half + r) * kCols + col];
    __stcg(mine + half * kCols + col, s);
  }
  // The last block of the panel merges the groups' rows in order.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(p.counters + pn, 1) == p.groups - 1;
    if (last) {
      __threadfence();
      p.counters[pn] = 0;  // every launch leaves its counters zero
    }
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  // drop_last (a negative control): the panel's last group left out
  const int live = p.groups - (p.drop_last ? 1 : 0);
  if (threadIdx.x < 2 * kCols) {
    const int half = threadIdx.x / kCols, col = threadIdx.x % kCols, n = n0 + col;
    const float* rows = p.part + (long long)pn * p.groups * 2 * kCols + half * kCols + col;
    float s = 0.f;
    for (int r = 0; r < live; ++r) s += __ldcg(rows + (long long)r * 2 * kCols);
    if (n < p.N) (half ? p.sumsq : p.sum)[n] = s;
  }
}

template <bool kBn>
int launch(const Params& p, int smem, cudaStream_t stream) {
  static int attr_for = -1;  // the largest dynamic shared memory set so far
  if (smem > attr_for) {
    const int rc = (int)cudaFuncSetAttribute(matmul_stats_f32_kernel<kBn>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    attr_for = smem;
  }
  const dim3 grid((p.N + kCols - 1) / kCols, p.groups);
  matmul_stats_f32_kernel<kBn><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). f32 a [M, K], w [N, K], y [M, N],
// sum and sumsq [N], contiguous. bn_relu: 0 = no prologue (mean, var,
// gamma, beta and eps unused), 1 = BN-apply + ReLU with the affine folded
// from them (f32 [K] each). groups: row groups a panel (ops/fused_block.
// f32_plan); part holds ceil(N / 64) x groups x 128 floats of scratch and
// counters ceil(N / 64) zero ints (left zero). drop_last != 0 leaves each
// panel's last group out of the statistics (a wrong variant, only for
// negative controls; needs groups >= 2). Returns cudaGetLastError() after
// the launch (0 = ok).
extern "C" int fused_block_f32_matmul_stats(const float* a, const float* w, const float* mean,
                                            const float* var, const float* gamma,
                                            const float* beta, float eps, float* y, float* sum,
                                            float* sumsq, float* part, int* counters, int M, int K,
                                            int N, int groups, int bn_relu, int drop_last,
                                            void* stream) {
  if (!a || !w || !y || !sum || !sumsq || !part || !counters || M < 1 || K < 1 || N < 1 ||
      groups < 1 || groups > 65535 || (drop_last && groups < 2) ||
      (bn_relu && (!mean || !var || !gamma || !beta)))
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes_fixed() + (bn_relu ? 8LL * K : 0LL);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const Params p = {a, w, mean, var, gamma, beta, eps, y, sum, sumsq, part, counters,
                    M, K, N, groups, drop_last != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn_relu ? launch<true>(p, (int)smem, s) : launch<false>(p, (int)smem, s);
}
