// Fused bottleneck-segment GEMMs with a BatchNorm-statistics epilogue,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// distributeddeeplearning_tpu/ops/pallas/fused_block.py (`_kernel`, run by
// `_run` behind `matmul_stats` and `bn_relu_matmul_stats`). Same contract:
//   a      [M, K]  bf16, row-major (an NHWC activation seen as rows)
//   w      [N, K]  bf16, row-major: the 1x1 conv's [out, in] weight, so
//                  the GEMM reads it as the column-major [K, N] operand
//   prologue none:     z = a
//   prologue bn_relu:  z = bf16(relu(f32(a) * aff_scale[k] + aff_shift[k]))
//                      (the folded BN affine, f32 [K] each)
//   y      [M, N]  bf16 = bf16(z @ w^T) with f32 accumulation
//   sum    [N]     f32  = sum over rows of f32(y)      (the ROUNDED y)
//   sumsq  [N]     f32  = sum over rows of f32(y)^2
// Rows past M in the last row tile are zero in z, never stored, and kept
// out of the statistics.
//
// Design. The TPU kernel walks the row blocks in order on one core and
// carries (sum, sumsq) in VMEM from one block to the next. Hopper blocks
// run in no order, so each block owns a [128, BN] tile of y: it loops
// over K in 32-wide slices (the slice for step k+1 is loaded into
// registers while step k computes, then stored to the other of two
// shared-memory buffers, with the prologue applied on the way in, once
// per element), multiplies with mma.sync m16n8k16 bf16 -> f32 on the
// tensor cores, rounds its tile to bf16, stores it and reduces its
// column partials from the rounded values in a fixed order (per thread,
// then a shuffle tree, then the warps in order). The partials go to a
// [row_tiles, N] buffer; a second small kernel sums them over the row
// tiles, again in a fixed order. No atomics: the statistics do not
// depend on the schedule and repeat bit for bit.
//
// What bounds it on an H100. At the stage-1 shapes of ResNet-50 at batch
// 64 (M = 200,704, K = 64, N = 256 for conv3) the bytes of a, w and y
// (128.5 MB, 38 us at 3.35 TB/s) bound it; at stage 4 (M = 3,136, K =
// 512, N = 2,048) the 6.6 GFLOP do (6.6 us at 989 TFLOP/s). mma.sync
// reaches a part of the card's wgmma rate, and the simple two-stage
// register pipeline does not keep enough loads in flight to reach the
// memory rate; PERF.md holds the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of y per block
constexpr int kBK = 32;        // K slice per pipeline step
constexpr int kLds = kBK + 8;  // padded smem row (80 B): ldmatrix rows hit distinct banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 of row `row` (k0..k0+7) through the prologue.
template <bool kBnRelu>
__device__ __forceinline__ uint4 prologue(uint4 v, const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          int k0) {
  if (!kBnRelu) return v;
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + k0));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + k0 + 4));
  const float4 t0 = __ldg(reinterpret_cast<const float4*>(shift + k0));
  const float4 t1 = __ldg(reinterpret_cast<const float4*>(shift + k0 + 4));
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float sh[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float z = fmaf(__bfloat162float(e[i]), sc[i], sh[i]);
    e[i] = __float2bfloat16(fmaxf(z, 0.f));
  }
  return v;
}

// One [kBM, BN] tile of y and its column partials.
//   WARPS_M x WARPS_N warps; each warp owns a (kBM/WARPS_M) x (BN/WARPS_N)
//   sub-tile = MI m16 tiles x NI n8 tiles of mma.sync accumulators.
template <int BN, int WARPS_M, int WARPS_N, bool kBnRelu>
__global__ void __launch_bounds__(kThreads)
    matmul_stats_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ aff_scale,
                        const float* __restrict__ aff_shift,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ part_sum,
                        float* __restrict__ part_sq, int M, int K, int N) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  constexpr int WM = kBM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  static_assert(NI % 2 == 0, "B fragments load in pairs of n8 tiles");
  constexpr int kChunksPerRow = kBK / 8;  // 16-byte chunks per row slice
  constexpr int A_CHUNKS = kBM * kChunksPerRow / kThreads;
  constexpr int B_CHUNKS = BN * kChunksPerRow / kThreads;
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small for the block");

  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kLds];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN][kLds];
  __shared__ float red_sum[WARPS_M][BN];
  __shared__ float red_sq[WARPS_M][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int col0 = blockIdx.x * BN;  // column tiles vary fastest: a row tile of a stays in L2
  const int row0 = blockIdx.y * kBM;

  uint4 a_reg[A_CHUNKS];
  uint4 b_reg[B_CHUNKS];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunksPerRow;
      const int kc = (c % kChunksPerRow) * 8;
      const int row = row0 + r;
      a_reg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (row < M)
        a_reg[i] = __ldg(reinterpret_cast<const uint4*>(a + (size_t)row * K + k0 + kc));
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int n = c / kChunksPerRow;
      const int kc = (c % kChunksPerRow) * 8;
      b_reg[i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(col0 + n) * K + k0 + kc));
    }
  };

  auto store_tile = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunksPerRow;
      const int kc = (c % kChunksPerRow) * 8;
      // Rows past M stay zero: the prologue of a zero row is not zero.
      const uint4 v = row0 + r < M
                          ? prologue<kBnRelu>(a_reg[i], aff_scale, aff_shift, k0 + kc)
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(&As[buf][r][kc]) = v;
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int n = c / kChunksPerRow;
      const int kc = (c % kChunksPerRow) * 8;
      *reinterpret_cast<uint4*>(&Bs[buf][n][kc]) = b_reg[i];
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int k_tiles = K / kBK;
  load_tile(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    // The buffer written here was last read two steps ago; the barrier
    // of the previous step ordered every read of it before this write.
    store_tile(buf, kt * kBK);
    __syncthreads();
    if (kt + 1 < k_tiles) load_tile((kt + 1) * kBK);  // in flight during the MMAs

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = warp_m * WM + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(smem_u32(&As[buf][r][c]), af[mi][0], af[mi][1], af[mi][2],
                    af[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        const int n = warp_n * WN + ni * 8 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(smem_u32(&Bs[buf][n][c]), bf[ni][0], bf[ni][1],
                    bf[ni + 1][0], bf[ni + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }

  // Epilogue: round to bf16, store, and reduce the column partials from
  // the rounded values. Thread (lane) holds rows lane/4 (+8) of each m16
  // tile and columns 2*(lane%4) (+1) of each n8 tile.
  float s[NI][2], q[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) s[ni][0] = s[ni][1] = q[ni][0] = q[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + warp_m * WM + mi * 16 + (lane >> 2) + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = col0 + warp_n * WN + ni * 8 + (lane & 3) * 2;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) = v;
        const float v0 = __low2float(v), v1 = __high2float(v);
        s[ni][0] += v0;
        s[ni][1] += v1;
        q[ni][0] += v0 * v0;
        q[ni][1] += v1 * v1;
      }
    }
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s[ni][j] += __shfl_xor_sync(0xffffffffu, s[ni][j], o);
        q[ni][j] += __shfl_xor_sync(0xffffffffu, q[ni][j], o);
      }
    }
    if (lane < 4) {
      const int c = warp_n * WN + ni * 8 + lane * 2;
      red_sum[warp_m][c] = s[ni][0];
      red_sum[warp_m][c + 1] = s[ni][1];
      red_sq[warp_m][c] = q[ni][0];
      red_sq[warp_m][c + 1] = q[ni][1];
    }
  }
  __syncthreads();
  for (int c = tid; c < BN; c += kThreads) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int wm = 0; wm < WARPS_M; ++wm) {
      ts += red_sum[wm][c];
      tq += red_sq[wm][c];
    }
    part_sum[(size_t)blockIdx.y * N + col0 + c] = ts;
    part_sq[(size_t)blockIdx.y * N + col0 + c] = tq;
  }
}

// sum[n] = sum over t of part[t, n], in a fixed order: 8 thread rows take
// the row tiles t = g, g+8, ... in turn, then their 8 sums are added in
// order.
constexpr int kRedCols = 32;
constexpr int kRedGroups = 8;

__global__ void __launch_bounds__(kRedCols* kRedGroups)
    reduce_partials_kernel(const float* __restrict__ part_sum,
                           const float* __restrict__ part_sq,
                           float* __restrict__ sum, float* __restrict__ sumsq,
                           int tiles, int N) {
  __shared__ float ss[kRedGroups][kRedCols];
  __shared__ float sq[kRedGroups][kRedCols];
  const int cx = threadIdx.x, g = threadIdx.y;
  const int col = blockIdx.x * kRedCols + cx;
  float ts = 0.f, tq = 0.f;
  if (col < N) {
    for (int t = g; t < tiles; t += kRedGroups) {
      ts += part_sum[(size_t)t * N + col];
      tq += part_sq[(size_t)t * N + col];
    }
  }
  ss[g][cx] = ts;
  sq[g][cx] = tq;
  __syncthreads();
  if (g == 0 && col < N) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < kRedGroups; ++i) {
      a += ss[i][cx];
      b += sq[i][cx];
    }
    sum[col] = a;
    sumsq[col] = b;
  }
}

template <int BN, int WARPS_M, int WARPS_N>
int launch(const void* a, const void* w, const float* aff_scale,
           const float* aff_shift, void* y, float* part_sum, float* part_sq,
           int M, int K, int N, int bn_relu, cudaStream_t stream) {
  const dim3 grid(N / BN, (M + kBM - 1) / kBM);
  const auto* a_ = static_cast<const __nv_bfloat16*>(a);
  const auto* w_ = static_cast<const __nv_bfloat16*>(w);
  auto* y_ = static_cast<__nv_bfloat16*>(y);
  if (bn_relu)
    matmul_stats_kernel<BN, WARPS_M, WARPS_N, true><<<grid, kThreads, 0, stream>>>(
        a_, w_, aff_scale, aff_shift, y_, part_sum, part_sq, M, K, N);
  else
    matmul_stats_kernel<BN, WARPS_M, WARPS_N, false><<<grid, kThreads, 0, stream>>>(
        a_, w_, aff_scale, aff_shift, y_, part_sum, part_sq, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). bn_relu: 0 = no prologue (aff_*
// unused), 1 = BN-apply + ReLU prologue. part_sum/part_sq are caller-owned
// scratch of [ceil(M / 128), N] f32 each. Requires M >= 1, K % 32 == 0,
// N % 64 == 0, every pointer 16-byte aligned, all tensors contiguous.
// Returns cudaGetLastError() after the two launches (0 = ok).
extern "C" int fused_block_matmul_stats(const void* a, const void* w,
                                        const float* aff_scale,
                                        const float* aff_shift, void* y,
                                        float* part_sum, float* part_sq,
                                        float* sum, float* sumsq, int M, int K,
                                        int N, int bn_relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < kBK || K % kBK != 0 || N < 64 || N % 64 != 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (N % 128 == 0)
    rc = launch<128, 2, 4>(a, w, aff_scale, aff_shift, y, part_sum, part_sq, M,
                           K, N, bn_relu, s);
  else
    rc = launch<64, 4, 2>(a, w, aff_scale, aff_shift, y, part_sum, part_sq, M,
                          K, N, bn_relu, s);
  if (rc != 0) return rc;
  const int tiles = (M + kBM - 1) / kBM;
  reduce_partials_kernel<<<dim3((N + kRedCols - 1) / kRedCols),
                           dim3(kRedCols, kRedGroups), 0, s>>>(
      part_sum, part_sq, sum, sumsq, tiles, N);
  return (int)cudaGetLastError();
}

// The row tile the partial buffers are sized by.
extern "C" int fused_block_row_tile(void) { return kBM; }
