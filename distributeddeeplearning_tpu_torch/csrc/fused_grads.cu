// Fused dW + db of a Dense layer's backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// distributeddeeplearning_tpu/ops/pallas/fused_grads.py: `_dw_db_kernel`
// (run by `matmul_dw_db`, the backward of `bias_dense`). Same function:
//   x [N, K], g [N, M] (bf16, or f32 for an f32 Dense such as ViT's head)
//   dW = g^T . x  f32 [M, K]  (the port's [out, in] Linear layout: the TPU
//                              kernel writes x^T . g as [K, M])
//   db = sum over rows of g   f32 [M]
// in one pass over g: the TPU kernel's reason to exist is that a plain
// matmul followed by a separate column sum reads g twice.
//
// Design. The TPU kernel walks the contraction (rows) over a sequential
// grid axis, carrying its accumulators in VMEM between steps. A GPU has no
// sequential grid axis, so here one block owns one dW output tile and
// loops over all N rows itself: the accumulators stay in registers and no
// block needs another's result (no atomics: results repeat bit for bit).
// * bf16: a block of 16 warps owns a 128 x 128 tile of dW (each warp 32 x
//   32). Row chunks of 64 of g's and x's tile columns arrive in shared
//   memory by cp.async through a ring of 3 (two chunks in flight while
//   one is multiplied), rows past N zero-filled. Both operands are
//   contracted over rows, so both fragments come from ldmatrix.trans: A
//   from g's columns, B from x's. mma.sync m16n8k16 bf16 -> f32. This
//   shape was the fastest of eight warp layouts, chunk heights and ring
//   depths timed at the ViT-B/16 shapes on the card: the kernel is bound
//   by latency per chunk, so more warps and taller chunks helped, and
//   deeper rings did not.
// * f32: CUDA-core FMA in full f32 (the tensor cores' f32 inputs would be
//   TF32), 64 x 64 tiles, 4 x 4 outputs a thread.
// * db is folded into the same pass: the blocks of the first K tile sum
//   the columns of the g chunks they already hold, in f32, in a fixed
//   order, so g is not streamed a second time.
// Tile edges in M and K are masked; a row that is not 16-byte aligned is
// loaded element by element.
//
// What bounds it on an H100 (ViT-B/16 training at batch 64, N = 12,608
// rows): operations. qkv (K 768, M 2304) does 44.6 GFLOP, 45.1 us at 989
// TFLOP/s, against 77 MB of x, g and dW (23 us at 3.35 TB/s); proj, fc1
// and fc2 likewise; the f32 head (N 64, K 768, M 1000) 98 MFLOP at the
// card's 67 TFLOP/s of f32 FMA. mma.sync reaches a part of the wgmma
// rate, each block re-reads its x and g columns from L2, and a narrow dW
// (proj: 36 tiles) leaves most SMs idle; PERF.md holds the measured
// times.

#include "mma.cuh"

namespace {

using namespace mma;

// bf16 path
constexpr int kBM = 128;       // dW rows (g's columns) per block
constexpr int kBK = 128;       // dW columns (x's columns) per block
constexpr int kBN = 64;        // rows per stage
constexpr int kStages = 3;     // the cp.async ring
constexpr int kWarpsM = 4, kWarpsK = 4;  // warps along M and K
constexpr int kThreads = 32 * kWarpsM * kWarpsK;
constexpr int kMI = kBM / kWarpsM / 16, kNI = kBK / kWarpsK / 8;  // a warp's m16, n8 tiles
constexpr int kDbSplit = kThreads / kBM;  // threads summing one db column
constexpr int kPitch = kBM + 8;

// f32 path
constexpr int kF = 64;        // dW tile, both dims
constexpr int kFN = 16;       // rows per stage
constexpr int kFThreads = 256;

struct Args {
  const void* x;
  const void* g;
  float* dw;
  float* db;
  int N, K, M, aligned;
};

// Rows n0 .. n0+kBN-1, columns c0 .. c0+127 of a row-major [N, C] matrix
// into a [kBN][kPitch] tile; out-of-range elements are zero.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int n0, int N, int c0,
                                           int C, bool aligned) {
  for (int i = threadIdx.x; i < kBN * (kBM / 8); i += kThreads) {
    const int r = i / (kBM / 8), col = (i % (kBM / 8)) * 8;
    const int n = n0 + r, c = c0 + col;
    bf16* d = dst + r * kPitch + col;
    if (aligned && c + 8 <= C) {
      cp_async16(d, n < N ? src + (long long)n * C + c : src, n < N);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (n < N && c + e < C) ? src[(long long)n * C + c + e] : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) dw_db_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sg = reinterpret_cast<bf16*>(smem);  // [kStages][kBN][kPitch]
  bf16* sx = sg + kStages * kBN * kPitch;    // [kStages][kBN][kPitch]
  float* sdb = reinterpret_cast<float*>(sx + kStages * kBN * kPitch);  // [kThreads]
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* g = static_cast<const bf16*>(a.g);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kBM, k0 = blockIdx.x * kBK;
  const int wm = (warp / kWarpsK) * kMI * 16, wk = (warp % kWarpsK) * kNI * 8;  // its sub-tile
  const bool with_db = blockIdx.x == 0;
  const bool aligned = a.aligned != 0;

  float acc[kMI][kNI][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < kMI; ++i) zero<kNI>(acc[i]);
  float db = 0.f;  // column threadIdx.x % kBM, rows r = threadIdx.x / kBM (mod kDbSplit)

  const int chunks = (a.N + kBN - 1) / kBN;
  auto load = [&](int c) {  // chunk c into its ring slot; one commit group each
    if (c < chunks) {
      const int slot = c % kStages;
      load_chunk(sg + slot * kBN * kPitch, g, c * kBN, a.N, m0, a.M, aligned);
      load_chunk(sx + slot * kBN * kPitch, x, c * kBN, a.N, k0, a.K, aligned);
    }
    cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) load(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // ... for every thread; chunk c - 1's slot is free
    load(c + kStages - 1);
    const bf16* G = sg + (c % kStages) * kBN * kPitch;
    const bf16* X = sx + (c % kStages) * kBN * kPitch;
    if (with_db)
      for (int r = threadIdx.x / kBM; r < kBN; r += kDbSplit)
        db += __bfloat162float(G[r * kPitch + threadIdx.x % kBM]);
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      uint32_t af[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        ldsm_x4_t(G + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * kPitch + wm + mi * 16 +
                      ((lane >> 3) & 1) * 8,
                  af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
#pragma unroll
      for (int ni = 0; ni < kNI; ni += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(X + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + wk + ni * 8 +
                      (lane >> 4) * 8,
                  b0, b1, b2, b3);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          mma16816(acc[mi][ni], af[mi], b0, b1);
          mma16816(acc[mi][ni + 1], af[mi], b2, b3);
        }
      }
    }
  }
  cp_async_wait_all();  // the ring's last (empty or, at N = 0, zero-fill) groups

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int k = k0 + wk + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (m < a.M && k < a.K) a.dw[(long long)m * a.K + k] = acc[mi][ni][e];
      }
  if (with_db) {  // the kDbSplit partial sums of each column, in a fixed order
    sdb[threadIdx.x] = db;
    __syncthreads();
    if (threadIdx.x < kBM && m0 + threadIdx.x < a.M) {
      float sum = 0.f;
      for (int i = 0; i < kDbSplit; ++i) sum += sdb[i * kBM + threadIdx.x];
      a.db[m0 + threadIdx.x] = sum;
    }
  }
}

__global__ void __launch_bounds__(kFThreads) dw_db_f32_kernel(Args a) {
  __shared__ float sg[kFN][kF];
  __shared__ float sx[kFN][kF];
  const float* x = static_cast<const float*>(a.x);
  const float* g = static_cast<const float*>(a.g);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kF, k0 = blockIdx.x * kF;
  const bool with_db = blockIdx.x == 0;

  float acc[4][4] = {};
  float db = 0.f;  // column threadIdx.x < kF
  for (int n0 = 0; n0 < a.N; n0 += kFN) {
    for (int i = threadIdx.x; i < kFN * kF; i += kFThreads) {
      const int r = i / kF, c = i % kF, n = n0 + r;
      sg[r][c] = (n < a.N && m0 + c < a.M) ? g[(long long)n * a.M + m0 + c] : 0.f;
      sx[r][c] = (n < a.N && k0 + c < a.K) ? x[(long long)n * a.K + k0 + c] : 0.f;
    }
    __syncthreads();
    if (with_db && threadIdx.x < kF)
      for (int r = 0; r < kFN; ++r) db += sg[r][threadIdx.x];
#pragma unroll
    for (int r = 0; r < kFN; ++r) {
      float gv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gv[i] = sg[r][ty + 16 * i];
        xv[i] = sx[r][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, k = k0 + tx + 16 * j;
      if (m < a.M && k < a.K) a.dw[(long long)m * a.K + k] = acc[i][j];
    }
  if (with_db && threadIdx.x < kF && m0 + threadIdx.x < a.M) a.db[m0 + threadIdx.x] = db;
}

constexpr int bf16_smem() { return 2 * kStages * kBN * kPitch * 2 + kThreads * 4; }

}  // namespace

// C entry point (loaded with ctypes). x [N, K] and g [N, M] are contiguous,
// both bf16 (dtype 0) or both f32 (dtype 1); dw [M, K] and db [M] are
// contiguous f32. aligned = 1 when K and M are multiples of 8 and x and g
// start 16-byte aligned (bf16 rows then load by cp.async). N >= 0,
// K, M >= 1. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int matmul_dw_db(const void* x, const void* g, float* dw, float* db, int N, int K,
                            int M, int dtype, int aligned, void* stream) {
  if (N < 0 || K < 1 || M < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Args a = {x, g, dw, db, N, K, M, aligned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dw_db_f32_kernel<<<dim3((K + kF - 1) / kF, (M + kF - 1) / kF), kFThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  cudaError_t rc = cudaFuncSetAttribute(dw_db_bf16_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bf16_smem());
  if (rc != cudaSuccess) return (int)rc;
  dw_db_bf16_kernel<<<dim3((K + kBK - 1) / kBK, (M + kBM - 1) / kBM), kThreads, bf16_smem(), s>>>(a);
  return (int)cudaGetLastError();
}
