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
// sequential grid axis: here a block owns one dW tile and one split of
// the rows, and keeps its accumulators in registers. Three kernels, by
// ops/fused_grads's choice of path:
// * wgmma (bf16, K and M multiples of 8, 16-byte aligned x and g, N >= 1:
//   every ViT Dense). ops/fused_grads.dw_db_plan, a function of the shape
//   and the SM count, picks the dW tile (128 rows x 128 or 256 columns)
//   and splits the rows into `splits` runs of whole 64-row chunks, so that
//   tiles x splits fill the card's SMs without a tail wave. A producer
//   warp brings each chunk's g and x columns by TMA, as 64-column panels in
//   128-byte swizzle, into a ring of mbarrier-guarded stages; both operands
//   are contracted over rows, so both are MN-major (wgmma's transpose
//   bits). Two consumer warpgroups run wgmma m64n128k16 bf16 -> f32 (one
//   or two a k-step: a 256-column tile takes x's two 128-column halves),
//   one 64-row half of the tile each, one chunk's products in flight while the
//   previous chunk's stage is released. With more than one split each
//   block writes its partial tile to scratch, and the last block of each
//   tile to finish (an int counter per tile, with fences) sums the
//   partials in split order and resets the counter.
// * mma.sync (bf16 shapes no tensor map takes: K or M not a multiple of 8,
//   misaligned pointers, N = 0): a block of 16 warps owns a 128 x 128 tile
//   of dW (each warp 32 x 32) and all N rows. Row chunks of 64 arrive by
//   cp.async through a ring of 3, rows past N zero-filled; both fragments
//   come from ldmatrix.trans; mma.sync m16n8k16 bf16 -> f32. A row that is
//   not 16-byte aligned is loaded element by element.
// * f32: CUDA-core FMA in full f32 (the tensor cores' f32 inputs would be
//   TF32), 64 x 64 tiles, 4 x 4 outputs a thread, all N rows a block.
// db is folded into the same pass, so g is not streamed a second time: the
// blocks of the first K tile sum the columns of the g chunks they already
// hold, in f32, in a fixed order; on the wgmma path as one more product a
// k-step, g's panel times a tile of ones (the splits merge in split
// order). Tile edges in M and K are masked. No float atomics: results
// repeat bit for bit.
//
// What bounds it on an H100 (ViT-B/16 training at batch 64, N = 12,608
// rows): operations. qkv (K 768, M 2304) does 44.6 GFLOP, 45.1 us at 989
// TFLOP/s, against 77 MB of x, g and dW (23 us at 3.35 TB/s); proj, fc1
// and fc2 likewise; the f32 head (N 64, K 768, M 1000) 98 MFLOP at the
// card's 67 TFLOP/s of f32 FMA. A 128-row dW tile reads (128 + BK) bf16
// of each row from L2 for 2 x 128 x BK flops, so the wider tile needs
// fewer bytes a flop; the splits keep the SMs busy where dW has few tiles
// (qkv: 54 of 128 x 256), at the cost of the partials' bytes. PERF.md
// holds the measured times; scripts/fused_grads_ablation.py rebuilds with
// the switches below and sweeps the plans.

#include "bulk.cuh"
#include "wgmma.cuh"

// Build switches (scripts/fused_grads_ablation.py), read back by
// ops/fused_grads.dw_db_plan through the entry points below: FG_STAGES the
// wgmma ring's stages (0: as many as 192 KB hold), FG_TILE_K the dW
// tile's columns (0: the plan's choice of 128 or 256), FG_ONE_SPLIT = 1
// one split a tile.
#ifndef FG_STAGES
#define FG_STAGES 0
#endif
#ifndef FG_TILE_K
#define FG_TILE_K 0
#endif
#ifndef FG_ONE_SPLIT
#define FG_ONE_SPLIT 0
#endif

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

// ------------------------------------------------------------ wgmma path

namespace wg {

constexpr int kBM = 128;            // dW rows (g's columns) a tile
constexpr int kBN = 64;             // rows of N a stage
constexpr int kPanel = kBN * 128;   // a stage's 64-column panel: 64 rows x 128 bytes
constexpr int kConsumers = 2;       // warpgroups, 64 dW rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BK>
__host__ __device__ constexpr int stage_bytes() { return (kBM + BK) / 64 * kPanel; }
template <int BK>
__host__ __device__ constexpr int stages() { return FG_STAGES > 0 ? FG_STAGES : 192 * 1024 / stage_bytes<BK>(); }
constexpr int kOnes = 256;  // bytes of bf16 ones: db's B operand
// The ring (1024-byte aligned), its full and empty mbarriers, the merge's
// flag, then (256-byte aligned) the ones.
template <int BK>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<BK>() * (stage_bytes<BK>() + 16) + 16 + 255 + kOnes;
}

// db's B operand: a K-major 16 x 8 bf16 tile of ones without swizzle (8
// rows of 16 bytes a core matrix, the two k halves 128 bytes apart), so an
// m64n8k16 product with g's panel as A sums 16 of g's rows into each of
// its 8 columns.
__device__ __forceinline__ uint64_t ones_desc(const unsigned char* ones) {
  return ((uint64_t)(smem_u32(ones) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

struct Params {
  float* dw;
  float* db;
  float* part;    // [tiles][splits][BK / 8][256 threads] float4s, then [M tiles][splits][kBM]
  int* counters;  // [tiles] zeros: splits done (the merge)
  int N, K, M, ktiles, tiles, splits, cps, drop_last;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// Thread t's accumulators (the m16n8 layout of consumer warpgroup t / 128)
// into dW rows m0 .., columns k0 .., masked at M and K (K even).
template <int BK>
__device__ __forceinline__ void store_dw(const Params& p, const float (*acc)[4], int m0, int k0) {
  const int t = threadIdx.x, lane = t & 31;
  const int r = m0 + 64 * (t >> 7) + 16 * ((t >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int c = k0 + 8 * j + 2 * (lane & 3);
    if (c >= p.K) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (r + 8 * half < p.M)
        *reinterpret_cast<float2*>(p.dw + (long long)(r + 8 * half) * p.K + c) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// The consumer warpgroups of a dw_db_wgmma_kernel block: the products
// over the block's chunks (one chunk's wgmmas in flight while the previous
// chunk's stage is released), db's among them (every block runs them, so
// no wgmma sits in a conditional path; the first K tile's blocks keep
// them), then dW and db, directly or through the merge of the tile's
// splits.
template <int BK>
__device__ __forceinline__ void consume(const Params& p, const unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int* flag, const unsigned char* ones,
                                        int tile, int split, int m0, int k0, int chunks) {
  constexpr int S = stages<BK>(), SB = stage_bytes<BK>(), GP = kBM / 64;
  const int t = threadIdx.x, wgi = t >> 7, lane = t & 31;
  const bool with_db = k0 == 0;
  const uint64_t b_ones = ones_desc(ones);
  float acc[BK / 8][4], dbacc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % S;
    bulk::mbar_wait(full + s, (c / S) & 1);
    const unsigned char* st = ring + s * SB;
    wg_begin();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t a = desc_mn_a(st, kBN, 64 * wgi, kk);
#pragma unroll
      for (int h = 0; h < BK / 128; ++h)  // x's 128-column halves (two 64-column panels each)
        Wgmma<128, 1, 1>::mma(acc + 16 * h, a,
                              desc_mn<128>(st + (GP + 2 * h) * kPanel, kBN, kk), 1);
      Wgmma<8, 0, 1>::mma(dbacc, a, b_ones, 1);
    }
    wg_commit();
    wg_wait<1>();  // chunk c - 1's products are done: release its stage
    __syncwarp();
    if (c > 0 && lane == 0) bulk::mbar_arrive(empty + (c - 1) % S);
  }
  wg_wait<0>();
  fence_acc<BK / 8>(acc);
  fence_acc<1>(dbacc);

  // db of tile rows r and r + 8 (every column of dbacc holds it): lanes
  // 0, 4, .. of each warp.
  const int r = 64 * wgi + 16 * ((t >> 5) & 3) + (lane >> 2);
  const bool db_lane = with_db && (lane & 3) == 0;
  if (p.splits == 1) {
    store_dw<BK>(p, acc, m0, k0);
    if (db_lane) {
      if (m0 + r < p.M) p.db[m0 + r] = dbacc[0][0];
      if (m0 + r + 8 < p.M) p.db[m0 + r + 8] = dbacc[0][2];
    }
    return;
  }

  // Write this split's partial tile (each thread's accumulators as float4s,
  // thread-interleaved) and db, then the last block of the tile merges.
  constexpr int kQuads = BK / 8;  // float4s a thread
  const long long plane = 128LL * kConsumers * kQuads;
  float4* mine = reinterpret_cast<float4*>(p.part) + ((long long)tile * p.splits + split) * plane;
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
    __stcg(mine + j * 128 * kConsumers + t, make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
  float* dbp = p.part + (long long)p.tiles * p.splits * plane * 4;
  const int mt = tile / p.ktiles;
  if (db_lane) {
    __stcg(dbp + ((long long)mt * p.splits + split) * kBM + r, dbacc[0][0]);
    __stcg(dbp + ((long long)mt * p.splits + split) * kBM + r + 8, dbacc[0][2]);
  }
  __threadfence();
  consumers_sync();
  if (t == 0) *flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  consumers_sync();
  if (!*flag) return;
  __threadfence();
  const int live = p.splits - p.drop_last;  // drop_last: a negative control
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int s = 0; s < live; ++s) {
    const float4* src = reinterpret_cast<const float4*>(p.part) + ((long long)tile * p.splits + s) * plane;
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const float4 v = __ldcg(src + j * 128 * kConsumers + t);
      acc[j][0] += v.x, acc[j][1] += v.y, acc[j][2] += v.z, acc[j][3] += v.w;
    }
  }
  store_dw<BK>(p, acc, m0, k0);
  if (with_db && t < kBM && m0 + t < p.M) {
    float sum = 0.f;
    for (int s = 0; s < live; ++s) sum += __ldcg(dbp + ((long long)mt * p.splits + s) * kBM + t);
    p.db[m0 + t] = sum;
  }
  if (t == 0) p.counters[tile] = 0;
}

// One block: dW tile `tile` over split `split` of the row chunks. Grid:
// tiles x splits, the split slowest, so the blocks of a wave read the same
// rows; within a split the K tile fastest (neighbouring blocks share g's
// columns).
template <int BK>
__global__ void __launch_bounds__(kThreads, 1)
    dw_db_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap xmap, const Params p) {
  constexpr int S = stages<BK>(), SB = stage_bytes<BK>(), GP = kBM / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SB);
  uint64_t* empty = full + S;
  int* flag = reinterpret_cast<int*>(empty + S);
  unsigned char* ones = ring + ((S * SB + 16 * S + 16 + 255) & ~255);
  const int tile = blockIdx.x % p.tiles, split = blockIdx.x / p.tiles;
  const int m0 = tile / p.ktiles * kBM, k0 = tile % p.ktiles * BK;
  const int c0 = split * p.cps, chunks = min(p.cps, (p.N + kBN - 1) / kBN - c0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bulk::mbar_init(full + i, 1);
      bulk::mbar_init(empty + i, 4 * kConsumers);
    }
    bulk::mbar_init_fence();
  }
  if (threadIdx.x < kOnes / 2) reinterpret_cast<bf16*>(ones)[threadIdx.x] = __float2bfloat16(1.f);
  tiles_landed();  // the ones, written by threads, are read by wgmma

  if (threadIdx.x >= kConsumers * 128) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % S, n0 = (c0 + c) * kBN;
        if (c >= S) bulk::mbar_wait(empty + s, (c / S - 1) & 1);
        bulk::mbar_arrive_expect(full + s, SB);
        unsigned char* st = ring + s * SB;
#pragma unroll
        for (int i = 0; i < GP; ++i) bulk::copy_2d(st + i * kPanel, &gmap, m0 + 64 * i, n0, full + s);
#pragma unroll
        for (int i = 0; i < BK / 64; ++i)
          bulk::copy_2d(st + (GP + i) * kPanel, &xmap, k0 + 64 * i, n0, full + s);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  consume<BK>(p, ring, full, empty, flag, ones, tile, split, m0, k0, chunks);
}

// A 2-D tensor map over a row-major [rows, cols] bf16 matrix, 64 x 64
// boxes in 128-byte swizzle (a wgmma panel); 0 or a CUDA error.
int panel_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const bulk::EncodeTiled encode = bulk::encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, kBN}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <int BK>
int launch(const void* x, const void* g, Params p, cudaStream_t s) {
  CUtensorMap gmap, xmap;
  int rc = panel_map(&gmap, g, p.N, p.M);
  if (rc == 0) rc = panel_map(&xmap, x, p.N, p.K);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(dw_db_wgmma_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes<BK>());
  if (rc != 0) return rc;
  dw_db_wgmma_kernel<BK><<<p.tiles * p.splits, kThreads, smem_bytes<BK>(), s>>>(gmap, xmap, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// C entry point (loaded with ctypes). x [N, K] and g [N, M] are contiguous,
// both bf16 (paths 0 and 1) or both f32 (path 2); dw [M, K] and db [M] are
// contiguous f32. path (ops/fused_grads's choice): 0 = wgmma (bf16, K and
// M multiples of 8, x and g 16-byte aligned, N >= 1) under dw_db_plan's
// tile_k (128 or 256), splits and cps (chunks of 64 rows a split; every
// split non-empty); with splits > 1, part holds tiles x splits x 128 x
// tile_k + M tiles x splits x 128 floats and counters `tiles` zero ints
// (left zero), and drop_last != 0 leaves each tile's last split out of the
// merge (a wrong variant, only for negative controls). 1 = mma.sync (bf16;
// aligned = 1 when K and M are multiples of 8 and x and g 16-byte aligned:
// rows then load by cp.async). 2 = f32. N >= 0, K, M >= 1. Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int matmul_dw_db(const void* x, const void* g, float* dw, float* db, float* part,
                            int* counters, int N, int K, int M, int path, int aligned, int tile_k,
                            int splits, int cps, int drop_last, void* stream) {
  if (N < 0 || K < 1 || M < 1 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    const int chunks = (N + wg::kBN - 1) / wg::kBN;
    if (N < 1 || K % 8 || M % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(g) % 16 || (tile_k != 128 && tile_k != 256) || splits < 1 ||
        cps < 1 || (long long)cps * (splits - 1) >= chunks || (long long)cps * splits < chunks ||
        (splits > 1 && (part == nullptr || counters == nullptr)) || drop_last < 0 ||
        drop_last >= splits)
      return (int)cudaErrorInvalidValue;
    const int ktiles = (K + tile_k - 1) / tile_k;
    const wg::Params p = {dw, db, part, counters, N, K, M, ktiles,
                          ktiles * ((M + wg::kBM - 1) / wg::kBM), splits, cps, drop_last};
    return tile_k == 256 ? wg::launch<256>(x, g, p, s) : wg::launch<128>(x, g, p, s);
  }
  const Args a = {x, g, dw, db, N, K, M, aligned};
  if (path == 2) {
    dw_db_f32_kernel<<<dim3((K + kF - 1) / kF, (M + kF - 1) / kF), kFThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  cudaError_t rc = cudaFuncSetAttribute(dw_db_bf16_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bf16_smem());
  if (rc != cudaSuccess) return (int)rc;
  dw_db_bf16_kernel<<<dim3((K + kBK - 1) / kBK, (M + kBM - 1) / kBM), kThreads, bf16_smem(), s>>>(a);
  return (int)cudaGetLastError();
}

// The wgmma path's build constants, for ops/fused_grads.dw_db_plan: the
// dW tile's columns (0: the plan's choice) and one split a tile (1).
extern "C" int matmul_dw_db_tile_k() { return FG_TILE_K; }
extern "C" int matmul_dw_db_one_split() { return FG_ONE_SPLIT; }
