// Fused bottleneck-segment GEMMs with a BatchNorm-statistics epilogue,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// distributeddeeplearning_tpu/ops/pallas/fused_block.py (`_kernel`, run by
// `_run` behind `matmul_stats` and `bn_relu_matmul_stats`). Same contract:
//   a      [M, K]  bf16, row-major (an NHWC activation seen as rows)
//   w      [N, K]  bf16, row-major: the 1x1 conv's [out, in] weight, so
//                  the GEMM reads it as the K-major [K, N] operand
//   prologue none:     z = a
//   prologue bn_relu:  z = bf16(relu(f32(a) * scale[k] + shift[k])), the BN
//                      affine folded from mean, var, gamma, beta (f32 [K])
//                      and eps: scale = rsqrt(var + eps) * gamma,
//                      shift = beta - mean * scale
//   y      [M, N]  bf16 = bf16(z @ w^T) with f32 accumulation
//   sum    [N]     f32  = sum over rows of f32(y)      (the ROUNDED y)
//   sumsq  [N]     f32  = sum over rows of f32(y)^2
// Rows past M are never stored and stay out of the statistics.
//
// What bounds it on an H100. ResNet-50 at batch 64 and 224 px calls the
// two ops at twelve shapes. At stage 1 (M = 200,704 rows) the bytes of a,
// w and y bound it (conv3, K 64, N 256: 128.5 MB, 38 us at 3.35 TB/s; y is
// 103 MB of that); at stage 4 the operations (conv3 at M 3,136, K 512, N
// 2,048: 6.6 GFLOP, 6.6 us at 989 TFLOP/s). So the kernel has to keep
// enough bytes in flight to stream a and y at the memory rate, and run the
// products at the wgmma rate.
//
// Design. The TPU kernel walks the row blocks in order on one core and
// carries (sum, sumsq) in VMEM from one block to the next. Here a
// persistent grid (csrc/fused_block_plan.h: one planner for the card and
// the host) walks items of 128 rows x one column panel of bn = 256, 128 or
// 64 columns; a block keeps one panel for all its items, so the blocks of
// one row tile run side by side and read a's rows from L2 after the first.
// * A producer warp brings each item's a (128 x 64 box) and w (bn x 64
//   box) by TMA, 128-byte swizzled, into a ring of mbarrier-guarded
//   stages; K past a multiple of 64 arrives as zeros.
// * Two consumer warpgroups, 64 rows each, run wgmma m64nNk16 bf16 -> f32
//   (a 256-column panel is two m64n128k16 products a k-step). Without the
//   prologue both operands come from shared memory. With it, each thread
//   loads its A fragments from the swizzled stage (ldmatrix), applies the
//   folded affine (computed into shared memory for every K once a block,
//   so no other launch folds it), ReLU and the bf16 rounding in
//   registers, and issues the register-A wgmma; FB_INPLACE=1 instead
//   rewrites the stage in place and takes the shared-memory product (an
//   ablation).
// * Epilogue: the accumulators, rounded to bf16, go one 64 x 64 box at a
//   time to two swizzled staging boxes a warpgroup, in turn (rows past M
//   as zeros: TMA filled a's rows past M with zeros, but the prologue of a
//   zero row is relu(shift), not zero); one thread stores each box with a
//   TMA tensor store, which drops rows past M, while the warpgroup stages
//   the next box and then multiplies the next item. Each thread sums one
//   column pair of each box (sum and sum of squares of the rounded y) over
//   its warp's 16 rows, item after item, in registers.
// * Statistics: the block sums its warps' rows in order into one row of
//   a [grid, 2, bn] buffer; the last block of each merge group (an int
//   counter per group, ops/_counters.py) sums its group's rows in block
//   order, the last group of the panel the group rows in group order. No
//   float atomics: y, sum and sumsq repeat bit for bit.
// One launch a call. PERF.md holds the measured times;
// scripts/fused_block_ablation.py rebuilds with the plan's switches and
// FB_INPLACE.

#include "bulk.cuh"
#include "fused_block_plan.h"
#include "wgmma.cuh"

#ifndef FB_INPLACE
#define FB_INPLACE 0
#endif

namespace {

using namespace mma;

constexpr int kConsumers = 2;                     // warpgroups, 64 rows of an item each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kFbRows * 128;  // a's box: 128 rows x 64 bf16

struct Params {
  FbPlan plan;
  const float* mean;  // the BN statistics and parameters of the prologue, f32 [K]
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
  float* sum;
  float* sumsq;
  float* part;    // plan.part_floats: [grid][2][bn] block rows, [panels][groups][2][bn] group rows
  int* counters;  // plan.counters zeros: [panels][groups + 1]
  int M, K, drop_last;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wgi) : "memory");
}

// Two bf16 (one register of an A fragment or a stage) through the prologue.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t v, float2 s, float2 h) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(fmaxf(fmaf(f.x, s.x, h.x), 0.f), fmaxf(fmaf(f.y, s.y, h.y), 0.f));
}

// The thread's A fragment of k-step kk (16 columns) of its warp's 16 rows
// of `at` (its warpgroup's 64 x 64 slice of the stage, 128-byte swizzled),
// through the prologue: scale at aff[k], shift at aff[kpad + k].
__device__ __forceinline__ void a_frag(uint32_t* af, const unsigned char* at, int kk,
                                       const float* aff, int kpad) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row = 16 * warp + (lane & 15), chunk = 2 * kk + (lane >> 4);
  ldsm_x4(at + row * 128 + ((chunk ^ (row & 7)) << 4), af[0], af[1], af[2], af[3]);
  const int k = 16 * kk + 2 * (lane & 3);  // af[0], af[1]: columns k, k+1; af[2], af[3]: k+8, k+9
  const float2 s0 = *reinterpret_cast<const float2*>(aff + k);
  const float2 s1 = *reinterpret_cast<const float2*>(aff + k + 8);
  const float2 h0 = *reinterpret_cast<const float2*>(aff + kpad + k);
  const float2 h1 = *reinterpret_cast<const float2*>(aff + kpad + k + 8);
  af[0] = bn_relu2(af[0], s0, h0);
  af[1] = bn_relu2(af[1], s0, h0);
  af[2] = bn_relu2(af[2], s1, h1);
  af[3] = bn_relu2(af[3], s1, h1);
}

// The prologue over the warpgroup's 64 x 64 slice `at` of the stage, in
// place (FB_INPLACE), made visible to the products that read it.
__device__ __forceinline__ void bn_relu_inplace(unsigned char* at, const float* aff, int kpad) {
  for (int i = threadIdx.x & 127; i < 64 * 8; i += 128) {
    const int r = i >> 3, ch = i & 7, k = (ch ^ (r & 7)) << 3;
    uint4* p = reinterpret_cast<uint4*>(at + r * 128 + (ch << 4));
    uint4 v = *p;
    const float4 sa = *reinterpret_cast<const float4*>(aff + k);
    const float4 sb = *reinterpret_cast<const float4*>(aff + k + 4);
    const float4 ha = *reinterpret_cast<const float4*>(aff + kpad + k);
    const float4 hb = *reinterpret_cast<const float4*>(aff + kpad + k + 4);
    v.x = bn_relu2(v.x, make_float2(sa.x, sa.y), make_float2(ha.x, ha.y));
    v.y = bn_relu2(v.y, make_float2(sa.z, sa.w), make_float2(ha.z, ha.w));
    v.z = bn_relu2(v.z, make_float2(sb.x, sb.y), make_float2(hb.x, hb.y));
    v.w = bn_relu2(v.w, make_float2(sb.z, sb.w), make_float2(hb.z, hb.w));
    *p = v;
  }
  bulk::fence_proxy_async();
  warpgroup_sync(threadIdx.x >> 7);
}

// Sums n rows of the statistics, in[r * stride ..] (BN sums, then BN sums
// of squares), column by column in row order, into out_s and out_q; the
// loads of 16 rows at a time in flight together.
template <int BN>
__device__ __forceinline__ void sum_rows(float* out_s, float* out_q, const float* in,
                                         long long stride, int n) {
  constexpr int kBatch = 16;
  for (int col = threadIdx.x; col < BN; col += kConsumers * 128) {
    float s = 0.f, q = 0.f;
    for (int r0 = 0; r0 < n; r0 += kBatch) {
      float vs[kBatch], vq[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float* row = in + (r0 + j) * stride + col;
        vs[j] = r0 + j < n ? __ldcg(row) : 0.f;
        vq[j] = r0 + j < n ? __ldcg(row + BN) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (r0 + j < n) s += vs[j], q += vq[j];
    }
    __stcg(out_s + col, s);
    __stcg(out_q + col, q);
  }
}

// The consumer warpgroups of a block: its items' products, staged y and
// TMA stores, the statistics of the rounded y, then the block's row of
// the statistics.
template <int BN, bool kBnRelu>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring, unsigned char* ystage,
                                        const float* aff, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* ymap) {
  constexpr int NW = BN < 128 ? BN : 128;  // a product's columns
  constexpr int NH = BN / NW;              // products a k-step
  constexpr int NQ = BN / 64;              // 64-column boxes of y an item
  constexpr int SB = fb_stage_bytes(BN);
  constexpr bool kRegA = kBnRelu && !FB_INPLACE;
  const FbPlan& pl = p.plan;
  const int t = threadIdx.x, wgi = t >> 7, tw = t & 127, lane = t & 31, warp = tw >> 5;
  const int S = pl.stages, kpad = pl.kblocks * kFbBoxK, pn = fb_panel(pl, blockIdx.x);
  float st[NQ][4];  // per box: the sums of columns 2 lane, 2 lane + 1 and of their squares
#pragma unroll
  for (int q = 0; q < NQ; ++q) st[q][0] = st[q][1] = st[q][2] = st[q][3] = 0.f;
  float acc[BN / 8][4];

  int c = 0;   // stages consumed
  int pc = 0;  // boxes of y staged
  for (int it = 0;; ++it) {
    const int tile = fb_tile(pl, blockIdx.x, it);
    if (tile < 0) break;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kb = 0; kb < pl.kblocks; ++kb, ++c) {
      const int s = c % S;
      bulk::mbar_wait(full + s, (c / S) & 1);
      unsigned char* at = ring + s * SB + wgi * 64 * 128;
      const unsigned char* wt = ring + s * SB + kABytes;
      if constexpr (kRegA) {
        uint32_t af[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag(af[kk], at, kk, aff + kb * kFbBoxK, kpad);
        wg_begin();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < NH; ++h)
            WgmmaRS<NW, 0>::mma(acc + 16 * h, af[kk], desc_k<64>(wt, BN, 128 * h, kk));
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // the products read af until the wait
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[kk][e])::"memory");
        __syncwarp();
        if (lane == 0) bulk::mbar_arrive(empty + s);
      } else {
        if constexpr (kBnRelu) bn_relu_inplace(at, aff + kb * kFbBoxK, kpad);
        wg_begin();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < NH; ++h)
            Wgmma<NW, 0, 0>::mma(acc + 16 * h, desc_k<64>(at, 64, 0, kk),
                                 desc_k<64>(wt, BN, 128 * h, kk), 1);
        wg_commit();
        wg_wait<1>();  // stage c - 1's products are done: release it
        __syncwarp();
        if (kb > 0 && lane == 0) bulk::mbar_arrive(empty + (c - 1) % S);
      }
    }
    if constexpr (!kRegA) {
      wg_wait<0>();
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(empty + (c - 1) % S);
    }
    fence_acc<BN / 8>(acc);

    // y rounded to bf16, one 64 x 64 box at a time, into the warpgroup's
    // two staging boxes in turn, each once the store of two boxes ago has
    // read it; rows past M as zeros. Thread (lane) holds rows r and r + 8
    // of its warp's 16, columns 8j + 2 (lane % 4) (+1).
    const int row0 = tile * kFbRows + 64 * wgi;
    const int r = 16 * warp + (lane >> 2);
    const bool ok0 = row0 + r < p.M, ok1 = row0 + r + 8 < p.M;
#pragma unroll
    for (int q = 0; q < NQ; ++q, ++pc) {
      unsigned char* box = ystage + (2 * wgi + (pc & 1)) * kFbPanelBytes;
      if (tw == 0) bulk::store_wait_read<1>();
      warpgroup_sync(wgi);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        unsigned char* d = box + r * 128 + ((jj ^ (r & 7)) << 4) + (lane & 3) * 4;
        const int j = 8 * q + jj;
        *reinterpret_cast<uint32_t*>(d) = ok0 ? pack_bf16(acc[j][0], acc[j][1]) : 0u;
        *reinterpret_cast<uint32_t*>(d + 8 * 128) = ok1 ? pack_bf16(acc[j][2], acc[j][3]) : 0u;
      }
      bulk::fence_proxy_async();
      warpgroup_sync(wgi);
      if (tw == 0 && row0 < p.M) {
        bulk::store_2d(ymap, box, pn * BN + 64 * q, row0);
        bulk::store_commit();
      }
      // Columns 2 lane, 2 lane + 1 of the box over the warp's 16 rows.
      const unsigned char* src = box + 16 * warp * 128 + (lane & 3) * 4;
#pragma unroll
      for (int i = 0; i < kFbStatRows; ++i) {
        const uint32_t v =
            *reinterpret_cast<const uint32_t*>(src + i * 128 + (((lane >> 2) ^ (i & 7)) << 4));
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
        st[q][0] += f.x;
        st[q][1] += f.y;
        st[q][2] = fmaf(f.x, f.x, st[q][2]);
        st[q][3] = fmaf(f.y, f.y, st[q][3]);
      }
    }
  }

  // The block's row: the warps' rows in order, in the ring, which no copy
  // or product uses any more once every consumer is here.
  float* red = reinterpret_cast<float*>(ring);  // [2][kFbStatParts][BN]
  consumers_sync();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float* row = red + (4 * wgi + warp) * BN + 64 * q + 2 * lane;
    row[0] = st[q][0];
    row[1] = st[q][1];
    row[kFbStatParts * BN] = st[q][2];
    row[kFbStatParts * BN + 1] = st[q][3];
  }
  consumers_sync();
  for (int col = t; col < BN; col += kConsumers * 128) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < kFbStatParts; ++i) {
      s += red[i * BN + col];
      q += red[(kFbStatParts + i) * BN + col];
    }
    __stcg(p.part + (long long)blockIdx.x * 2 * BN + col, s);
    __stcg(p.part + (long long)blockIdx.x * 2 * BN + BN + col, q);
  }
}

// One arrival of the block on `count`, after every consumer's writes
// (one thread's gpu-scope fence after the block barrier orders them all);
// true in every consumer thread of the block that arrives `last`, whose
// later loads then see the other arrivals' writes.
__device__ __forceinline__ bool arrive_last(int* count, int last, int* flag) {
  consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool mine = atomicAdd(count, 1) == last;
    if (mine) {
      __threadfence();
      *count = 0;  // every launch leaves its counters zero
    }
    *flag = mine;
  }
  consumers_sync();
  return *flag;
}

// The merge of the blocks' rows: the last block of the merge group sums
// the group's rows in block order, the last of the panel's groups the
// group rows in order.
template <int BN>
__device__ __forceinline__ void merge(const Params& p, int* flag) {
  const FbPlan& pl = p.plan;
  const int pn = fb_panel(pl, blockIdx.x);
  const int g = blockIdx.x / pl.panels / pl.group, first = g * pl.group;
  const int members = min(pl.group, pl.blocks_per_panel - first);
  if (!arrive_last(p.counters + pn * (pl.groups + 1) + g, members - 1, flag)) return;
  // drop_last (a negative control): the panel's last block left out
  const int live = members - (p.drop_last && g == pl.groups - 1 ? 1 : 0);
  float* groups = p.part + ((long long)pl.grid + pn * pl.groups) * 2 * BN;
  sum_rows<BN>(groups + g * 2 * BN, groups + g * 2 * BN + BN,
               p.part + ((long long)first * pl.panels + pn) * 2 * BN, (long long)pl.panels * 2 * BN,
               live);
  if (!arrive_last(p.counters + pn * (pl.groups + 1) + pl.groups, pl.groups - 1, flag)) return;
  sum_rows<BN>(p.sum + pn * BN, p.sumsq + pn * BN, groups, 2 * BN, pl.groups);
}

// One persistent block: plan.grid of them, block b on panel b % panels.
template <int BN, bool kBnRelu>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_stats_tma_kernel(const __grid_constant__ CUtensorMap amap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap ymap, const Params p) {
  constexpr int SB = fb_stage_bytes(BN);
  const FbPlan& pl = p.plan;
  const int S = pl.stages, kpad = pl.kblocks * kFbBoxK;
  extern __shared__ __align__(1024) unsigned char ring[];  // 128-byte swizzled boxes: 1024-aligned
  unsigned char* ystage = ring + S * SB;
  float* aff = reinterpret_cast<float*>(ystage + kFbYBytes);  // scale [kpad], shift [kpad]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ystage + kFbYBytes + fb_affine_bytes(pl.kblocks, kBnRelu));
  uint64_t* empty = full + S;
  int* flag = reinterpret_cast<int*>(empty + S);
  if (threadIdx.x == 0) {
    if (bulk::smem_u32(ring) & 1023) __trap();  // the swizzle needs the alignment asked for
    for (int i = 0; i < S; ++i) {
      bulk::mbar_init(full + i, 1);
      bulk::mbar_init(empty + i, 4 * kConsumers);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      const int pn = fb_panel(pl, blockIdx.x);
      int c = 0;
      for (int it = 0;; ++it) {
        const int tile = fb_tile(pl, blockIdx.x, it);
        if (tile < 0) break;
        for (int kb = 0; kb < pl.kblocks; ++kb, ++c) {
          const int s = c % S;
          if (c >= S) bulk::mbar_wait(empty + s, (c / S - 1) & 1);
          bulk::mbar_arrive_expect(full + s, SB);
          unsigned char* st = ring + s * SB;
          bulk::copy_2d(st, &amap, kb * kFbBoxK, tile * kFbRows, full + s);
          bulk::copy_2d(st + kABytes, &wmap, kb * kFbBoxK, pn * BN, full + s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  // The folded BN affine (ops/fused_block._affine_rows, operation for
  // operation), while the producer's first loads are in flight:
  // scale = rsqrt(var + eps) * gamma, shift = beta - mean * scale.
  if constexpr (kBnRelu) {
    for (int k = threadIdx.x; k < kpad; k += kConsumers * 128) {
      float sc = 0.f, sh = 0.f;
      if (k < p.K) {
        sc = __fmul_rn(rsqrtf(__fadd_rn(p.var[k], p.eps)), p.gamma[k]);
        sh = __fsub_rn(p.beta[k], __fmul_rn(p.mean[k], sc));
      }
      aff[k] = sc;
      aff[kpad + k] = sh;
    }
    consumers_sync();
  }
  consume<BN, kBnRelu>(p, ring, ystage, aff, full, empty, &ymap);
  merge<BN>(p, flag);
  if ((threadIdx.x & 127) == 0) bulk::store_wait_read<0>();  // the staged y outlives no store
}

// A 2-D tensor map over a row-major [rows, cols] bf16 matrix, boxes of 64
// columns x box_rows rows in 128-byte swizzle; 0 or a CUDA error.
int tile_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const bulk::EncodeTiled encode = bulk::encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kFbBoxK, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// Blocks of the instantiation an SM holds at `smem` bytes (the occupancy
// API; the attribute first raised to `smem`, which the launch then uses).
template <int BN, bool R>
int blocks_per_sm(int smem, int* out) {
  auto* kern = matmul_stats_tma_kernel<BN, R>;
  int rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, kThreads, smem);
  return rc;
}

template <int BN, bool R>
int launch(const void* a, const void* w, void* y, const Params& p, cudaStream_t s) {
  CUtensorMap amap, wmap, ymap;
  int rc = tile_map(&amap, a, p.M, p.K, kFbRows);
  if (rc == 0) rc = tile_map(&wmap, w, p.plan.panels * BN, p.K, BN);
  if (rc == 0) rc = tile_map(&ymap, y, p.M, p.plan.panels * BN, 64);
  if (rc != 0) return rc;
  matmul_stats_tma_kernel<BN, R><<<p.plan.grid, kThreads, p.plan.smem, s>>>(amap, wmap, ymap, p);
  return (int)cudaGetLastError();
}

// The plan on the current device: its SM count, and the blocks an SM of
// the plan's instantiation holds.
int card_plan(FbPlan& pl, int M, int K, int N, int bn_relu) {
  int dev = 0, sms = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != 0) return rc;
  if (!fb_plan(pl, M, K, N, bn_relu, sms, 1)) return (int)cudaErrorInvalidValue;
  switch (pl.bn * 2 + (bn_relu != 0)) {
    case 512: rc = blocks_per_sm<256, false>(pl.smem, &per_sm); break;
    case 513: rc = blocks_per_sm<256, true>(pl.smem, &per_sm); break;
    case 256: rc = blocks_per_sm<128, false>(pl.smem, &per_sm); break;
    case 257: rc = blocks_per_sm<128, true>(pl.smem, &per_sm); break;
    case 128: rc = blocks_per_sm<64, false>(pl.smem, &per_sm); break;
    default: rc = blocks_per_sm<64, true>(pl.smem, &per_sm); break;
  }
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  return fb_plan(pl, M, K, N, bn_relu, sms, per_sm) ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point (loaded with ctypes). bn_relu: 0 = no prologue (mean,
// var, gamma, beta and eps unused), 1 = BN-apply + ReLU prologue with the
// affine folded from them (f32 [K] each). part holds part_floats floats of
// scratch and counters n_counters zero ints (left zero), at least the
// plan's (fused_block_plan). drop_last != 0 leaves each panel's last
// block out of the statistics (a wrong variant, only for negative
// controls). Requires M >= 1, K % 32 == 0, N % 64 == 0, a, w, y, sum,
// sumsq and part 16-byte aligned, all tensors contiguous. Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int fused_block_matmul_stats(const void* a, const void* w, const float* mean,
                                        const float* var, const float* gamma, const float* beta,
                                        float eps, void* y, float* sum, float* sumsq, float* part,
                                        long long part_floats, int* counters, int n_counters,
                                        int M, int K, int N, int bn_relu, int drop_last,
                                        void* stream) {
  const void* ptrs[6] = {a, w, y, sum, sumsq, part};
  for (const void* q : ptrs)
    if (q == nullptr || reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  if (M < 1 || K < 32 || K % 32 || N < 64 || N % 64 || counters == nullptr ||
      (bn_relu && (!mean || !var || !gamma || !beta)))
    return (int)cudaErrorInvalidValue;
  FbPlan pl;
  int rc = card_plan(pl, M, K, N, bn_relu);
  if (rc != 0) return rc;
  if (part_floats < pl.part_floats || n_counters < pl.counters) return (int)cudaErrorInvalidValue;
  const Params p = {pl, mean, var, gamma, beta, eps, sum, sumsq, part, counters, M, K,
                    drop_last != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.bn * 2 + (bn_relu != 0)) {
    case 512: return launch<256, false>(a, w, y, p, s);
    case 513: return launch<256, true>(a, w, y, p, s);
    case 256: return launch<128, false>(a, w, y, p, s);
    case 257: return launch<128, true>(a, w, y, p, s);
    case 128: return launch<64, false>(a, w, y, p, s);
    default: return launch<64, true>(a, w, y, p, s);
  }
}

// The plan a call of (M, K, N, bn_relu) runs on the current device:
// kFbPlanInts ints (fb_plan_ints). Returns 0 or a CUDA error.
extern "C" int fused_block_plan(int M, int K, int N, int bn_relu, int* out) {
  FbPlan pl;
  const int rc = card_plan(pl, M, K, N, bn_relu);
  if (rc == 0) fb_plan_ints(pl, out);
  return rc;
}
