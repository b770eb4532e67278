// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the Pallas TPU kernels of
// distributeddeeplearning_tpu/ops/pallas/flash.py: `_flash_fwd_kernel`
// (run by `_flash`), `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (run by `_flash_bwd_rule`, the custom VJP of `flash_attention`).
// Same contract, per (batch, head):
//   q [Tq, D], k/v [Tk, D], do [Tq, D]  bf16, read as strided [B, T, H, D]
//       views (the last dim contiguous; batch, sequence and head strides
//       in elements), so q, k and v may be slices of the packed qkv
//       projection [B, T, 3, H, D] and no copy runs per layer
//   s   = f32(q . k^T) * scale  (the scale on the f32 product)
//   mask: key >= Tk, and key > query when causal (Tq == Tk)
//   forward:  online softmax over key tiles: running max m, sum l (f32, of
//             the unrounded p) and an f32 accumulator of bf16(p) . v;
//             o = bf16(acc / l), lse = m + log(l) f32 [B*H, Tq]
//   dq:   p = exp(s - lse), dp = do . v^T, ds = p * (dp - delta) * scale,
//         dq = sum over key tiles of bf16(ds) . k
//   dk/dv: dv = sum over query tiles of bf16(p)^T . do,
//          dk = sum over query tiles of bf16(ds)^T . q
// where delta = rowsum(f32(do) * f32(o)) [B*H, Tq] (computed by the
// caller, as the JAX package computes it outside its kernels). The
// rounding points are the JAX kernels'. Masked scores take the finite
// -1e30 and masked p is 0, so a fully masked row gives no NaN; l == 0
// stores o = 0 and lse = m. Rows past Tq (Tk) are loaded as zeros and
// never stored.
//
// Design. The TPU kernels walk a sequential grid axis and carry m, l and
// the accumulators in VMEM scratch from one step to the next. Here a work
// item is 128 rows of one head (queries for the forward and dq, keys for
// dk/dv) and the other sequence is a loop inside the block:
// * Warp specialized: three warpgroups a block (384 threads, one block an
//   SM). Two consumer groups of 64 rows issue the products; one thread of
//   the producer group keeps tiles in flight by TMA. setmaxnreg moves
//   registers to the consumers (232 a thread, 240 in dk/dv; the producer
//   keeps 40, 24).
//   Nothing meets at a block-wide barrier: each buffer has a "full"
//   mbarrier (TMA's byte count) and an "empty" one (one arrival per
//   consumer warp once its products have read it).
// * Persistent: the grid is one block per SM (at most one per item); a
//   block takes items in snake order (blockIdx.x, then 2G-1-blockIdx.x, ...)
//   over a list sorted longest first (causal: the last query blocks of the
//   forward and dq, the first key blocks of dk/dv), which balances the
//   causal lengths as a greedy queue would. The producer loads the next
//   item's resident tiles (double buffered, but for dq at D >= 96) and
//   tiles while the consumers finish this one.
// * Loads: one 4-D tensor map per operand over the strided [B, T, H, D]
//   view (built per call by the C entry points through the driver's
//   cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint, so no
//   -lcuda), boxes of [rows][64] columns with the 128-byte swizzle (D =
//   32: [rows][32], 64-byte swizzle), the layouts wgmma reads (wgmma.cuh).
//   TMA zero fills rows past T. D = 96 is held as 128 columns, the last 32
//   zero filled (out of the map's bounds) and never stored; its score
//   products contract over 96 only. dk/dv's lse and delta come by 1-D TMA
//   from the 16-byte aligned element at or before each tile's first.
// * Stores: each consumer group writes its [64][D] result as bf16 into a
//   swizzled scratch tile and one TMA store writes it out (rows past T are
//   clipped by the map).
// * Products: wgmma. Q.K^T and dO.V^T (and k.q^T, v.dO^T in dk/dv) read
//   both operands from swizzled shared memory; bf16(p).V, ds.K, p^T.dO
//   and ds^T.q take the score accumulator as register A fragments and B
//   as an MN-major view of the same tiles (scripts/flash_attention_ablation.py
//   times the alternative that stages p and ds in shared memory instead).
// * Software pipelined: each kernel issues tile j+1's score products
//   together with tile j's second products and does tile j+1's softmax or
//   element work while those run (the last tile's products are peeled off,
//   so no wgmma sits in a conditional path, which would serialize them).
// * Forward (flash_fwd_kernel): 128 query rows; K and V tiles of KN keys
//   through a ring (K and V with separate full barriers). Scores stay
//   unscaled in registers: p = 2^(s*c - m*c) with c = scale*log2(e) and m
//   the running max of the unscaled scores, alpha = 2^((m_old - m)*c), lse
//   = scale*m + log(l).
// * dq (flash_bwd_dq_kernel): 128 query rows, Q and dO resident; K and V
//   tiles through the ring; per tile one batch of Q.K^T and dO.V^T, then
//   p = 2^(s*c - lse*log2(e)), ds, and dq += bf16(ds).K.
// * dk/dv (flash_bwd_dkv_kernel): 128 keys, K and V resident; the head's
//   (q, dO, lse, delta) tiles of KM queries through the ring; per tile one
//   batch of k.q^T and v.dO^T, then one of bf16(p)^T.dO and bf16(ds)^T.q.
// * Masks: only tiles that hold a masked entry test each element, in a
//   pass of their own that sets the score to -1e30 (so p = 0): the
//   elementwise loops stay free of branches, which kept the backward's
//   element work from overlapping the products when it was not. dq and
//   dk/dv skips the tiles that have no kept entry. dq and dk/dv are
//   separate kernels (as on the TPU), so no atomics: gradients repeat bit
//   for bit.
//
// What bounds it on an H100 (lm_base training: B = 8, H = 12, T = 1024,
// D = 64, causal): the forward does 4*B*H*P*D = 13 GFLOP for P =
// T(T+1)/2 query-key pairs (13 us at 989 TFLOP/s) and moves 50 MB (15 us
// at 3.35 TB/s); dq 6*B*H*P*D and dk/dv 8*B*H*P*D operations bound them.
// Each query block reads every K and V tile up to its diagonal again (113
// MB from L2 in the forward), and that traffic, not the products, is most
// of the forward's time. PERF.md holds the measured times, and
// scripts/flash_attention_ablation.py what each part of the kernels costs.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)

#include "wgmma.cuh"

// FLASH_ABLATE (a compile-time bit mask, 0 in every build the package
// makes) skips parts of the kernels so that a timing-only build shows
// what each part costs (scripts/flash_attention_ablation.py): 1 the score
// products (q.k^T, dO.v^T and their transposes), 2 the products whose A
// operand is the score accumulator (bf16(p).v, ds.k, p^T.dO, ds^T.q), 4
// the softmax and the backward's elementwise work.
#ifndef FLASH_ABLATE
#define FLASH_ABLATE 0
#endif
// FLASH_STAGED_DS (0 in every build the package makes) is the ablation's
// alternative backward: bf16(p) and bf16(ds) are written to swizzled
// shared memory and the dq, dk and dv products read both operands from
// there, instead of taking A from registers.
#ifndef FLASH_STAGED_DS
#define FLASH_STAGED_DS 0
#endif
// FLASH_ONE_BLOCK_PER_TILE (0 in every build the package makes) launches
// one block per work item instead of one per SM: the ablation's check of
// the persistent schedule.
#ifndef FLASH_ONE_BLOCK_PER_TILE
#define FLASH_ONE_BLOCK_PER_TILE 0
#endif

namespace {

using namespace mma;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kRows = 64 * kConsumers;            // rows a block owns
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// dk/dv's consumers hold two [64][D] accumulators beside two tiles of
// scores: they take 240 registers, the most that 24 left to the producer
// allows (dq measured faster at 232).
constexpr int kDkvProducerRegs = 24, kDkvConsumerRegs = 240;

// Columns a tile holds in shared memory: D = 96 pads to 128.
template <int D>
__host__ __device__ constexpr int padded() { return D == 96 ? 128 : D; }
// Tile shapes, bounded by the consumers' registers: the forward's and dq's
// key tile, dk/dv's query tile; and the rings' depths, bounded by shared
// memory (every kernel double-buffers its resident tiles besides).
template <int D>
__host__ __device__ constexpr int fwd_kn() { return padded<D>() >= 128 ? 64 : 128; }
template <int D>
__host__ __device__ constexpr int dq_kn() { return padded<D>() >= 128 ? 64 : 128; }
template <int D>
__host__ __device__ constexpr int dkv_km() { return padded<D>() >= 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int fwd_stages() { return 4; }
template <int D>
__host__ __device__ constexpr int dq_stages() { return 4; }
// dq's resident (q, dO) buffers: two, so that the next item's load
// overlaps this one's work, but one at D >= 96, where two would leave the
// pipelined loop no ring stage to prefetch into.
template <int D>
__host__ __device__ constexpr int dq_buffers() { return padded<D>() >= 128 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_stages() { return padded<D>() >= 128 ? 3 : 6; }
// A dk/dv stage: q, dO, then lse and delta of its KM queries, each read by
// TMA from the 16-byte aligned element at or before the tile's first (KM +
// 4 values: up to 3 more) into a 128-byte aligned slot.
template <int D>
__host__ __device__ constexpr int dkv_lbytes() { return ((dkv_km<D>() + 4) * 4 + 127) / 128 * 128; }
template <int D>
__host__ __device__ constexpr int dkv_stage() {
  return (2 * padded<D>() * dkv_km<D>() * 2 + 2 * dkv_lbytes<D>() + 1023) / 1024 * 1024;
}
// Each consumer group's scratch tile: its [64][DP] output on the way to a
// TMA store (and, in the FLASH_STAGED_DS build, its staged p and ds).
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
template <int D>
__host__ __device__ constexpr int out_bytes() { return 64 * padded<D>() * 2; }
template <int D>
__host__ __device__ constexpr int fwd_xb() { return out_bytes<D>(); }
template <int D>
__host__ __device__ constexpr int dq_xb() {
  return cmax(out_bytes<D>(), FLASH_STAGED_DS ? 64 * dq_kn<D>() * 2 : 0);
}
template <int D>
__host__ __device__ constexpr int dkv_xb() {
  return cmax(out_bytes<D>(), FLASH_STAGED_DS ? 2 * 64 * dkv_km<D>() * 2 : 0);
}

struct Params {
  float* lse_out;      // forward: [B*H, Tq]
  const float* lse;    // dq: [B*H, Tq]
  const float* delta;  // dq: [B*H, Tq]
  int BH, H, Tq, Tk, causal, drop_last;
  float scale;
};

// The tensor maps: operands q, k, v, dO (4-D, bf16), the backward's lse and
// delta (1-D over [B*H*Tq] f32, for dk/dv), and the outputs o0 (o, dq or
// dk) and o1 (dv), written by TMA stores of 64-row boxes.
struct Maps {
  CUtensorMap q, k, v, d, lse, delta, o0, o1;
};

// Work items, longest first: item i is row block i / BH (0 = the longest
// when causal) of head i % BH. A block takes items in snake order over
// the grid (blockIdx.x, then 2G-1-blockIdx.x, ...), which balances the
// causal lengths across blocks as well as a greedy queue would.
__device__ __forceinline__ int nth_item(int n) {
  const int g = gridDim.x;
  return n * g + ((n & 1) ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// ------------------------------------------------------ mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` from TMA.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// A box of the 4-D map (column c, head h, row r, batch b) into shared
// memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(unsigned char* dst, const CUtensorMap* map, int c, int h,
                                         int r, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(r), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// A box of a 1-D f32 map (from element x) into shared memory.
__device__ __forceinline__ void tma_load_1d(unsigned char* dst, const CUtensorMap* map, int x,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// Rows r0 .. r0+ROWS-1 of head (b, h) into a [ROWS][DP] tile: one box, or
// two [ROWS][64] halves when DP = 128.
template <int DP, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* tile, const CUtensorMap* map, int h,
                                         int r0, int b, uint64_t* bar) {
#pragma unroll
  for (int half = 0; half < (DP == 128 ? 2 : 1); ++half)
    tma_load(tile + half * ROWS * 128, map, half * 64, h, r0, b, bar);
}

// A barrier of consumer group wg's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
// The group's last TMA store has read its scratch tile (its leader waits,
// then the group).
__device__ __forceinline__ void scratch_free(int wg) {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  wg_sync(wg);
}

// A shared-memory box to the 4-D map at (column c, head h, row r, batch b);
// rows and columns out of the map's bounds are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const unsigned char* src, int c,
                                          int h, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c), "r"(h), "r"(r), "r"(b)
      : "memory");
}

// The group's acc [64][D] (times mul0 on each thread's first row, mul1 on
// its second) as bf16 to rows r0 .. r0+63 of head (b, h): into its scratch
// tile (swizzled [64][DP], as the map's boxes are), then one TMA store
// issued by the group's leader.
template <int D>
__device__ __forceinline__ void store_tile(unsigned char* st, const CUtensorMap* map,
                                           const float (*acc)[4], float mul0, float mul1, int h,
                                           int r0, int b, int wg) {
  constexpr int DP = padded<D>();
  const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  scratch_free(wg);
#pragma unroll
  for (int di = 0; di < D / 8; ++di)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = di * 8 + (lane & 3) * 2;
      const float mul = half ? mul1 : mul0;
      *reinterpret_cast<uint32_t*>(st + chunk_off<DP>(r + 8 * half, di, 64) + (col % 8) * 2) =
          pack_bf16(acc[di][2 * half] * mul, acc[di][2 * half + 1] * mul);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int half = 0; half < (DP == 128 ? 2 : 1); ++half)
      tma_store(map, st + half * 64 * 128, half * 64, h, r0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}
// Before the block exits: every TMA store of the group has completed.
__device__ __forceinline__ void stores_done() {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The barriers a kernel uses, after its tiles; initialized by thread 0,
// then made visible to the block (and to TMA).
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n, const int* counts) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + i, counts[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------- shared math

// The products behind the ablation mask. abt: acc[N/8] = A (64 rows from
// a_row0 of a tile of a_rows rows) . B^T (N rows), over D columns of
// DP-column tiles. xb: acc[DP/8] += X (registers) . B (the first KT*8
// rows of a tile of `rows` rows).
template <int DP, int N, int D>
__device__ __forceinline__ void abt(float (*acc)[4], const unsigned char* a, int a_rows,
                                    int a_row0, const unsigned char* b) {
  if (FLASH_ABLATE & 1) return;
  wg_abt_ss<DP, N, D / 16>(acc, a, a_rows, a_row0, b);
}
template <int DP, int KT>
__device__ __forceinline__ void xb(float (*acc)[4], const uint32_t (*af)[4],
                                   const unsigned char* b, int rows) {
  if (FLASH_ABLATE & 2) return;
  wg_xb_rs<DP, KT>(acc, af, b, rows);
}

// Entry (row, col) is kept: col < Tk, and col <= row when causal.
__device__ __forceinline__ bool kept(const Params& p, int row, int col) {
  return col < p.Tk && (!p.causal || col <= row);
}

// Masked entries of the warp's scores s[NT][4] (key tile at k0) to
// kNegInf; this thread's rows are row0 and row0 + 8.
template <int NT>
__device__ __forceinline__ void apply_mask(float (*s)[4], const Params& p, int row0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + ni * 8 + (lane & 3) * 2 + (e & 1);
      if (!kept(p, row0 + (e >> 1) * 8, col)) s[ni][e] = kNegInf;
    }
}

// The same for transposed scores (rows = keys key0 and key0 + 8, columns =
// queries from q0): queries past Tq, and (causal) queries before the key.
template <int NT>
__device__ __forceinline__ void apply_mask_t(float (*s)[4], const Params& p, int key0, int q0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + ni * 8 + (lane & 3) * 2 + (e & 1);
      if (qi >= p.Tq || (p.causal && qi < key0 + (e >> 1) * 8)) s[ni][e] = kNegInf;
    }
}

// Key tiles rows q0 .. q0+kRows-1 need: all, or up to the diagonal.
template <int KN>
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int tiles = (p.Tk + KN - 1) / KN;
  if (p.causal) tiles = min(tiles, (q0 + kRows - 1) / KN + 1);
  return tiles;
}
// Whether the 16 rows from wr0 meet a masked key in k0 .. k0+n-1.
__device__ __forceinline__ bool needs_mask(const Params& p, int wr0, int k0, int n) {
  return k0 + n > p.Tk || (p.causal && k0 + n - 1 > wr0);
}

// One key tile (at k0) of the forward's online softmax, in place: the
// unscaled scores sc become p = 2^(s*c - m*c) (0 where masked), with c =
// scale*log2(e) and m the running row max of the unscaled scores; l (this
// thread's part of the row sums) and m are updated, and alpha is what the
// accumulator of the earlier tiles is to be scaled by.
template <int NT>
__device__ __forceinline__ void online_softmax(float (*sc)[4], float* m, float* l, float* alpha,
                                               float c, const Params& p, int wr0, int row0,
                                               int k0) {
  const bool mask = needs_mask(p, wr0, k0, NT * 8);
  if (mask) apply_mask<NT>(sc, p, row0, k0);
  if (FLASH_ABLATE & 4) {
    alpha[0] = alpha[1] = 1.f;
    l[0] += sc[0][0];  // keeps the scores live
    return;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[ni][e]);
  quad_max(mx);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    alpha[r] = ex2((m[r] - mx[r]) * c);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
  const float mc[2] = {m[0] * c, m[1] * c};
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(sc[ni][e], c, -mc[e >> 1]));
      // a row with no kept key yet has m = kNegInf too
      sc[ni][e] = mask && sc[ni][e] == kNegInf ? 0.f : x;
      l[e >> 1] += sc[ni][e];
    }
}

#if FLASH_STAGED_DS
// The warp's score-shaped x[KT][4] (rows 16w .. of the group) as bf16 into
// a swizzled [64][KT*8] K-major tile; then the group's writes handed to
// wgmma (generic -> async proxy, and a barrier of the group's 128 threads).
template <int KT>
__device__ __forceinline__ void stage_scores(unsigned char* tile, const float (*x)[4], int wg) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r = 16 * w + (lane >> 2);
  scratch_free(wg);  // the last tile's readers (products, or a TMA store) are done
#pragma unroll
  for (int ni = 0; ni < KT; ++ni)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = ni * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(tile + chunk_off<KT * 8>(r + 8 * half, col / 8, 64) +
                                   (col % 8) * 2) =
          pack_bf16(x[ni][2 * half], x[ni][2 * half + 1]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
}
// acc[DP/8] += A (the staged [64][KT*8] tile) . B (the first KT*8 rows of
// a tile of `rows` rows, MN-major).
template <int DP, int KT>
__device__ __forceinline__ void xb_staged(float (*acc)[4], const unsigned char* a,
                                          const unsigned char* b, int rows) {
  if (FLASH_ABLATE & 2) return;
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc)
    Wgmma<DP, 1>::mma(acc, desc_k<KT * 8>(a, 64, 0, kc), desc_mn<DP>(b, rows, kc), 1);
}
#endif

// ---------------------------------------------------------------- forward

// Per item (128 query rows of a head): the producer loads Q into one of
// two buffers (rfull/rempty) and streams K and V tiles through the ring
// (kfull, vfull, empty); the consumers run the online softmax.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int DP = padded<D>(), KN = fwd_kn<D>(), NT = KN / 8, S = fwd_stages<D>();
  constexpr int QT = tile_bytes<DP, kRows>(), KT = tile_bytes<DP, KN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = aligned_smem(smem_raw);  // 2 buffers
  unsigned char* sk = sq + 2 * QT;              // S stages
  unsigned char* sv = sk + S * KT;              // S stages
  unsigned char* sx = sv + S * KT;              // a scratch tile a group
  uint64_t* rfull = reinterpret_cast<uint64_t*>(sx + kConsumers * fwd_xb<D>());
  uint64_t* rempty = rfull + 2;
  uint64_t* kfull = rempty + 2;
  uint64_t* vfull = kfull + S;
  uint64_t* empty = vfull + S;
  {
    int counts[4 + 3 * S];
    for (int i = 0; i < 4 + 3 * S; ++i) counts[i] = 1;
    counts[2] = counts[3] = kConsumerWarps;
    for (int s = 0; s < S; ++s) counts[4 + 2 * S + s] = kConsumerWarps;
    init_barriers(rfull, 4 + 3 * S, counts);
  }
  const int nq = (p.Tq + kRows - 1) / kRows, items = nq * p.BH;
  const int wg = threadIdx.x >> 7;

  if (wg == kConsumers) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;  // position in the ring, over all items
      for (int n = 0, item; (item = nth_item(n)) < items; ++n) {
        const int bh = item % p.BH, b = bh / p.H, h = bh % p.H;
        const int q0 = (nq - 1 - item / p.BH) * kRows;
        const int tiles = key_tiles<KN>(p, q0) - p.drop_last;  // drop_last: a negative control
        const int rb = n & 1;
        if (n >= 2) mbar_wait(rempty + rb, (n / 2 - 1) & 1);
        mbar_expect(rfull + rb, QT);
        tma_tile<DP, kRows>(sq + rb * QT, &maps.q, h, q0, b, rfull + rb);
        for (int j = 0; j < tiles; ++j, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
          mbar_expect(kfull + s, KT);
          tma_tile<DP, KN>(sk + s * KT, &maps.k, h, j * KN, b, kfull + s);
          mbar_expect(vfull + s, KT);
          tma_tile<DP, KN>(sv + s * KT, &maps.v, h, j * KN, b, vfull + s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float c = p.scale * kLog2e;
  int it = 0;
  for (int n = 0, item; (item = nth_item(n)) < items; ++n) {
    const int bh = item % p.BH, b = bh / p.H, h = bh % p.H;
    const int q0 = (nq - 1 - item / p.BH) * kRows;
    const int tiles = key_tiles<KN>(p, q0) - p.drop_last;
    const int rb = n & 1;
    const unsigned char* q = sq + rb * QT;
    const int wr0 = q0 + warp * 16, gr0 = q0 + wg * 64, row0 = wr0 + (lane >> 2);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part
    float acc[DP / 8][4];
    zero<DP / 8>(acc);
    mbar_wait(rfull + rb, (n / 2) & 1);

    if (gr0 >= p.Tq || tiles <= 0) {  // no row of the group to compute: release the tiles
      for (int j = 0; j < tiles; ++j, ++it) {
        mbar_wait(kfull + it % S, (it / S) & 1);
        mbar_wait(vfull + it % S, (it / S) & 1);
        if (lane == 0) mbar_arrive(empty + it % S);
      }
    } else {
      // Software pipelined: while the tensor cores run tile j's P.V, the
      // group takes the softmax of tile j+1's scores, issued together with it.
      float sc[NT][4];
      uint32_t pf[NT / 2][4];  // bf16(p) of the tile whose P.V is next
      mbar_wait(kfull + it % S, (it / S) & 1);
      wg_begin();
      abt<DP, KN, D>(sc, q, kRows, wg * 64, sk + (it % S) * KT);
      wg_end();
      fence_acc<NT>(sc);
      float alpha[2];
      online_softmax<NT>(sc, m, l, alpha, c, p, wr0, row0, 0);
      a_frags<NT>(pf, sc);
      for (int j = 0; j + 1 < tiles; ++j, ++it) {
        const int s = it % S, s1 = (it + 1) % S;
        mbar_wait(kfull + s1, ((it + 1) / S) & 1);
        mbar_wait(vfull + s, (it / S) & 1);
        wg_begin();
        abt<DP, KN, D>(sc, q, kRows, wg * 64, sk + s1 * KT);
        wg_commit();
        xb<DP, NT>(acc, pf, sv + s * KT, KN);
        wg_commit();
        wg_wait<1>();  // the scores; P.V may still run
        fence_acc<NT>(sc);
        online_softmax<NT>(sc, m, l, alpha, c, p, wr0, row0, (j + 1) * KN);
        wg_wait<0>();
        fence_acc<DP / 8>(acc);
        if (lane == 0) mbar_arrive(empty + s);
        a_frags<NT>(pf, sc);
#pragma unroll
        for (int di = 0; di < DP / 8; ++di) {
          acc[di][0] *= alpha[0];
          acc[di][1] *= alpha[0];
          acc[di][2] *= alpha[1];
          acc[di][3] *= alpha[1];
        }
      }
      // the last tile's P.V
      mbar_wait(vfull + it % S, (it / S) & 1);
      wg_begin();
      xb<DP, NT>(acc, pf, sv + (it % S) * KT, KN);
      wg_end();
      fence_acc<DP / 8>(acc);
      if (lane == 0) mbar_arrive(empty + it % S);
      ++it;
    }
    if (lane == 0) mbar_arrive(rempty + rb);

    if (gr0 < p.Tq) {
      quad_sum(l);
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ls = l[r] == 0.f ? 1.f : l[r];
        inv[r] = 1.f / ls;
        const int row = row0 + r * 8;
        if ((lane & 3) == 0 && row < p.Tq)
          p.lse_out[(long long)bh * p.Tq + row] =
              (m[r] == kNegInf ? kNegInf : m[r] * p.scale) + logf(ls);
      }
      store_tile<D>(sx + wg * fwd_xb<D>(), &maps.o0, acc, inv[0], inv[1], h, gr0, b, wg);
    }
  }
  stores_done();
}

// --------------------------------------------------------------------- dq

// Per item (128 query rows of a head): Q and dO into one of RB buffers,
// K and V tiles through the ring; per tile one batch of Q.K^T and dO.V^T,
// then dq += bf16(ds).K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int DP = padded<D>(), KN = dq_kn<D>(), NT = KN / 8, S = dq_stages<D>();
  constexpr int RB = dq_buffers<D>();
  constexpr int QT = tile_bytes<DP, kRows>(), KT = tile_bytes<DP, KN>();
  constexpr int XB = dq_xb<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = aligned_smem(smem_raw);  // RB buffers of (q, dO)
  unsigned char* sk = sq + 2 * RB * QT;         // S stages
  unsigned char* sv = sk + S * KT;              // S stages
  unsigned char* sx = sv + S * KT;              // a scratch tile a group
  uint64_t* rfull = reinterpret_cast<uint64_t*>(sx + kConsumers * XB);
  uint64_t* rempty = rfull + 2;
  uint64_t* full = rempty + 2;
  uint64_t* empty = full + S;
  {
    int counts[4 + 2 * S];
    for (int i = 0; i < 4 + 2 * S; ++i) counts[i] = 1;
    counts[2] = counts[3] = kConsumerWarps;
    for (int s = 0; s < S; ++s) counts[4 + S + s] = kConsumerWarps;
    init_barriers(rfull, 4 + 2 * S, counts);
  }
  const int nq = (p.Tq + kRows - 1) / kRows, items = nq * p.BH;
  const int wg = threadIdx.x >> 7;

  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int n = 0, item; (item = nth_item(n)) < items; ++n) {
        const int bh = item % p.BH, b = bh / p.H, h = bh % p.H;
        const int q0 = (nq - 1 - item / p.BH) * kRows;
        const int rb = n % RB;
        if (n >= RB) mbar_wait(rempty + rb, (n / RB - 1) & 1);
        mbar_expect(rfull + rb, 2 * QT);
        tma_tile<DP, kRows>(sq + 2 * rb * QT, &maps.q, h, q0, b, rfull + rb);
        tma_tile<DP, kRows>(sq + (2 * rb + 1) * QT, &maps.d, h, q0, b, rfull + rb);
        for (int j = 0, tiles = key_tiles<KN>(p, q0); j < tiles; ++j, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
          mbar_expect(full + s, 2 * KT);
          tma_tile<DP, KN>(sk + s * KT, &maps.k, h, j * KN, b, full + s);
          tma_tile<DP, KN>(sv + s * KT, &maps.v, h, j * KN, b, full + s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float c = p.scale * kLog2e;
  int it = 0;
  for (int n = 0, item; (item = nth_item(n)) < items; ++n) {
    const int bh = item % p.BH, b = bh / p.H, h = bh % p.H;
    const int q0 = (nq - 1 - item / p.BH) * kRows;
    const int tiles = key_tiles<KN>(p, q0);
    const int rb = n % RB;
    const unsigned char* q = sq + 2 * rb * QT;
    const unsigned char* dout = q + QT;
    const int wr0 = q0 + warp * 16, gr0 = q0 + wg * 64, row0 = wr0 + (lane >> 2);
    float lse2[2], delta[2];  // lse * log2(e): p = 2^(s*c - lse2)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      lse2[r] = row < p.Tq ? p.lse[(long long)bh * p.Tq + row] * kLog2e : 0.f;
      delta[r] = row < p.Tq ? p.delta[(long long)bh * p.Tq + row] : 0.f;
    }
    float dq[DP / 8][4];
    zero<DP / 8>(dq);
    mbar_wait(rfull + rb, (n / RB) & 1);

    // Per tile: the scores q.k^T and dO.v^T, then ds in place of the scores
    // and dq += bf16(ds).k.
    float sc[NT][4], dp[NT][4];
    auto scores = [&](int t) {
      abt<DP, KN, D>(sc, q, kRows, wg * 64, sk + (t % S) * KT);
      abt<DP, KN, D>(dp, dout, kRows, wg * 64, sv + (t % S) * KT);
    };
    auto elementwise = [&](int k0) {
      if (needs_mask(p, wr0, k0, KN)) apply_mask<NT>(sc, p, row0, k0);  // p = 0 there
      if (FLASH_ABLATE & 4) return;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          sc[ni][e] = ex2(fmaf(sc[ni][e], c, -lse2[r])) * (dp[ni][e] - delta[r]) * p.scale;
        }
    };
    if (gr0 >= p.Tq) {  // no row of the group: release the tiles
      for (int j = 0; j < tiles; ++j, ++it) {
        mbar_wait(full + it % S, (it / S) & 1);
        if (lane == 0) mbar_arrive(empty + it % S);
      }
    } else {
#if FLASH_STAGED_DS
      for (int j = 0; j < tiles; ++j, ++it) {
        mbar_wait(full + it % S, (it / S) & 1);
        wg_begin();
        scores(it);
        wg_end();
        fence_acc<NT>(sc);
        fence_acc<NT>(dp);
        elementwise(j * KN);
        stage_scores<NT>(sx + wg * XB, sc, wg);
        wg_begin();
        xb_staged<DP, NT>(dq, sx + wg * XB, sk + (it % S) * KT, KN);
        wg_end();
        fence_acc<DP / 8>(dq);
        if (lane == 0) mbar_arrive(empty + it % S);
      }
#else
      // Software pipelined as the forward: tile j+1's score products are
      // issued with tile j's dq product, and its element work runs while
      // that does. (Tiles whose entries are all masked give ds = 0.)
      uint32_t af[NT / 2][4];  // bf16(ds) of the tile in hand
      mbar_wait(full + it % S, (it / S) & 1);
      wg_begin();
      scores(it);
      wg_end();
      fence_acc<NT>(sc);
      fence_acc<NT>(dp);
      elementwise(0);
      a_frags<NT>(af, sc);
      for (int j = 0; j + 1 < tiles; ++j, ++it) {
        mbar_wait(full + (it + 1) % S, ((it + 1) / S) & 1);
        wg_begin();
        scores(it + 1);
        wg_commit();
        xb<DP, NT>(dq, af, sk + (it % S) * KT, KN);
        wg_commit();
        wg_wait<1>();  // the scores; the dq product may still run
        fence_acc<NT>(sc);
        fence_acc<NT>(dp);
        elementwise((j + 1) * KN);
        wg_wait<0>();
        fence_acc<DP / 8>(dq);
        if (lane == 0) mbar_arrive(empty + it % S);
        a_frags<NT>(af, sc);
      }
      wg_begin();
      xb<DP, NT>(dq, af, sk + (it % S) * KT, KN);
      wg_end();
      fence_acc<DP / 8>(dq);
      if (lane == 0) mbar_arrive(empty + it % S);
      ++it;
#endif
    }
    if (lane == 0) mbar_arrive(rempty + rb);
    if (gr0 < p.Tq) store_tile<D>(sx + wg * XB, &maps.o0, dq, 1.f, 1.f, h, gr0, b, wg);
  }
  stores_done();
}

// ------------------------------------------------------------------ dk/dv

// Per item (128 keys of a head): K and V into one of two buffers; the
// head's (q, dO, lse, delta) tiles of KM queries through the ring; per tile
// one batch of k.q^T and v.dO^T, then one of bf16(p)^T.dO and bf16(ds)^T.q.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int DP = padded<D>(), KM = dkv_km<D>(), NT = KM / 8, S = dkv_stages<D>();
  constexpr int KT = tile_bytes<DP, kRows>(), QT = tile_bytes<DP, KM>();
  constexpr int LB = KM + 4, LBYTES = dkv_lbytes<D>(), STAGE = dkv_stage<D>();
  constexpr int XB = dkv_xb<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = aligned_smem(smem_raw);  // 2 buffers of (k, v)
  unsigned char* ring = sk + 4 * KT;
  unsigned char* sx = ring + S * STAGE;  // a scratch tile a group
  uint64_t* rfull = reinterpret_cast<uint64_t*>(sx + kConsumers * XB);
  uint64_t* rempty = rfull + 2;
  uint64_t* full = rempty + 2;
  uint64_t* empty = full + S;
  {
    int counts[4 + 2 * S];
    for (int i = 0; i < 4 + 2 * S; ++i) counts[i] = 1;
    counts[2] = counts[3] = kConsumerWarps;
    for (int s = 0; s < S; ++s) counts[4 + S + s] = kConsumerWarps;
    init_barriers(rfull, 4 + 2 * S, counts);
  }
  const int nk = (p.Tk + kRows - 1) / kRows, items = nk * p.BH;
  const int wg = threadIdx.x >> 7;
  auto first_tile = [&](int k0) { return p.causal ? k0 / KM : 0; };  // earlier queries see none
  const int qtiles = (p.Tq + KM - 1) / KM;

  if (wg == kConsumers) {
    setmaxnreg_dec<kDkvProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int n = 0, item; (item = nth_item(n)) < items; ++n) {
        const int bh = item % p.BH, b = bh / p.H, h = bh % p.H;
        const int k0 = (item / p.BH) * kRows;  // causal: the longest key blocks first
        const int rb = n & 1;
        if (n >= 2) mbar_wait(rempty + rb, (n / 2 - 1) & 1);
        mbar_expect(rfull + rb, 2 * KT);
        tma_tile<DP, kRows>(sk + 2 * rb * KT, &maps.k, h, k0, b, rfull + rb);
        tma_tile<DP, kRows>(sk + (2 * rb + 1) * KT, &maps.v, h, k0, b, rfull + rb);
        for (int i = first_tile(k0); i < qtiles; ++i, ++it) {
          const int s = it % S, q0 = i * KM;
          if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
          unsigned char* st = ring + s * STAGE;
          const int x0 = (bh * p.Tq + q0) & ~3;
          mbar_expect(full + s, 2 * QT + 2 * LB * 4);
          tma_tile<DP, KM>(st, &maps.q, h, q0, b, full + s);
          tma_tile<DP, KM>(st + QT, &maps.d, h, q0, b, full + s);
          tma_load_1d(st + 2 * QT, &maps.lse, x0, full + s);
          tma_load_1d(st + 2 * QT + LBYTES, &maps.delta, x0, full + s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kDkvConsumerRegs>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float c = p.scale * kLog2e;
  int it = 0;
  for (int n = 0, item; (item = nth_item(n)) < items; ++n) {
    const int bh = item % p.BH, b = bh / p.H, h = bh % p.H;
    const int k0 = (item / p.BH) * kRows;
    const int rb = n & 1;
    const unsigned char* sk_ = sk + 2 * rb * KT;
    const unsigned char* sv_ = sk_ + KT;
    const int gk0 = k0 + wg * 64, wk0 = k0 + warp * 16;
    const int key0 = wk0 + (lane >> 2);  // this thread's keys: key0, key0 + 8
    float dk[DP / 8][4], dv[DP / 8][4];
    zero<DP / 8>(dk);
    zero<DP / 8>(dv);
    mbar_wait(rfull + rb, (n / 2) & 1);

    // Tiles of the group: from its first with a kept entry (causal: the
    // first whose last query reaches the group's first key), none when its
    // keys are all past Tk.
    int i1 = first_tile(k0);
    if (p.causal) i1 = max(i1, gk0 / KM);
    if (gk0 >= p.Tk) i1 = qtiles;
    for (int i = first_tile(k0); i < i1; ++i, ++it) {  // no kept entry: release
      mbar_wait(full + it % S, (it / S) & 1);
      if (lane == 0) mbar_arrive(empty + it % S);
    }
    // Per tile: the transposed scores k.q^T and v.dO^T, then from them
    // bf16(p)^T and bf16(ds)^T for dv and dk.
    float sc[NT][4], dp[NT][4];  // transposed: rows = keys, columns = queries
    auto tile_at = [&](int t) { return ring + (t % S) * STAGE; };
    auto scores = [&](int t) {
      abt<DP, KM, D>(sc, sk_, kRows, wg * 64, tile_at(t));
      abt<DP, KM, D>(dp, sv_, kRows, wg * 64, tile_at(t) + QT);
    };
    // p^T and ds^T of tile t (query tile i) in place of its scores
    auto elementwise = [&](int t, int i) {
      const int q0 = i * KM;
      const float* slse = reinterpret_cast<const float*>(tile_at(t) + 2 * QT) +
                          ((bh * p.Tq + q0) & 3);
      const float* sdelta = slse + LBYTES / 4;
      float lq[NT][2], dl[NT][2];  // this thread's queries' lse * log2(e) and delta
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = ni * 8 + (lane & 3) * 2 + j;
          lq[ni][j] = slse[qc] * kLog2e;
          dl[ni][j] = sdelta[qc];
        }
      // keys past Tk need no mask: their rows of dk and dv are not stored
      if (q0 + KM > p.Tq || (p.causal && q0 < wk0 + 16)) apply_mask_t<NT>(sc, p, key0, q0);
      if (FLASH_ABLATE & 4) return;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = ex2(fmaf(sc[ni][e], c, -lq[ni][e & 1]));  // 0 where masked
          sc[ni][e] = pe;
          dp[ni][e] = pe * (dp[ni][e] - dl[ni][e & 1]) * p.scale;  // ds^T
        }
    };
#if FLASH_STAGED_DS
    for (int i = i1; i < qtiles; ++i, ++it) {
      mbar_wait(full + it % S, (it / S) & 1);
      wg_begin();
      scores(it);
      wg_end();
      fence_acc<NT>(sc);
      fence_acc<NT>(dp);
      elementwise(it, i);
      unsigned char* sp = sx + wg * XB;
      stage_scores<NT>(sp, sc, wg);
      stage_scores<NT>(sp + tile_bytes<KM, 64>(), dp, wg);
      wg_begin();
      xb_staged<DP, NT>(dv, sp, tile_at(it) + QT, KM);
      xb_staged<DP, NT>(dk, sp + tile_bytes<KM, 64>(), tile_at(it), KM);
      wg_end();
      fence_acc<DP / 8>(dv);
      fence_acc<DP / 8>(dk);
      if (lane == 0) mbar_arrive(empty + it % S);
    }
#else
    // Software pipelined as the forward: tile t+1's score products are
    // issued with tile t's gradient products, and its element work runs
    // while those do.
    if (i1 < qtiles) {
      uint32_t ap[NT / 2][4], ad[NT / 2][4];  // bf16(p)^T and bf16(ds)^T of the tile in hand
      mbar_wait(full + it % S, (it / S) & 1);
      wg_begin();
      scores(it);
      wg_end();
      fence_acc<NT>(sc);
      fence_acc<NT>(dp);
      elementwise(it, i1);
      a_frags<NT>(ap, sc);
      a_frags<NT>(ad, dp);
      for (int i = i1; i + 1 < qtiles; ++i, ++it) {
        mbar_wait(full + (it + 1) % S, ((it + 1) / S) & 1);
        wg_begin();
        scores(it + 1);
        wg_commit();
        xb<DP, NT>(dv, ap, tile_at(it) + QT, KM);
        xb<DP, NT>(dk, ad, tile_at(it), KM);
        wg_commit();
        wg_wait<1>();  // the scores; the gradient products may still run
        fence_acc<NT>(sc);
        fence_acc<NT>(dp);
        elementwise(it + 1, i + 1);
        wg_wait<0>();
        fence_acc<DP / 8>(dv);
        fence_acc<DP / 8>(dk);
        if (lane == 0) mbar_arrive(empty + it % S);
        a_frags<NT>(ap, sc);
        a_frags<NT>(ad, dp);
      }
      wg_begin();
      xb<DP, NT>(dv, ap, tile_at(it) + QT, KM);
      xb<DP, NT>(dk, ad, tile_at(it), KM);
      wg_end();
      fence_acc<DP / 8>(dv);
      fence_acc<DP / 8>(dk);
      if (lane == 0) mbar_arrive(empty + it % S);
      ++it;
    }
#endif
    if (lane == 0) mbar_arrive(rempty + rb);
    if (gk0 < p.Tk) {
      store_tile<D>(sx + wg * XB, &maps.o0, dk, 1.f, 1.f, h, gk0, b, wg);
      store_tile<D>(sx + wg * XB, &maps.o1, dv, 1.f, 1.f, h, gk0, b, wg);
    }
  }
  stores_done();
}

// ---------------------------------------------------------------- launches

constexpr int kAlignSlack = 1024;  // for aligned_smem
constexpr int kBarBytes = 256;     // the mbarriers after the tiles

template <int D>
constexpr int fwd_smem() {
  return kAlignSlack + 2 * tile_bytes<padded<D>(), kRows>() +
         2 * fwd_stages<D>() * tile_bytes<padded<D>(), fwd_kn<D>()>() + kConsumers * fwd_xb<D>() +
         kBarBytes;
}
template <int D>
constexpr int dq_smem() {
  return kAlignSlack + 2 * dq_buffers<D>() * tile_bytes<padded<D>(), kRows>() +
         2 * dq_stages<D>() * tile_bytes<padded<D>(), dq_kn<D>()>() + kConsumers * dq_xb<D>() +
         kBarBytes;
}
template <int D>
constexpr int dkv_smem() {
  return kAlignSlack + 4 * tile_bytes<padded<D>(), kRows>() + dkv_stages<D>() * dkv_stage<D>() +
         kConsumers * dkv_xb<D>() + kBarBytes;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                 : nullptr;
  }();
  return fn;
}

struct View {  // element strides of a [B, T, H, D] view
  long long b, t, h;
};
View view(const long long* s) { return View{s[0], s[1], s[2]}; }

// The 4-D map (D, H, T, B) of a bf16 view, boxes of `rows` rows and
// min(DP, 64) columns. Returns 0 or a CUDA error code.
int make_map(CUtensorMap* map, const void* base, View v, int B, int T, int H, int D, int rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const int dp = D == 96 ? 128 : D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)v.h * 2, (cuuint64_t)v.t * 2, (cuuint64_t)v.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(dp < 64 ? dp : 64), 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             dp == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The 1-D map of n f32 values, boxes of `box` values.
int make_map_1d(CUtensorMap* map, const float* base, long long n, int box) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t unused[1] = {((cuuint64_t)n * 4 + 15) / 16 * 16};  // rank 1 has no stride
  const cuuint32_t boxes[1] = {(cuuint32_t)box}, elem[1] = {1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
                             dims, unused, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Blocks to launch for `items` work items: one an SM (persistent), or
// one an item in the ablation's FLASH_ONE_BLOCK_PER_TILE build.
int grid_for(int items) {
#if FLASH_ONE_BLOCK_PER_TILE
  return items;
#else
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 1;
  return items < sms ? items : sms;
#endif
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int items, const Maps& maps, const Params& p,
           cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid_for(items), kThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// The tensors of one call: base pointers and views of q, k, v, dO and the
// outputs o0, o1.
struct Operands {
  const void *q, *k, *v, *d;
  void *o0, *o1;
  View vq, vk, vv, vd, vo0, vo1;
};

template <int D>
int run(int op, const Operands& x, const Params& p, int B, cudaStream_t s) {
  Maps maps = {};
  // Box rows: the block's 128 rows, or the ring's tile.
  const int q_rows = op == 2 ? dkv_km<D>() : kRows;
  const int kv_rows = op == 0 ? fwd_kn<D>() : op == 1 ? dq_kn<D>() : kRows;
  int rc = make_map(&maps.q, x.q, x.vq, B, p.Tq, p.H, D, q_rows);
  if (!rc) rc = make_map(&maps.k, x.k, x.vk, B, p.Tk, p.H, D, kv_rows);
  if (!rc) rc = make_map(&maps.v, x.v, x.vv, B, p.Tk, p.H, D, kv_rows);
  if (!rc && op > 0) rc = make_map(&maps.d, x.d, x.vd, B, p.Tq, p.H, D, q_rows);
  if (!rc && op == 2) rc = make_map_1d(&maps.lse, p.lse, (long long)p.BH * p.Tq, dkv_km<D>() + 4);
  if (!rc && op == 2)
    rc = make_map_1d(&maps.delta, p.delta, (long long)p.BH * p.Tq, dkv_km<D>() + 4);
  const int t_out = op == 2 ? p.Tk : p.Tq;  // rows of o, dq; of dk and dv
  if (!rc) rc = make_map(&maps.o0, x.o0, x.vo0, B, t_out, p.H, D, 64);
  if (!rc && op == 2) rc = make_map(&maps.o1, x.o1, x.vo1, B, t_out, p.H, D, 64);
  if (rc) return rc;
  const int nq = (p.Tq + kRows - 1) / kRows, nk = (p.Tk + kRows - 1) / kRows;
  if (op == 0) return launch(flash_fwd_kernel<D>, fwd_smem<D>(), nq * p.BH, maps, p, s);
  if (op == 1) return launch(flash_bwd_dq_kernel<D>, dq_smem<D>(), nq * p.BH, maps, p, s);
  return launch(flash_bwd_dkv_kernel<D>, dkv_smem<D>(), nk * p.BH, maps, p, s);
}

int dispatch(int op, const Operands& x, Params p, int B, int D, cudaStream_t s) {
  if (B < 1 || p.H < 1 || p.Tq < 1 || p.Tk < 1 || (p.causal && p.Tq != p.Tk) ||
      (long long)B * p.H * ((p.Tq > p.Tk ? p.Tq : p.Tk) + kRows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.BH = B * p.H;
  switch (D) {
    case 32: return run<32>(op, x, p, B, s);
    case 64: return run<64>(op, x, p, B, s);
    case 96: return run<96>(op, x, p, B, s);
    case 128: return run<128>(op, x, p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes). Tensors are bf16 [B, T, H, D] views
// with the last dim contiguous, 16-byte aligned starts and strides that
// are multiples of 8 elements; `strides` holds (batch, seq, head) element
// strides, three per view, in the order of the views each function names.
// lse and delta are contiguous f32 [B*H, Tq] with 16-byte aligned starts
// (dk/dv reads them by TMA). D is 32, 64, 96 or 128;
// causal needs Tq == Tk. Each builds its tensor maps, launches, and returns
// cudaGetLastError() after the launch (0 = ok; a map the driver refuses
// returns cudaErrorInvalidValue, no encoder cudaErrorNotSupported).

// views: q, k, v, o. drop_last = 1 skips each row's last key tile (a
// deliberately wrong variant for a negative control; 0 otherwise).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const long long* strides, int B, int H, int Tq, int Tk, int D,
                         int causal, float scale, int drop_last, void* stream) {
  const Operands x = {q,  k,  v, nullptr, o, nullptr, view(strides), view(strides + 3),
                      view(strides + 6), {}, view(strides + 9), {}};
  Params p = {};
  p.lse_out = lse;
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.causal = causal, p.scale = scale, p.drop_last = drop_last ? 1 : 0;
  return dispatch(0, x, p, B, D, static_cast<cudaStream_t>(stream));
}

// views: q, k, v, do, dq.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            const long long* strides, int B, int H, int Tq, int Tk, int D,
                            int causal, float scale, void* stream) {
  const Operands x = {q, k, v, dout, dq, nullptr, view(strides), view(strides + 3),
                      view(strides + 6), view(strides + 9), view(strides + 12), {}};
  Params p = {};
  p.lse = lse, p.delta = delta;
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.causal = causal, p.scale = scale;
  return dispatch(1, x, p, B, D, static_cast<cudaStream_t>(stream));
}

// views: q, k, v, do, dk, dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Tq, int Tk, int D,
                             int causal, float scale, void* stream) {
  const Operands x = {q, k, v, dout, dk, dv, view(strides), view(strides + 3), view(strides + 6),
                      view(strides + 9), view(strides + 12), view(strides + 15)};
  Params p = {};
  p.lse = lse, p.delta = delta;
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.causal = causal, p.scale = scale;
  return dispatch(2, x, p, B, D, static_cast<cudaStream_t>(stream));
}
