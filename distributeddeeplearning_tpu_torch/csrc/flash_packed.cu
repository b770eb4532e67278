// Packed-QKV attention for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the Pallas TPU kernels of
// distributeddeeplearning_tpu/ops/pallas/flash_packed.py: `_fwd_kernel`
// (run by `_packed_fwd`) and `_bwd_kernel` (run by `_packed_bwd_rule`, the
// custom VJP of `fused_qkv_attention`). Same contract, per (batch b, head h):
//   qkv  [B, T, 3*H*D] bf16, the QKV projection's own output: q, k and v of
//        head h at columns h*D, H*D + h*D and 2*H*D + h*D (no reshape, no
//        copy); out and dO [B, T, H*D], head h at columns h*D
//   s    = f32(q . k^T) * scale; mask: key >= T, query >= T, and key >
//          query when causal
//   forward: m = the row's max score over its kept keys, p = exp(s - m)
//            (0 where masked), l = sum(p) in f32 (1 where 0),
//            o = bf16(sum(bf16(p) . v) / l)
//   backward (no saved statistics): m and l again, pn = p / l (f32),
//            delta = rowsum(f32(dO) * f32(o)), dp = dO . v^T,
//            ds = bf16(pn * (dp - delta) * scale); dq = ds . k,
//            dk = ds^T . q, dv = bf16(pn)^T . dO with f32 sums, each rounded
//            once, written into dqkv [B, T, 3*H*D] in qkv's layout (no
//            concat, no transpose)
// Rows past T are loaded as zeros (a NaN bit pattern in padding would
// poison every contraction: the TPU kernel's `_zero_tail`) and never
// stored; a fully masked row divides by 1.
//
// Design. The TPU kernel keeps a whole [T, T] score matrix per head in
// VMEM, with about six f32 [T, T] intermediates in the backward (6.3 MB at
// T = 512). An H100 block has at most 227 KB of shared memory, so every
// kernel here streams 64-row tiles through shared memory and keeps scores
// in registers; what bounds the work at these short rows is latency
// (loads, products, barriers), so the design fills the SMs with few
// round trips per tile.
// * Products: Hopper's wgmma, issued by a warpgroup (4 warps, 64 rows).
//   Products with both operands in shared memory (q.k^T, dO.v^T and their
//   transposes) read K-major tiles; products whose A operand is a score
//   tile in registers (bf16(p).v, ds.k, pn^T.dO, ds^T.q) take it in the
//   m16n8k16 fragment layout the accumulator already has, and B as an
//   MN-major view of the same tile. Tiles are unpadded and swizzled
//   (64- or 128-byte) as wgmma's layouts want; cp.async fills them, and
//   a proxy fence and a barrier hand them to wgmma. Products issued
//   together share one commit and wait.
// * Blocks: two warpgroups, 128 rows, 256 threads, at most 128 registers
//   a thread (two blocks an SM; one in the backward at D = 128).
// * Forward (packed_fwd_kernel), a block per (b, h, 128 query rows): Q and
//   every K tile the rows need stay in shared memory, each K tile its own
//   cp.async group; pass 1 takes each row's exact max as the tiles land,
//   pass 2 recomputes the scores from shared memory and streams V through
//   a 2-stage ring. One Q.K^T more than an online softmax, for the TPU
//   kernel's rounding points.
// * Backward, two kernels on one stream, no atomics (gradients repeat bit
//   for bit):
//   - packed_bwd_dq_kernel, a block per (b, h, 128 query rows): delta
//     from 16-byte loads of dO and o; Q, dO and the K tiles resident, V
//     through the ring; pass 1 takes m and l (online, f32), pass 2 forms
//     ds from q.k^T and dO.v^T (one batch) and adds ds.k. It writes each
//     row's m, 1/l and delta to an f32 scratch [3][B*H][Tpad] (Tpad = T
//     rounded up to 128; rows past T get m = -1e30, 1/l = 1, delta = 0).
//   - packed_bwd_dkv_kernel, a block per (b, h, 128 keys): K and V
//     resident while the head's (q, dO, statistics) tiles of 32 queries
//     stream through the ring; per tile, k.q^T and v.dO^T (one batch),
//     then pn^T.dO and ds^T.q (one batch). It recomputes no statistic.
// * Scale: scores stay unscaled in registers; p = 2^(s*c - m*c) with c =
//   scale*log2(e) and m the row max of the unscaled scores (scale > 0, so
//   scale*m is the row's max score, rounded once), one FMA and one SFU
//   op an element.
// * Masks: only tiles that hold a masked entry (the last key tile, rows
//   past T, the causal diagonal) test each element; a warpgroup skips a
//   tile where all its entries are masked. Causal: query blocks stop at
//   the diagonal key tile and key blocks start at it; the forward and dq
//   take their query blocks in reverse order, so the longest start first.
//
// What bounds it on an H100 (ViT-B/16 training: B = 64, T = 197, H = 12,
// D = 64): the forward moves qkv in (58.1 MB) and o out (19.4 MB), 23.1 us
// at 3.35 TB/s, against 7.6 GFLOP (7.7 us at 989 TFLOP/s); the backward
// moves qkv, o and dO in (96.9 MB) and dqkv out (58.1 MB), 46.3 us,
// against 19.1 GFLOP (19.3 us). Both are byte-bound at this T; T pads to
// whole 64-row tiles, the forward takes Q.K^T twice and the backward
// three times. PERF.md holds the measured times, and
// scripts/packed_attention_ablation.py what each part of the kernels
// costs.

#include "wgmma.cuh"

// PACKED_ABLATE (a compile-time bit mask, 0 in every build the package
// makes) skips parts of the kernels so that a timing-only build shows
// what each part costs (scripts/packed_attention_ablation.py): 1 the
// score products (q.k^T, dO.v^T and their transposes), 2 the products
// whose A operand is in registers (bf16(p).v, ds.k, pn^T.dO, ds^T.q),
// 4 the softmax and the backward's elementwise work.
#ifndef PACKED_ABLATE
#define PACKED_ABLATE 0
#endif

namespace {

using namespace mma;

constexpr int kWarps = 8;  // every block: two warpgroups of 4 warps
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: queries, or keys for dk/dv
constexpr int kCols = 64;           // key tile of the forward and dq
constexpr int kDkvRows = 32;        // query tile of dk/dv (bounds registers)
constexpr int kStages = 2;          // ring depth: V tiles, or dk/dv's query tiles
constexpr int kMaxT = 512;          // the TPU kernel's MAX_T
constexpr int kStatsPad = 128;      // statistics rows per head: T rounded up to 128
// Blocks per SM for __launch_bounds__: 2 caps a thread at 128 registers.
// The backward at D = 128 needs more (dk and dv alone take 128) and runs
// one block per SM.
template <int D>
__host__ __device__ constexpr int bwd_min_blocks() { return D >= 128 ? 1 : 2; }

// The shared wgmma products (wgmma.cuh) behind this file's ablation mask.
template <int D, int N>
__device__ __forceinline__ void wg_abt(float (*acc)[4], const unsigned char* a, int a_rows,
                                       int a_row0, const unsigned char* b) {
  if (PACKED_ABLATE & 1) return;
  wg_abt_ss<D, N>(acc, a, a_rows, a_row0, b);
}
template <int D, int KT>
__device__ __forceinline__ void wg_xb(float (*acc)[4], const uint32_t (*af)[4],
                                      const unsigned char* b, int rows) {
  if (PACKED_ABLATE & 2) return;
  wg_xb_rs<D, KT>(acc, af, b, rows);
}

// ------------------------------------------------------------ shared math

struct Params {
  const bf16* qkv;   // [B, T, 3*H*D]
  const bf16* out;   // backward: [B, T, H*D]
  const bf16* dout;  // backward: [B, T, H*D]
  bf16* o;           // forward output
  bf16* dqkv;        // backward output: [B, T, 3*H*D]
  float* stats;      // backward scratch: [3][B*H][Tpad] (m, 1/l, delta)
  int H, T, Tpad, causal, drop_last;
  float scale;
};

// Key tiles the block's rows q0 .. q0+kRows-1 need: all, or up to the
// diagonal when causal.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int tiles = (p.T + kCols - 1) / kCols;
  if (p.causal) tiles = min(tiles, (q0 + kRows - 1) / kCols + 1);
  return tiles;
}

__device__ __forceinline__ bool kept(const Params& p, int row, int col) {
  return col < p.T && row < p.T && (!p.causal || col <= row);
}

// The [T, D] views of head h of batch b (row stride ld).
template <int D>
struct Head {
  const bf16 *q, *k, *v;
  long long ld;
  __device__ Head(const Params& p, int b, int h) {
    ld = 3LL * p.H * D;
    q = p.qkv + (long long)b * p.T * ld + h * D;
    k = q + p.H * D;
    v = k + p.H * D;
  }
};

// Whether the 16 rows from wr0 meet a masked entry of the columns c0 ..
// c0+n-1 (rows = queries, columns = keys): rows or keys past T, or keys
// past a row when causal. Tiles inside the rows' kept region skip the mask.
__device__ __forceinline__ bool needs_mask(const Params& p, int wr0, int c0, int n) {
  return c0 + n > p.T || wr0 + 16 > p.T || (p.causal && c0 + n - 1 > wr0);
}
// Whether every entry of `rows` rows from r0 is masked: rows past T, or
// (causal) keys past every row.
__device__ __forceinline__ bool all_masked(const Params& p, int r0, int c0, int rows = 16) {
  return r0 >= p.T || (p.causal && c0 > r0 + rows - 1);
}

// Masked entries of the warp's scores s[NT][4] (unscaled, key tile at k0)
// to kNegInf. Rows of this thread: row0 and row0 + 8. The scale enters
// where p is formed: exp(scale*s - m) = 2^(s*c - m_raw*c) with c =
// scale*log2(e) and m_raw the row max of the unscaled scores (scale > 0, so
// the row's max score is scale*m_raw, rounded once).
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

template <int NT>
__device__ __forceinline__ void row_max(float* m, const float (*s)[4]) {
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[ni][e]);
}

// s <- p = 2^(s*c - m*c) for the unscaled scores s and row maxes m, c =
// scale*log2(e) (0 where masked: a masked tile may hold a row with no kept
// key, whose m is kNegInf too); l += sum(p) over this thread's entries.
template <int NT>
__device__ __forceinline__ void softmax_numerators(float (*s)[4], const float* m, float c,
                                                   bool mask, float* l = nullptr) {
  const float mc[2] = {m[0] * c, m[1] * c};
  if (PACKED_ABLATE & 4) {
    if (l) l[0] += s[0][0];  // keeps the scores live
    return;
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(s[ni][e], c, -mc[e >> 1]));
      s[ni][e] = mask && s[ni][e] == kNegInf ? 0.f : x;
      if (l) l[e >> 1] += s[ni][e];
    }
}

// The warp's rows of o = acc / l (l == 0 taken as 1).
template <int D>
__device__ __forceinline__ void store_out(const Params& p, int b, int h, int row0,
                                          const float (*acc)[4], float* l) {
  quad_sum(l);
  const long long ldo = (long long)p.H * D;
  store_rows<D>(p.o + (long long)b * p.T * ldo + h * D, ldo, row0, p.T, acc,
                1.f / (l[0] == 0.f ? 1.f : l[0]), 1.f / (l[1] == 0.f ? 1.f : l[1]));
}

// Wait until at most n committed cp.async groups are in flight (fewer
// when n > 7: stricter, never looser).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// ---------------------------------------------------------------- forward

// o of 128 query rows (two warpgroups of 64) in two passes over the key
// tiles: Q and every K tile the rows need stay in shared memory, loaded
// once, each K tile its own cp.async group; pass 1 takes the row max as
// they land, pass 2 recomputes the scores from shared memory and streams V
// through the ring (its first stages in flight since the start).
template <int D>
__global__ void __launch_bounds__(kThreads, 2) packed_fwd_kernel(Params p) {
  constexpr int NT = kCols / 8, S = kStages;
  constexpr int TILE = tile_bytes<D, kCols>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = aligned_smem(smem_raw);
  unsigned char* sv = sq + tile_bytes<D, kRows>();  // the V ring, S tiles
  unsigned char* sk = sv + S * TILE;                // K tiles 0 .. tiles-1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const Head<D> hd(p, b, h);
  const int wr0 = q0 + warp * 16, gr0 = q0 + wg * 64;  // first row of the warp, of its group
  const int row0 = wr0 + (lane >> 2);
  const int tiles = key_tiles(p, q0) - p.drop_last;

  auto issue_v = [&](int i) {
    if (i < tiles) load_tile_sw<kCols, D, kThreads>(sv + (i % S) * TILE, hd.v, hd.ld, i * kCols, p.T);
    cp_async_commit();
  };
  load_tile_sw<kRows, D, kThreads>(sq, hd.q, hd.ld, q0, p.T);
  for (int j = 0; j < tiles; ++j) {
    load_tile_sw<kCols, D, kThreads>(sk + j * TILE, hd.k, hd.ld, j * kCols, p.T);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < S; ++i) issue_v(i);

  const float c = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m of the unscaled scores
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_dyn(tiles - 1 - j + S);
    tiles_landed();
    if (!all_masked(p, gr0, j * kCols, 64)) {
      float s[NT][4];
      wg_begin();
      wg_abt<D, kCols>(s, sq, kRows, wg * 64, sk + j * TILE);
      wg_end();
      fence_acc<NT>(s);
      if (needs_mask(p, wr0, j * kCols, kCols)) apply_mask<NT>(s, p, row0, j * kCols);
      row_max<NT>(m, s);
    }
  }
  quad_max(m);

  float acc[D / 8][4];
  zero<D / 8>(acc);
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<S - 1>();
    tiles_landed();
    if (!all_masked(p, gr0, i * kCols, 64)) {
      float s[NT][4];
      wg_begin();
      wg_abt<D, kCols>(s, sq, kRows, wg * 64, sk + i * TILE);
      wg_end();
      fence_acc<NT>(s);
      const bool mask = needs_mask(p, wr0, i * kCols, kCols);
      if (mask) apply_mask<NT>(s, p, row0, i * kCols);
      softmax_numerators<NT>(s, m, c, mask, l);
      uint32_t af[NT / 2][4];
      a_frags<NT>(af, s);
      wg_begin();
      wg_xb<D, NT>(acc, af, sv + (i % S) * TILE, kCols);
      wg_end();
      fence_acc<D / 8>(acc);
    }
    __syncthreads();
    issue_v(i + S);
  }
  cp_async_wait_all();  // nothing in flight at exit
  if (wr0 < p.T) store_out<D>(p, b, h, row0, acc, l);
}

// ---------------------------------------------------------------- backward

// delta[r] = rowsum(f32(dO) * f32(o)) for the block's rows from r0 (0
// past T): 16-byte loads, the D/8 chunks of a row summed across
// neighbouring lanes in a fixed order.
template <int D>
__device__ void row_deltas(float* delta, const bf16* dob, const bf16* ob, long long ld, int r0,
                           int T) {
  constexpr int C = D / 8;  // chunks a row: 4, 8 or 16 lanes, within one warp
  static_assert((kRows * C) % kThreads == 0, "every lane takes part in each shuffle");
  for (int c = threadIdx.x; c < kRows * C; c += kThreads) {
    const int r = c / C, col = (c % C) * 8;
    float acc = 0.f;
    if (r0 + r < T) {
      const uint4 a = *reinterpret_cast<const uint4*>(dob + (long long)(r0 + r) * ld + col);
      const uint4 o = *reinterpret_cast<const uint4*>(ob + (long long)(r0 + r) * ld + col);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(o2[i]);
        acc += x.x * y.x + x.y * y.y;
      }
    }
#pragma unroll
    for (int off = C / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (c % C == 0) delta[r] = acc;
  }
}

// dq of 128 query rows (two warpgroups of 64), and the rows' m, 1/l and
// delta into p.stats. Q, dO and every K tile the rows need stay in shared
// memory, loaded once (each K tile its own cp.async group); V streams
// through a 2-stage ring. Pass 1 takes m and l (online, f32) as the K
// tiles land; pass 2 forms ds from Q.K^T and dO.V^T (one wgmma batch) and
// adds ds . K.
template <int D>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<D>()) packed_bwd_dq_kernel(Params p) {
  constexpr int NT = kCols / 8, S = kStages, TILE = tile_bytes<D, kCols>();
  constexpr int QT = tile_bytes<D, kRows>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = aligned_smem(smem_raw);
  unsigned char* sdo = sq + QT;
  unsigned char* sv = sdo + QT;      // the V ring, S tiles
  unsigned char* sk = sv + S * TILE;  // K tiles 0 .. tiles-1
  float* sdelta = reinterpret_cast<float*>(sk + ((p.T + kCols - 1) / kCols) * TILE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const Head<D> hd(p, b, h);
  const long long ldo = (long long)p.H * D;
  const bf16* dob = p.dout + (long long)b * p.T * ldo + h * D;
  const bf16* ob = p.out + (long long)b * p.T * ldo + h * D;
  const int wr0 = q0 + warp * 16, gr0 = q0 + wg * 64;
  const int row0 = wr0 + (lane >> 2);
  const int tiles = key_tiles(p, q0);

  auto issue_v = [&](int i) {
    if (i < tiles)
      load_tile_sw<kCols, D, kThreads>(sv + (i % S) * TILE, hd.v, hd.ld, i * kCols, p.T);
    cp_async_commit();
  };
  load_tile_sw<kRows, D, kThreads>(sq, hd.q, hd.ld, q0, p.T);
  load_tile_sw<kRows, D, kThreads>(sdo, dob, ldo, q0, p.T);
  for (int j = 0; j < tiles; ++j) {
    load_tile_sw<kCols, D, kThreads>(sk + j * TILE, hd.k, hd.ld, j * kCols, p.T);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < S; ++i) issue_v(i);
  row_deltas<D>(sdelta, dob, ob, ldo, q0, p.T);  // seen after a sync

  const float c = p.scale * kLog2e;
  // m: the row max of the unscaled scores; l of exp(scale*s - scale*m)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_dyn(tiles - 1 - j + S);
    tiles_landed();
    if (!all_masked(p, gr0, j * kCols, 64)) {
      const bool mask = needs_mask(p, wr0, j * kCols, kCols);
      float s[NT][4];
      wg_begin();
      wg_abt<D, kCols>(s, sq, kRows, wg * 64, sk + j * TILE);
      wg_end();
      fence_acc<NT>(s);
      if (mask) apply_mask<NT>(s, p, row0, j * kCols);
      float mx[2] = {m[0], m[1]};
      row_max<NT>(mx, s);
      quad_max(mx);
      float sum[2] = {0.f, 0.f};
      softmax_numerators<NT>(s, mx, c, mask, sum);
      quad_sum(sum);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * ex2((m[r] - mx[r]) * c) + sum[r];
        m[r] = mx[r];
      }
    }
  }
  float inv[2], delta[2];
  const long long bht = (long long)gridDim.y * p.Tpad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    delta[r] = sdelta[row - q0];
    if ((lane & 3) == 0) {
      float* at = p.stats + (long long)bh * p.Tpad + row;
      at[0] = m[r] == kNegInf ? kNegInf : m[r] * p.scale;
      at[bht] = inv[r];
      at[2 * bht] = delta[r];
    }
  }

  float dq[D / 8][4];
  zero<D / 8>(dq);
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<S - 1>();
    tiles_landed();
    const int k0 = i * kCols;
    if (!all_masked(p, gr0, k0, 64)) {
      float s[NT][4], dp[NT][4];
      wg_begin();
      wg_abt<D, kCols>(s, sq, kRows, wg * 64, sk + i * TILE);
      wg_abt<D, kCols>(dp, sdo, kRows, wg * 64, sv + (i % S) * TILE);
      wg_end();
      fence_acc<NT>(s);
      fence_acc<NT>(dp);
      const bool mask = needs_mask(p, wr0, k0, kCols);
      if (mask) apply_mask<NT>(s, p, row0, k0);
      softmax_numerators<NT>(s, m, c, mask);  // p; pn = p / l below
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[ni][e] = s[ni][e] * inv[r] * (dp[ni][e] - delta[r]) * p.scale;  // ds
        }
      uint32_t af[NT / 2][4];
      a_frags<NT>(af, s);
      wg_begin();
      wg_xb<D, NT>(dq, af, sk + i * TILE, kCols);
      wg_end();
      fence_acc<D / 8>(dq);
    }
    __syncthreads();
    issue_v(i + S);
  }
  cp_async_wait_all();  // nothing in flight at exit
  store_rows<D>(p.dqkv + (hd.q - p.qkv), hd.ld, row0, p.T, dq, 1.f, 1.f);
}

// dk and dv of 128 keys (two warpgroups of 64): K and V stay in shared
// memory while the head's query tiles (q, dO and their rows' m, 1/l,
// delta) stream through the ring. Each step is two wgmma batches: k.q^T
// and v.dO^T, then pn^T . dO and ds^T . q.
template <int D>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<D>()) packed_bwd_dkv_kernel(Params p) {
  constexpr int S = kStages, BQ = kDkvRows;
  constexpr int NT = BQ / 8;
  constexpr int QT = tile_bytes<D, BQ>();
  constexpr int STAGE = (2 * QT + 3 * BQ * 4 + 1023) / 1024 * 1024;  // q, dO, statistics
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = aligned_smem(smem_raw);
  unsigned char* sv = sk + tile_bytes<D, kRows>();
  unsigned char* ring = sv + tile_bytes<D, kRows>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const Head<D> hd(p, b, h);
  const long long ldo = (long long)p.H * D;
  const bf16* dob = p.dout + (long long)b * p.T * ldo + h * D;
  const long long bht = (long long)gridDim.y * p.Tpad;
  const float* stats = p.stats + (long long)bh * p.Tpad;
  const int i0 = p.causal ? k0 / BQ : 0;
  const int steps = (p.T + BQ - 1) / BQ - i0;

  auto issue = [&](int j) {
    if (j < steps) {
      unsigned char* st = ring + (j % S) * STAGE;
      const int q0 = (i0 + j) * BQ;
      load_tile_sw<BQ, D, kThreads>(st, hd.q, hd.ld, q0, p.T);
      load_tile_sw<BQ, D, kThreads>(st + QT, dob, ldo, q0, p.T);
      float* ts = reinterpret_cast<float*>(st + 2 * QT);
      if (threadIdx.x < 3 * BQ / 4) {  // rows q0 .. q0+BQ-1 < Tpad of each statistic
        const int which = threadIdx.x / (BQ / 4), c = threadIdx.x % (BQ / 4);
        cp_async16(ts + which * BQ + 4 * c, stats + which * bht + q0 + 4 * c, true);
      }
    }
    cp_async_commit();
  };
  load_tile_sw<kRows, D, kThreads>(sk, hd.k, hd.ld, k0, p.T);
  load_tile_sw<kRows, D, kThreads>(sv, hd.v, hd.ld, k0, p.T);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) issue(j);

  const int gk0 = k0 + wg * 64, wk0 = k0 + warp * 16;
  const int key0 = wk0 + (lane >> 2);  // this thread's keys: key0, key0 + 8
  const float sl = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);
  for (int j = 0; j < steps; ++j) {
    issue(j + S - 1);
    cp_async_wait<S - 1>();
    tiles_landed();
    const int q0 = (i0 + j) * BQ;
    // Every entry masked: keys past T, or (causal) every query of the tile
    // before every key of the group.
    if (gk0 < p.T && !(p.causal && q0 + BQ - 1 < gk0)) {
      const unsigned char* sq = ring + (j % S) * STAGE;
      const unsigned char* sdo = sq + QT;
      const float* sm = reinterpret_cast<const float*>(sdo + QT);
      const float* sinv = sm + BQ;
      const float* sdelta = sinv + BQ;
      float s[NT][4], dp[NT][4];  // transposed: rows = keys, columns = queries
      wg_begin();
      wg_abt<D, BQ>(s, sk, kRows, wg * 64, sq);
      wg_abt<D, BQ>(dp, sv, kRows, wg * 64, sdo);
      wg_end();
      fence_acc<NT>(s);
      fence_acc<NT>(dp);
      // keys past T need no mask: their rows of dk and dv are not stored
      const bool mask = q0 + BQ > p.T || (p.causal && q0 < wk0 + 16);
      if (!(PACKED_ABLATE & 4))
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = ni * 8 + (lane & 3) * 2 + (e & 1);
          float pn = 0.f, ds = 0.f;
          if (!mask || kept(p, q0 + qc, key0 + (e >> 1) * 8)) {
            pn = ex2(fmaf(s[ni][e], sl, -sm[qc] * kLog2e)) * sinv[qc];
            ds = pn * (dp[ni][e] - sdelta[qc]) * p.scale;
          }
          s[ni][e] = pn;
          dp[ni][e] = ds;  // ds^T
        }
      uint32_t ap[NT / 2][4], ad[NT / 2][4];
      a_frags<NT>(ap, s);
      a_frags<NT>(ad, dp);
      wg_begin();
      wg_xb<D, NT>(dv, ap, sdo, BQ);
      wg_xb<D, NT>(dk, ad, sq, BQ);
      wg_end();
      fence_acc<D / 8>(dv);
      fence_acc<D / 8>(dk);
    }
    __syncthreads();
  }
  bf16* dkb = p.dqkv + (hd.k - p.qkv);
  store_rows<D>(dkb, hd.ld, key0, p.T, dk, 1.f, 1.f);
  store_rows<D>(dkb + p.H * D, hd.ld, key0, p.T, dv, 1.f, 1.f);
}

// ---------------------------------------------------------------- launches

constexpr int kAlignSlack = 1024;  // for aligned_smem
template <int D>
int fwd_smem(int tiles) {
  return kAlignSlack + tile_bytes<D, kRows>() + (kStages + tiles) * tile_bytes<D, kCols>();
}
template <int D>
int dq_smem(int tiles) {
  return kAlignSlack + 2 * tile_bytes<D, kRows>() + (kStages + tiles) * tile_bytes<D, kCols>() +
         kRows * 4;
}
template <int D>
constexpr int dkv_smem() {
  constexpr int BQ = kDkvRows;
  return kAlignSlack + 2 * tile_bytes<D, kRows>() +
         kStages * ((2 * tile_bytes<D, BQ>() + 3 * BQ * 4 + 1023) / 1024 * 1024);
}

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int run(bool backward, const Params& p, int B, cudaStream_t s) {
  const int tiles = (p.T + kCols - 1) / kCols;  // key tiles of the head
  const dim3 grid((p.T + kRows - 1) / kRows, B * p.H);
  if (!backward)
    return launch(packed_fwd_kernel<D>, fwd_smem<D>(tiles), grid, p, s);
  const int rc = launch(packed_bwd_dq_kernel<D>, dq_smem<D>(tiles), grid, p, s);
  if (rc != 0) return rc;
  return launch(packed_bwd_dkv_kernel<D>, dkv_smem<D>(), grid, p, s);
}

int dispatch(bool backward, Params p, int B, int D, cudaStream_t s) {
  if (B < 1 || p.H < 1 || p.T < 1 || p.T > kMaxT || B * p.H > 65535)
    return (int)cudaErrorInvalidValue;
  p.Tpad = (p.T + kStatsPad - 1) / kStatsPad * kStatsPad;
  switch (D) {
    case 32: return run<32>(backward, p, B, s);
    case 64: return run<64>(backward, p, B, s);
    case 128: return run<128>(backward, p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes). Tensors are contiguous with 16-byte
// aligned starts: qkv and dqkv [B, T, 3*H*D] bf16, out and dout
// [B, T, H*D] bf16, stats [3, B*H, Tpad] f32 with Tpad = T rounded up to a
// multiple of 128. D is 32, 64 or 128; 1 <= T <= 512. Each returns
// cudaGetLastError() after its launches (0 = ok).

// drop_last = 1 skips each query block's last key tile (a deliberately
// wrong variant for a negative control; 0 otherwise).
extern "C" int fused_qkv_fwd(const void* qkv, void* out, int B, int T, int H, int D, int causal,
                             float scale, int drop_last, void* stream) {
  Params p = {};
  p.qkv = static_cast<const bf16*>(qkv);
  p.o = static_cast<bf16*>(out);
  p.H = H, p.T = T, p.causal = causal, p.scale = scale, p.drop_last = drop_last ? 1 : 0;
  return dispatch(false, p, B, D, static_cast<cudaStream_t>(stream));
}

// Two launches on `stream`: the dq kernel (which writes stats), then the
// dk/dv kernel (which reads them).
extern "C" int fused_qkv_bwd(const void* qkv, const void* out, const void* dout, void* dqkv,
                             void* stats, int B, int T, int H, int D, int causal, float scale,
                             void* stream) {
  Params p = {};
  p.qkv = static_cast<const bf16*>(qkv);
  p.out = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.dqkv = static_cast<bf16*>(dqkv);
  p.stats = static_cast<float*>(stats);
  p.H = H, p.T = T, p.causal = causal, p.scale = scale;
  return dispatch(true, p, B, D, static_cast<cudaStream_t>(stream));
}
