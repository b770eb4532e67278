// Stride-1 SAME depthwise convolution for Hopper (sm_90a): the forward,
// its dgrad and its wgrad.
//
// Replaces the Pallas TPU kernels of
// distributeddeeplearning_tpu/ops/pallas/depthwise.py: `_conv_kernel` (run
// by `_run_conv`, forward and dgrad) and `_wgrad_kernel` (run by
// `_depthwise_bwd`). Same functions, on NHWC activations (a channels_last
// [N, C, H, W] tensor is NHWC in memory):
//   x, dy  [B, H, W, C]  bf16 or f32
//   taps   [K*K, C]      f32, tap t = di*K + dj
//   y[b,i,j,c]  = sum_t xpad[b, i+di, j+dj, c] * taps[t, c]       (forward)
//   dx          = the same stencil on dy with taps[K*K-1-t]         (dgrad)
//   dw[t, c]    = sum_{b,i,j} xpad[b, i+di, j+dj, c] * dy[b,i,j,c] (wgrad)
// with xpad zero outside the image (P = K/2 on each side) and every sum
// in f32; y and dx are rounded once to the input's dtype.
//
// What bounds it on an H100: bytes. EfficientNet-B4's stride-1 layers at
// batch 64 do 2*K*K flops per output element against 4 bytes (bf16 in and
// out): 190^2 x 48, K 3 moves 444 MB (133 us at 3.35 TB/s) for 2.0 GFLOP
// (30 us at 67 TFLOP/s of f32 FMA); at K 5 the flops come within 2x of
// the bytes (48^2 x 336: 59 us of bytes, 37 of flops), so the
// instructions a thread issues per output matter as much as the bytes.
//
// Design. The TPU kernels hold whole images in VMEM and build a padded
// window per 16-row strip; Mosaic could not keep the K*K accumulation in
// registers, which is why they lost to XLA's grouped conv (PROFILE.md,
// round 4). Here the forward and dgrad take one of three paths, by
// ops/depthwise.stencil_path (shape, dtype and alignment alone):
// * The TMA row ring (k in {3, 5, 7}, rows of C a multiple of 16 bytes,
//   x 16-byte aligned: all of B4's layers). x is a 4-D tensor map [B, H,
//   W, C]; TMA zero-fills every element outside it, negative coordinates
//   included, which is the SAME padding, so a box of (1 image, 1 row, the
//   tile's columns from w0 - P, a channel slice) brings a padded input
//   row with no halo logic in the threads. A block owns an item (image,
//   strip of rows, column tile, channel slice) and walks down its rows:
//   one producer thread keeps the next rows in flight into an mbarrier
//   ring and each input byte of the strip comes from device memory once
//   (a tile's halo columns are re-read from L2). The strip length is
//   chosen so the items fill the card's block slots (by the occupancy the
//   kernel's registers and shared memory allow) at the least cost in
//   waves x rows. Two kernels compute from the ring:
//   - vector (k = 3 on rows wider than 12): a thread computes 8 columns x
//     one 16-byte channel vector in f32, one tap row's taps of its
//     channels at a time from shared memory; 16-byte loads and stores.
//     The tile is the whole row (up to 256 columns a box; wider rows take
//     several boxes), the channel slice the widest whose ring fits two
//     blocks an SM.
//   - lane (k = 5 and 7, and narrow rows): lanes are consecutive channels
//     (conflict-free 2- or 4-byte shared loads, and each warp's stores
//     cover whole 32-byte sectors); a thread keeps its channel's k*k taps
//     and 12 (or 8) f32 sums in registers: fewer instructions per output
//     than a vector of channels, whose taps do not fit in registers at
//     k = 5. Column tiles of up to 256 threads' runs, channel slices of
//     at least four column groups.
//   scripts/depthwise_ablation.py times each kernel at B4's layers.
// * The staged-tile kernel (k in {3, 5, 7}, rows no tensor map can take:
//   C not a multiple of the 16-byte vector, or x misaligned): one block
//   owns a tile of 8 output rows x 12 output columns x 32 channels of one
//   image and stages the tile's inputs plus the P-wide halo into shared
//   memory as f32, zero-filled outside the image and past C (16-byte loads
//   where C allows, else one element); thread (channel, row) keeps its 12
//   outputs and its channel's taps in registers.
// * The direct kernel (any other odd k): one thread per output, taps read
//   from global memory: right, not fast.
// The dgrad is the forward reading the tap table reversed (the `flip`
// argument; the TPU code reverses the table, `wt[::-1]`).
//
// The wgrad (the TPU's `_wgrad_kernel`: partials per batch block, then one
// sum) reads x and dy once each, so it is bound by bytes like the forward
// (190^2 x 48, K 3: 444 MB, 133 us). It takes the path the forward takes,
// but for f32 rows of at most 24 columns, which take the staged tile
// (ops/depthwise.wgrad_path):
// * The TMA row ring (the shapes above), under depthwise_plan.h's
//   WgPlan: an item is (image, strip of rows, column tile, channel
//   slice) and a second tensor map brings dy's rows
//   (no halo) into the same ring slots as x's: ring row i holds padded x
//   row i and dy row i, whose last reader is output row i for both. A
//   thread owns `run` columns x V channels (V = 4, 2, 1 at k = 3, 5, 7:
//   k*k*V <= 50 f32 sums in registers across the whole strip) and loads
//   V channels at a time (8, 4 or 2 bytes of bf16); channel slices are
//   fitted to C, so C = 24 and 48 leave no lanes idle. At the strip's end
//   the block sums its runs in run order and writes one partial row per
//   (image, strip, column tile).
// * The staged-tile wgrad (ragged C, misaligned x or dy): each block of
//   the staged-tile shape walks every row tile of a column strip with its
//   K*K per-channel sums in f32 registers, sums its 8 rows of threads in
//   shared memory in a fixed order and writes one partial row per (image,
//   column strip).
// * Any other odd k: a direct wgrad (one block per tap and 32 channels).
// A second kernel sums the partial rows in a fixed order. No atomics: dw
// repeats bit for bit, like the TPU's partials-then-sum. The measured
// times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk.cuh"
#include "depthwise_plan.h"

// Build switches (scripts/depthwise_ablation.py): DW_TMA_KERNEL forces
// the TMA stencil's kernel (0: tma_kernel's choice, 1: vector, 2: lane);
// DW_RING_EXTRA the stencil ring's rows beyond k (0: the plan's choice);
// the wgrad's are in depthwise_plan.h.
#ifndef DW_TMA_KERNEL
#define DW_TMA_KERNEL 0
#endif
#ifndef DW_RING_EXTRA
#define DW_RING_EXTRA 0
#endif

namespace {

constexpr int kThreads = kCB * kTH;  // 256: the staged tile's block (depthwise_plan.h)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ long long offset(const Shape& s, int b, int h, int w, int c) {
  return ((static_cast<long long>(b) * s.H + h) * s.W + w) * s.C + c;
}

// Two bf16 in one 32-bit word (the lower address in the low half) -> f32.
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 16 loaded bytes of T -> 16 / sizeof(T) floats at dst (16-byte aligned).
__device__ __forceinline__ void unpack(const uint4& r, float* dst, bf16) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(lo_bf16(r.x), hi_bf16(r.x), lo_bf16(r.y), hi_bf16(r.y));
  d[1] = make_float4(lo_bf16(r.z), hi_bf16(r.z), lo_bf16(r.w), hi_bf16(r.w));
}
__device__ __forceinline__ void unpack(const uint4& r, float* dst, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
                  __uint_as_float(r.w));
}

template <int K>
__host__ __device__ constexpr int tile_floats() {
  return (kTH + K - 1) * (kTW + K - 1) * kCB;
}

// Rows h0-P .. h0+kTH+P-1, columns w0-P .. w0+kTW+P-1 and channels
// c0 .. c0+31 of image b, as f32, into tile[row][col][channel]; zero
// outside the image and past C. kVec: 16-byte loads (C is a multiple of
// 16 / sizeof(T) and x is 16-byte aligned).
template <typename T, int K, bool kVec>
__device__ __forceinline__ void stage(float* tile, const T* x, const Shape& s, int b, int h0,
                                      int w0, int c0) {
  constexpr int P = K / 2, Cols = kTW + K - 1;
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;  // channels per load
  constexpr int kPer = kCB / V;                                   // loads per pixel
  constexpr int kUnits = (kTH + K - 1) * Cols * kPer;
  constexpr int kIters = (kUnits + kThreads - 1) / kThreads;
  using Raw = std::conditional_t<kVec, uint4, float>;
  Raw raw[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int q = i % kPer, col = (i / kPer) % Cols, row = i / (kPer * Cols);
    const int h = h0 - P + row, w = w0 - P + col, c = c0 + q * V;
    const bool inside = i < kUnits && h >= 0 && h < s.H && w >= 0 && w < s.W && c < s.C;
    if constexpr (kVec) {
      raw[it] = inside ? *reinterpret_cast<const uint4*>(x + offset(s, b, h, w, c))
                       : make_uint4(0u, 0u, 0u, 0u);
    } else {
      raw[it] = inside ? to_f32(x[offset(s, b, h, w, c)]) : 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < kUnits) {
      if constexpr (kVec) {
        unpack(raw[it], tile + i * V, T{});
      } else {
        tile[i] = raw[it];
      }
    }
  }
}

// Forward (flip = 0) and dgrad (flip = 1). Grid: (channel tiles x row
// tiles x column tiles, 1, B), the channel tile fastest.
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dwconv_stencil_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                          T* __restrict__ y, Shape s, int tiles_w, int flip) {
  extern __shared__ __align__(16) float tile[];
  constexpr int Cols = kTW + K - 1;
  const int ctiles = (s.C + kCB - 1) / kCB;
  const int tx = threadIdx.x % kCB, ty = threadIdx.x / kCB;
  const int b = blockIdx.z, c0 = (blockIdx.x % ctiles) * kCB, c = c0 + tx;
  const int spatial = blockIdx.x / ctiles;
  const int h0 = (spatial / tiles_w) * kTH, w0 = (spatial % tiles_w) * kTW;

  float wt[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wt[t] = c < s.C ? taps[static_cast<long long>(flip ? K * K - 1 - t : t) * s.C + c] : 0.f;
  stage<T, K, kVec>(tile, x, s, b, h0, w0, c0);
  __syncthreads();

  float acc[kTW];
#pragma unroll
  for (int r = 0; r < kTW; ++r) acc[r] = 0.f;
#pragma unroll
  for (int di = 0; di < K; ++di) {
    const float* row = tile + (ty + di) * Cols * kCB + tx;
    float in[Cols];
#pragma unroll
    for (int j = 0; j < Cols; ++j) in[j] = row[j * kCB];
#pragma unroll
    for (int dj = 0; dj < K; ++dj)
#pragma unroll
      for (int r = 0; r < kTW; ++r) acc[r] = fmaf(in[r + dj], wt[di * K + dj], acc[r]);
  }
  const int h = h0 + ty;
  if (h < s.H && c < s.C) {
#pragma unroll
    for (int r = 0; r < kTW; ++r)
      if (w0 + r < s.W) y[offset(s, b, h, w0 + r, c)] = from_f32<T>(acc[r]);
  }
}

// ------------------------------------------------ the TMA row-ring stencils

constexpr int kTmaMaxConsumers = 256;  // compute threads a block at most

// How a TMA-stencil launch is cut (host plans below): an item is (image,
// strip of `rows` output rows, tile of `tw` output columns, slice of `cs`
// channels); a padded input row of the tile is `pieces` boxes of `box_w`
// columns x cs channels; the ring holds `ring` such rows. `units` is the
// compute threads' work a row (vector kernel) or their column groups
// (lane kernel).
struct TmaPlan {
  int cs, cslices, tw, ctiles, rows, strips, box_w, pieces, ring, units, consumers, smem;
};

__host__ __device__ inline int tma_row_bytes(const TmaPlan& p, int elem) {
  return p.pieces * p.box_w * p.cs * elem;
}
// Shared memory: the ring's full and empty mbarriers, the taps [k*k][cs]
// f32 (flipped for the dgrad; the vector kernel's), then the ring rows
// (each a multiple of 128 bytes).
__host__ __device__ inline int tma_taps_off(const TmaPlan& p) { return (2 * p.ring * 8 + 127) & ~127; }
__host__ __device__ inline int tma_ring_off(const TmaPlan& p, int K, bool taps) {
  return (tma_taps_off(p) + (taps ? K * K * p.cs * 4 : 0) + 127) & ~127;
}

// The item of block blockIdx.x: channel slice fastest, then column tile,
// strip, image.
struct Item {
  int b, c0, w0, h0, n_out;
};
__device__ __forceinline__ Item item_of(const Shape& s, const TmaPlan& pl) {
  Item it;
  int item = blockIdx.x;
  it.c0 = item % pl.cslices * pl.cs;
  item /= pl.cslices;
  it.w0 = item % pl.ctiles * pl.tw;
  item /= pl.ctiles;
  it.b = item / pl.strips;
  it.h0 = item % pl.strips * pl.rows;
  it.n_out = min(pl.rows, s.H - it.h0);
  return it;
}

// Thread 0 sets up the ring's barriers (before the block's barrier).
__device__ __forceinline__ void init_ring(unsigned char* smem, const TmaPlan& pl) {
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  for (int i = 0; i < pl.ring; ++i) {
    bulk::mbar_init(full + i, 1);
    bulk::mbar_init(full + pl.ring + i, pl.consumers / 32);
  }
  bulk::mbar_init_fence();
}

// The producer (lane 0 of the warp after the consumers): input rows
// h0-P .. h0+n_out+P-1 of the item's tile, each as its boxes.
template <typename T, int K>
__device__ __forceinline__ void produce_rows(const CUtensorMap* xmap, const TmaPlan& pl,
                                             unsigned char* smem, unsigned char* ring,
                                             const Item& it) {
  if (threadIdx.x != pl.consumers) return;
  constexpr int P = K / 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + pl.ring;
  const int row_bytes = tma_row_bytes(pl, sizeof(T)), box = pl.box_w * pl.cs * (int)sizeof(T);
  for (int i = 0; i < it.n_out + K - 1; ++i) {
    const int slot = i % pl.ring;
    if (i >= pl.ring) bulk::mbar_wait(empty + slot, ((i / pl.ring) - 1) & 1);
    bulk::mbar_arrive_expect(full + slot, row_bytes);
    for (int pc = 0; pc < pl.pieces; ++pc)
      bulk::copy_4d(ring + slot * row_bytes + pc * box, xmap, it.c0,
                    it.w0 + pc * pl.box_w - P, it.h0 - P + i, it.b, full + slot);
  }
}

// The vector kernel (k = 3 on rows wider than 12: memory bound). Thread u
// of a row's units
// computes RW columns x one 16-byte channel vector (8 bf16 or 4 f32) of
// the row: f32 sums in registers, one tap row's taps of its channels at a
// time from shared memory, 16-byte loads and stores.
template <typename T, int K, int RW>
__global__ void __launch_bounds__(kTmaMaxConsumers + 32)
    dwconv_stencil_tma_vec_kernel(const __grid_constant__ CUtensorMap xmap,
                                  const float* __restrict__ taps, T* __restrict__ y, Shape s,
                                  TmaPlan pl, int flip) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + pl.ring;
  float* taps_s = reinterpret_cast<float*>(smem + tma_taps_off(pl));
  unsigned char* ring = smem + tma_ring_off(pl, K, true);
  const int row_bytes = tma_row_bytes(pl, sizeof(T));
  const Item it = item_of(s, pl);
  init_ring(smem, pl);
  for (int i = threadIdx.x; i < K * K * pl.cs; i += blockDim.x) {
    const int t = i / pl.cs, c = it.c0 + i % pl.cs;
    taps_s[i] = c < s.C ? taps[static_cast<long long>(flip ? K * K - 1 - t : t) * s.C + c] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x >= pl.consumers) {
    produce_rows<T, K>(&xmap, pl, smem, ring, it);
    return;
  }

  const int vecs = pl.cs / V;
  for (int i = 0; i < K - 1; ++i) bulk::mbar_wait(full + i % pl.ring, (i / pl.ring) & 1);
  for (int r = 0; r < it.n_out; ++r) {
    {
      const int i = r + K - 1;
      bulk::mbar_wait(full + i % pl.ring, (i / pl.ring) & 1);
    }
    for (int u = threadIdx.x; u < pl.units; u += pl.consumers) {
      const int run = u / vecs, cl = (u % vecs) * V, c = it.c0 + cl;
      const int wl = run * RW;  // the run's first column within the tile
      if (c >= s.C || it.w0 + wl >= s.W) continue;
      float acc[RW][V];
#pragma unroll
      for (int o = 0; o < RW; ++o)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[o][e] = 0.f;
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const unsigned char* in = ring + ((r + di) % pl.ring) * row_bytes;
        float w[K][V];
#pragma unroll
        for (int dj = 0; dj < K; ++dj)
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(&w[dj][e]) =
                *reinterpret_cast<const float4*>(taps_s + (di * K + dj) * pl.cs + cl + e);
#pragma unroll
        for (int jj = 0; jj < RW + K - 1; ++jj) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(in + ((wl + jj) * pl.cs + cl) * (int)sizeof(T));
          float x[V];
          if constexpr (sizeof(T) == 2) {
            x[0] = lo_bf16(raw.x), x[1] = hi_bf16(raw.x), x[2] = lo_bf16(raw.y);
            x[3] = hi_bf16(raw.y), x[4] = lo_bf16(raw.z), x[5] = hi_bf16(raw.z);
            x[6] = lo_bf16(raw.w), x[7] = hi_bf16(raw.w);
          } else {
            x[0] = __uint_as_float(raw.x), x[1] = __uint_as_float(raw.y);
            x[2] = __uint_as_float(raw.z), x[3] = __uint_as_float(raw.w);
          }
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const int o = jj - dj;
            if (o < 0 || o >= RW) continue;
#pragma unroll
            for (int e = 0; e < V; ++e) acc[o][e] = fmaf(x[e], w[dj][e], acc[o][e]);
          }
        }
      }
      T* out = y + offset(s, it.b, it.h0 + r, it.w0 + wl, c);
#pragma unroll
      for (int o = 0; o < RW; ++o) {
        if (it.w0 + wl + o >= s.W) break;
        uint4 v;
        if constexpr (sizeof(T) == 2) {
          uint32_t q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            __nv_bfloat162 h = __floats2bfloat162_rn(acc[o][2 * e], acc[o][2 * e + 1]);
            q[e] = *reinterpret_cast<uint32_t*>(&h);
          }
          v = make_uint4(q[0], q[1], q[2], q[3]);
        } else {
          v = make_uint4(__float_as_uint(acc[o][0]), __float_as_uint(acc[o][1]),
                         __float_as_uint(acc[o][2]), __float_as_uint(acc[o][3]));
        }
        *reinterpret_cast<uint4*>(out + static_cast<long long>(o) * s.C) = v;
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bulk::mbar_arrive(empty + r % pl.ring);
  }
}

// The lane kernel (k = 5 and 7, compute bound, and narrow rows). Lanes are
// consecutive
// channels (conflict-free 2- or 4-byte shared loads; each warp's stores
// cover whole 32-byte sectors); thread (group g, channel ch) keeps its
// channel's k*k taps and RW f32 sums in registers and computes columns
// g*RW .. of the tile.
template <typename T, int K, int RW>
__global__ void __launch_bounds__(kTmaMaxConsumers + 32)
    dwconv_stencil_tma_lane_kernel(const __grid_constant__ CUtensorMap xmap,
                                   const float* __restrict__ taps, T* __restrict__ y, Shape s,
                                   TmaPlan pl, int flip) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + pl.ring;
  unsigned char* ring = smem + tma_ring_off(pl, K, false);
  const int row_bytes = tma_row_bytes(pl, sizeof(T));
  const Item it = item_of(s, pl);
  init_ring(smem, pl);
  __syncthreads();
  if (threadIdx.x >= pl.consumers) {
    produce_rows<T, K>(&xmap, pl, smem, ring, it);
    return;
  }

  const int ch = threadIdx.x % pl.cs, g = threadIdx.x / pl.cs;
  const int c = it.c0 + ch, wg = it.w0 + g * RW;  // this thread's channel and first column
  const bool active = g < pl.units && c < s.C && wg < s.W;
  float w[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    w[t] = active ? taps[static_cast<long long>(flip ? K * K - 1 - t : t) * s.C + c] : 0.f;

  for (int i = 0; i < K - 1; ++i) bulk::mbar_wait(full + i % pl.ring, (i / pl.ring) & 1);
  for (int r = 0; r < it.n_out; ++r) {
    {
      const int i = r + K - 1;
      bulk::mbar_wait(full + i % pl.ring, (i / pl.ring) & 1);
    }
    if (active) {
      float acc[RW];
#pragma unroll
      for (int o = 0; o < RW; ++o) acc[o] = 0.f;
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const T* in = reinterpret_cast<const T*>(ring + ((r + di) % pl.ring) * row_bytes) +
                      g * RW * pl.cs + ch;
#pragma unroll
        for (int jj = 0; jj < RW + K - 1; ++jj) {
          const float x = to_f32(in[jj * pl.cs]);
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const int o = jj - dj;
            if (o >= 0 && o < RW) acc[o] = fmaf(x, w[di * K + dj], acc[o]);
          }
        }
      }
      T* out = y + offset(s, it.b, it.h0 + r, wg, c);
#pragma unroll
      for (int o = 0; o < RW; ++o)
        if (wg + o < s.W) out[static_cast<long long>(o) * s.C] = from_f32<T>(acc[o]);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bulk::mbar_arrive(empty + r % pl.ring);
  }
}

// ------------------------------------------------- the TMA row-ring wgrad

// V consecutive channels of T at p (V-element aligned), as f32.
template <typename T, int V>
__device__ __forceinline__ void load_channels(const unsigned char* p, float* out) {
  static_assert(V == 1 || V == 2 || V == 4, "a thread's channels: 1, 2 or 4");
  if constexpr (sizeof(T) == 2) {
    if constexpr (V == 1) {
      out[0] = __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
    } else if constexpr (V == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
      out[0] = lo_bf16(u), out[1] = hi_bf16(u);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      out[0] = lo_bf16(u.x), out[1] = hi_bf16(u.x), out[2] = lo_bf16(u.y), out[3] = hi_bf16(u.y);
    }
  } else {
    if constexpr (V == 1) {
      out[0] = *reinterpret_cast<const float*>(p);
    } else if constexpr (V == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      out[0] = u.x, out[1] = u.y;
    } else {
      const float4 u = *reinterpret_cast<const float4*>(p);
      out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
    }
  }
}

// The wgrad on the row ring. The producer (lane 0 of the warp after the
// consumers) brings padded x rows h0-P .. h0+n_out+P-1 of the item, ring
// row i with dy row h0+i (i < n_out): x row i is last read by output row
// i, as dy row i is, so both leave the ring together. Compute thread
// (run g, channel vector q) keeps its k*k x V sums in registers over the
// whole strip: per output row its RW dy values, then per tap row the
// RW + k - 1 x values of its run, one fma per (tap, column, channel).
// Then the consumers sum their runs in run order through shared memory
// and write the item's slice of its partial row.
template <typename T, int K, int V, int RW>
__global__ void __launch_bounds__(kWgMaxConsumers + 32, 2)
    dwconv_wgrad_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap dymap, float* __restrict__ part,
                            Shape s, WgPlan pl) {
  constexpr int P = K / 2, E = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + pl.ring;
  unsigned char* ring = smem + wg_ring_off(pl);
  const int xrow = wg_xrow_bytes(pl, E), slot = wg_slot_bytes(pl, E);
  int item = blockIdx.x;
  const int c0 = item % pl.cslices * pl.cs;
  item /= pl.cslices;
  const int ctile = item % pl.ctiles;
  item /= pl.ctiles;
  const int strip = item % pl.strips, b = item / pl.strips;
  const int w0 = ctile * pl.tw, h0 = strip * pl.rows, n_out = min(pl.rows, s.H - h0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.ring; ++i) {
      bulk::mbar_init(full + i, 1);
      bulk::mbar_init(empty + i, pl.consumers / 32);
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= pl.consumers) {
    if (threadIdx.x == pl.consumers) {
      const uint32_t xb = pl.box_w * pl.cs * E, db = pl.tw * pl.cs * E;
      for (int i = 0; i < n_out + K - 1; ++i) {
        const int sl = i % pl.ring;
        if (i >= pl.ring) bulk::mbar_wait(empty + sl, (i / pl.ring - 1) & 1);
        bulk::mbar_arrive_expect(full + sl, xb + (i < n_out ? db : 0u));
        bulk::copy_4d(ring + sl * slot, &xmap, c0, w0 - P, h0 - P + i, b, full + sl);
        if (i < n_out)
          bulk::copy_4d(ring + sl * slot + xrow, &dymap, c0, w0, h0 + i, b, full + sl);
      }
    }
    return;
  }

  const int vecs = pl.cs / V, runs = pl.tw / RW;
  const int q = threadIdx.x % vecs, g = threadIdx.x / vecs;
  const bool active = g < runs;
  const int choff = q * V * E, col0 = g * RW, pitch = pl.cs * E;
  float acc[K * K][V];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[t][e] = 0.f;
  for (int i = 0; i < K - 1; ++i) bulk::mbar_wait(full + i % pl.ring, (i / pl.ring) & 1);
  for (int r = 0; r < n_out; ++r) {
    {
      const int i = r + K - 1;
      bulk::mbar_wait(full + i % pl.ring, (i / pl.ring) & 1);
    }
    if (active) {
      const unsigned char* dyr = ring + (r % pl.ring) * slot + xrow + choff + col0 * pitch;
      float d[RW][V];
#pragma unroll
      for (int o = 0; o < RW; ++o) load_channels<T, V>(dyr + o * pitch, d[o]);
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const unsigned char* xr = ring + ((r + di) % pl.ring) * slot + choff + col0 * pitch;
#pragma unroll
        for (int jj = 0; jj < RW + K - 1; ++jj) {
          float xv[V];
          load_channels<T, V>(xr + jj * pitch, xv);
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const int o = jj - dj;
            if (o < 0 || o >= RW) continue;
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[di * K + dj][e] = fmaf(xv[e], d[o][e], acc[di * K + dj][e]);
          }
        }
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bulk::mbar_arrive(empty + r % pl.ring);
  }

  // Every copy has landed and every consumer is past the ring: its bytes
  // take the runs' sums, which are then added in run order.
  asm volatile("bar.sync 1, %0;\n" ::"r"(pl.consumers) : "memory");
  float* red = reinterpret_cast<float*>(ring);  // [runs][K*K][cs]
  if (active)
#pragma unroll
    for (int t = 0; t < K * K; ++t)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(g * K * K + t) * pl.cs + q * V + e] = acc[t][e];
  asm volatile("bar.sync 1, %0;\n" ::"r"(pl.consumers) : "memory");
  const long long prow = (static_cast<long long>(b) * pl.strips + strip) * pl.ctiles + ctile;
  for (int i = threadIdx.x; i < K * K * pl.cs; i += pl.consumers) {
    const int t = i / pl.cs, cl = i % pl.cs;
    float sum = 0.f;
    for (int gg = 0; gg < runs; ++gg) sum += red[(gg * K * K + t) * pl.cs + cl];
    if (c0 + cl < s.C) part[(prow * K * K + t) * s.C + c0 + cl] = sum;
  }
}

// The staged-tile wgrad (shapes no tensor map takes): partials
// part[b * tiles_w + column tile][t][c]. Grid: (channel
// tiles x column tiles, 1, B), the channel tile fastest; each block walks
// every row tile of its column strip.
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dwconv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        float* __restrict__ part, Shape s, int tiles_w) {
  extern __shared__ __align__(16) float tile[];
  constexpr int Cols = kTW + K - 1;
  const int ctiles = (s.C + kCB - 1) / kCB;
  const int tx = threadIdx.x % kCB, ty = threadIdx.x / kCB;
  const int b = blockIdx.z, c0 = (blockIdx.x % ctiles) * kCB, c = c0 + tx;
  const int tw = blockIdx.x / ctiles, w0 = tw * kTW;

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;
  for (int h0 = 0; h0 < s.H; h0 += kTH) {
    __syncthreads();  // the previous row tile is no longer read
    stage<T, K, kVec>(tile, x, s, b, h0, w0, c0);
    const int h = h0 + ty;
    float g[kTW];
#pragma unroll
    for (int r = 0; r < kTW; ++r)
      g[r] = (h < s.H && w0 + r < s.W && c < s.C) ? to_f32(dy[offset(s, b, h, w0 + r, c)])
                                                  : 0.f;
    __syncthreads();
#pragma unroll
    for (int di = 0; di < K; ++di) {
      const float* row = tile + (ty + di) * Cols * kCB + tx;
      float in[Cols];
#pragma unroll
      for (int j = 0; j < Cols; ++j) in[j] = row[j * kCB];
#pragma unroll
      for (int dj = 0; dj < K; ++dj)
#pragma unroll
        for (int r = 0; r < kTW; ++r) acc[di * K + dj] = fmaf(in[r + dj], g[r], acc[di * K + dj]);
    }
  }
  // Sum the block's kTH rows of threads, in order.
  __syncthreads();
  float* red = tile;  // [kTH][K*K][kCB]
#pragma unroll
  for (int t = 0; t < K * K; ++t) red[(ty * K * K + t) * kCB + tx] = acc[t];
  __syncthreads();
  const long long prow = static_cast<long long>(b) * tiles_w + tw;
  for (int t = ty; t < K * K; t += kTH) {
    float sum = 0.f;
    for (int r = 0; r < kTH; ++r) sum += red[(r * K * K + t) * kCB + tx];
    if (c < s.C) part[(prow * K * K + t) * s.C + c] = sum;
  }
}

// dw[i] = sum over p of part[p][i], i < n, in a fixed order: thread row ty
// sums p = ty, ty + 32, ..., then the 32 rows are summed in order.
__global__ void __launch_bounds__(1024)
    dwconv_sum_partials_kernel(const float* __restrict__ part, float* __restrict__ dw, int P,
                               int n) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + tx;
  float sum = 0.f;
  if (i < n)
    for (int p = ty; p < P; p += 32) sum += part[static_cast<long long>(p) * n + i];
  red[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && i < n) {
    float total = 0.f;
    for (int r = 0; r < 32; ++r) total += red[r][tx];
    dw[i] = total;
  }
}

// Any other odd K: one thread per output element.
template <typename T>
__global__ void dwconv_stencil_direct_kernel(const T* __restrict__ x,
                                             const float* __restrict__ taps, T* __restrict__ y,
                                             Shape s, int K, int flip) {
  const long long n = static_cast<long long>(s.B) * s.H * s.W * s.C;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = i % s.C, w = (i / s.C) % s.W, h = (i / (static_cast<long long>(s.C) * s.W)) % s.H;
  const int b = i / (static_cast<long long>(s.C) * s.W * s.H);
  const int P = K / 2;
  float acc = 0.f;
  for (int di = 0; di < K; ++di) {
    const int hh = h + di - P;
    if (hh < 0 || hh >= s.H) continue;
    for (int dj = 0; dj < K; ++dj) {
      const int ww = w + dj - P;
      if (ww < 0 || ww >= s.W) continue;
      const int t = di * K + dj;
      acc = fmaf(to_f32(x[offset(s, b, hh, ww, c)]),
                 taps[static_cast<long long>(flip ? K * K - 1 - t : t) * s.C + c], acc);
    }
  }
  y[i] = from_f32<T>(acc);
}

// Any other odd K: block (32 channels, 8 rows) per tap; row ty sums the
// positions ty, ty + 8, ... of all images, then the rows are summed in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dwconv_wgrad_direct_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                               float* __restrict__ dw, Shape s, int K) {
  __shared__ float red[kTH][kCB];
  const int tx = threadIdx.x % kCB, ty = threadIdx.x / kCB;
  const int c = blockIdx.x * kCB + tx, t = blockIdx.y;
  const int di = t / K - K / 2, dj = t % K - K / 2;
  const long long positions = static_cast<long long>(s.B) * s.H * s.W;
  float sum = 0.f;
  if (c < s.C) {
    for (long long p = ty; p < positions; p += kTH) {
      const int w = p % s.W, h = (p / s.W) % s.H, b = p / (static_cast<long long>(s.W) * s.H);
      const int hh = h + di, ww = w + dj;
      if (hh < 0 || hh >= s.H || ww < 0 || ww >= s.W) continue;
      sum = fmaf(to_f32(x[offset(s, b, hh, ww, c)]), to_f32(dy[offset(s, b, h, w, c)]), sum);
    }
  }
  red[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < s.C) {
    float total = 0.f;
    for (int r = 0; r < kTH; ++r) total += red[r][tx];
    dw[static_cast<long long>(t) * s.C + c] = total;
  }
}

template <int K>
constexpr int stencil_smem() {
  return tile_floats<K>() * 4;
}

template <int K>
constexpr int wgrad_smem() {
  return (tile_floats<K>() > kTH * K * K * kCB ? tile_floats<K>() : kTH * K * K * kCB) * 4;
}

// 16-byte loads apply: C a multiple of the vector and x 16-byte aligned.
template <typename T>
bool vector_loads(const void* x, int C) {
  return C % (16 / static_cast<int>(sizeof(T))) == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int K>
int launch_stencil(const void* x, const float* taps, void* y, Shape s, int flip,
                   cudaStream_t stream) {
  const int tiles_w = (s.W + kTW - 1) / kTW, tiles_h = (s.H + kTH - 1) / kTH;
  const dim3 grid(((s.C + kCB - 1) / kCB) * tiles_h * tiles_w, 1, s.B);
  auto kernel = vector_loads<T>(x, s.C) ? dwconv_stencil_kernel<T, K, true>
                                        : dwconv_stencil_kernel<T, K, false>;
  const int rc = set_smem(kernel, stencil_smem<K>());
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, stencil_smem<K>(), stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(y), s, tiles_w, flip);
  return (int)cudaGetLastError();
}

// dw = the sum of `rows` partial rows (each n floats), in a fixed order.
int sum_partials(const float* part, float* dw, int rows, int n, cudaStream_t stream) {
  dwconv_sum_partials_kernel<<<(n + 31) / 32, 1024, 0, stream>>>(part, dw, rows, n);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_wgrad(const void* x, const void* dy, float* part, float* dw, Shape s, int drop_last,
                 cudaStream_t stream) {
  const int tiles_w = (s.W + kTW - 1) / kTW;
  const dim3 grid(((s.C + kCB - 1) / kCB) * tiles_w, 1, s.B);
  auto kernel = vector_loads<T>(x, s.C) ? dwconv_wgrad_kernel<T, K, true>
                                        : dwconv_wgrad_kernel<T, K, false>;
  int rc = set_smem(kernel, wgrad_smem<K>());
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, wgrad_smem<K>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, s, tiles_w);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return sum_partials(part, dw, s.B * tiles_w - drop_last, K * K * s.C, stream);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Which TMA stencil a shape takes: the vector kernel at k = 3 on rows
// wider than 12 (memory bound), else the lane kernel
// (scripts/depthwise_ablation.py times both at B4's layers).
constexpr int kTmaVector = 1, kTmaLane = 2;
__host__ __device__ constexpr int tma_kernel(int K, int W) {
  if (DW_TMA_KERNEL != 0) return DW_TMA_KERNEL;
  return K == 3 && W > 12 ? kTmaVector : kTmaLane;
}

// Columns a TMA-stencil thread computes: the vector kernel 8, or 4 on
// rows of at most 12; the lane kernel 12 where that divides the row, else 8.
__host__ __device__ constexpr int tma_run(bool vec, int W) {
  return vec ? (W > 12 ? 8 : 4) : (W % 12 == 0 ? 12 : 8);
}

// Strips of `kernel`'s plan (a TmaPlan or a WgPlan): rows by strip_rows
// at the blocks an SM the kernel's registers, threads and shared memory
// allow.
template <typename Plan, typename Kernel>
void set_strips(Plan& p, Kernel kernel, const Shape& s, int K) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.consumers + 32, p.smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  plan_strips(p, s, K, sm_count(), per_sm);
}

// The vector kernel's plan (k = 3): a tile is the whole row, its padded
// row as few boxes of at most 256 columns (a multiple of 8) as cover the
// runs and the halo; the channel slice is the widest (at most 256, C if
// it fits) whose ring of k + 1 rows and taps fit 113 KB, evened out over
// the slices.
template <int K>
TmaPlan tma_vec_plan(const Shape& s, int elem) {
  TmaPlan p{};
  const int V = 16 / elem, RW = tma_run(true, s.W);
  const int runs = (s.W + RW - 1) / RW, needed = runs * RW + K - 1;
  p.tw = s.W;
  p.ctiles = 1;
  p.pieces = (needed + 255) / 256;
  p.box_w = ((needed + p.pieces - 1) / p.pieces + 7) / 8 * 8;
  p.ring = K + (DW_RING_EXTRA > 0 ? DW_RING_EXTRA : 1);
  auto smem_of = [&](int cs) {
    TmaPlan q = p;
    q.cs = cs;
    return tma_ring_off(q, K, true) + q.ring * tma_row_bytes(q, elem);
  };
  int cs = min(256, (s.C + V - 1) / V * V);
  while (cs > V && smem_of(cs) > 113 * 1024) cs -= V;
  p.cslices = (s.C + cs - 1) / cs;
  p.cs = ((s.C + p.cslices - 1) / p.cslices + V - 1) / V * V;
  p.smem = smem_of(p.cs);
  p.units = runs * (p.cs / V);
  p.consumers = min(kTmaMaxConsumers, (p.units + 31) / 32 * 32);
  return p;
}

// The lane kernel's plan (k = 5, 7): the channel slice is at most 256
// channels and leaves at least four column groups of 256 threads where
// the row has them (a tile's halo then costs at most (k-1)/32 of its
// reads), evened out over the slices; the column tile is as many runs as
// the threads cover, its box the tile and the halo (a multiple of 8, at
// most 256); the ring holds k rows and as many more as make 16 KB.
template <int K>
TmaPlan tma_lane_plan(const Shape& s, int elem) {
  TmaPlan p{};
  const int V = 16 / elem, RW = tma_run(false, s.W);
  const int runs = (s.W + RW - 1) / RW;
  const int max_groups = min(runs, (256 - K + 1) / RW);
  int cs = kTmaMaxConsumers / min(4, max_groups) / V * V;
  cs = max(V, min(cs, (s.C + V - 1) / V * V));
  p.cslices = (s.C + cs - 1) / cs;
  p.cs = ((s.C + p.cslices - 1) / p.cslices + V - 1) / V * V;
  p.units = max(1, min(max_groups, kTmaMaxConsumers / p.cs));
  p.tw = p.units * RW;
  p.ctiles = (s.W + p.tw - 1) / p.tw;
  p.consumers = (p.units * p.cs + 31) / 32 * 32;
  p.pieces = 1;
  p.box_w = (p.tw + K - 1 + 7) / 8 * 8;
  const int rb = tma_row_bytes(p, elem);
  p.ring = K + (DW_RING_EXTRA > 0 ? DW_RING_EXTRA : max(1, min(4, (16384 + rb - 1) / rb)));
  p.smem = tma_ring_off(p, K, false) + p.ring * rb;
  return p;
}

// A 4-D tensor map over an NHWC tensor [B, H, W, C] of T whose boxes are
// (cs channels, box_w columns, one row, one image); 0 or a CUDA error.
template <typename T>
int nhwc_map(CUtensorMap* map, const void* base, const Shape& s, int cs, int box_w) {
  const bulk::EncodeTiled encode = bulk::encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)s.C, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
  const cuuint64_t strides[3] = {s.C * e, (cuuint64_t)s.W * s.C * e,
                                 (cuuint64_t)s.H * s.W * s.C * e};
  const cuuint32_t box[4] = {(cuuint32_t)cs, (cuuint32_t)box_w, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <typename T, int K, int RW, bool kVec>
int launch_stencil_tma(const void* x, const float* taps, void* y, Shape s, int flip,
                       cudaStream_t stream) {
  TmaPlan pl = kVec ? tma_vec_plan<K>(s, sizeof(T)) : tma_lane_plan<K>(s, sizeof(T));
  if (pl.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (kVec) return dwconv_stencil_tma_vec_kernel<T, K, RW>;
    else return dwconv_stencil_tma_lane_kernel<T, K, RW>;
  }();
  int rc = set_smem(kernel, pl.smem);
  if (rc != 0) return rc;
  set_strips(pl, kernel, s, K);
  CUtensorMap map;
  rc = nhwc_map<T>(&map, x, s, pl.cs, pl.box_w);
  if (rc != 0) return rc;
  const int items = s.B * pl.strips * pl.ctiles * pl.cslices;
  kernel<<<items, pl.consumers + 32, pl.smem, stream>>>(map, taps, static_cast<T*>(y), s, pl, flip);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int stencil_tma_k(const void* x, const float* taps, void* y, Shape s, int flip,
                  cudaStream_t stream) {
  if (tma_kernel(K, s.W) == kTmaVector)
    return tma_run(true, s.W) == 4
               ? launch_stencil_tma<T, K, 4, true>(x, taps, y, s, flip, stream)
               : launch_stencil_tma<T, K, 8, true>(x, taps, y, s, flip, stream);
  return tma_run(false, s.W) == 12
             ? launch_stencil_tma<T, K, 12, false>(x, taps, y, s, flip, stream)
             : launch_stencil_tma<T, K, 8, false>(x, taps, y, s, flip, stream);
}

// path: 0 = the TMA row ring (k in {3, 5, 7}, C a multiple of the 16-byte
// vector, x 16-byte aligned), 1 = the tile kernel (k in {3, 5, 7}), 2 =
// the direct kernel (any odd k): ops/depthwise.stencil_path's rule.
template <typename T>
int stencil(const void* x, const float* taps, void* y, Shape s, int K, int flip, int path,
            cudaStream_t stream) {
  const bool fixed_k = K == 3 || K == 5 || K == 7;
  if (path == 0) {
    if (!fixed_k || s.C % (16 / (int)sizeof(T)) != 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(y) % 16)
      return (int)cudaErrorInvalidValue;
    switch (K) {
      case 3: return stencil_tma_k<T, 3>(x, taps, y, s, flip, stream);
      case 5: return stencil_tma_k<T, 5>(x, taps, y, s, flip, stream);
      default: return stencil_tma_k<T, 7>(x, taps, y, s, flip, stream);
    }
  }
  if (path == 1) {
    switch (K) {
      case 3: return launch_stencil<T, 3>(x, taps, y, s, flip, stream);
      case 5: return launch_stencil<T, 5>(x, taps, y, s, flip, stream);
      case 7: return launch_stencil<T, 7>(x, taps, y, s, flip, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 2) return (int)cudaErrorInvalidValue;
  const long long n = static_cast<long long>(s.B) * s.H * s.W * s.C;
  dwconv_stencil_direct_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                    stream>>>(static_cast<const T*>(x), taps,
                                              static_cast<T*>(y), s, K, flip);
  return (int)cudaGetLastError();
}

template <typename T, int K, int RW>
auto wgrad_tma_kernel() {
  return dwconv_wgrad_tma_kernel<T, K, wgrad_vec(K), RW>;
}

// The TMA wgrad's plan for this card: depthwise_plan.h's geometry, then
// strips at the occupancy of the kernel it picks (whose shared memory it
// also sets); 0 or a CUDA error.
template <typename T, int K>
int wgrad_tma_plan_k(const Shape& s, WgPlan& pl) {
  if (s.C % (16 / (int)sizeof(T)) != 0 || !wg_geometry(pl, s, K, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const auto kernel = pl.run == 4 ? wgrad_tma_kernel<T, K, 4>() : wgrad_tma_kernel<T, K, 8>();
  const int rc = set_smem(kernel, pl.smem);
  if (rc != 0) return rc;
  set_strips(pl, kernel, s, K);
  return 0;
}

template <typename T, int K>
int wgrad_tma_k(const void* x, const void* dy, float* part, float* dw, Shape s, int drop_last,
                cudaStream_t stream) {
  WgPlan pl;
  int rc = wgrad_tma_plan_k<T, K>(s, pl);
  if (rc != 0) return rc;
  CUtensorMap xmap, dymap;
  if ((rc = nhwc_map<T>(&xmap, x, s, pl.cs, pl.box_w)) != 0) return rc;
  if ((rc = nhwc_map<T>(&dymap, dy, s, pl.cs, pl.tw)) != 0) return rc;
  const int partials = s.B * pl.strips * pl.ctiles;
  const auto kernel = pl.run == 4 ? wgrad_tma_kernel<T, K, 4>() : wgrad_tma_kernel<T, K, 8>();
  kernel<<<partials * pl.cslices, pl.consumers + 32, pl.smem, stream>>>(xmap, dymap, part, s, pl);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return sum_partials(part, dw, partials - drop_last, K * K * s.C, stream);
}

template <typename T>
int wgrad_tma_plan(const Shape& s, int K, WgPlan& pl) {
  switch (K) {
    case 3: return wgrad_tma_plan_k<T, 3>(s, pl);
    case 5: return wgrad_tma_plan_k<T, 5>(s, pl);
    case 7: return wgrad_tma_plan_k<T, 7>(s, pl);
    default: return (int)cudaErrorInvalidValue;
  }
}

// path as for the stencil: 0 = the TMA row ring, 1 = the staged tile, 2 =
// the direct kernel (no partials, nothing to drop).
template <typename T>
int wgrad(const void* x, const void* dy, float* part, float* dw, Shape s, int K, int path,
          int drop_last, cudaStream_t stream) {
  if (path == 0) {
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16)
      return (int)cudaErrorInvalidValue;
    switch (K) {
      case 3: return wgrad_tma_k<T, 3>(x, dy, part, dw, s, drop_last, stream);
      case 5: return wgrad_tma_k<T, 5>(x, dy, part, dw, s, drop_last, stream);
      case 7: return wgrad_tma_k<T, 7>(x, dy, part, dw, s, drop_last, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path == 1) {
    switch (K) {
      case 3: return launch_wgrad<T, 3>(x, dy, part, dw, s, drop_last, stream);
      case 5: return launch_wgrad<T, 5>(x, dy, part, dw, s, drop_last, stream);
      case 7: return launch_wgrad<T, 7>(x, dy, part, dw, s, drop_last, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 2 || drop_last) return (int)cudaErrorInvalidValue;
  dwconv_wgrad_direct_kernel<T><<<dim3((s.C + kCB - 1) / kCB, K * K), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dw, s, K);
  return (int)cudaGetLastError();
}

bool valid(int B, int H, int W, int C, int K, int dtype) {
  return B >= 1 && B <= 65535 && C >= 1 && K > 1 && K % 2 == 1 && H >= K && W >= K &&
         (dtype == 0 || dtype == 1) && static_cast<long long>(B) * H * W * C < (1LL << 38) &&
         static_cast<long long>((C + kCB - 1) / kCB) * ((H + kTH - 1) / kTH) *
                 ((W + kTW - 1) / kTW) < (1LL << 31);
}

}  // namespace

// C entry points (loaded with ctypes). Tensors are contiguous NHWC ([B, H,
// W, C]) of dtype 0 = bf16 or 1 = f32, taps [K*K, C] f32, dw [K*K, C] f32.
// Each returns cudaGetLastError() after its launches (0 = ok).

// y = the stencil of x with taps (flip = 0), or with the taps reversed
// (flip = 1: the dgrad, x = dy, y = dx), by the kernel `path` names (0 =
// TMA row ring, 1 = tile, 2 = direct, as ops/depthwise.stencil_path
// picks; an infeasible path returns cudaErrorInvalidValue).
extern "C" int depthwise_stencil(const void* x, const float* taps, void* y, int B, int H, int W,
                                 int C, int K, int dtype, int flip, int path, void* stream) {
  if (!valid(B, H, W, C, K, dtype)) return (int)cudaErrorInvalidValue;
  const Shape s = {B, H, W, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? stencil<bf16>(x, taps, y, s, K, flip, path, st)
                    : stencil<float>(x, taps, y, s, K, flip, path, st);
}

// dw = the wgrad of x and dy by the kernels `path` names (0 = TMA row
// ring, 1 = staged tile, 2 = direct, as ops/depthwise.stencil_path
// picks). part holds the partial rows depthwise_wgrad_plan counts (TMA: B
// x strips x column tiles; tile: B x ceil(W / 12); direct: none), each
// K*K*C floats. drop_last != 0 leaves the last partial row out of the sum
// (a wrong variant, only for negative controls; not on the direct path).
// An infeasible path returns cudaErrorInvalidValue.
extern "C" int depthwise_wgrad(const void* x, const void* dy, float* part, float* dw, int B,
                               int H, int W, int C, int K, int dtype, int path, int drop_last,
                               void* stream) {
  if (!valid(B, H, W, C, K, dtype)) return (int)cudaErrorInvalidValue;
  const Shape s = {B, H, W, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? wgrad<bf16>(x, dy, part, dw, s, K, path, drop_last, st)
                    : wgrad<float>(x, dy, part, dw, s, K, path, drop_last, st);
}

// The plan depthwise_wgrad runs on the current device for this shape and
// path, as kWgPlanInts ints (depthwise_plan.h's wgrad_plan_ints); 0 or a
// CUDA error. x and dy are taken 16-byte aligned.
extern "C" int depthwise_wgrad_plan(int B, int H, int W, int C, int K, int dtype, int path,
                                    int* out) {
  if (!valid(B, H, W, C, K, dtype) || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  const Shape s = {B, H, W, C};
  if (path != 0) {
    wgrad_plan_ints(nullptr, s, path, out);
    return 0;
  }
  WgPlan pl;
  const int rc = dtype == 0 ? wgrad_tma_plan<bf16>(s, K, pl) : wgrad_tma_plan<float>(s, K, pl);
  if (rc == 0) wgrad_plan_ints(&pl, s, path, out);
  return rc;
}
