// Masked online-softmax decode attention over a dense row cache or a
// paged block pool, for Hopper (sm_90a), with the cache stored in the
// compute dtype or quantized (int8 or fp8 e4m3 codes with f32 scales).
//
// Replaces the Pallas TPU kernel
// distributeddeeplearning_tpu/ops/pallas/paged_decode.py::fused_decode_attention
// (kernel body `_decode_kernel`, `quant` False and True). Same contract:
//   q      [B, t, H, D]   compute dtype (bf16 or f32)
//   k, v   dense [B, L, H, D] rows, or a paged pool [nb, bs, H, D]
//          read through an int32 block table [B, mb]; stored in the
//          compute dtype, or as int8 / float8_e4m3fn codes
//   ks, vs f32 scales [..., H, 1] beside quantized k, v (same rows)
//   q_pos  [B, t] int32 absolute position of each query row
//   out    [B, t, H, D]   compute dtype
// A quantized element dequantizes as the TPU kernel's
// `(code.astype(f32) * scale).astype(q.dtype)`: int8 -> f32 and
// e4m3 -> f32 are exact, the product is f32, and it is rounded to the
// compute dtype before the dot, as there. Keys at positions > q_pos or
// >= kv_len are masked with finfo(f32).min; V is zeroed past kv_len
// (kills 0*NaN); q is pre-scaled by D**-0.5 and rounded to the compute
// dtype; scores, the running max m, the running sum l and the P.V
// accumulator are f32; p is rounded to the compute dtype before P.V;
// l == 0 maps to 1. Table entries past a row's live length point at
// trash block 0, whose contents may be garbage: masking, not residency,
// keeps them out. Garbage must be finite (0 * NaN is NaN): the pools
// start zeroed, and the quantizers never write a NaN code (fp8 values
// are clipped to +-448 first).
//
// What bounds it on an H100: the K/V bytes it must read. The serving
// decode step of lm_base at full depth reads 8 rows x 2048 positions x
// 768 x 2 B x 2 (K+V) = 50.3 MB per layer call in bf16, about 15 us at
// 3.35 TB/s; quantized, 25.2 MB of codes + 1.6 MB of scales, about
// 8.0 us. A decode call has one query row per cache row, so the whole
// card must stream K and V at once, with enough bytes in flight per SM
// to cover the memory latency.
//
// Design (flash-decoding with a bulk-copy ring):
// * Work item: (cache row b, a tile of 16 query rows (4 in f32), a group
//   of heads, a split of the key axis). The split plan is the wrapper's,
//   a function of shapes alone (ops/paged_decode.split_plan): enough
//   splits that the blocks of a full-length call fill the card, at most
//   128 keys a block (a decode call at B 8 takes 16 splits: 128 blocks,
//   one an SM; the old one-block-per-(tile, head) design launched 96 that
//   each walked all 2048 keys behind three barriers a chunk). A block
//   whose split starts past its tile's live length (max q_pos + 1, capped
//   by kv_len) returns at once and the merge never reads it, so the plan
//   reads nothing back from the device.
// * Copies: one producer warp keeps a ring of kStages (4) in flight, each
//   stage 16 key positions of K and V, all heads of the block's group. A
//   position's heads are contiguous in both layouts, so lane j copies K's
//   row of position j and lane 16 + j V's, each one 1-D bulk copy
//   (cp.async.bulk: no tensor map, hence no host encode per call) into a
//   row padded by 16 bytes, so that ldmatrix reads the rows without bank
//   conflicts; one arrival a stage expects all of its bytes. A quantized
//   stage whose positions are one run of the cache (one head group; dense
//   rows, or pool blocks of a multiple of 16 positions) is one copy for K
//   and one for V, unpadded (its reader goes row by row). The lanes read
//   their table entries eight chunks ahead, all at once. Data stays in
//   the storage dtype; V rows past kv_len are zero filled (and their
//   scales set to 0), never read.
// * Products: bf16 runs on tensor cores, mma.sync m16n8k16 with f32
//   accumulation: Q.K^T per head over a 16-key chunk (q fragments built
//   from device memory, pre-scaled and rounded, the tile padded to 16
//   rows: at t = 1 every warp still works, on its own heads), the online
//   softmax on the accumulator fragments, and bf16(p).V with V's
//   fragments from ldmatrix.trans. Twelve consumer warps take the group's
//   heads in turn (h, h + 12, ...: one head each at lm_base). f32 compute
//   keeps exact f32 products on the CUDA cores: lanes (row, key) of a
//   4-row tile score two keys each and accumulate D/8 output columns.
// * Quantized stores: ldmatrix cannot transpose 8-bit data (V's B
//   fragments gather bytes from several rows), so the consumers turn each
//   stage's codes into a double-buffered compute-dtype tile, code x scale
//   rounded as the TPU kernel rounds, 16 codes a thread, and free the
//   stage at once; the products then read the tile as they read bf16.
// * Combine: with more than one split, each block writes its rows'
//   (m, l, f32 accumulator) to scratch and bumps its tile's counter; the
//   last block to finish merges the live splits of each (row, head) in
//   split order, in the same launch (a second merge kernel took the same
//   device time and a launch more for the host). A tile with nothing
//   live still runs split 0, which writes the neutral result (zeros).
//   With one split the block writes the output itself. Either way the
//   sums run in a fixed order: the output repeats bit for bit.
// The measured times, and the rejected alternatives, are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"
#include "mma.cuh"

// Build switches (scripts/paged_decode_ablation.py). PD_STAGES: the
// ring's depth. PD_ABLATE (timing only, the output is wrong): bit 1 skips
// the consumers' products and softmax, bit 2 the producer's copies.

#ifndef PD_STAGES
#define PD_STAGES 4
#endif
#ifndef PD_ABLATE
#define PD_ABLATE 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 16;  // key positions per ring stage
constexpr int kStages = PD_STAGES;
static_assert(kStages >= 2, "the ring needs two stages");
constexpr int kConsumerWarps = 12;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block may use
constexpr float kMaskValue = -3.4028234663852886e38f;  // finfo(f32).min
constexpr float kNegInit = -1e30f;  // running-max init: keeps exp() NaN-free

// Heads a consumer warp holds at once, by head dim (a block's group is at
// most kConsumerWarps times this).
__host__ __device__ constexpr int heads_per_warp(int d) { return d == 32 ? 2 : 1; }
// Query rows per tile: 16 (an m16 fragment) in bf16, 4 in f32.
__host__ __device__ constexpr int tile_rows(int compute_elem) { return compute_elem == 2 ? 16 : 4; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Storage formats of the cache. `raw` is the element type in memory;
// `kQuant` whether codes with scales beside them.
template <typename T>
struct StoreNative {
  using raw = T;
  static constexpr bool kQuant = false;
};
// decode2: the exact f32 values of two codes, the lower address in the
// low byte of `pair`.
struct StoreInt8 {
  using raw = int8_t;
  static constexpr bool kQuant = true;
  __device__ static void decode2(uint16_t pair, float& lo, float& hi) {
    lo = static_cast<float>(static_cast<int8_t>(pair & 0xff));
    hi = static_cast<float>(static_cast<int8_t>(pair >> 8));
  }
};
struct StoreFp8E4M3 {
  using raw = uint8_t;  // __nv_fp8_storage_t
  static constexpr bool kQuant = true;
  __device__ static void decode2(uint16_t pair, float& lo, float& hi) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
    lo = f.x;
    hi = f.y;
  }
};

// Shared-memory layout of a block (bytes; mirrored by
// ops/paged_decode._smem_bytes): the mbarriers and a flag, the f32 q tile, the ring
// (each stage K rows, V rows, then K and V scales when quantized) and,
// quantized, two dequantized [K rows, V rows] tiles.
struct Layout {
  int stride_s;   // a staged position row: G heads x D in the storage dtype (+ 16
                  // unless a stage is one copy)
  int stride_c;   // a q or dequantized row: G x D in the compute dtype, + 16
  int scale_off;  // the scales' offset within a stage
  int stage;      // bytes per stage
  int q_off, ring_off, tile_off, total;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

__host__ __device__ inline Layout layout(int G, int D, int store_elem, int compute_elem,
                                         bool quant, bool chunk_copy) {
  Layout L;
  L.stride_s = G * D * store_elem + (chunk_copy ? 0 : 16);
  L.stride_c = G * D * compute_elem + 16;
  L.scale_off = 2 * kChunk * L.stride_s;
  L.stage = align128(L.scale_off + (quant ? 2 * kChunk * G * 4 : 0));
  L.q_off = align128(2 * kStages * 8 + 4);  // the mbarriers, then the merge's flag
  // The q tile in f32 (bf16 builds its fragments from device memory).
  L.ring_off = align128(L.q_off + (compute_elem == 4 ? tile_rows(4) * L.stride_c : 0));
  L.tile_off = L.ring_off + kStages * L.stage;
  L.total = L.tile_off + (quant ? 2 * 2 * kChunk * L.stride_c : 0);
  return L;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* q_pos;
  const int* table;
  void* out;
  float* part_acc;  // [splits, B, t, H, D] (splits > 1)
  float* part_ml;   // [splits, B, t, H, 2]
  int* counters;    // [B, tiles, groups] zeros: splits done (in-kernel merge)
  int B, t, H, paged, bs, mb, cache_len, kv_len;
  int G, groups, splits, cps, drop_last;
  float scale;
};

// A quantized stage is one copy for K and one for V where its positions
// are one run of the cache: a single head group, dense rows or pool
// blocks of a multiple of 16 positions (ops/paged_decode._smem_bytes
// counts the rows' padding regardless: an upper bound).
template <typename S>
__host__ __device__ inline bool chunk_copy(const Params& p) {
  return S::kQuant && p.groups == 1 && (!p.paged || p.bs % kChunk == 0);
}

// Chunks of 16 keys a tile's rows reach, and the splits that hold them:
// at least split 0, which writes the neutral partial (or, alone, zeros)
// when nothing is live (kv_len 0, or every q_pos negative).
__device__ __forceinline__ void live_range(const Params& p, int b, int r0, int nrows, int& nch,
                                           int& live) {
  int maxpos = -1;
  for (int r = 0; r < nrows; ++r) maxpos = max(maxpos, p.q_pos[b * p.t + r0 + r]);
  const int kv_end = min(p.kv_len, maxpos + 1);
  nch = kv_end > 0 ? (kv_end + kChunk - 1) / kChunk : 0;
  live = max(1, (nch + p.cps - 1) / p.cps);
}

// ------------------------------------------------------------- producer

template <typename S, int D>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem, const Layout& L,
                                        int b, int h0, int hg, int c_begin, int n_my) {
  using R = typename S::raw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const int lane = threadIdx.x & 31, j = lane & 15;
  const bool is_v = lane >= 16;
  const R* src = static_cast<const R*>(is_v ? p.v : p.k);
  const uint32_t bytes = hg * D * sizeof(R);
  // Table entries are read kAhead chunks at a time, all loads in flight
  // together, so their latency is paid once per kAhead chunks.
  constexpr int kAhead = 8;
  for (int i0 = 0; i0 < n_my; i0 += kAhead) {
    long long rows[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int pos = (c_begin + i0 + a) * kChunk + j;
      rows[a] = -1;
      if (i0 + a < n_my && pos < p.kv_len)
        rows[a] = p.paged ? (long long)p.table[b * p.mb + pos / p.bs] * p.bs + pos % p.bs
                          : (long long)b * p.cache_len + pos;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int i = i0 + a;
      if (i >= n_my) break;
      const int st = i % kStages;
      if (i >= kStages) bulk::mbar_wait(empty + st, ((i / kStages) - 1) & 1);
      unsigned char* stage = smem + L.ring_off + st * L.stage;
      unsigned char* dst = stage + ((is_v ? kChunk : 0) + j) * L.stride_s;
      const long long row = rows[a];
      const bool valid = row >= 0;
      if constexpr (S::kQuant) {
        const float* sc = is_v ? p.vs : p.ks;
        float* sd =
            reinterpret_cast<float*>(stage + L.scale_off) + ((is_v ? kChunk : 0) + j) * p.G;
        for (int hh = 0; hh < hg; ++hh) sd[hh] = valid ? sc[row * p.H + h0 + hh] : 0.f;
      }
      if (!valid && is_v) {
        for (uint32_t o = 0; o < bytes; o += 16)
          *reinterpret_cast<uint4*>(dst + o) = make_uint4(0u, 0u, 0u, 0u);
        bulk::fence_proxy_async();  // before a later copy into this row
      }
      // One arrival a stage, after the warp's stores, expecting every row.
      const int n_valid = __popc(__ballot_sync(0xffffffffu, valid)) / 2;
      __syncwarp();
      if (PD_ABLATE & 2) {
        if (lane == 0) bulk::mbar_arrive_expect(full + st, 0u);
        continue;
      }
      if (lane == 0) bulk::mbar_arrive_expect(full + st, 2u * n_valid * bytes);
      if (chunk_copy<S>(p)) {  // the valid rows are one run: one copy each for K and V
        if (j == 0 && n_valid > 0)
          bulk::copy_1d(dst, src + (row * p.H + h0) * D, n_valid * bytes, full + st);
      } else if (valid) {
        bulk::copy_1d(dst, src + (row * p.H + h0) * D, bytes, full + st);
      }
    }
  }
}

// Quantized stage -> dequantized compute-dtype tile, by the consumers:
// kPerRow threads a row, 16 codes (one 16-byte load) a unit, kBatch
// units' loads in flight before any is converted.
template <typename T, typename S, int D>
__device__ __forceinline__ void dequantize(const unsigned char* stage, unsigned char* tile,
                                           const Layout& L, int G, int hg) {
  static_assert(kConsumers % (2 * kChunk) == 0, "threads split evenly over the stage's rows");
  constexpr int kPerRow = kConsumers / (2 * kChunk), kBatch = 4;
  const int row = threadIdx.x / kPerRow;  // K rows 0..15, V rows 16..31
  const int per_row = hg * D / 16;
  const unsigned char* src = stage + row * L.stride_s;
  const float* scales = reinterpret_cast<const float*>(stage + L.scale_off) + row * G;
  T* dst = reinterpret_cast<T*>(tile + row * L.stride_c);
  for (int c0 = threadIdx.x % kPerRow; c0 < per_row; c0 += kBatch * kPerRow) {
    uint4 raw[kBatch];
#pragma unroll
    for (int a = 0; a < kBatch; ++a) {
      const int cc = c0 + a * kPerRow;
      if (cc < per_row) raw[a] = *reinterpret_cast<const uint4*>(src + cc * 16);
    }
#pragma unroll
    for (int a = 0; a < kBatch; ++a) {
      const int cc = c0 + a * kPerRow;
      if (cc >= per_row) break;
      const float sc = scales[cc / (D / 16)];
      const uint32_t w[4] = {raw[a].x, raw[a].y, raw[a].z, raw[a].w};
      float x[16];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        S::decode2(static_cast<uint16_t>(w[e / 2] >> (16 * (e % 2))), x[2 * e], x[2 * e + 1]);
        x[2 * e] *= sc;
        x[2 * e + 1] *= sc;
      }
      T* d = dst + cc * 16;
      if constexpr (sizeof(T) == 2) {
        uint32_t o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = mma::pack_bf16(x[2 * e], x[2 * e + 1]);
        reinterpret_cast<uint4*>(d)[0] = make_uint4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<uint4*>(d)[1] = make_uint4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 16; e += 4)
          *reinterpret_cast<float4*>(d + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      }
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------ consumers

// The stage (or dequantized tile) of chunk i: K rows at *kt, V rows at
// *vt, `stride` bytes apart. Frees the stage at once when quantized.
template <typename T, typename S, int D>
__device__ __forceinline__ int ready_chunk(const Params& p, unsigned char* smem, const Layout& L,
                                           int i, int hg, const unsigned char** kt,
                                           const unsigned char** vt) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const int st = i % kStages;
  bulk::mbar_wait(full + st, (i / kStages) & 1);
  unsigned char* stage = smem + L.ring_off + st * L.stage;
  if constexpr (S::kQuant) {
    unsigned char* tile = smem + L.tile_off + (i & 1) * 2 * kChunk * L.stride_c;
    dequantize<T, S, D>(stage, tile, L, p.G, hg);
    consumers_sync();  // the tile is whole; nobody reads the stage again
    if ((threadIdx.x & 31) == 0) bulk::mbar_arrive(empty + st);
    *kt = tile;
    *vt = tile + kChunk * L.stride_c;
    return L.stride_c;
  } else {
    *kt = stage;
    *vt = stage + kChunk * L.stride_s;
    return L.stride_s;
  }
}

template <typename S>
__device__ __forceinline__ void release_chunk(const Params& p, unsigned char* smem, int i) {
  if constexpr (!S::kQuant) {
    uint64_t* empty = reinterpret_cast<uint64_t*>(smem) + kStages;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) bulk::mbar_arrive(empty + i % kStages);
  }
}

// After a block has written its partials: the last block of its (row b,
// q tile, head group) to finish (a counter, with fences, as in CUDA's
// threadFenceReduction) merges the live splits of each (row, head) in
// split order and resets the counter. Scratch: the block's shared memory
// past the barriers, free once the ring has drained.
template <typename T, int D>
__device__ __forceinline__ void merge_if_last(const Params& p, unsigned char* smem,
                                              const Layout& L, int b, int r0, int nrows, int h0,
                                              int hg, int live, int cidx) {
  int* last = reinterpret_cast<int*>(smem + 2 * kStages * 8);  // after the mbarriers
  consumers_sync();  // every partial of this block is written
  if (threadIdx.x == 0) {
    __threadfence();
    *last = atomicAdd(p.counters + cidx, 1) == live - 1;
  }
  consumers_sync();
  if (!*last) return;
  __threadfence();
  const long long plane = (long long)p.B * p.t * p.H;
  float* scratch = reinterpret_cast<float*>(smem + L.q_off);
  const int cap = (L.total - L.q_off) / 4 / (2 * live + 1);  // items a pass
  for (int i0 = 0; i0 < nrows * hg; i0 += cap) {
    const int items = min(cap, nrows * hg - i0);
    float* w = scratch;                   // [items][live]: m_s, then exp(m_s - max)
    float* ls = scratch + items * live;   // [items][live]: l_s
    float* inv = ls + items * live;       // [items]: 1 / l
    auto row_of = [&](int it) {
      const int j = i0 + it;
      return (long long)(b * p.t + r0 + j / hg) * p.H + h0 + j % hg;
    };
    for (int i = threadIdx.x; i < items * live; i += kConsumers) {  // all loads at once
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          p.part_ml + ((i % live) * plane + row_of(i / live)) * 2));
      w[i] = ml.x;
      ls[i] = ml.y;
    }
    consumers_sync();
    for (int it = threadIdx.x; it < items; it += kConsumers) {
      float mx = kNegInit;
      for (int s = 0; s < live; ++s) mx = fmaxf(mx, w[it * live + s]);
      float l = 0.f;
      for (int s = 0; s < live; ++s) {
        const float ws = expf(w[it * live + s] - mx);
        w[it * live + s] = ws;
        l += ls[it * live + s] * ws;
      }
      inv[it] = 1.f / (l == 0.f ? 1.f : l);
    }
    consumers_sync();
    constexpr int kBatch = 16;  // partial rows in flight a thread
    for (int i = threadIdx.x; i < items * D; i += kConsumers) {
      const int it = i / D, c = i % D;
      const long long row = row_of(it);
      float a = 0.f;
      for (int s0 = 0; s0 < live; s0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          v[k] = s0 + k < live ? __ldcg(p.part_acc + ((s0 + k) * plane + row) * D + c) : 0.f;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (s0 + k < live) a += v[k] * w[it * live + s0 + k];
      }
      static_cast<T*>(p.out)[row * D + c] = from_f32<T>(a * inv[it]);
    }
    consumers_sync();  // before the next pass rewrites the scratch
  }
  if (threadIdx.x == 0) p.counters[cidx] = 0;
}

// bf16 compute: tensor cores. Warp w holds heads w, w + 8, ... of the
// group: q fragments, the [16][D] accumulator and m, l of rows lane/4 and
// lane/4 + 8.
template <typename S, int D>
__device__ __forceinline__ void consume_mma(const Params& p, unsigned char* smem, const Layout& L,
                                            int b, int r0, int nrows, int h0, int hg,
                                            int c_begin, int n_my, int split, int live, int cidx) {
  constexpr int HPW = heads_per_warp(D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int mi = lane >> 3, rr = lane & 7;  // ldmatrix: this lane's matrix and row
  // q fragments straight from device memory, pre-scaled and rounded to
  // bf16; rows past t are zero.
  auto q_pair = [&](int row, int h, int col) -> uint32_t {
    if (row >= nrows) return 0u;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(p.q) + ((long long)(b * p.t + r0 + row) * p.H + h) * D + col);
    return mma::pack_bf16(__bfloat162float(v.x) * p.scale, __bfloat162float(v.y) * p.scale);
  };

  uint32_t qf[HPW][D / 16][4];
  float acc[HPW][D / 8][4], m[HPW][2], l[HPW][2];
#pragma unroll
  for (int hs = 0; hs < HPW; ++hs) {
    const int hh = warp + hs * kConsumerWarps;
    m[hs][0] = m[hs][1] = kNegInit;
    l[hs][0] = l[hs][1] = 0.f;
    mma::zero<D / 8>(acc[hs]);
    if (hh < hg) {
      const int row = lane >> 2, col = 2 * (lane & 3);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        qf[hs][ks][0] = q_pair(row, h0 + hh, ks * 16 + col);
        qf[hs][ks][1] = q_pair(row + 8, h0 + hh, ks * 16 + col);
        qf[hs][ks][2] = q_pair(row, h0 + hh, ks * 16 + col + 8);
        qf[hs][ks][3] = q_pair(row + 8, h0 + hh, ks * 16 + col + 8);
      }
    }
  }
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (lane >> 2) + 8 * h;
    pos[h] = r < nrows ? p.q_pos[b * p.t + r0 + r] : -1;
  }

  for (int i = 0; i < n_my; ++i) {
    const unsigned char *kt, *vt;
    const int stride = ready_chunk<bf16, S, D>(p, smem, L, i, hg, &kt, &vt);
    const int key0 = (c_begin + i) * kChunk;
#pragma unroll
    for (int hs = 0; hs < HPW; ++hs) {
      const int hh = warp + hs * kConsumerWarps;
      if (hh >= hg || (PD_ABLATE & 1)) continue;  // warp-uniform
      const unsigned char* kh = kt + hh * D * 2;
      const unsigned char* vh = vt + hh * D * 2;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0, b1, b2, b3;
        mma::ldsm_x4(kh + (rr + 8 * (mi >> 1)) * stride + (ks * 16 + 8 * (mi & 1)) * 2, b0, b1,
                     b2, b3);
        mma::mma16816(s[0], qf[hs][ks], b0, b1);
        mma::mma16816(s[1], qf[hs][ks], b2, b3);
      }
      float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * n + 2 * (lane & 3) + (e & 1);
          if (key > pos[e >> 1] || key >= p.kv_len) s[n][e] = kMaskValue;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      mma::quad_max(mx);
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[hs][h], mx[h]);
        alpha[h] = expf(m[hs][h] - m_new);
        m[hs][h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[hs][e >> 1]);
          ps[e >> 1] += s[n][e];
        }
      mma::quad_sum(ps);
#pragma unroll
      for (int h = 0; h < 2; ++h) l[hs][h] = l[hs][h] * alpha[h] + ps[h];
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[hs][nt][0] *= alpha[0];
        acc[hs][nt][1] *= alpha[0];
        acc[hs][nt][2] *= alpha[1];
        acc[hs][nt][3] *= alpha[1];
      }
      const uint32_t pa[4] = {mma::pack_bf16(s[0][0], s[0][1]), mma::pack_bf16(s[0][2], s[0][3]),
                              mma::pack_bf16(s[1][0], s[1][1]), mma::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t b0, b1, b2, b3;
        mma::ldsm_x4_t(reinterpret_cast<const bf16*>(vh + (rr + 8 * (mi & 1)) * stride +
                                                     (16 * jj + 8 * (mi >> 1)) * 2),
                       b0, b1, b2, b3);
        mma::mma16816(acc[hs][2 * jj], pa, b0, b1);
        mma::mma16816(acc[hs][2 * jj + 1], pa, b2, b3);
      }
    }
    release_chunk<S>(p, smem, i);
  }

#pragma unroll
  for (int hs = 0; hs < HPW; ++hs) {
    const int hh = warp + hs * kConsumerWarps;
    if (hh >= hg) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h;
      if (r >= nrows) continue;
      const long long row = ((long long)(b * p.t + r0 + r) * p.H + h0 + hh);
      if (p.splits == 1) {
        const float inv = 1.f / (l[hs][h] == 0.f ? 1.f : l[hs][h]);
        bf16* o = static_cast<bf16*>(p.out) + row * D;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(o + nt * 8 + 2 * (lane & 3)) =
              __floats2bfloat162_rn(acc[hs][nt][2 * h] * inv, acc[hs][nt][2 * h + 1] * inv);
      } else {
        const long long prow = (long long)split * p.B * p.t * p.H + row;
        float* o = p.part_acc + prow * D;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<float2*>(o + nt * 8 + 2 * (lane & 3)) =
              make_float2(acc[hs][nt][2 * h], acc[hs][nt][2 * h + 1]);
        if ((lane & 3) == 0)
          *reinterpret_cast<float2*>(p.part_ml + prow * 2) = make_float2(m[hs][h], l[hs][h]);
      }
    }
  }
  if (p.splits > 1) merge_if_last<bf16, D>(p, smem, L, b, r0, nrows, h0, hg, live, cidx);
}

// f32 compute: exact f32 products on the CUDA cores. Lane (r, kl) of a
// 4-row tile scores keys kl and kl + 8 of row r and accumulates columns
// kl, kl + 8, ... of it.
template <typename S, int D>
__device__ __forceinline__ void consume_fma(const Params& p, unsigned char* smem, const Layout& L,
                                            int b, int r0, int nrows, int h0, int hg,
                                            int c_begin, int n_my, int split, int live, int cidx) {
  constexpr int HPW = heads_per_warp(D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = lane >> 3, kl = lane & 7;
  const float* q_row = reinterpret_cast<const float*>(smem + L.q_off + r * L.stride_c);
  const int pos = r < nrows ? p.q_pos[b * p.t + r0 + r] : -1;

  float acc[HPW][D / 8], m[HPW], l[HPW];
#pragma unroll
  for (int hs = 0; hs < HPW; ++hs) {
    m[hs] = kNegInit;
    l[hs] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[hs][c] = 0.f;
  }

  for (int i = 0; i < n_my; ++i) {
    const unsigned char *kt, *vt;
    const int stride = ready_chunk<float, S, D>(p, smem, L, i, hg, &kt, &vt);
    const int key0 = (c_begin + i) * kChunk;
#pragma unroll
    for (int hs = 0; hs < HPW; ++hs) {
      const int hh = warp + hs * kConsumerWarps;
      if (hh >= hg) continue;  // warp-uniform
      const float* qh = q_row + hh * D;
      const float* k0 = reinterpret_cast<const float*>(kt + kl * stride) + hh * D;
      const float* k1 = reinterpret_cast<const float*>(kt + (kl + 8) * stride) + hh * D;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        s0 = fmaf(qh[c], k0[c], s0);
        s1 = fmaf(qh[c], k1[c], s1);
      }
      if (key0 + kl > pos || key0 + kl >= p.kv_len) s0 = kMaskValue;
      if (key0 + kl + 8 > pos || key0 + kl + 8 >= p.kv_len) s1 = kMaskValue;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[hs], mx);
      const float alpha = expf(m[hs] - m_new);
      m[hs] = m_new;
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[hs] = l[hs] * alpha + ps;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[hs][c] *= alpha;
      const float* vh = reinterpret_cast<const float*>(vt) + hh * D + kl;
#pragma unroll
      for (int jk = 0; jk < kChunk; ++jk) {
        const float pj = __shfl_sync(0xffffffffu, jk < 8 ? p0 : p1, (lane & ~7) | (jk & 7));
        const float* vr = reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(vh) +
                                                         jk * stride);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) acc[hs][c] = fmaf(pj, vr[8 * c], acc[hs][c]);
      }
    }
    release_chunk<S>(p, smem, i);
  }

#pragma unroll
  for (int hs = 0; hs < HPW; ++hs) {
    const int hh = warp + hs * kConsumerWarps;
    if (hh >= hg || r >= nrows) continue;
    const long long row = ((long long)(b * p.t + r0 + r) * p.H + h0 + hh);
    if (p.splits == 1) {
      const float inv = 1.f / (l[hs] == 0.f ? 1.f : l[hs]);
      float* o = static_cast<float*>(p.out) + row * D + kl;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) o[8 * c] = acc[hs][c] * inv;
    } else {
      const long long prow = (long long)split * p.B * p.t * p.H + row;
      float* o = p.part_acc + prow * D + kl;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) o[8 * c] = acc[hs][c];
      if (kl == 0) *reinterpret_cast<float2*>(p.part_ml + prow * 2) = make_float2(m[hs], l[hs]);
    }
  }
  if (p.splits > 1) merge_if_last<float, D>(p, smem, L, b, r0, nrows, h0, hg, live, cidx);
}

// Grid: (splits, tiles x groups, B), the split fastest.
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const __grid_constant__ Params p) {
  using R = typename S::raw;
  constexpr int TQ = tile_rows(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.G, D, sizeof(R), sizeof(T), S::kQuant, chunk_copy<S>(p));

  const int split = blockIdx.x;
  const int tile = blockIdx.y / p.groups, group = blockIdx.y % p.groups;
  const int b = blockIdx.z;
  const int r0 = tile * TQ, nrows = min(TQ, p.t - r0);
  const int h0 = group * p.G, hg = min(p.G, p.H - h0);
  int nch, live;
  live_range(p, b, r0, nrows, nch, live);
  if (split >= live) return;  // past the live length: never combined
  const int c_begin = split * p.cps;
  int c_end = min(c_begin + p.cps, nch);
  if (p.drop_last && split == live - 1) c_end = c_begin;  // the negative control
  const int n_my = max(0, c_end - c_begin);

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int s = 0; s < kStages; ++s) {
      bulk::mbar_init(bars + s, 1);                           // full: the producer
      bulk::mbar_init(bars + kStages + s, kConsumerWarps);  // empty: one per consumer warp
    }
    bulk::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the copies start while the consumers load q
    produce<S, D>(p, smem, L, b, h0, hg, c_begin, n_my);
    return;
  }
  const int cidx = blockIdx.y + gridDim.y * b;  // (b, tile, group)
  if constexpr (sizeof(T) == 2) {
    consume_mma<S, D>(p, smem, L, b, r0, nrows, h0, hg, c_begin, n_my, split, live, cidx);
  } else {
    // The f32 q tile, pre-scaled; rows past t zero.
    const float* q = static_cast<const float*>(p.q);
    for (int i = threadIdx.x; i < TQ * hg * D; i += kConsumers) {
      const int rq = i / (hg * D), c = i % (hg * D);
      reinterpret_cast<float*>(smem + L.q_off + rq * L.stride_c)[c] =
          rq < nrows ? q[((long long)(b * p.t + r0 + rq) * p.H + h0) * D + c] * p.scale : 0.f;
    }
    consumers_sync();
    consume_fma<S, D>(p, smem, L, b, r0, nrows, h0, hg, c_begin, n_my, split, live, cidx);
  }
}

template <typename T, typename S, int D>
int launch(const Params& p, cudaStream_t stream) {
  using R = typename S::raw;
  const Layout L = layout(p.G, D, sizeof(R), sizeof(T), S::kQuant, chunk_copy<S>(p));
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, S, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int tq = tile_rows(sizeof(T));
  const int tiles = (p.t + tq - 1) / tq;
  const dim3 grid(p.splits, tiles * p.groups, p.B);
  decode_attention_kernel<T, S, D><<<grid, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int dispatch_d(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, S, 32>(p, stream);
    case 64:
      return launch<T, S, 64>(p, stream);
    case 128:
      return launch<T, S, 128>(p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_store(int store, int d, const Params& p, cudaStream_t stream) {
  switch (store) {
    case 0:
      return dispatch_d<T, StoreNative<T>>(d, p, stream);
    case 1:
      return dispatch_d<T, StoreInt8>(d, p, stream);
    case 2:
      return dispatch_d<T, StoreFp8E4M3>(d, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (loaded with ctypes). dtype (of q and out): 0 = bf16,
// 1 = f32. store (of k and v): 0 = the compute dtype (k_scale, v_scale
// unused), 1 = int8 codes, 2 = float8_e4m3fn codes, each with f32
// scales [..., H, 1] laid out as k and v without their last axis.
// paged: 0 = dense rows [B, cache_len, H, D] (table unused), 1 = pool
// [nb, block_size, H, D] through table [B, mb]. The split plan (heads
// per group, groups, splits, chunks of 16 keys per split) is the
// caller's (ops/paged_decode.split_plan, for paged_decode_ring_stages()
// stages); with splits > 1, part_acc holds splits x B x t x H x D floats
// and part_ml twice splits x B x t x H, and counters B x tiles x groups
// ints that are zero on entry and left zero (the last block of each tile
// resets its own, so a counter buffer serves one stream at a time).
// drop_last_split != 0 drops each tile's last live split (a wrong
// variant, for negative controls). All tensors contiguous, q, k, v and
// out 16-byte aligned. Returns cudaGetLastError() after the launch (0 =
// ok; a plan whose shared memory does not fit returns
// cudaErrorInvalidValue).
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const float* k_scale, const float* v_scale,
    const int* q_pos, const int* table, void* out, float* part_acc, float* part_ml, int* counters,
    int batch, int t, int heads, int d, int paged, int block_size, int mb, int cache_len,
    int kv_len, int dtype, int store, int group_heads, int groups, int splits,
    int chunks_per_split, int drop_last_split, float scale, void* stream) {
  if (batch <= 0 || t <= 0 || heads <= 0 || group_heads <= 0 || groups <= 0 || splits <= 0 ||
      chunks_per_split <= 0 || batch > 65535 ||
      (long long)groups * group_heads < heads || (long long)(groups - 1) * group_heads >= heads ||
      group_heads > kConsumerWarps * heads_per_warp(d))
    return (int)cudaErrorInvalidValue;
  if (store != 0 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{q,      k,          v,     k_scale,   v_scale,   q_pos,
                 table,  out,        part_acc, part_ml, counters, batch,    t,
                 heads,  paged,      block_size, mb,    cache_len, kv_len,
                 group_heads, groups, splits, chunks_per_split, drop_last_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_store<bf16>(store, d, p, st);
  if (dtype == 1) return dispatch_store<float>(store, d, p, st);
  return (int)cudaErrorInvalidValue;
}

// The ring's depth this library was built with (split_plan sizes a
// block's shared memory by it).
extern "C" int paged_decode_ring_stages() { return kStages; }
