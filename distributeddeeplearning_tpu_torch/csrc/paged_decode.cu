// Masked online-softmax decode attention over a dense row cache or a
// paged block pool, for Hopper (sm_90a), with the cache stored in the
// compute dtype or quantized (int8 or fp8 e4m3 codes with f32 scales,
// dequantized in registers).
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
// Design. One thread block per (q-tile of 16 query rows, head, batch
// row); the TPU's sequential K grid axis becomes a loop inside the
// block over chunks of 32 key positions, and the block loads its own
// table entries (and, quantized, the chunk's 32 K and 32 V scales of
// its head) in place of the TPU's scalar prefetch. Each chunk of K and
// V is staged in shared memory as f32, dequantized while it is written
// there (16-byte vector loads from device memory: 8 bf16 or 16 8-bit
// codes); K rows are padded to D+1 floats so that lane j reading key j
// is free of bank conflicts. Each warp owns query rows of the tile:
// lane j scores key j, the warp reduces max and sum with shuffles, and
// each lane accumulates D/32 output columns. The loop stops at the last
// chunk that max(q_pos) of the tile or kv_len reaches: a fully masked
// chunk contributes exact zeros (alpha = 1, p = 0), so stopping early
// does not change the result.
//
// What bounds it on an H100: the K/V bytes it must read. The serving
// decode step of lm_base at full depth reads 8 rows x 2048 positions x
// 768 x 2 B x 2 (K+V) = 50.3 MB per layer call in bf16, about 15 us at
// 3.35 TB/s; quantized, 25.2 MB of codes + 1.6 MB of scales, about
// 8.0 us. This simple kernel keeps one chunk in flight per block and
// does not reach either (PERF.md holds the measured times).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 32;  // key positions per chunk: one per lane
constexpr int kTileQ = 16;   // query rows per thread block
constexpr int kRowsPerWarp = kTileQ / kWarps;
constexpr float kMaskValue = -3.4028234663852886e38f;  // finfo(f32).min
constexpr float kNegInit = -1e30f;  // running-max init: keeps exp() NaN-free

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an f32 value through the compute dtype (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Storage formats of the cache. `raw` is the element type in memory;
// `decode` its exact f32 value (a code, before the scale); `kQuant`
// whether scales come beside it.
template <typename T>
struct StoreNative {
  using raw = T;
  static constexpr bool kQuant = false;
  __device__ static float decode(raw x) { return to_f32(x); }
};
struct StoreInt8 {
  using raw = int8_t;
  static constexpr bool kQuant = true;
  __device__ static float decode(raw x) { return static_cast<float>(x); }
};
struct StoreFp8E4M3 {
  using raw = uint8_t;  // __nv_fp8_storage_t
  static constexpr bool kQuant = true;
  __device__ static float decode(raw x) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q,
                            const typename S::raw* __restrict__ k,
                            const typename S::raw* __restrict__ v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ table,
                            T* __restrict__ out, int t, int heads, int paged,
                            int block_size, int mb, int cache_len, int kv_len,
                            float scale) {
  using R = typename S::raw;
  constexpr int kVec = 16 / sizeof(R);  // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  constexpr int kCols = D / 32;  // output columns per lane

  __shared__ float q_s[kTileQ][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];
  __shared__ long long key_row[kBlockK];  // (row * heads + h) of key j, -1 = none
  __shared__ float ks_s[kBlockK];  // key j's K and V scales (quantized)
  __shared__ float vs_s[kBlockK];
  __shared__ int tile_max_pos;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = min(kTileQ, t - r0);

  // Query tile, pre-scaled and rounded to the compute dtype.
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const long long off = ((long long)(b * t + r0 + r) * heads + h) * D + c;
    q_s[r][c] = round_to<T>(to_f32(q[off]) * scale);
  }
  if (tid == 0) {
    int mx = -1;
    for (int r = 0; r < nrows; ++r) mx = max(mx, q_pos[b * t + r0 + r]);
    tile_max_pos = mx;
  }

  int my_pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    my_pos[i] = r < nrows ? q_pos[b * t + r0 + r] : -1;
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  const int kv_end = min(kv_len, tile_max_pos + 1);
  for (int c0 = 0; c0 < kv_end; c0 += kBlockK) {
    if (tid < kBlockK) {
      const int pos = c0 + tid;
      long long kr = -1;
      if (pos < kv_len) {
        long long row;
        if (paged) {
          const int phys = table[b * mb + pos / block_size];
          row = (long long)phys * block_size + pos % block_size;
        } else {
          row = (long long)b * cache_len + pos;
        }
        kr = row * heads + h;
      }
      key_row[tid] = kr;
      if constexpr (S::kQuant) {
        ks_s[tid] = kr >= 0 ? k_scale[kr] : 0.f;
        vs_s[tid] = kr >= 0 ? v_scale[kr] : 0.f;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int j = i / kVecPerRow, cv = (i % kVecPerRow) * kVec;
      const long long kr = key_row[j];
      alignas(16) R kt[kVec];
      alignas(16) R vt[kVec];
      if (kr >= 0) {
        const long long off = kr * D + cv;
        *reinterpret_cast<uint4*>(kt) = *reinterpret_cast<const uint4*>(k + off);
        *reinterpret_cast<uint4*>(vt) = *reinterpret_cast<const uint4*>(v + off);
        if constexpr (S::kQuant) {
          const float sk = ks_s[j], sv = vs_s[j];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            k_s[j][cv + e] = round_to<T>(S::decode(kt[e]) * sk);
            v_s[j][cv + e] = round_to<T>(S::decode(vt[e]) * sv);
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            k_s[j][cv + e] = S::decode(kt[e]);
            v_s[j][cv + e] = S::decode(vt[e]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_s[j][cv + e] = 0.f;
          v_s[j][cv + e] = 0.f;
        }
      }
    }
    __syncthreads();

    const int kidx = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      if (r >= nrows) continue;  // warp-uniform
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(q_s[r][c], k_s[lane][c], s);
      if (kidx > my_pos[i] || kidx >= kv_len) s = kMaskValue;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(s - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pj, v_s[j][lane + 32 * c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r >= nrows) continue;
    const float inv_l = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    const long long base = ((long long)(b * t + r0 + r) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      out[base + lane + 32 * c] = from_f32<T>(acc[i][c] * inv_l);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* q_pos;
  const int* table;
  void* out;
  int batch, t, heads, paged, block_size, mb, cache_len, kv_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename S, int D>
int launch(const Args& a) {
  using R = typename S::raw;
  const dim3 grid((a.t + kTileQ - 1) / kTileQ, a.heads, a.batch);
  decode_attention_kernel<T, S, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const R*>(a.k),
      static_cast<const R*>(a.v), a.k_scale, a.v_scale, a.q_pos, a.table,
      static_cast<T*>(a.out), a.t, a.heads, a.paged, a.block_size, a.mb,
      a.cache_len, a.kv_len, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int dispatch_d(int d, const Args& a) {
  switch (d) {
    case 32:
      return launch<T, S, 32>(a);
    case 64:
      return launch<T, S, 64>(a);
    case 128:
      return launch<T, S, 128>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_store(int store, int d, const Args& a) {
  switch (store) {
    case 0:
      return dispatch_d<T, StoreNative<T>>(d, a);
    case 1:
      return dispatch_d<T, StoreInt8>(d, a);
    case 2:
      return dispatch_d<T, StoreFp8E4M3>(d, a);
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
// [nb, block_size, H, D] through table [B, mb]. All tensors contiguous,
// q, k, v and out 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 = ok).
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const float* k_scale,
                                      const float* v_scale, const int* q_pos,
                                      const int* table, void* out, int batch,
                                      int t, int heads, int d, int paged,
                                      int block_size, int mb, int cache_len,
                                      int kv_len, int dtype, int store,
                                      float scale, void* stream) {
  if (batch <= 0 || t <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if (store != 0 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, q_pos, table, out, batch, t, heads,
               paged, block_size, mb, cache_len, kv_len, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_store<__nv_bfloat16>(store, d, a);
  if (dtype == 1) return dispatch_store<float>(store, d, a);
  return (int)cudaErrorInvalidValue;
}
