// Masked online-softmax decode attention over a dense row cache or a
// paged block pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// distributeddeeplearning_tpu/ops/pallas/paged_decode.py::fused_decode_attention
// (kernel body `_decode_kernel`). Same contract:
//   q      [B, t, H, D]   compute dtype (bf16 or f32)
//   k, v   dense [B, L, H, D] rows, or a paged pool [nb, bs, H, D]
//          read through an int32 block table [B, mb]
//   q_pos  [B, t] int32 absolute position of each query row
//   out    [B, t, H, D]   compute dtype
// Keys at positions > q_pos or >= kv_len are masked with finfo(f32).min;
// V is zeroed past kv_len (kills 0*NaN); q is pre-scaled by D**-0.5 and
// rounded to the compute dtype; scores, the running max m, the running
// sum l and the P.V accumulator are f32; p is rounded to the storage
// dtype before P.V; l == 0 maps to 1. Table entries past a row's live
// length point at trash block 0, whose contents may be garbage: masking,
// not residency, keeps them out.
//
// Design. One thread block per (q-tile of 16 query rows, head, batch
// row); the TPU's sequential K grid axis becomes a loop inside the
// block over chunks of 32 key positions, and the block loads its own
// table entries in place of the TPU's scalar prefetch. Each chunk of K
// and V is staged in shared memory as f32 (16-byte vector loads from
// device memory); K rows are padded to D+1 floats so that lane j reading
// key j is free of bank conflicts. Each warp owns query rows of the
// tile: lane j scores key j, the warp reduces max and sum with shuffles,
// and each lane accumulates D/32 output columns. The loop stops at the
// last chunk that max(q_pos) of the tile or kv_len reaches: a fully
// masked chunk contributes exact zeros (alpha = 1, p = 0), so stopping
// early does not change the result.
//
// What bounds it on an H100: the K/V bytes it must read. The serving
// decode step of lm_base at full depth reads 8 rows x 2048 positions x
// 768 x 2 B x 2 (K+V) = 50.3 MB per layer call, about 15 us at
// 3.35 TB/s; this simple kernel keeps one chunk in flight per block and
// does not reach that (PERF.md holds the measured times).

#include <cuda_bf16.h>
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

// Round an f32 value through the storage dtype (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ table,
                            T* __restrict__ out, int t, int heads, int paged,
                            int block_size, int mb, int cache_len, int kv_len,
                            float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  constexpr int kCols = D / 32;  // output columns per lane

  __shared__ float q_s[kTileQ][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];
  __shared__ long long key_off[kBlockK];  // element offset of key j's [D] row, -1 = none
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
      long long off = -1;
      if (pos < kv_len) {
        long long row;
        if (paged) {
          const int phys = table[b * mb + pos / block_size];
          row = (long long)phys * block_size + pos % block_size;
        } else {
          row = (long long)b * cache_len + pos;
        }
        off = (row * heads + h) * D;
      }
      key_off[tid] = off;
    }
    __syncthreads();

    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int j = i / kVecPerRow, cv = (i % kVecPerRow) * kVec;
      const long long off = key_off[j];
      alignas(16) T kt[kVec];
      alignas(16) T vt[kVec];
      if (off >= 0) {
        *reinterpret_cast<uint4*>(kt) = *reinterpret_cast<const uint4*>(k + off + cv);
        *reinterpret_cast<uint4*>(vt) = *reinterpret_cast<const uint4*>(v + off + cv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_s[j][cv + e] = to_f32(kt[e]);
          v_s[j][cv + e] = to_f32(vt[e]);
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

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* q_pos,
            const int* table, void* out, int batch, int t, int heads,
            int paged, int block_size, int mb, int cache_len, int kv_len,
            float scale, cudaStream_t stream) {
  const dim3 grid((t + kTileQ - 1) / kTileQ, heads, batch);
  decode_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, table, static_cast<T*>(out), t, heads,
      paged, block_size, mb, cache_len, kv_len, scale);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* q_pos,
               const int* table, void* out, int batch, int t, int heads,
               int d, int paged, int block_size, int mb, int cache_len,
               int kv_len, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      launch<T, 32>(q, k, v, q_pos, table, out, batch, t, heads, paged,
                    block_size, mb, cache_len, kv_len, scale, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, q_pos, table, out, batch, t, heads, paged,
                    block_size, mb, cache_len, kv_len, scale, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, q_pos, table, out, batch, t, heads, paged,
                     block_size, mb, cache_len, kv_len, scale, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). dtype: 0 = bf16, 1 = f32. paged: 0 =
// dense rows [B, cache_len, H, D] (table unused), 1 = pool
// [nb, block_size, H, D] through table [B, mb]. All tensors contiguous,
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const int* q_pos,
                                      const int* table, void* out, int batch,
                                      int t, int heads, int d, int paged,
                                      int block_size, int mb, int cache_len,
                                      int kv_len, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || t <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(q, k, v, q_pos, table, out, batch, t,
                                     heads, d, paged, block_size, mb,
                                     cache_len, kv_len, scale, s);
  if (dtype == 1)
    return dispatch_d<float>(q, k, v, q_pos, table, out, batch, t, heads, d,
                             paged, block_size, mb, cache_len, kv_len, scale,
                             s);
  return (int)cudaErrorInvalidValue;
}
