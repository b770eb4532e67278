// Flash attention on the CUDA cores, for the inputs csrc/flash.cu does not
// take: f32 q, k, v at any head dim up to 256, and bf16 at a head dim
// other than 32, 64, 96 or 128 (ViT-H/16's 80, packed attention's 16 or
// 256). Forward (out, LSE), dq, and dk/dv; sm_90a, f32 FMA, no tensor
// cores (TF32 would round the f32 inputs to 10 bits, which the JAX f32
// path does not).
//
// Replaces the Pallas TPU kernels of
// distributeddeeplearning_tpu/ops/pallas/flash.py (`_flash_fwd_kernel`,
// `_flash_bwd_dq_kernel`, `_flash_bwd_dkv_kernel`) where csrc/flash.cu
// refuses the input, and serves the packed-QKV attention of
// distributeddeeplearning_tpu/ops/pallas/flash_packed.py (`_fwd_kernel`,
// `_bwd_kernel`) where csrc/flash_packed.cu refuses it
// (ops/flash_packed.py reads q, k and v as strided column views of the
// [B, T, 3*H*d] projection and writes dq, dk, dv into views of one dqkv).
// Same contract as csrc/flash.cu, per (batch, head):
//   q [Tq, d], k/v [Tk, d], do [Tq, d] in T (float or bf16), read as
//       strided [B, T, H, d] views (the last dim contiguous; batch,
//       sequence and head strides in elements)
//   s   = f32(q . k^T) * scale; mask: key >= Tk, key > query when causal
//   forward: online softmax over key tiles (running max m, sum l of the
//            unrounded p), acc += T(p) . v in f32; o = T(acc / l),
//            lse = m + log(l) (l == 0 taken as 1)
//            kPacked (packed attention's numerics): p = exp(s - m) over the
//            row's full max m, found by a first pass over the keys
//   dq:   p = exp(s - lse), dp = do . v^T, ds = T(p * (dp - delta) * scale),
//         dq = sum of ds . k
//   dk/dv: dv = sum of T(p)^T . do, dk = sum of ds^T . q
// The T() roundings are the JAX kernels' rounding points; at f32 they do
// nothing. Rows past Tq (Tk) and columns past d load as zeros (a zero
// column adds nothing to any sum) and are never stored.
//
// What bounds it on an H100: the operations. lm_base training in f32 (B 8,
// H 12, T 1024, d 64, causal) is 12.9 GFLOP forward, 19.3 dq and 25.8
// dk/dv: 0.19, 0.29 and 0.39 ms at 67 TFLOP/s of f32 FMA, against 25-50
// MB of operands (8-15 us at 3.35 TB/s).
//
// Design (simple, SIMT): a block of 256 threads (16 x 16) owns R rows of
// one head (queries for the forward and dq, keys for dk/dv) and loops
// over the other sequence in tiles of C = 64. Every tile lands in shared
// memory as f32 rows of DP + 4 floats (DP = 64, 128 or 256: d rounded up;
// the 4 floats of padding put consecutive rows 4 banks apart, so the
// 16-byte reads of 8 rows by a quarter warp meet no bank twice). Thread
// (ty, tx) computes the scores of rows ty*RM .. ty*RM + RM - 1 against
// columns tx, tx + 16, tx + 32, tx + 48 of the tile (16-byte loads along
// d, a row's max and sum by shuffles over the 16 tx lanes), writes its
// rounded p (or ds) to shared memory, and then accumulates the same rows'
// output columns 4 tx .. 4 tx + 3 (+ 64 g) from 16-byte loads of V (K, dO,
// Q). Sums run in a fixed order and nothing is atomic: the outputs repeat
// bit for bit. The measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kC = 64;         // the streamed tile
constexpr int kLP = kC + 4;    // a row of the p / ds tile in shared memory
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
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
// x rounded to T and read back: a rounding point of the JAX kernels.
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f32<T>(from_f32<T>(x));
}

struct View {  // element strides of a [B, T, H, d] view; the last dim is contiguous
  long long b, t, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Tq] (backward)
  const float* delta;  // [B*H, Tq] (backward)
  void* o0;            // out, dq or dk
  void* o1;            // dv
  float* lse_out;      // [B*H, Tq] (forward)
  View vq, vk, vv, vdo, v0, v1;
  int H, Tq, Tk, d, causal, drop_last;
  float scale;
};

// Rows row0 .. row0 + R - 1 of head (b, h) of x into tile [R][DP + 4] as
// f32: zeros past n rows and d columns.
template <typename T, int R, int DP>
__device__ __forceinline__ void load_rows(float* tile, const void* x, View s, int b, int h,
                                          int row0, int n, int d) {
  const T* base = static_cast<const T*>(x) + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP, row = row0 + r;
    tile[r * (DP + 4) + c] = row < n && c < d ? to_f32<T>(base[row * s.t + c]) : 0.f;
  }
}

// Rows row0 .. of head (b, h) of an accumulator, each row divided by its
// div[i], into the strided view (rows < n, columns < d): thread (ty, tx)
// holds rows ty*RM + i, columns 4 tx + 64 g + e.
template <typename T, int RM, int G>
__device__ __forceinline__ void store_rows(void* x, View s, int b, int h, int row0, int n, int d,
                                           const float (&acc)[RM][G][4], const float (&div)[RM]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T* base = static_cast<T*>(x) + b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty * RM + i;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * tx + 64 * g + e;
        if (c < d) base[row * s.t + c] = from_f32<T>(acc[i][g][e] / div[i]);
      }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float lane_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = sum over c < dk of a[row i][c] * b[col j][c]: rows ty*RM + i of
// `a`, rows tx + 16 j of `b` (both [.][DP + 4] f32 tiles).
template <int RM, int DP>
__device__ __forceinline__ void scores(float (&s)[RM][4], const float* a, const float* b, int dk) {
  constexpr int LD = DP + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < dk; c += 4) {
    float4 av[RM], bv[4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * RM + i) * LD + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(av[i], bv[j], s[i][j]);
  }
}

// acc[i][g][e] += sum over n < kC of p[row i][n] * x[n][4 tx + 64 g + e]:
// p a [R][kLP] tile (rows ty*RM + i), x a [kC][DP + 4] tile.
template <int RM, int DP>
__device__ __forceinline__ void accumulate(float (&acc)[RM][DP / 64][4], const float* p,
                                           const float* x) {
  constexpr int LD = DP + 4, G = DP / 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int n0 = 0; n0 < kC; n0 += 4) {
    float4 pv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty * RM + i) * kLP + n0);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      float4 xv[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        xv[g] = *reinterpret_cast<const float4*>(x + (n0 + nn) * LD + 4 * tx + 64 * g);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pi = nn == 0 ? pv[i].x : nn == 1 ? pv[i].y : nn == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][g][0] = fmaf(pi, xv[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(pi, xv[g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(pi, xv[g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(pi, xv[g].w, acc[i][g][3]);
        }
      }
    }
  }
}

template <int RM, int G>
__device__ __forceinline__ void zero(float (&acc)[RM][G][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g][0] = acc[i][g][1] = acc[i][g][2] = acc[i][g][3] = 0.f;
}

__device__ __forceinline__ bool kept(const Params& p, int query, int key) {
  return key < p.Tk && query < p.Tq && (!p.causal || key <= query);
}

// Rows of a block: 64 queries (32 keys or queries at DP 256 in the
// backward, where two more tiles share the shared memory).
template <int DP>
__host__ __device__ constexpr int fwd_rows() {
  return 64;
}
template <int DP>
__host__ __device__ constexpr int bwd_rows() {
  return DP == 256 ? 32 : 64;
}
template <int DP>
__host__ __device__ constexpr int fwd_smem() {
  return (fwd_rows<DP>() * (DP + 4) + 2 * kC * (DP + 4) + fwd_rows<DP>() * kLP) * 4;
}
template <int DP>
__host__ __device__ constexpr int dq_smem() {
  return (2 * bwd_rows<DP>() * (DP + 4) + 2 * kC * (DP + 4) + bwd_rows<DP>() * kLP) * 4;
}
template <int DP>
__host__ __device__ constexpr int dkv_smem() {
  return (2 * bwd_rows<DP>() * (DP + 4) + 2 * kC * (DP + 4) + 2 * bwd_rows<DP>() * kLP + 2 * kC) *
         4;
}

// Forward: grid (query tiles, B*H).
template <typename T, int DP, bool kPacked>
__global__ void __launch_bounds__(kThreads) flash_generic_fwd_kernel(const __grid_constant__ Params p) {
  constexpr int R = fwd_rows<DP>(), RM = R / 16, G = DP / 64, LD = DP + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + R * LD;
  float* vs = ks + kC * LD;
  float* ps = vs + kC * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, q0 = blockIdx.x * R;
  const int dk = (p.d + 3) & ~3;
  load_rows<T, R, DP>(qs, p.q, p.vq, b, h, q0, p.Tq, p.d);
  const int kend = p.causal ? min(p.Tk, q0 + R) : p.Tk;
  int tiles = (kend + kC - 1) / kC;
  if (p.drop_last && tiles > 0) --tiles;  // the negative control

  float m[RM], l[RM], acc[RM][G][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) m[i] = kNegInf, l[i] = 0.f;
  zero(acc);
  float s[RM][4];

  if constexpr (kPacked) {  // the first pass: the row's full max
    for (int t = 0; t < tiles; ++t) {
      __syncthreads();
      load_rows<T, kC, DP>(ks, p.k, p.vk, b, h, t * kC, p.Tk, p.d);
      __syncthreads();
      scores<RM, DP>(s, qs, ks, dk);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kept(p, q0 + ty * RM + i, t * kC + tx + 16 * j))
            mx = fmaxf(mx, __fmul_rn(s[i][j], p.scale));
        m[i] = fmaxf(m[i], lane_max16(mx));
      }
    }
  }

  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // the last tile's readers are done
    load_rows<T, kC, DP>(ks, p.k, p.vk, b, h, t * kC, p.Tk, p.d);
    load_rows<T, kC, DP>(vs, p.v, p.vv, b, h, t * kC, p.Tk, p.d);
    __syncthreads();
    scores<RM, DP>(s, qs, ks, dk);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int query = q0 + ty * RM + i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = kept(p, query, t * kC + tx + 16 * j);
        s[i][j] = keep[j] ? __fmul_rn(s[i][j], p.scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      float alpha = 1.f;
      if constexpr (!kPacked) {
        const float m_new = fmaxf(m[i], lane_max16(mx));
        alpha = expf(m[i] - m_new);
        m[i] = m_new;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = keep[j] ? expf(s[i][j] - m[i]) : 0.f;
        sum += pj;
        ps[(ty * RM + i) * kLP + tx + 16 * j] = rounded<T>(pj);
      }
      l[i] = l[i] * alpha + lane_sum16(sum);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    __syncthreads();
    accumulate<RM, DP>(acc, ps, vs);
  }

  float l_safe[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) l_safe[i] = l[i] == 0.f ? 1.f : l[i];
  store_rows<T, RM, G>(p.o0, p.v0, b, h, q0, p.Tq, p.d, acc, l_safe);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int query = q0 + ty * RM + i;
      if (query < p.Tq) p.lse_out[(long long)blockIdx.y * p.Tq + query] = m[i] + logf(l_safe[i]);
    }
  }
}

// dq: grid (query tiles, B*H).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_generic_dq_kernel(const __grid_constant__ Params p) {
  constexpr int R = bwd_rows<DP>(), RM = R / 16, G = DP / 64, LD = DP + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + R * LD;
  float* ks = dos + R * LD;
  float* vs = ks + kC * LD;
  float* dss = vs + kC * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, q0 = blockIdx.x * R;
  const int dk = (p.d + 3) & ~3;
  load_rows<T, R, DP>(qs, p.q, p.vq, b, h, q0, p.Tq, p.d);
  load_rows<T, R, DP>(dos, p.dout, p.vdo, b, h, q0, p.Tq, p.d);
  float lse[RM], delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int query = q0 + ty * RM + i;
    const long long at = (long long)blockIdx.y * p.Tq + query;
    lse[i] = query < p.Tq ? p.lse[at] : 0.f;
    delta[i] = query < p.Tq ? p.delta[at] : 0.f;
  }
  const int kend = p.causal ? min(p.Tk, q0 + R) : p.Tk;
  const int tiles = (kend + kC - 1) / kC;
  float acc[RM][G][4], s[RM][4], dp[RM][4];
  zero(acc);
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();
    load_rows<T, kC, DP>(ks, p.k, p.vk, b, h, t * kC, p.Tk, p.d);
    load_rows<T, kC, DP>(vs, p.v, p.vv, b, h, t * kC, p.Tk, p.d);
    __syncthreads();
    scores<RM, DP>(s, qs, ks, dk);
    scores<RM, DP>(dp, dos, vs, dk);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = kept(p, q0 + ty * RM + i, t * kC + tx + 16 * j);
        const float pj = keep ? expf(__fmul_rn(s[i][j], p.scale) - lse[i]) : 0.f;
        dss[(ty * RM + i) * kLP + tx + 16 * j] =
            rounded<T>(__fmul_rn(__fmul_rn(pj, dp[i][j] - delta[i]), p.scale));
      }
    __syncthreads();
    accumulate<RM, DP>(acc, dss, ks);
  }
  float one[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) one[i] = 1.f;  // x / 1 == x: dq as summed
  store_rows<T, RM, G>(p.o0, p.v0, b, h, q0, p.Tq, p.d, acc, one);
}

// dk/dv: grid (key tiles, B*H); thread (ty, tx) owns keys ty*RM + i.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_generic_dkv_kernel(const __grid_constant__ Params p) {
  constexpr int R = bwd_rows<DP>(), RM = R / 16, G = DP / 64, LD = DP + 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + R * LD;
  float* qs = vs + R * LD;
  float* dos = qs + kC * LD;
  float* pts = dos + kC * LD;  // [key][query]: T(p)
  float* dsts = pts + R * kLP;  // [key][query]: T(ds)
  float* lse_s = dsts + R * kLP;
  float* delta_s = lse_s + kC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, k0 = blockIdx.x * R;
  const int dk = (p.d + 3) & ~3;
  load_rows<T, R, DP>(ks, p.k, p.vk, b, h, k0, p.Tk, p.d);
  load_rows<T, R, DP>(vs, p.v, p.vv, b, h, k0, p.Tk, p.d);
  // Causal: query tiles wholly before the first key hold nothing.
  const int first = p.causal ? k0 / kC : 0;
  const int tiles = (p.Tq + kC - 1) / kC;
  float dk_acc[RM][G][4], dv_acc[RM][G][4], s[RM][4], dp[RM][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int t = first; t < tiles; ++t) {
    const int q0 = t * kC;
    __syncthreads();
    load_rows<T, kC, DP>(qs, p.q, p.vq, b, h, q0, p.Tq, p.d);
    load_rows<T, kC, DP>(dos, p.dout, p.vdo, b, h, q0, p.Tq, p.d);
    for (int r = threadIdx.x; r < kC; r += kThreads) {
      const bool in = q0 + r < p.Tq;
      const long long at = (long long)blockIdx.y * p.Tq + q0 + r;
      lse_s[r] = in ? p.lse[at] : 0.f;
      delta_s[r] = in ? p.delta[at] : 0.f;
    }
    __syncthreads();
    scores<RM, DP>(s, ks, qs, dk);
    scores<RM, DP>(dp, vs, dos, dk);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool keep = kept(p, q0 + r, k0 + ty * RM + i);
        const float pj = keep ? expf(__fmul_rn(s[i][j], p.scale) - lse_s[r]) : 0.f;
        pts[(ty * RM + i) * kLP + r] = rounded<T>(pj);
        dsts[(ty * RM + i) * kLP + r] =
            rounded<T>(__fmul_rn(__fmul_rn(pj, dp[i][j] - delta_s[r]), p.scale));
      }
    __syncthreads();
    accumulate<RM, DP>(dv_acc, pts, dos);
    accumulate<RM, DP>(dk_acc, dsts, qs);
  }
  float one[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) one[i] = 1.f;
  store_rows<T, RM, G>(p.o0, p.v0, b, h, k0, p.Tk, p.d, dk_acc, one);
  store_rows<T, RM, G>(p.o1, p.v1, b, h, k0, p.Tk, p.d, dv_acc, one);
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// op: 0 forward, 1 dq, 2 dk/dv.
template <typename T, int DP>
int launch(int op, int packed, const Params& p, int B, cudaStream_t stream) {
  const int rows = op == 0 ? fwd_rows<DP>() : bwd_rows<DP>();
  const int n = op == 2 ? p.Tk : p.Tq;
  const dim3 grid((n + rows - 1) / rows, B * p.H);
  int rc = 0;
  if (op == 0 && packed) {
    static const int attr = prepare(flash_generic_fwd_kernel<T, DP, true>, fwd_smem<DP>());
    if ((rc = attr) != 0) return rc;
    flash_generic_fwd_kernel<T, DP, true><<<grid, kThreads, fwd_smem<DP>(), stream>>>(p);
  } else if (op == 0) {
    static const int attr = prepare(flash_generic_fwd_kernel<T, DP, false>, fwd_smem<DP>());
    if ((rc = attr) != 0) return rc;
    flash_generic_fwd_kernel<T, DP, false><<<grid, kThreads, fwd_smem<DP>(), stream>>>(p);
  } else if (op == 1) {
    static const int attr = prepare(flash_generic_dq_kernel<T, DP>, dq_smem<DP>());
    if ((rc = attr) != 0) return rc;
    flash_generic_dq_kernel<T, DP><<<grid, kThreads, dq_smem<DP>(), stream>>>(p);
  } else {
    static const int attr = prepare(flash_generic_dkv_kernel<T, DP>, dkv_smem<DP>());
    if ((rc = attr) != 0) return rc;
    flash_generic_dkv_kernel<T, DP><<<grid, kThreads, dkv_smem<DP>(), stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dp(int op, int packed, const Params& p, int B, cudaStream_t stream) {
  if (p.d <= 64) return launch<T, 64>(op, packed, p, B, stream);
  if (p.d <= 128) return launch<T, 128>(op, packed, p, B, stream);
  return launch<T, 256>(op, packed, p, B, stream);
}

int dispatch(int op, int dtype, int packed, const Params& p, int B, void* stream) {
  if (B < 1 || p.H < 1 || p.Tq < 1 || p.Tk < 1 || p.d < 1 || p.d > 256 || B * p.H > 65535 ||
      (p.causal && p.Tq != p.Tk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dp<bf16>(op, packed, p, B, s);
  if (dtype == 1) return dispatch_dp<float>(op, packed, p, B, s);
  return (int)cudaErrorInvalidValue;
}

View view(const long long* s) { return {s[0], s[1], s[2]}; }

}  // namespace

// C entry points (loaded with ctypes). dtype of q, k, v, do and the
// outputs: 0 = bf16, 1 = f32. strides: 3 element strides (batch,
// sequence, head) of each view in the order of the pointers; the last
// dim of each view contiguous. 1 <= d <= 256; causal needs Tq == Tk.
// lse (and delta) f32 contiguous [B*H, Tq]. Each returns
// cudaGetLastError() after its launch (0 = ok).

// views: q, k, v, out. packed != 0: packed attention's numerics (p over
// the row's full max). drop_last != 0 skips each row's last key tile (a
// wrong variant, for negative controls).
extern "C" int flash_generic_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                 const long long* strides, int B, int H, int Tq, int Tk, int D,
                                 int causal, float scale, int dtype, int packed, int drop_last,
                                 void* stream) {
  Params p = {};
  p.q = q, p.k = k, p.v = v, p.o0 = o, p.lse_out = lse;
  p.vq = view(strides), p.vk = view(strides + 3), p.vv = view(strides + 6);
  p.v0 = view(strides + 9);
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.d = D, p.causal = causal, p.scale = scale;
  p.drop_last = drop_last ? 1 : 0;
  return dispatch(0, dtype, packed, p, B, stream);
}

// views: q, k, v, do, dq.
extern "C" int flash_generic_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                    const float* lse, const float* delta, void* dq,
                                    const long long* strides, int B, int H, int Tq, int Tk, int D,
                                    int causal, float scale, int dtype, void* stream) {
  Params p = {};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.lse = lse, p.delta = delta, p.o0 = dq;
  p.vq = view(strides), p.vk = view(strides + 3), p.vv = view(strides + 6);
  p.vdo = view(strides + 9), p.v0 = view(strides + 12);
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.d = D, p.causal = causal, p.scale = scale;
  return dispatch(1, dtype, 0, p, B, stream);
}

// views: q, k, v, do, dk, dv.
extern "C" int flash_generic_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                     const float* lse, const float* delta, void* dk, void* dv,
                                     const long long* strides, int B, int H, int Tq, int Tk, int D,
                                     int causal, float scale, int dtype, void* stream) {
  Params p = {};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.lse = lse, p.delta = delta, p.o0 = dk, p.o1 = dv;
  p.vq = view(strides), p.vk = view(strides + 3), p.vv = view(strides + 6);
  p.vdo = view(strides + 9), p.v0 = view(strides + 12), p.v1 = view(strides + 15);
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.d = D, p.causal = causal, p.scale = scale;
  return dispatch(2, dtype, 0, p, B, stream);
}
