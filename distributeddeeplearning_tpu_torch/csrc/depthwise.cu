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
// Design. The TPU kernels hold whole images in VMEM and build a padded
// window per 16-row strip; Mosaic could not keep the K*K accumulation in
// registers, which is why they lost to XLA's grouped conv (PROFILE.md,
// round 4). Here:
// * One block owns a tile of 8 output rows x 12 output columns x 32
//   channels of one image (the wgrad block walks all row tiles of a column
//   strip). It stages the tile's input rows and columns plus the P-wide
//   halo into shared memory as f32, zero-filled outside the image and past
//   C. Channels are the fastest index: where C is a multiple of the 16-byte
//   vector (8 bf16, 4 f32) a thread loads 16 bytes at once, else one
//   element. All of a thread's loads are issued before any is stored, so
//   each warp keeps several in flight. The channel tile is the fastest
//   block index, so the blocks that share a pixel's cache lines run
//   together.
// * Thread (channel tx, row ty) keeps its 12 outputs of row ty in f32
//   registers through all K*K taps: for each tap row it reads the 12+K-1
//   inputs it needs from shared memory once and applies all K taps of that
//   row to them. Its channel's taps sit in registers, read once.
// * The dgrad is the same kernel reading the tap table reversed (the
//   `flip` argument; the TPU code reverses the table, `wt[::-1]`).
// * The wgrad thread keeps its K*K per-channel sums in f32 registers over
//   its rows; the block then sums its 8 rows of threads in shared memory
//   in a fixed order and writes one partial row per (image, column strip);
//   a second kernel sums the partials in a fixed order. No atomics: dw
//   repeats bit for bit, like the TPU's partials-then-sum.
// * K in {3, 5, 7} is compiled with K fixed, so the loops unroll and the
//   arrays stay in registers. Any other odd K takes a direct kernel (one
//   thread per output, taps read from global memory) and a direct wgrad
//   (one block per tap and 32 channels): right, not fast.
//
// What bounds it on an H100: bytes. EfficientNet-B4's stride-1 layers at
// batch 64 do 2*K*K flops per output element against 4 bytes (bf16 in and
// out): 190^2 x 48, K 3 moves 444 MB (133 us at 3.35 TB/s) for 2.0 GFLOP
// (30 us at 67 TFLOP/s of f32 FMA). The halo is re-read from L2 (1.5x the
// tile's inputs at K 3, 2x at K 5), the last channel tile of C = 48 or
// C = 24 leaves lanes idle, each thread stores 2-byte outputs, and the
// wgrad re-stages its halo rows for each row tile; PERF.md holds the
// measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCB = 32;              // channels per block: one warp's lanes
constexpr int kTH = 8;               // output rows per tile: one warp each
constexpr int kTW = 12;              // output columns per thread
constexpr int kThreads = kCB * kTH;  // 256

using bf16 = __nv_bfloat16;

struct Shape {
  int B, H, W, C;
};

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

// wgrad partials: part[b * tiles_w + column tile][t][c]. Grid: (channel
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

template <typename T, int K>
int launch_wgrad(const void* x, const void* dy, float* part, float* dw, Shape s,
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
  const int n = K * K * s.C;
  dwconv_sum_partials_kernel<<<(n + 31) / 32, 1024, 0, stream>>>(part, dw, s.B * tiles_w, n);
  return (int)cudaGetLastError();
}

template <typename T>
int stencil(const void* x, const float* taps, void* y, Shape s, int K, int flip,
            cudaStream_t stream) {
  switch (K) {
    case 3: return launch_stencil<T, 3>(x, taps, y, s, flip, stream);
    case 5: return launch_stencil<T, 5>(x, taps, y, s, flip, stream);
    case 7: return launch_stencil<T, 7>(x, taps, y, s, flip, stream);
    default: {
      const long long n = static_cast<long long>(s.B) * s.H * s.W * s.C;
      dwconv_stencil_direct_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                        stream>>>(static_cast<const T*>(x), taps,
                                                  static_cast<T*>(y), s, K, flip);
      return (int)cudaGetLastError();
    }
  }
}

template <typename T>
int wgrad(const void* x, const void* dy, float* part, float* dw, Shape s, int K,
          cudaStream_t stream) {
  switch (K) {
    case 3: return launch_wgrad<T, 3>(x, dy, part, dw, s, stream);
    case 5: return launch_wgrad<T, 5>(x, dy, part, dw, s, stream);
    case 7: return launch_wgrad<T, 7>(x, dy, part, dw, s, stream);
    default:
      dwconv_wgrad_direct_kernel<T><<<dim3((s.C + kCB - 1) / kCB, K * K), kThreads, 0,
                                      stream>>>(static_cast<const T*>(x),
                                                static_cast<const T*>(dy), dw, s, K);
      return (int)cudaGetLastError();
  }
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
// (flip = 1: the dgrad, x = dy, y = dx).
extern "C" int depthwise_stencil(const void* x, const float* taps, void* y, int B, int H, int W,
                                 int C, int K, int dtype, int flip, void* stream) {
  if (!valid(B, H, W, C, K, dtype)) return (int)cudaErrorInvalidValue;
  const Shape s = {B, H, W, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? stencil<bf16>(x, taps, y, s, K, flip, st)
                    : stencil<float>(x, taps, y, s, K, flip, st);
}

// Rows of the wgrad's partial buffer (each K*K*C floats): 0 when K takes
// the direct kernel, which needs none.
extern "C" int depthwise_wgrad_partials(int B, int W, int K) {
  return (K == 3 || K == 5 || K == 7) ? B * ((W + kTW - 1) / kTW) : 0;
}

// dw = the wgrad of x and dy; part holds depthwise_wgrad_partials() rows.
extern "C" int depthwise_wgrad(const void* x, const void* dy, float* part, float* dw, int B,
                               int H, int W, int C, int K, int dtype, void* stream) {
  if (!valid(B, H, W, C, K, dtype)) return (int)cudaErrorInvalidValue;
  const Shape s = {B, H, W, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? wgrad<bf16>(x, dy, part, dw, s, K, st)
                    : wgrad<float>(x, dy, part, dw, s, K, st);
}
