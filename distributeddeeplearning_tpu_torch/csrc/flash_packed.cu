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
// T = 512). An H100 block has at most 227 KB of shared memory, and one
// 197 x 197 f32 tile alone is 155 KB, so both kernels stream 64-wide
// tiles, as flash.cu does, with its mma.sync m16n8k16 products from
// ldmatrix fragments (the score accumulators become the next product's A
// fragment in registers; p and ds never touch memory).
// * Forward: one block of 4 warps per (b, h, 64-query tile). Two passes
//   over the key tiles: the first takes each row's max, the second
//   computes p = exp(s - m) with the row's final max, rounds it to bf16
//   for P.V and sums l from the unrounded p: the TPU kernel's rounding
//   points exactly, at the cost of a second Q.K^T.
// * Backward: T <= 512, so one block can own a whole (b, h). Blocks
//   (bh, 0) compute m, l (online, f32) and delta for every row into shared
//   memory, then walk the key tiles with dk and dv in registers, each
//   looping over the query tiles; blocks (bh, 1 + i) compute dq of query
//   tile i, their rows' m, l and delta first. No atomics: gradients repeat
//   bit for bit. Both kinds of blocks share one launch; the long dk/dv
//   blocks come first in the grid's order, so they start first.
//
// What bounds it on an H100 (ViT-B/16 training: B = 64, T = 197, H = 12,
// D = 64): the forward moves qkv in (58.1 MB) and o out (19.4 MB), 23.1 us
// at 3.35 TB/s, against 7.6 GFLOP (7.7 us at 989 TFLOP/s); the backward
// moves qkv, o and dO in (96.9 MB) and dqkv out (58.1 MB), 46.3 us,
// against 19.1 GFLOP (19.3 us). Both are byte-bound at this T. mma.sync
// from one cp.async stage reaches a part of the card's rate, and the
// second Q.K^T pass and the recomputed statistics add work; PERF.md holds
// the measured times.

#include "mma.cuh"

namespace {

using namespace mma;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows of a forward or dq block: 16 per warp
constexpr int kCols = 64;      // key tile
constexpr int kMaxT = 512;     // the TPU kernel's MAX_T

struct Params {
  const bf16* qkv;   // [B, T, 3*H*D]
  const bf16* out;   // forward: written; backward: read. [B, T, H*D]
  const bf16* dout;  // backward: [B, T, H*D]
  bf16* o;           // forward output
  bf16* dqkv;        // backward output: [B, T, 3*H*D]
  int H, T, causal, drop_last;
  float scale;
};

// Key tiles query tile q0 needs: all, or up to its diagonal when causal.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int tiles = (p.T + kCols - 1) / kCols;
  if (p.causal) tiles = min(tiles, (q0 + kRows - 1) / kCols + 1);
  return tiles;
}

__device__ __forceinline__ bool kept(const Params& p, int row, int col) {
  return col < p.T && row < p.T && (!p.causal || col <= row);
}

// s[NT][4] = scale * (the warp's 16 rows of sq) . (key tile at k0)^T, masked
// entries at kNegInf. Rows of this thread: row0 and row0 + 8.
template <int D, int NT>
__device__ __forceinline__ void scores(float (*s)[4], const bf16* sq, const bf16* sk,
                                       const Params& p, int row0, int k0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  zero<NT>(s);
  gemm_abt<D, NT>(s, sq, warp * 16, sk);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + ni * 8 + (lane & 3) * 2 + (e & 1);
      s[ni][e] = kept(p, row0 + (e >> 1) * 8, col) ? s[ni][e] * p.scale : kNegInf;
    }
}

// m and l of this thread's two rows (row0, row0 + 8) over `tiles` key
// tiles, with the online recurrence in f32 (l of exp(s - m) for the row's
// final m, summed in another order). sq holds the warp's rows; sk is the
// key tile buffer, refilled here.
template <int D>
__device__ void row_stats(const bf16* sq, bf16* sk, const bf16* kb, long long ld,
                          const Params& p, int row0, int tiles, float* m, float* l) {
  constexpr int NT = kCols / 8;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<kCols, D>(sk, kb, ld, j * kCols, p.T);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4];
    scores<D, NT>(s, sq, sk, p, row0, j * kCols);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[ni][e]);
    quad_max(mx);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum[e >> 1] += s[ni][e] == kNegInf ? 0.f : exp_f32(s[ni][e] - mx[e >> 1]);
    quad_sum(sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * exp_f32(m[r] - mx[r]) + sum[r];
      m[r] = mx[r];
    }
  }
}

// delta[r - r0] = rowsum(f32(dO) * f32(o)) for rows r0 <= r < min(r1, T):
// one warp per row, a fixed order of sums.
template <int D>
__device__ void row_deltas(float* delta, const bf16* dob, const bf16* ob, long long ld, int r0,
                           int r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = r0 + warp; r < r1; r += kThreads / 32) {
    float acc = 0.f;
#pragma unroll
    for (int i = lane; i < D; i += 32)
      acc += __bfloat162float(dob[(long long)r * ld + i]) * __bfloat162float(ob[(long long)r * ld + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[r - r0] = acc;
  }
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kThreads) packed_fwd_kernel(Params p) {
  constexpr int P = D + 8;
  constexpr int NT = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kRows * P;
  bf16* sv = sk + kCols * P;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const long long ld = 3LL * p.H * D;
  const bf16* qb = p.qkv + (long long)b * p.T * ld + h * D;
  const bf16* kb = qb + p.H * D;
  const bf16* vb = kb + p.H * D;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8

  load_tile<kRows, D>(sq, qb, ld, q0, p.T);
  cp_async_commit();
  const int tiles = key_tiles(p, q0) - p.drop_last;  // drop_last: a negative control

  // Pass 1: each row's max over its kept keys.
  float m[2] = {kNegInf, kNegInf};
  for (int j = 0; j < tiles; ++j) {
    __syncthreads();
    load_tile<kCols, D>(sk, kb, ld, j * kCols, p.T);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4];
    scores<D, NT>(s, sq, sk, p, row0, j * kCols);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[ni][e]);
  }
  quad_max(m);

  // Pass 2: p = exp(s - m), l = sum(p), acc = sum(bf16(p) . v).
  float acc[D / 8][4];
  zero<D / 8>(acc);
  float l[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    __syncthreads();
    load_tile<kCols, D>(sk, kb, ld, j * kCols, p.T);
    load_tile<kCols, D>(sv, vb, ld, j * kCols, p.T);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4];
    scores<D, NT>(s, sq, sk, p, row0, j * kCols);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = s[ni][e] == kNegInf ? 0.f : exp_f32(s[ni][e] - m[e >> 1]);
        l[e >> 1] += s[ni][e];
      }
    gemm_xb<D, NT>(acc, s, sv);
  }
  quad_sum(l);
  const long long ldo = (long long)p.H * D;
  store_rows<D>(p.o + (long long)b * p.T * ldo + h * D, ldo, row0, p.T, acc,
                1.f / (l[0] == 0.f ? 1.f : l[0]), 1.f / (l[1] == 0.f ? 1.f : l[1]));
}

// ---------------------------------------------------------------- backward

template <int D>
__device__ void bwd_dq(const Params& p, unsigned char* smem, int q0, int b, int h) {
  constexpr int P = D + 8;
  constexpr int NT = kCols / 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kRows * P;
  bf16* sk = sdo + kRows * P;
  bf16* sv = sk + kCols * P;
  float* sdelta = reinterpret_cast<float*>(sv + kCols * P);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ld = 3LL * p.H * D, ldo = (long long)p.H * D;
  const bf16* qb = p.qkv + (long long)b * p.T * ld + h * D;
  const bf16* kb = qb + p.H * D;
  const bf16* vb = kb + p.H * D;
  const bf16* dob = p.dout + (long long)b * p.T * ldo + h * D;
  const bf16* ob = p.out + (long long)b * p.T * ldo + h * D;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_tile<kRows, D>(sq, qb, ld, q0, p.T);
  load_tile<kRows, D>(sdo, dob, ldo, q0, p.T);
  cp_async_commit();
  row_deltas<D>(sdelta, dob, ob, ldo, q0, min(q0 + kRows, p.T));
  const int tiles = key_tiles(p, q0);
  float m[2], l[2];
  row_stats<D>(sq, sk, kb, ld, p, row0, tiles, m, l);  // syncs: sdelta is visible after
  float inv[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    delta[r] = row0 + r * 8 < p.T ? sdelta[row0 + r * 8 - q0] : 0.f;
  }

  float dq[D / 8][4];
  zero<D / 8>(dq);
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * kCols;
    __syncthreads();
    load_tile<kCols, D>(sk, kb, ld, k0, p.T);
    load_tile<kCols, D>(sv, vb, ld, k0, p.T);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    scores<D, NT>(s, sq, sk, p, row0, k0);
    zero<NT>(dp);
    gemm_abt<D, NT>(dp, sdo, warp * 16, sv);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pn = s[ni][e] == kNegInf ? 0.f : exp_f32(s[ni][e] - m[r]) * inv[r];
        s[ni][e] = pn * (dp[ni][e] - delta[r]) * p.scale;  // ds
      }
    gemm_xb<D, NT>(dq, s, sk);
  }
  store_rows<D>(p.dqkv + (long long)b * p.T * ld + h * D, ld, row0, p.T, dq, 1.f, 1.f);
}

template <int D>
__device__ void bwd_dkv(const Params& p, unsigned char* smem, int b, int h) {
  constexpr int P = D + 8;
  constexpr int BQ = D >= 128 ? 32 : 64;  // query tile of the dk/dv loop (bounds registers)
  constexpr int NT = BQ / 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // kRows rows (statistics), then BQ
  bf16* sdo = sq + kRows * P;
  bf16* sk = sdo + kRows * P;
  bf16* sv = sk + kCols * P;
  float* sm = reinterpret_cast<float*>(sv + kCols * P);  // [kMaxT] each
  float* sinv = sm + kMaxT;
  float* sdelta = sinv + kMaxT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ld = 3LL * p.H * D, ldo = (long long)p.H * D;
  const bf16* qb = p.qkv + (long long)b * p.T * ld + h * D;
  const bf16* kb = qb + p.H * D;
  const bf16* vb = kb + p.H * D;
  const bf16* dob = p.dout + (long long)b * p.T * ldo + h * D;
  const bf16* ob = p.out + (long long)b * p.T * ldo + h * D;
  bf16* dkb = p.dqkv + (long long)b * p.T * ld + p.H * D + h * D;
  bf16* dvb = dkb + p.H * D;

  // Statistics of every row, in 64-row tiles as the dq blocks take them.
  row_deltas<D>(sdelta, dob, ob, ldo, 0, p.T);
  for (int q0 = 0; q0 < p.T; q0 += kRows) {
    __syncthreads();  // every warp is done with sq
    load_tile<kRows, D>(sq, qb, ld, q0, p.T);
    cp_async_commit();
    const int row0 = q0 + warp * 16 + (lane >> 2);
    float m[2], l[2];
    row_stats<D>(sq, sk, kb, ld, p, row0, key_tiles(p, q0), m, l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if ((lane & 3) == 0 && row < p.T) {
        sm[row] = m[r];
        sinv[row] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      }
    }
  }

  const int qtiles = (p.T + BQ - 1) / BQ;
  for (int k0 = 0; k0 < p.T; k0 += kCols) {
    __syncthreads();  // statistics are written; every warp is done with sk, sv
    load_tile<kCols, D>(sk, kb, ld, k0, p.T);
    load_tile<kCols, D>(sv, vb, ld, k0, p.T);
    cp_async_commit();
    const int key0 = k0 + warp * 16 + (lane >> 2);  // this thread's keys: key0, key0 + 8
    float dk[D / 8][4], dv[D / 8][4];
    zero<D / 8>(dk);
    zero<D / 8>(dv);
    for (int i = p.causal ? k0 / BQ : 0; i < qtiles; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile<BQ, D>(sq, qb, ld, q0, p.T);
      load_tile<BQ, D>(sdo, dob, ldo, q0, p.T);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float s[NT][4], dp[NT][4];  // transposed: rows = keys, columns = queries
      zero<NT>(s);
      zero<NT>(dp);
      gemm_abt<D, NT>(s, sk, warp * 16, sq);
      gemm_abt<D, NT>(dp, sv, warp * 16, sdo);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + ni * 8 + (lane & 3) * 2 + (e & 1);
          const int key = key0 + (e >> 1) * 8;
          float pn = 0.f, ds = 0.f;  // the statistics exist for rows < T only
          if (kept(p, qi, key)) {
            pn = exp_f32(s[ni][e] * p.scale - sm[qi]) * sinv[qi];
            ds = pn * (dp[ni][e] - sdelta[qi]) * p.scale;
          }
          s[ni][e] = pn;
          dp[ni][e] = ds;  // ds^T
        }
      gemm_xb<D, NT>(dv, s, sdo);
      gemm_xb<D, NT>(dk, dp, sq);
    }
    store_rows<D>(dkb, ld, key0, p.T, dk, 1.f, 1.f);
    store_rows<D>(dvb, ld, key0, p.T, dv, 1.f, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) packed_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  if (blockIdx.y == 0)
    bwd_dkv<D>(p, smem, b, h);
  else
    bwd_dq<D>(p, smem, (blockIdx.y - 1) * kRows, b, h);
}

// ---------------------------------------------------------------- launches

template <int D>
constexpr int fwd_smem() { return (kRows + 2 * kCols) * (D + 8) * 2; }
template <int D>
constexpr int bwd_smem() { return (2 * kRows + 2 * kCols) * (D + 8) * 2 + 3 * kMaxT * 4; }

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int run(bool backward, const Params& p, int B, cudaStream_t s) {
  const int qtiles = (p.T + kRows - 1) / kRows;
  if (!backward) return launch(packed_fwd_kernel<D>, fwd_smem<D>(), dim3(qtiles, B * p.H), p, s);
  return launch(packed_bwd_kernel<D>, bwd_smem<D>(), dim3(B * p.H, 1 + qtiles), p, s);
}

int dispatch(bool backward, const Params& p, int B, int D, cudaStream_t s) {
  if (B < 1 || p.H < 1 || p.T < 1 || p.T > kMaxT) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return run<32>(backward, p, B, s);
    case 64: return run<64>(backward, p, B, s);
    case 128: return run<128>(backward, p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes). Tensors are contiguous bf16 with
// 16-byte aligned starts: qkv and dqkv [B, T, 3*H*D], out and dout
// [B, T, H*D]. D is 32, 64 or 128; 1 <= T <= 512. Each returns
// cudaGetLastError() after its launch (0 = ok).

// drop_last = 1 skips each query tile's last key tile (a deliberately wrong
// variant for a negative control; 0 otherwise).
extern "C" int fused_qkv_fwd(const void* qkv, void* out, int B, int T, int H, int D, int causal,
                             float scale, int drop_last, void* stream) {
  Params p = {};
  p.qkv = static_cast<const bf16*>(qkv);
  p.o = static_cast<bf16*>(out);
  p.H = H, p.T = T, p.causal = causal, p.scale = scale, p.drop_last = drop_last ? 1 : 0;
  return dispatch(false, p, B, D, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_qkv_bwd(const void* qkv, const void* out, const void* dout, void* dqkv, int B,
                             int T, int H, int D, int causal, float scale, void* stream) {
  Params p = {};
  p.qkv = static_cast<const bf16*>(qkv);
  p.out = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.dqkv = static_cast<bf16*>(dqkv);
  p.H = H, p.T = T, p.causal = causal, p.scale = scale;
  return dispatch(true, p, B, D, static_cast<cudaStream_t>(stream));
}
