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
// the accumulators in VMEM scratch from one step to the next. Here one
// block of 4 warps owns a 64-row tile (16 rows a warp) and loops over the
// other sequence inside the block: the forward and dq over key tiles of
// 64, dk/dv over query tiles of 64 (32 at D = 128, to bound registers).
// Tiles arrive in shared memory by cp.async (rows past the end are zero
// filled); products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix
// fragments, the score accumulator turned into the next product's A
// fragment in registers (p and ds never touch memory). dk/dv computes the
// transposed scores s^T = k . q^T so that each warp's rows are its keys.
// Causal: the forward and dq stop at the diagonal tile, dk/dv start
// there; the forward and dq take their query tiles in reverse order (and
// dk/dv its key tiles in order), so the longest blocks start first. dq
// and dk/dv are separate kernels (as on the TPU), so no atomics:
// gradients repeat bit for bit.
//
// What bounds it on an H100 (lm_base training: B = 8, H = 12, T = 1024,
// D = 64, causal): the forward does 4*B*H*P*D = 13 GFLOP for P =
// T(T+1)/2 query-key pairs (13 us at 989 TFLOP/s) and moves 50 MB (15 us
// at 3.35 TB/s); dq 6*B*H*P*D and dk/dv 8*B*H*P*D operations bound them.
// mma.sync reaches a part of the card's wgmma rate and there is no
// multi-stage pipeline; PERF.md holds the measured times.

#include "mma.cuh"

namespace {

using namespace mma;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns: 16 per warp
constexpr int kCols = 64;      // the forward's and dq's key tile

struct View {  // element strides of a [B, T, H, D] view
  long long b, t, h;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;    // backward
  const float* lse;    // backward: [B*H, Tq]
  const float* delta;  // backward: [B*H, Tq]
  bf16* out0;          // forward: o; dq: dq; dk/dv: dk
  bf16* out1;          // dk/dv: dv
  float* lse_out;      // forward: [B*H, Tq]
  View vq, vk, vv, vdo, vout0, vout1;
  int H, Tq, Tk, causal, drop_last;
  float scale;
};

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int P = D + 8;
  constexpr int NT = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kRows * P;
  bf16* sv = sk + kCols * P;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const bf16* qb = p.q + b * p.vq.b + h * p.vq.h;
  const bf16* kb = p.k + b * p.vk.b + h * p.vk.h;
  const bf16* vb = p.v + b * p.vv.b + h * p.vv.h;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8

  load_tile<kRows, D>(sq, qb, p.vq.t, q0, p.Tq);
  cp_async_commit();

  float acc[D / 8][4];
  zero<D / 8>(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int tiles = (p.Tk + kCols - 1) / kCols;
  if (p.causal) tiles = min(tiles, (q0 + kRows - 1) / kCols + 1);
  tiles -= p.drop_last;  // a test-only variant (a negative control)

  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * kCols;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kCols, D>(sk, kb, p.vk.t, k0, p.Tk);
    load_tile<kCols, D>(sv, vb, p.vv.t, k0, p.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[NT][4];
    zero<NT>(s);
    gemm_abt<D, NT>(s, sq, warp * 16, sk);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + ni * 8 + (lane & 3) * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < p.Tk && (!p.causal || col <= row);
        s[ni][e] = ok ? s[ni][e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[ni][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp_f32(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[ni][e];
        s[ni][e] = x == kNegInf ? 0.f : exp_f32(x - m[e >> 1]);
        sum[e >> 1] += s[ni][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int di = 0; di < D / 8; ++di) {
      acc[di][0] *= alpha[0];
      acc[di][1] *= alpha[0];
      acc[di][2] *= alpha[1];
      acc[di][3] *= alpha[1];
    }
    gemm_xb<D, NT>(acc, s, sv);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / ls;
    const int row = row0 + r * 8;
    if ((lane & 3) == 0 && row < p.Tq) p.lse_out[(long long)bh * p.Tq + row] = m[r] + logf(ls);
  }
  store_rows<D>(p.out0 + b * p.vout0.b + h * p.vout0.h, p.vout0.t, row0, p.Tq, acc, inv[0],
                inv[1]);
}

// --------------------------------------------------------------------- dq

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int P = D + 8;
  constexpr int NT = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kRows * P;
  bf16* sk = sdo + kRows * P;
  bf16* sv = sk + kCols * P;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const bf16* kb = p.k + b * p.vk.b + h * p.vk.h;
  const bf16* vb = p.v + b * p.vv.b + h * p.vv.h;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_tile<kRows, D>(sq, p.q + b * p.vq.b + h * p.vq.h, p.vq.t, q0, p.Tq);
  load_tile<kRows, D>(sdo, p.dout + b * p.vdo.b + h * p.vdo.h, p.vdo.t, q0, p.Tq);
  cp_async_commit();
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse[r] = row < p.Tq ? p.lse[(long long)bh * p.Tq + row] : 0.f;
    delta[r] = row < p.Tq ? p.delta[(long long)bh * p.Tq + row] : 0.f;
  }

  float dq[D / 8][4];
  zero<D / 8>(dq);
  int tiles = (p.Tk + kCols - 1) / kCols;
  if (p.causal) tiles = min(tiles, (q0 + kRows - 1) / kCols + 1);

  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * kCols;
    __syncthreads();
    load_tile<kCols, D>(sk, kb, p.vk.t, k0, p.Tk);
    load_tile<kCols, D>(sv, vb, p.vv.t, k0, p.Tk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[NT][4], dp[NT][4];
    zero<NT>(s);
    zero<NT>(dp);
    gemm_abt<D, NT>(s, sq, warp * 16, sk);
    gemm_abt<D, NT>(dp, sdo, warp * 16, sv);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + ni * 8 + (lane & 3) * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < p.Tk && row < p.Tq && (!p.causal || col <= row);
        const float pe = ok ? exp_f32(s[ni][e] * p.scale - lse[e >> 1]) : 0.f;
        s[ni][e] = pe * (dp[ni][e] - delta[e >> 1]) * p.scale;  // ds
      }
    gemm_xb<D, NT>(dq, s, sk);
  }
  store_rows<D>(p.out0 + b * p.vout0.b + h * p.vout0.h, p.vout0.t, row0, p.Tq, dq, 1.f, 1.f);
}

// ------------------------------------------------------------------ dk/dv

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int P = D + 8;
  constexpr int BQ = D >= 128 ? 32 : 64;  // query tile
  constexpr int NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kRows * P;
  bf16* sq = sv + kRows * P;
  bf16* sdo = sq + BQ * P;
  float* slse = reinterpret_cast<float*>(sdo + BQ * P);
  float* sdelta = slse + BQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const bf16* qb = p.q + b * p.vq.b + h * p.vq.h;
  const bf16* dob = p.dout + b * p.vdo.b + h * p.vdo.h;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this thread's keys: key0, key0 + 8

  load_tile<kRows, D>(sk, p.k + b * p.vk.b + h * p.vk.h, p.vk.t, k0, p.Tk);
  load_tile<kRows, D>(sv, p.v + b * p.vv.b + h * p.vv.h, p.vv.t, k0, p.Tk);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);
  const int tiles = (p.Tq + BQ - 1) / BQ;
  const int first = p.causal ? k0 / BQ : 0;  // earlier query tiles see none of these keys

  for (int i = first; i < tiles; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile<BQ, D>(sq, qb, p.vq.t, q0, p.Tq);
    load_tile<BQ, D>(sdo, dob, p.vdo.t, q0, p.Tq);
    cp_async_commit();
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < p.Tq;
      slse[r] = ok ? p.lse[(long long)bh * p.Tq + q0 + r] : 0.f;
      sdelta[r] = ok ? p.delta[(long long)bh * p.Tq + q0 + r] : 0.f;
    }
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
        const int c = ni * 8 + (lane & 3) * 2 + (e & 1);
        const int qi = q0 + c;
        const int key = key0 + (e >> 1) * 8;
        const bool ok = key < p.Tk && qi < p.Tq && (!p.causal || qi >= key);
        const float pe = ok ? exp_f32(s[ni][e] * p.scale - slse[c]) : 0.f;
        s[ni][e] = pe;
        dp[ni][e] = pe * (dp[ni][e] - sdelta[c]) * p.scale;  // ds^T
      }
    gemm_xb<D, NT>(dv, s, sdo);
    gemm_xb<D, NT>(dk, dp, sq);
  }
  store_rows<D>(p.out0 + b * p.vout0.b + h * p.vout0.h, p.vout0.t, key0, p.Tk, dk, 1.f, 1.f);
  store_rows<D>(p.out1 + b * p.vout1.b + h * p.vout1.h, p.vout1.t, key0, p.Tk, dv, 1.f, 1.f);
}

// ---------------------------------------------------------------- launches

template <int D>
constexpr int fwd_smem() { return (kRows + 2 * kCols) * (D + 8) * 2; }
template <int D>
constexpr int dq_smem() { return (2 * kRows + 2 * kCols) * (D + 8) * 2; }
template <int D>
constexpr int dkv_smem() {
  return (2 * kRows + 2 * (D >= 128 ? 32 : 64)) * (D + 8) * 2 + 2 * (D >= 128 ? 32 : 64) * 4;
}

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int run(int op, const Params& p, int B, cudaStream_t s) {
  const int bh = B * p.H;
  if (op == 0)
    return launch(flash_fwd_kernel<D>, fwd_smem<D>(), dim3((p.Tq + kRows - 1) / kRows, bh), p, s);
  if (op == 1)
    return launch(flash_bwd_dq_kernel<D>, dq_smem<D>(), dim3((p.Tq + kRows - 1) / kRows, bh), p,
                  s);
  return launch(flash_bwd_dkv_kernel<D>, dkv_smem<D>(), dim3((p.Tk + kRows - 1) / kRows, bh), p,
                s);
}

int dispatch(int op, const Params& p, int B, int D, cudaStream_t s) {
  if (B < 1 || p.H < 1 || p.Tq < 1 || p.Tk < 1 || (p.causal && p.Tq != p.Tk))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return run<32>(op, p, B, s);
    case 64: return run<64>(op, p, B, s);
    case 96: return run<96>(op, p, B, s);
    case 128: return run<128>(op, p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

}  // namespace

// C entry points (loaded with ctypes). Tensors are bf16 [B, T, H, D] views
// with the last dim contiguous and 16-byte aligned rows; `strides` holds
// (batch, seq, head) element strides, three per view, in the order of the
// views each function names. lse and delta are contiguous f32 [B*H, Tq].
// D is 32, 64, 96 or 128; causal needs Tq == Tk. Each returns
// cudaGetLastError() after its launch (0 = ok).

// views: q, k, v, o. drop_last = 1 skips each row's last key tile (a
// deliberately wrong variant for a negative control; 0 otherwise).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const long long* strides, int B, int H, int Tq, int Tk, int D,
                         int causal, float scale, int drop_last, void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out0 = static_cast<bf16*>(o);
  p.lse_out = lse;
  p.vq = view(strides), p.vk = view(strides + 3), p.vv = view(strides + 6);
  p.vout0 = view(strides + 9);
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.causal = causal, p.scale = scale, p.drop_last = drop_last ? 1 : 0;
  return dispatch(0, p, B, D, static_cast<cudaStream_t>(stream));
}

// views: q, k, v, do, dq.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            const long long* strides, int B, int H, int Tq, int Tk, int D,
                            int causal, float scale, void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse, p.delta = delta;
  p.out0 = static_cast<bf16*>(dq);
  p.vq = view(strides), p.vk = view(strides + 3), p.vv = view(strides + 6);
  p.vdo = view(strides + 9), p.vout0 = view(strides + 12);
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.causal = causal, p.scale = scale;
  return dispatch(1, p, B, D, static_cast<cudaStream_t>(stream));
}

// views: q, k, v, do, dk, dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Tq, int Tk, int D,
                             int causal, float scale, void* stream) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse, p.delta = delta;
  p.out0 = static_cast<bf16*>(dk);
  p.out1 = static_cast<bf16*>(dv);
  p.vq = view(strides), p.vk = view(strides + 3), p.vv = view(strides + 6);
  p.vdo = view(strides + 9), p.vout0 = view(strides + 12), p.vout1 = view(strides + 15);
  p.H = H, p.Tq = Tq, p.Tk = Tk, p.causal = causal, p.scale = scale;
  return dispatch(2, p, B, D, static_cast<cudaStream_t>(stream));
}
