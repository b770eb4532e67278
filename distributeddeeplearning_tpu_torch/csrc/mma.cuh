// Warp-level building blocks shared by the port's CUDA kernels
// (fused_grads.cu, flash_packed.cu, paged_decode.cu, and through wgmma.cuh
// flash.cu): cp.async copies into shared memory, the ldmatrix fragment
// loads and the m16n8k16 bf16 -> f32 tensor-core product, bf16 packing, the
// attention kernels' row store and quad reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the finite mask value of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const bf16* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// d[4] += A (16 x 16, fragment a[4]) . B (16 x 8, fragment b0, b1).
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// The warp's 16 rows of acc [16][D] as bf16 into rows row0 (lane/4) and
// row0 + 8 of a [T, D] view, rows < T only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long st, int row0, int T,
                                          const float (*acc)[4], float mul0, float mul1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= T) continue;
    const float mul = half ? mul1 : mul0;
#pragma unroll
    for (int di = 0; di < D / 8; ++di) {
      const int col = di * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)row * st + col) =
          __floats2bfloat162_rn(acc[di][2 * half] * mul, acc[di][2 * half + 1] * mul);
    }
  }
}

// Reduce the two row values a thread holds across the 4 lanes of its quad
// (the lanes that share rows lane/4 and lane/4 + 8 of an accumulator).
__device__ __forceinline__ void quad_max(float* v) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 1));
    v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 2));
  }
}
__device__ __forceinline__ void quad_sum(float* v) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v[r] += __shfl_xor_sync(0xffffffffu, v[r], 1);
    v[r] += __shfl_xor_sync(0xffffffffu, v[r], 2);
  }
}

}  // namespace mma
