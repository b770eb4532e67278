// Warpgroup building blocks shared by the port's wgmma kernels
// (flash_packed.cu, flash.cu, fused_grads.cu, fused_block.cu): swizzled shared-memory
// tiles, wgmma descriptors, the m64nNk16 bf16 -> f32 products with A from
// shared memory or from registers, and the fences around them.
//
// Shared-memory tiles are row-major [rows][D] bf16 without padding, their
// 16-byte chunks swizzled as wgmma's canonical layouts want (the XOR of a
// chunk's index with its row's low bits): 64-byte rows (D = 32) take the
// 64-byte swizzle, 128-byte rows (D = 64) the 128-byte one, and D = 128 is
// two [rows][64] halves of 128-byte swizzle. Tiles start on 1024 bytes.
// TMA's SWIZZLE_64B and SWIZZLE_128B modes write the same layouts.

#pragma once

#include "mma.cuh"

namespace mma {

// 2^x by the SFU alone (exp2f adds a rescaling for results below 2^-126,
// which every use here rounds to nothing).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ tiles and wgmma

template <int D>
__device__ __forceinline__ int chunk_off(int r, int c, int rows) {
  if constexpr (D == 32) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else if constexpr (D == 64) return r * 128 + ((c ^ (r & 7)) << 4);
  else return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}
template <int D, int ROWS>
__host__ __device__ constexpr int tile_bytes() { return ROWS * D * 2; }

// Rows r0 .. r0+ROWS-1 of one head's [T, D] view (row stride `st`
// elements) into a tile, by the block's THREADS threads; rows >= T zero
// filled.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_sw(unsigned char* tile, const bf16* base, long long st,
                                             int r0, int T) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < T;
    cp_async16(tile + chunk_off<D>(r, c, ROWS), ok ? base + (long long)(r0 + r) * st + c * 8 : base,
               ok);
  }
}

// wgmma descriptors: start address, leading and stride byte offsets (in
// 16-byte units) and the swizzle mode (64-byte for D = 32, else 128-byte).
template <int D>
__device__ __forceinline__ uint64_t make_desc(const unsigned char* at, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = D == 32 ? 2 : 1;
  return ((uint64_t)(smem_u32(at) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}
template <int D>
__host__ __device__ constexpr int row_bytes() { return D == 32 ? 64 : 128; }

// K-major operand (the contraction runs along the tile's columns): k-step
// kk (16 columns) of rows row0 .. of a tile of `rows` rows. The leading
// offset is unused by swizzled K-major layouts; 8-row groups are 8 rows
// apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows, int row0, int kk) {
  constexpr int kSteps = row_bytes<D>() / 32;
  return make_desc<D>(tile + (kk / kSteps) * rows * row_bytes<D>() + row0 * row_bytes<D>() +
                          (kk % kSteps) * 32,
                      16, 8 * row_bytes<D>());
}

// MN-major B operand (the contraction runs along the tile's rows, the
// product's columns along its D columns): k-step kk is rows 16kk .. 16kk+15.
// Leading offset: from one 64-column half to the next (D = 128); stride:
// from one 8-row group to the next.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int rows, int kk) {
  return make_desc<D>(tile + kk * 16 * row_bytes<D>(), rows * 128, 8 * row_bytes<D>());
}

// MN-major A operand (the contraction runs along the tile's rows, the
// product's 64 rows along its columns): rows m0 .. m0+63 of the product are
// the 64-column panel m0 / 64 of a tile of `rows` rows stored as such
// panels (desc_mn's layout), k-step kk its rows 16kk .. 16kk+15.
__device__ __forceinline__ uint64_t desc_mn_a(const unsigned char* tile, int rows, int m0, int kk) {
  return desc_mn<128>(tile + (m0 / 64) * rows * 128, rows, kk);
}

// wgmma.mma_async m64nNk16, bf16 -> f32, both operands from shared
// memory, accumulating when `acc` is non-zero: A K-major (TA = 0) or
// MN-major (TA = 1), B K-major (TB = 0) or MN-major (TB = 1).
template <int N, int TB = 0, int TA = 0>
struct Wgmma;
template <int TB, int TA>
struct Wgmma<8, TB, TA> {
  static __device__ __forceinline__ void mma(float (*d)[4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
        "%8, %7;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "l"(a), "l"(b), "r"(acc), "n"(TB), "n"(TA));
  }
};
template <int TB, int TA>
struct Wgmma<128, TB, TA> {
  static __device__ __forceinline__ void mma(float (*d)[4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(acc), "n"(TB), "n"(TA));
  }
};
template <int TB, int TA>
struct Wgmma<64, TB, TA> {
  static __device__ __forceinline__ void mma(float (*d)[4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(acc), "n"(TB), "n"(TA));
  }
};
template <int TB, int TA>
struct Wgmma<32, TB, TA> {
  static __device__ __forceinline__ void mma(float (*d)[4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(acc), "n"(TB), "n"(TA));
  }
};

// wgmma in three parts, so that a warpgroup can issue several products
// and wait for them once: wg_begin (before the first product: registers
// written since are ordered before it), the products, wg_end (commit and
// wait; then fence_acc on each result, so that no use of it is moved
// above the wait).
__device__ __forceinline__ void wg_begin() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_end() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The two parts of wg_end apart: commit the products issued since the
// last commit as one group, and wait until at most N groups are pending.
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// A warp-specialized kernel's register split: its producer warpgroup
// gives registers back, its consumer warpgroups take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int NT>
__device__ __forceinline__ void fence_acc(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][e])::"memory");
}

// Issue the warpgroup's acc[N/8][4] = A (64 rows from a_row0 of tile `a`,
// `a_rows` rows) . B^T (the N rows of tile `b`), over the first 16*KSTEPS
// of the tiles' D columns, in the m16n8 accumulator layout (warp w of the
// group: rows 16w + lane/4 and + 8).
template <int D, int N, int KSTEPS = D / 16>
__device__ __forceinline__ void wg_abt_ss(float (*acc)[4], const unsigned char* a, int a_rows,
                                          int a_row0, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    Wgmma<N>::mma(acc, desc_k<D>(a, a_rows, a_row0, kk), desc_k<D>(b, N, 0, kk), kk > 0);
}

// cp.async writes (generic proxy) made visible to wgmma (async proxy),
// then to the block.
__device__ __forceinline__ void tiles_landed() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The same with A from registers (the m16n8k16 A-fragment layout, warp w
// of the group holding rows 16w .. 16w+15) and B MN-major (TB = 1,
// transposed) or K-major (TB = 0); always accumulating.
template <int N, int TB = 1>
struct WgmmaRS;
template <int TB>
struct WgmmaRS<32, TB> {
  static __device__ __forceinline__ void mma(float (*d)[4], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};
template <int TB>
struct WgmmaRS<64, TB> {
  static __device__ __forceinline__ void mma(float (*d)[4], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};
template <int TB>
struct WgmmaRS<128, TB> {
  static __device__ __forceinline__ void mma(float (*d)[4], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

// X [16][KT*8] of this warp, score-shaped accumulators x[KT][4], as bf16
// A fragments (two n8 accumulator tiles are one k16 fragment).
template <int KT>
__device__ __forceinline__ void a_frags(uint32_t (*af)[4], const float (*x)[4]) {
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc) {
    af[kc][0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    af[kc][1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    af[kc][2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    af[kc][3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
  }
}

// Issue the warpgroup's acc[D/8][4] += X . B: X [64][KT*8] from registers
// (a_frags), B the first KT*8 rows of a tile of `rows` rows (rows = the
// contraction index).
template <int D, int KT>
__device__ __forceinline__ void wg_xb_rs(float (*acc)[4], const uint32_t (*af)[4],
                                         const unsigned char* b, int rows) {
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc) WgmmaRS<D>::mma(acc, af[kc], desc_mn<D>(b, rows, kc));
}

// Dynamic shared memory rounded up to the 1024-byte alignment of the tiles.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

}  // namespace mma
