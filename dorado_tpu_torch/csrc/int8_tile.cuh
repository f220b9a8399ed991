// The int8 tile product of K13 (w8a8_matmul.cu; K2 and K12 run on wgmma
// instead): a block of 256 threads multiplies a 128-row tile of int8
// activations by a 128-row tile of int8 weights (one output channel a row)
// on the tensor cores, mma.sync.m16n8k32 (s8 x s8 -> s32), 8 warps as 4 x
// 2, a warp computing 32 x 64 of the 128 x 128 tile.
// Rows of the shared tiles are padded by 16 bytes, which spreads the 8 rows
// of an ldmatrix over all 32 banks. K comes in slabs of 128 bytes through
// cp.async, so that the next slab loads while this one is multiplied.
#pragma once

#include "common.cuh"

namespace {

constexpr int BM = 128;        // rows a block tile
constexpr int BN = 128;        // weight rows a block tile
constexpr int PAD = 16;        // bytes of padding a shared row
constexpr int THREADS = 256;
constexpr int BK = 128;        // bytes of K a slab
constexpr int LDT = BK + PAD;  // a slab's shared row stride

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a_tile[wm.., :klen] . b_tile[wn.., :klen]^T for one warp's 32 x 64
// part; acc[i][j][2h + e] is row wm + 16i + g + 8h, column wn + 8j + 2*t4 + e
// (g = lane / 4, t4 = lane % 4). The fragments come through ldmatrix: 8 rows
// of 16 bytes are one of its 8 x 8 b16 matrices, and a lane's 4 bytes of a
// row are the mma's. One x4 load is a 16 x 32 byte fragment of a, or the
// 32 bytes of K of two 8-row tiles of b. Rows must be 16-byte aligned.
__device__ __forceinline__ void warp_product(int (&acc)[2][8][4], const int8_t* a_tile, int lda,
                                             const int8_t* b_tile, int ldb, int klen, int wm,
                                             int wn, int lane) {
  // lane l gives the row address of matrix l / 8, row l % 8
  const int8_t* a_lane = a_tile + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 16;
  const int8_t* b_lane = b_tile + (wn + (lane & 7) + (lane >> 4) * 8) * ldb + ((lane >> 3) & 1) * 16;
  for (int k0 = 0; k0 < klen; k0 += 32) {
    uint32_t a[2][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_lane + i * 16 * lda + k0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ldmatrix_x4(b[jj], b_lane + jj * 16 * ldb + k0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mma_s8(acc[i][2 * jj], a[i], b[jj][0], b[jj][1]);
        mma_s8(acc[i][2 * jj + 1], a[i], b[jj][2], b[jj][3]);
      }
  }
}

__device__ __forceinline__ void clear(int (&acc)[2][8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

}  // namespace
