// The W8A8 feed-forward of the sup transformer: int8 rows times int8 weights
// on the tensor cores, for rows that are quantised already.
//
// Two kernels on the tile product of int8_tile.cuh (128 x 128 tiles on
// mma.sync.m16n8k32, 128-byte slabs of K brought in with cp.async while the
// previous one is multiplied), two blocks an SM so that one block's epilogue
// overlaps the other's products.
//
// swiglu_w8a8_kernel. Replaces dorado_tpu/ops/int8_matmul.py::swiglu_w8a8
// (Pallas body _swiglu_kernel). Per row of xq [M, K] int8 with scale xs[m], and the
// two halves wy, wg [F, K] int8 of fc1 with scales wys, wgs [F]:
//   y = (float(xq . wy[f]) * xs) * wys[f];  g = (float(xq . wg[f]) * xs) * wgs[f]
//   t = y * (g * (1 / (1 + exp(-g))))
//   ts = max(max_f |t|, 1e-12) * (1/127);   tq = int8(rint(t * (1 / ts)))
// A row's scale needs its whole F = 2048 wide t, which no block can hold in
// f32 beside its tiles. So a block owns 128 rows, keeps their int8 x in
// shared memory (the weights stream through a two-stage ring of K slabs),
// and walks over the feature tiles twice: the first pass
// keeps only the row maxima (in shared memory), the second recomputes t and
// quantises it. The price is twice the int8 products (the recomputed t is
// bit-equal, so the result is that of one pass). What bounds it on the H100:
// operations: at M = 131072, K = 512, F = 2048 one pass is 550 GOP (0.28 ms
// at the int8 peak) against 336 MB moved (0.10 ms); the weights (2 MB) come
// from L2 for every block.
//
// w8a8_matmul_kernel. Replaces dorado_tpu/ops/int8_matmul.py::w8a8_matmul
// (Pallas body _a8_kernel): out = bf16((float(xq . wq[o]) * xs) * ws[o]) for
// xq [M, K] int8, wq [O, K] int8. K = 2048 is too deep to keep a block's rows
// resident, so K streams through a three-stage ring of 128-byte tiles.
// Bounded by operations (275 GOP, 0.14 ms) just ahead of bytes (403 MB,
// 0.12 ms) at sup's fc2 shape.
//
// The int32 sums are exact and every float step of the epilogues is a single
// rounded operation, as in the plain versions.
#include "int8_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// fc1 + SwiGLU + per-row requantisation
// ---------------------------------------------------------------------------

constexpr int SW_MAX_K = 512;  // BM * (K + PAD) + the ring: two blocks an SM
constexpr int SW_FEATS = 64;   // features a tile: 64 rows of wy and 64 of wg
constexpr int SW_STAGES = 2;

__global__ void __launch_bounds__(THREADS, 2) swiglu_w8a8_kernel(
    const int8_t* __restrict__ xq,  // [M, K]
    const float* __restrict__ xs,   // [M]
    const int8_t* __restrict__ wy,  // [F, K]
    const float* __restrict__ wys,  // [F]
    const int8_t* __restrict__ wg,  // [F, K]
    const float* __restrict__ wgs,  // [F]
    int8_t* __restrict__ tq,        // [M, F]
    float* __restrict__ ts,         // [M]
    int M, int K, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = K + PAD;
  int8_t* a_tile = reinterpret_cast<int8_t*>(smem);                        // [BM][ld]
  int8_t* b_ring = a_tile + BM * ld;                                       // [2][BN][LDT]
  int* row_amax = reinterpret_cast<int*>(b_ring + SW_STAGES * BN * LDT);   // [BM], float bits

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int vec_per_row = K / 16;
  const int k_slabs = K / BK;

  // Slab q is the BK bytes of K number q % k_slabs of feature tile
  // q / k_slabs. Shared row r of a weight slab holds, for the warp column
  // r / 64, 32 features of wy and then the same 32 features of wg, so a
  // thread gets y and g of one feature in accumulators j and j + 4.
  auto load_slab = [&](int q, int tiles) {
    int8_t* b = b_ring + (q % SW_STAGES) * BN * LDT;
    const int tile = (q / k_slabs) % tiles;
    const int k0 = (q % k_slabs) * BK;
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const int feat = tile * SW_FEATS + (r >> 6) * 32 + (r & 31);
      const int8_t* src = ((r & 32) ? wg : wy) + (size_t)feat * K + k0 + c;
      cp_async16(b + r * LDT + c, src);
    }
  };

  const int tiles = F / SW_FEATS;
  const int slabs = 2 * tiles * k_slabs;  // two passes over the feature tiles
  for (int i = tid; i < BM * vec_per_row; i += THREADS) {
    const int r = i / vec_per_row, c = i - r * vec_per_row;
    if (m0 + r < M)
      cp_async16(a_tile + r * ld + c * 16, xq + (size_t)(m0 + r) * K + c * 16);
    else
      *reinterpret_cast<uint4*>(a_tile + r * ld + c * 16) = make_uint4(0, 0, 0, 0);
  }
  load_slab(0, tiles);
  cp_async_commit();
  if (tid < BM) row_amax[tid] = 0;

  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  const float inv127 = (float)(1.0 / 127.0);
  float row_x[2][2], row_inv[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      row_x[i][h] = (m < M) ? xs[m] : 0.f;
      row_inv[i][h] = 0.f;
    }

  int acc[2][8][4];
  float amax[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // the thread's share of its rows' max |t|
  for (int q = 0; q < slabs; ++q) {
    const int it = q / k_slabs, ks = q - it * k_slabs;
    const int tile = it % tiles;
    const bool second = it >= tiles;
    cp_async_wait<0>();
    __syncthreads();  // slab q landed; the other stage and row_amax are free
    if (q + 1 < slabs) load_slab(q + 1, tiles);
    cp_async_commit();
    if (ks == 0) {
      clear(acc);
      if (it == tiles) {
        // the row maxima are complete: the rows' scales
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float row_max = __int_as_float(row_amax[wm + i * 16 + g + h * 8]);
            row_inv[i][h] = __fdiv_rn(1.0f, __fmul_rn(fmaxf(row_max, 1e-12f), inv127));
          }
        if (tid < BM && m0 + tid < M)
          ts[m0 + tid] = __fmul_rn(fmaxf(__int_as_float(row_amax[tid]), 1e-12f), inv127);
      }
    }
    warp_product(acc, a_tile + ks * BK, ld, b_ring + (q % SW_STAGES) * BN * LDT, LDT, BK, wm,
                 wn, lane);
    if (ks != k_slabs - 1) continue;

    // the tile's products are whole: t, and its row maxima or its int8 values
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int feat = tile * SW_FEATS + (warp & 1) * 32 + j * 8 + t4 * 2;
      const float sy[2] = {wys[feat], wys[feat + 1]};
      const float sg[2] = {wgs[feat], wgs[feat + 1]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = __fmul_rn(__fmul_rn((float)acc[i][j][2 * h + e], row_x[i][h]), sy[e]);
            const float gt =
                __fmul_rn(__fmul_rn((float)acc[i][j + 4][2 * h + e], row_x[i][h]), sg[e]);
            const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gt)));
            t[e] = __fmul_rn(y, __fmul_rn(gt, sig));
          }
          if (!second) {
            amax[i][h] = fmaxf(amax[i][h], fmaxf(fabsf(t[0]), fabsf(t[1])));
          } else {
            const int m = m0 + wm + i * 16 + g + h * 8;
            if (m < M) {
              const int q0 = __float2int_rn(rintf(__fmul_rn(t[0], row_inv[i][h])));
              const int q1 = __float2int_rn(rintf(__fmul_rn(t[1], row_inv[i][h])));
              const uint16_t packed = (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
              *reinterpret_cast<uint16_t*>(tq + (size_t)m * F + feat) = packed;
            }
          }
        }
      }
    }
    if (it == tiles - 1) {
      // the end of the first pass: the threads' maxima into the rows'
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = amax[i][h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          // non-negative floats order as their bit patterns do
          if (t4 == 0) atomicMax(&row_amax[wm + i * 16 + g + h * 8], __float_as_int(v));
        }
    }
  }
}

// ---------------------------------------------------------------------------
// int8 matmul of pre-quantised rows (fc2)
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;

__global__ void __launch_bounds__(THREADS) w8a8_matmul_kernel(
    const int8_t* __restrict__ xq,   // [M, K]
    const float* __restrict__ xs,    // [M]
    const int8_t* __restrict__ wq,   // [O, K]
    const float* __restrict__ ws,    // [O]
    __nv_bfloat16* __restrict__ out, // [M, O]
    int M, int K, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a_ring = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][LDT]
  int8_t* b_ring = a_ring + STAGES * BM * LDT;       // [STAGES][BN][LDT]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the output tiles of one row block are neighbours in the grid, so the
  // blocks that share its x rows run together and find them in L2
  const int n_tiles = O / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;

  auto load_stage = [&](int stage, int kt) {
    int8_t* a = a_ring + stage * BM * LDT;
    int8_t* b = b_ring + stage * BN * LDT;
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      if (m0 + r < M)
        cp_async16(a + r * LDT + c, xq + (size_t)(m0 + r) * K + kt * BK + c);
      else
        *reinterpret_cast<uint4*>(a + r * LDT + c) = make_uint4(0, 0, 0, 0);
      cp_async16(b + r * LDT + c, wq + (size_t)(n0 + r) * K + kt * BK + c);
    }
  };

  const int k_tiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  int acc[2][8][4];
  clear(acc);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; the stage consumed last round is free
    const int ahead = kt + STAGES - 1;
    if (ahead < k_tiles) load_stage(ahead % STAGES, ahead);
    cp_async_commit();
    const int stage = kt % STAGES;
    warp_product(acc, a_ring + stage * BM * LDT, LDT, b_ring + stage * BN * LDT, LDT, BK, wm,
                 wn, lane);
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + t4 * 2;
    const float w0 = ws[col], w1 = ws[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m < M) {
          const float s = xs[m];
          __nv_bfloat162 y;
          y.x = __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)acc[i][j][2 * h], s), w0));
          y.y = __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)acc[i][j][2 * h + 1], s), w1));
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * O + col) = y;
        }
      }
    }
  }
}

}  // namespace

// K a multiple of 128 up to 512, F a multiple of 64, M >= 1.
DTT_EXPORT int swiglu_w8a8_i8(const void* xq, const void* xs, const void* wy, const void* wys,
                              const void* wg, const void* wgs, void* tq, void* ts, int M, int K,
                              int F, void* stream) {
  if (M <= 0 || K <= 0 || K > SW_MAX_K || K % 128 || F <= 0 || F % SW_FEATS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = BM * (K + PAD) + SW_STAGES * BN * LDT + BM * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_w8a8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swiglu_w8a8_kernel<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wy), static_cast<const float*>(wys),
      static_cast<const int8_t*>(wg), static_cast<const float*>(wgs),
      static_cast<int8_t*>(tq), static_cast<float*>(ts), M, K, F);
  return static_cast<int>(cudaGetLastError());
}

// K and O multiples of 128, M >= 1.
DTT_EXPORT int w8a8_matmul_bf16(const void* xq, const void* xs, const void* wq, const void* ws,
                                void* out, int M, int K, int O, void* stream) {
  if (M <= 0 || K <= 0 || K % BK || O <= 0 || O % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)((M + BM - 1) / BM) * (O / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = STAGES * (BM + BN) * LDT;
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_matmul_kernel<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, K, O);
  return static_cast<int>(cudaGetLastError());
}
