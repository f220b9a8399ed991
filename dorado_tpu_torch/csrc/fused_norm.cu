// The sup encoder's residual RMSNorm fused into the matmul in front of it.
//
// Replaces dorado_tpu/ops/fused_norm.py::matmul_residual_rmsnorm (Pallas body
// _kernel). For each row m of x [M, K] (bf16), with w [O, K] bf16, the
// optional bias [O] float32, residual [M, O] bf16 and norm weight [O] bf16:
//   a    = sum_k x[m][k] * w[o][k] (+ bias[o])           f32
//   h    = bf16(bf16(a) + bf16(residual[m][o] * alpha))  the stream's rounding
//   rstd = 1 / sqrt(sum_o h^2 / O + eps)                 f32
//   out  = bf16(bf16(h * rstd) * nw[o])
// exactly the JAX kernel's order of roundings. The TPU kernel multiplies a
// 512-row tile by the whole weight in VMEM; here the norm needs a row's 512
// sums on one SM, so a CTA owns 64 rows and all 512 columns.
//
// What bounds it on the H100: at sup's out_proj (M = 131072, K = 512, with a
// bias) bytes: 403 MB (x, residual, output; 0.12 ms) against 69 GFLOP
// (0.07 ms at the bf16 peak); at fc2 (K = 2048, no bias) operations:
// 275 GFLOP (0.28 ms) against 807 MB (0.24 ms). The norm needs a row's 512
// sums in one CTA, and 512 f32 accumulators a row leave room for 64 rows a
// warpgroup: the weight's traffic into the SMs is large beside the
// products. The first version (mma.sync from a cp.async ring, one 64-row
// block a CTA) read the whole weight from L2 for every block, 4.3 GB at fc2,
// and overlapped no epilogue with any load (1.509 ms at fc2, the unfused
// route 0.902).
//
// Design:
//   - a CTA owns 128 rows: two consumer warpgroups of 64 rows, each running
//     wgmma m64n256k16 (bf16 in, f32 sums in registers, 128 a thread) over
//     all of K twice, once for columns 0-255 and once for 256-511, so that a
//     weight slab serves 128 rows;
//   - the tile's residual [128][512] comes into shared memory by TMA (boxes
//     of 64 rows x 64 columns, 128-byte swizzle) while the first pass runs;
//     each pass's epilogue rounds its sums with the bias, adds the rounded
//     residual and writes h over the residual in place, summing the rows'
//     squares in registers (a row's four lanes join by shuffles: no
//     exchange between the warpgroups); the last step scales h in place and
//     a TMA store writes the tile (rows past M are not written);
//   - one producer thread (its warpgroup gives registers back with
//     setmaxnreg) keeps TMA loads of the x and W k-slabs (32 k: one 64-byte
//     swizzle row; 8 KB of x + 16 KB of W) in flight through a ring of four
//     stages with full and empty mbarriers; the wgmma descriptors read the
//     TMA's swizzle; a slab's products may run while the next slab's are
//     issued;
//   - a cluster of two CTAs on neighbouring row blocks: each loads half of
//     every W slab and multicasts it to both, halving W's L2 reads; a stage
//     is refilled only when the consumers of both CTAs have released it (the
//     empty barrier counts their remote arrivals);
//   - persistent CTAs, as many clusters as run at once, striding over pairs
//     of row blocks: the ring runs on from one tile into the next. Rows past
//     M come in as zeros.
// Every mbarrier wait traps after about 4 s instead of hanging the card.
// The epilogue's roundings are paired (one conversion instruction for two
// values), and its code is written once for both passes: two unrolled
// copies overflowed the instruction cache and slowed the kernel sharply.
//
// matmul_residual_rmsnorm_f32 (K14 at float32: the JAX package's
// compute_dtype=float32 stream on the fused-norm route) computes
//   h   = (sum_k x[m][k] * w[o][k] + bias[o]) + residual[m][o] * alpha
//   out = (h * rstd) * nw[o],  rstd = 1 / sqrt(sum_o h^2 / O + eps)
// all in float32 (the stream's roundings are float32 ones) in
// fused_norm_f32_kernel. The bf16 design does not carry over: its tile of
// 128 rows x 512 columns doubles to 256 KB in float32, over the 227 KB a
// block has, and float32 products need tf32 operands split in three. So a
// CTA of 8 warps owns 64 rows and all 512 columns, in two passes of 256
// columns (each warp 32 rows x 64 columns, 64 float32 sums a thread); each
// pass streams x and W through a two-stage cp.async ring of 32-k slabs (x
// 64 x 32, W 256 x 32, rows 36 floats apart so that the fragment loads fall
// on distinct banks) into mma.sync m16n8k8 in 3xTF32 (each operand split
// into tf32 hi + lo, a_lo b_hi + a_hi b_lo + a_hi b_hi: float32 products
// but for about 2^-21 of each, as K1 float32 and K10 at float32 do). Each
// pass's epilogue writes h, with the bias and the scaled residual, into a
// [64][520] float32 tile in shared memory (133 KB; 225 KB with the ring);
// then each warp takes 8 rows, sums their squares across the warp and
// writes the normalised rows times the weight in full lines. What bounds it:
// the products, three times over on tf32 mma.sync (below the card's wgmma
// rate), and W's reads from L2, one for every 64 rows: 1.70 ms at out_proj
// and 6.02 at fc2 against 1.03 and 4.10 ms of float32 operations at 67
// TFLOP/s (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
#include "common.cuh"
#include "tma_map.cuh"

namespace {

constexpr int O = 512;         // output width: sup's d_model
constexpr int BM = 128;        // rows a tile: 64 a consumer warpgroup (a wgmma's M)
constexpr int HALF = 256;      // columns a pass (a wgmma's N): two passes a tile
constexpr int BK = 32;         // k a slab: one 64-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int INFLIGHT = 1;    // slabs whose products may run while the next slab's are issued
constexpr int CS = 2;          // CTAs a cluster
constexpr int WBOX = HALF / CS;  // W rows of a pass each CTA of a cluster loads and multicasts
constexpr int CONSUMERS = 2;   // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int X_TILE = BM * BK, W_TILE = HALF * BK;  // bf16 elements a stage
constexpr int STAGE_BYTES = 2 * (X_TILE + W_TILE);
constexpr int RBOX = 64;       // columns a box of the residual and output tiles (128 bytes)
constexpr int TILE_BYTES = 2 * BM * O;
// the ring and the residual / h / output tile (1024-byte aligned for the
// swizzles), the ring's full and empty mbarriers and the tile's two, and the
// norm weight [O] bf16
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + TILE_BYTES + (2 * STAGES + 2) * 8 + O * 2;

__global__ void __launch_bounds__(THREADS, 1) fused_norm_kernel(
    const __grid_constant__ CUtensorMap map_x,  // x [M, K]: boxes of BM rows x BK
    const __grid_constant__ CUtensorMap map_w,  // w [O, K]: boxes of WBOX rows x BK
    const __grid_constant__ CUtensorMap map_r,  // residual [M, O]: boxes of 64 rows x RBOX
    const __grid_constant__ CUtensorMap map_o,  // out [M, O]: the same boxes
    const float* __restrict__ bias,             // [O] or null
    const __nv_bfloat16* __restrict__ nw,       // [O]
    int M, int K, float alpha, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* x_ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][BK]
  __nv_bfloat16* w_ring = x_ring + STAGES * X_TILE;                 // [STAGES][HALF][BK]
  // the tile, [2 warpgroups][O / RBOX boxes][64 rows][RBOX]: the residual,
  // then h in its place, then the output in h's
  unsigned char* tile_s = reinterpret_cast<unsigned char*>(w_ring + STAGES * W_TILE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tile_s + TILE_BYTES);
  __nv_bfloat16* nw_s = reinterpret_cast<__nv_bfloat16*>(bars + 2 * STAGES + 2);  // [O]
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  // the tile's residual is in; its output has left it
  const uint32_t res_full = smem_u32(bars + 2 * STAGES), res_empty = res_full + 8;

  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t rank = cluster_rank();
  const int k_tiles = (K + BK - 1) / BK;
  const int groups = ((M + BM - 1) / BM + CS - 1) / CS;  // pairs of row blocks
  const int cid = blockIdx.x / CS, nclusters = gridDim.x / CS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrival + the bytes
      mbar_init(empty0 + 8 * s, CONSUMERS * CS);  // every consumer of the cluster
    }
    mbar_init(res_full, 1);
    mbar_init(res_empty, CONSUMERS);  // each warpgroup's output has left the tile
    mbar_init_fence();
  }
  for (int i = tid; i < O; i += THREADS) nw_s[i] = nw[i];
  cluster_sync();  // the cluster's mbarriers are initialised; the norm weight is in

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load -----------------------------
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0, phase = 0, tile = 0;
      for (int grp = cid; grp < groups; grp += nclusters, ++tile) {
        const int m0 = (grp * CS + rank) * BM;
        for (int pass = 0; pass < 2; ++pass)
          for (int kt = 0; kt < k_tiles; ++kt) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the whole cluster released the stage
            mbar_expect(full0 + 8 * stage, STAGE_BYTES);
            tma_load_2d(smem_u32(x_ring + stage * X_TILE), &map_x, kt * BK, m0,
                        full0 + 8 * stage);
            tma_load_2d_multicast(smem_u32(w_ring + stage * W_TILE + rank * WBOX * BK), &map_w,
                                  kt * BK, pass * HALF + rank * WBOX, full0 + 8 * stage,
                                  (1 << CS) - 1);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
            // the tile's residual once the ring is full, after the last
            // tile's output has left the tile buffer
            if (pass == 0 && kt == (k_tiles < STAGES ? k_tiles : STAGES) - 1) {
              mbar_wait(res_empty, (tile & 1) ^ 1);
              mbar_expect(res_full, TILE_BYTES);
              for (int b = 0; b < 2 * O / RBOX; ++b)
                tma_load_2d(smem_u32(tile_s + b * 64 * RBOX * 2), &map_r, (b % (O / RBOX)) * RBOX,
                            m0 + 64 * (b / (O / RBOX)), res_full);
            }
          }
      }
      // the peers' consumers have released every stage: their arrivals on
      // this CTA's empty barriers are in before it exits
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue -------------------
    setmaxnreg_inc<232>();
    const int lt = tid % 128, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = (lt >> 5) * 16 + g;  // the thread's rows r0, r0 + 8 of its warpgroup's 64
    unsigned char* my_tile = tile_s + wg * (O / RBOX) * 64 * RBOX * 2;
    // column col's pair at row `row` of the warpgroup's boxes [O / RBOX][64
    // rows][RBOX]: box col / 64, 16-byte chunk (col % 64) / 8 XOR row % 8 (the
    // 128-byte swizzle: the 8 rows of a warp's access fall on distinct banks)
    auto at = [&](int row, int col) {
      return reinterpret_cast<__nv_bfloat162*>(
          my_tile + ((col / RBOX) * 64 + row) * RBOX * 2 +
          ((((col % RBOX) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
    };
    const __nv_bfloat162 alpha2 = __float2bfloat162_rn(alpha);  // alpha is a bf16 value
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0, phase = 0, tile = 0;
    for (int grp = cid; grp < groups; grp += nclusters, ++tile) {
      const int m0 = (grp * CS + rank) * BM;
      float ss[2] = {0.f, 0.f};  // the rows' sums of squares
      for (int pass = 0; pass < 2; ++pass) {
        int held = -1;  // the stage whose products may still run
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t xa = smem_u32(x_ring + stage * X_TILE + wg * 64 * BK);
          const uint32_t wb = smem_u32(w_ring + stage * W_TILE);
#pragma unroll
          for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n256k16(acc, wgmma_desc<2 * BK>(xa + 32 * kk),
                             wgmma_desc<2 * BK>(wb + 32 * kk), kt > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<INFLIGHT>();
          // the slab before is consumed: release its stage in every CTA of the
          // cluster
          if (held >= 0 && lt < CS) mbar_arrive_cluster(empty0 + 8 * held, lt);
          held = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
        if (lt < CS) mbar_arrive_cluster(empty0 + 8 * held, lt);
        // the pass's h in place of its residual, and the rows' squares (one
        // copy of this code for both passes: unrolled twice, the epilogues
        // overflow the instruction cache)
        if (pass == 0) mbar_wait(res_full, tile & 1);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = pass * HALF + 8 * j + 2 * t4;
          const float2 b = bias ? __ldg(reinterpret_cast<const float2*>(bias + col))
                                : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* p = at(r0 + 8 * h, col);
            // the column pair's roundings two at a time: bf16(sum + bias) by
            // one conversion; bf16(res * alpha) and bf16(ab + ra) in bf16x2
            // arithmetic, the same values (a product of two bf16 is exact in
            // f32, and a f32 sum of two bf16 is inexact only where one is
            // under 2^-16 of the other, far from a bf16 tie)
            const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
            const __nv_bfloat162 ab = __floats2bfloat162_rn(bias ? __fadd_rn(s0, b.x) : s0,
                                                            bias ? __fadd_rn(s1, b.y) : s1);
            // (_rn: no contraction of the two into one fused multiply-add)
            const __nv_bfloat162 hv = __hadd2_rn(ab, __hmul2_rn(*p, alpha2));
            *p = hv;
            const float2 hf = __bfloat1622float2(hv);
            ss[h] = __fadd_rn(__fadd_rn(ss[h], __fmul_rn(hf.x, hf.x)), __fmul_rn(hf.y, hf.y));
          }
        }
      }

      // the rows' scales (a row's 512 squares: the thread's 128 and those of
      // the three lanes that share its rows), the normalised rows times the
      // weight in place of h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = ss[h];
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(v, (float)O), eps)));
#pragma unroll 8
        for (int j = 0; j < O / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          __nv_bfloat162* p = at(r0 + 8 * h, col);
          const float2 hf = __bfloat1622float2(*p);
          // bf16(h * rstd), then bf16(hr * nw) in bf16x2 (exact as above)
          *p = __hmul2_rn(__floats2bfloat162_rn(__fmul_rn(hf.x, rstd), __fmul_rn(hf.y, rstd)),
                       *reinterpret_cast<const __nv_bfloat162*>(nw_s + col));
        }
      }
      // the warpgroup's 64 rows to the output by TMA (rows past M are not
      // written), then the tile buffer is free for the next residual
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (lt == 0) {
        const unsigned char* boxes = tile_s + wg * (O / RBOX) * 64 * RBOX * 2;
        for (int b = 0; b < O / RBOX; ++b)
          tma_store_2d(&map_o, b * RBOX, m0 + 64 * wg, smem_u32(boxes + b * 64 * RBOX * 2));
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive_local(res_empty);
      }
    }
  }
}

// ---- K14 at float32 -----------------------------------------------------------

namespace f32 {

constexpr int BM = 64;          // rows a CTA
constexpr int HALF = 256;       // columns a pass
constexpr int BK = 32;          // k a slab
constexpr int LDS = BK + 4;     // the slabs' row stride in floats
constexpr int LDH = O + 8;      // h's row stride in floats
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGE = (BM + HALF) * LDS;  // floats a stage
constexpr int SMEM_BYTES = (2 * STAGE + BM * LDH) * 4;

// cp.async of the 32-k slab at k0 of x's rows [m0, m0 + BM) and W's rows
// [n0, n0 + HALF) into stage `st`; x's rows past M are zero-filled.
__device__ __forceinline__ void load_slab(const float* x, const float* w, int M, int K, int m0,
                                          int n0, int k0, float* st) {
  for (int i = threadIdx.x; i < (BM + HALF) * (BK / 4); i += THREADS) {
    const int r = i / (BK / 4), c = i % (BK / 4);
    const bool is_x = r < BM;
    const int m = m0 + r;
    const bool ok = !is_x || m < M;
    const float* src = is_x ? x + (size_t)(ok ? m : 0) * K + k0 + 4 * c
                            : w + (size_t)(n0 + r - BM) * K + k0 + 4 * c;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(st + r * LDS + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
                 "r"(ok ? 16 : 0));
  }
}

// x^2 + y^2 + z^2 + w^2, each step one rounded operation
__device__ __forceinline__ float squares(float4 v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                   __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
}

__global__ void __launch_bounds__(THREADS, 1) fused_norm_f32_kernel(
    const float* __restrict__ x,     // [M, K]
    const float* __restrict__ w,     // [O, K]
    const float* __restrict__ bias,  // [O] or null
    const float* __restrict__ res,   // [M, O]
    const float* __restrict__ nw,    // [O]
    float* __restrict__ out,         // [M, O]
    int M, int K, float alpha, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [2][BM + HALF][LDS]: x rows, then W rows
  float* h_s = ring + 2 * STAGE;                 // [BM][LDH]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int wr = (warp >> 2) * 32;  // the warp's rows of the block
  const int wc = (warp & 3) * 64;   // and columns of the pass
  const int k_tiles = K / BK;

  for (int pass = 0; pass < 2; ++pass) {
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    load_slab(x, w, M, K, m0, pass * HALF, 0, ring);
    cp_async_commit();
    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles) {
        load_slab(x, w, M, K, m0, pass * HALF, (kt + 1) * BK, ring + ((kt + 1) & 1) * STAGE);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* xs = ring + (kt & 1) * STAGE;
      const float* ws = xs + BM * LDS;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ap = xs + (wr + 16 * mt + g) * LDS + 8 * ks + t4;
          tf32_split(ap[0], ah[mt][0], al[mt][0]);
          tf32_split(ap[8 * LDS], ah[mt][1], al[mt][1]);
          tf32_split(ap[4], ah[mt][2], al[mt][2]);
          tf32_split(ap[8 * LDS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* bp = ws + (wc + 8 * nt + g) * LDS + 8 * ks + t4;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(bp[0], bh0, bl0);
          tf32_split(bp[4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_3xtf32_split(acc[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
      __syncthreads();  // the stage is free for the slab after next
    }
    // h = (sum + bias) + residual * alpha into h_s
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = pass * HALF + wc + 8 * nt + 2 * t4;
      const float2 b = bias ? __ldg(reinterpret_cast<const float2*>(bias + col))
                            : make_float2(0.f, 0.f);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr + 16 * mt + g + 8 * h, m = m0 + r;
          const float2 rv =
              m < M ? __ldg(reinterpret_cast<const float2*>(res + (size_t)m * O + col))
                    : make_float2(0.f, 0.f);
          const float s0 = acc[mt][nt][2 * h], s1 = acc[mt][nt][2 * h + 1];
          const float a0 = bias ? __fadd_rn(s0, b.x) : s0;
          const float a1 = bias ? __fadd_rn(s1, b.y) : s1;
          *reinterpret_cast<float2*>(h_s + r * LDH + col) = make_float2(
              __fadd_rn(a0, __fmul_rn(rv.x, alpha)), __fadd_rn(a1, __fmul_rn(rv.y, alpha)));
        }
    }
  }
  __syncthreads();
  // each warp's 8 rows: the sum of squares across the warp, then the
  // normalised row times the weight, in full lines
  for (int r = warp * (BM / WARPS); r < (warp + 1) * (BM / WARPS); ++r) {
    const int m = m0 + r;
    float4 hv[O / 128];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < O / 128; ++i) {
      hv[i] = *reinterpret_cast<const float4*>(h_s + r * LDH + 128 * i + 4 * lane);
      ss = __fadd_rn(ss, squares(hv[i]));
    }
    ss = warp_sum(ss);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)O), eps)));
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < O / 128; ++i) {
      const int col = 128 * i + 4 * lane;
      const float4 nv = __ldg(reinterpret_cast<const float4*>(nw + col));
      *reinterpret_cast<float4*>(out + (size_t)m * O + col) = make_float4(
          __fmul_rn(__fmul_rn(hv[i].x, rstd), nv.x), __fmul_rn(__fmul_rn(hv[i].y, rstd), nv.y),
          __fmul_rn(__fmul_rn(hv[i].z, rstd), nv.z), __fmul_rn(__fmul_rn(hv[i].w, rstd), nv.w));
    }
  }
}

}  // namespace f32

}  // namespace

// K14 at float32: every tensor float32; O = 512, K a multiple of 32, M >= 1;
// bias may be null; all 16-byte aligned.
DTT_EXPORT int matmul_residual_rmsnorm_f32(const void* x, const void* w, const void* bias,
                                           const void* res, const void* nw, void* out, int M,
                                           int K, int out_width, float alpha, float eps,
                                           void* stream) {
  if (M <= 0 || K <= 0 || K % f32::BK || out_width != O)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(f32::fused_norm_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         f32::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + f32::BM - 1) / f32::BM;
  f32::fused_norm_f32_kernel<<<blocks, f32::THREADS, f32::SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<const float*>(nw), static_cast<float*>(out), M, K, alpha, eps);
  return static_cast<int>(cudaGetLastError());
}

// O = 512, K a multiple of 32, M >= 1; bias may be null (else 8-byte
// aligned); x, w, res and out 16-byte aligned.
DTT_EXPORT int matmul_residual_rmsnorm_bf16(const void* x, const void* w, const void* bias,
                                            const void* res, const void* nw, void* out, int M,
                                            int K, int out_width, float alpha, float eps,
                                            void* stream) {
  if (M <= 0 || K <= 0 || K % 32 || out_width != O)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w, map_r, map_o;
  if (!make_map(&map_x, x, 2, M, K, BM, BK) || !make_map(&map_w, w, 2, O, K, WBOX, BK) ||
      !make_map(&map_r, res, 2, M, O, 64, RBOX) || !make_map(&map_o, out, 2, M, O, 64, RBOX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_norm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card runs at once
  int active = 0;
  err = active_clusters((const void*)fused_norm_kernel, CS, THREADS, SMEM_BYTES, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = ((M + BM - 1) / BM + CS - 1) / CS;
  cfg.gridDim = dim3(CS * (groups < active ? groups : active));
  err = cudaLaunchKernelEx(&cfg, fused_norm_kernel, map_x, map_w, map_r, map_o,
                           static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(nw),
                           M, K, alpha, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
