// The W8A8 feed-forward of the sup transformer: int8 rows times int8 weights
// on the tensor cores, for rows that are quantised already.
//
// swiglu_w8a8_kernel (K12). Replaces dorado_tpu/ops/int8_matmul.py::
// swiglu_w8a8 (Pallas body _swiglu_kernel). Per row of xq [M, K] int8 with
// scale xs[m], and the two halves wy, wg [F, K] int8 of fc1 with scales
// wys, wgs [F]:
//   y = (float(xq . wy[f]) * xs) * wys[f];  g = (float(xq . wg[f]) * xs) * wgs[f]
//   t = y * (g * (1 / (1 + exp(-g))))
//   ts = max(max_f |t|, 1e-12) * (1/127);   tq = int8(rint(t * (1 / ts)))
// The int32 sums are exact and every float step is one correctly rounded
// operation in this order (1 / x by rcp_near, exact where 1 <= x < 2^126,
// else __frcp_rn: the value of __fdiv_rn(1, x); rint by rint_small); only
// expf may differ from PyTorch's exp in the last bit.
//
// What bounds it on the H100: operations. At sup (M = 131072, K = 512,
// F = 2048) one pass over both halves is 550 GOP, 0.278 ms at the int8
// peak, against 336 MB moved (0.10 ms); its epilogue (an expf and a
// reciprocal a value, 268 M values) is about as much work again on the
// ALUs, and the weights (2 MB) come from L2 for every 128 rows, 2.1 GB in
// all. A row's scale needs its whole F = 2048 wide t, which one CTA cannot
// hold in float32. The first version (mma.sync from a two-stage cp.async
// ring) therefore walked the features twice, once for the row maxima and
// once to recompute t and quantise it, twice the products and the epilogue:
// 2.792 ms.
//
// Design (one pass): a cluster of C CTAs shares a 128-row block, each CTA
// owning F / C of its features (C = 8 and 256 features at sup, chosen from
// the shape by ops/int8_matmul.py::swiglu_plan):
//   - the block's int8 x (128 x K, 64 KB at K = 512) comes once by TMA,
//     multicast to the C CTAs (CTA r loads the 128-byte columns r, r + C, ..);
//   - one producer thread streams the CTA's weight slabs through a TMA ring:
//     64 features of wy and the same 64 of wg by 64 bytes of K (8 KB), so a
//     thread's accumulators hold y and g of the same features;
//   - two consumer warpgroups of 64 rows run wgmma m64n128k32 .s32.s8.s8,
//     then compute t once a feature tile into a float32 tile in shared
//     memory, [128][F / C] (128 KB at sup; 32-byte groups swizzled by row so
//     that neither the fragment stores nor the row reads conflict), keeping
//     each row's running max |t| in registers. The reciprocal has no branch
//     (rcp_near), so the chains of a thread's 16 values interleave: with
//     __frcp_rn's slow-path branch for every value the epilogue was the
//     slowest part of the kernel;
//   - at the end of a block the consumers write their rows' maxima and go on
//     with the next block. Three quantiser warps take the block from there:
//     one thread publishes the CTA's maxima to the cluster (a cluster-scope
//     fence and an arrival on every CTA's barrier, which stalled the
//     consumers when they did it), all three read the C maxima of each row
//     through distributed shared memory (max is exact in any order),
//     quantise the t tile a feature tile at a time (4-byte stores, 64
//     contiguous bytes a row) and free each tile's columns for the
//     consumers' next block; CTA 0 writes ts. The consumers still wait for
//     the first tile's columns at each block: the quantisers' loop is slow
//     to issue (beside the consumers' epilogue), not to load;
//   - persistent clusters stride over the row blocks; the ring runs on from
//     one block into the next.
// x (64 KB) and t (128 KB) leave room for four 8 KB stages at K = 512, not
// for the two tiles of slabs that would let the next tile's products be
// issued before this tile's epilogue, so a warpgroup's epilogue does not
// overlap its own products.
// Where F / 64 has no divisor C <= 8 with F / C <= 256, the plan takes the
// two-pass form of the same kernel (ONE_PASS false, one CTA a block, all F):
// it recomputes t, as the first version did. Rows past M come in as zeros
// (t = 0: they raise no row max) and are not stored. Every mbarrier wait
// traps after about 4 s instead of hanging the card.
//
// w8a8_matmul_kernel (K13). Replaces dorado_tpu/ops/int8_matmul.py::
// w8a8_matmul (Pallas body _a8_kernel): out = TO((float(xq . wq[o]) * xs)
// * ws[o]) for xq [M, K] int8 with row scales xs, wq [O, K] int8 with
// channel scales ws, TO bf16 or float32 (the JAX package's
// compute_dtype=float32 path); the int32 sums are exact and the two products
// single rounded operations, so it equals the plain version bit for bit. The
// float32 form is an instantiation of the same kernel whose tile, twice the
// bf16 one's bytes, leaves through the same buffer in two halves of 64
// columns, so that the ring keeps its depth; its output doubles in bytes
// (0.260 ms at sup's fc2 against a 0.161 ms byte bound; NVIDIA H100 80GB
// HBM3, 700 W, chip_smoke.py).
//
// What bounds it on the H100: operations, just ahead of bytes. At sup's fc2
// (M = 131072, K = 2048, O = 512) it is 275 GOP (0.139 ms at the int8 peak)
// against 403 MB of x in and the output out (0.120 ms); the 1 MB weight
// stays in L2 but is read from it for every 128-row block, 1 GB in all
// with one CTA a tile. The first version (mma.sync from a three-stage
// cp.async ring, every thread issuing copies, 4096 short-lived 128 x 128
// CTAs fetching each row block once for each of the four column tiles, the
// epilogue storing 4-byte pairs from the fragments) took 0.516 ms.
//
// Design (persistent CTAs in clusters of up to four along O, from
// ops/int8_matmul.py::w8a8_plan: the largest of 4, 2, 1 that divides O / 128):
//   - CTA r of a cluster computes the 128 x 128 tile of column tile r of the
//     cluster's work unit (a row block and the cluster's column tiles); K
//     streams through a ring of six 32 KB stages (128 rows of x and 128
//     channels of w by 128 bytes of K, in the 128-byte swizzle the wgmma
//     descriptors read);
//   - one producer warp's lane fills the ring by TMA: its CTA's w slab, and
//     its 1 / cluster share of the row block's x slab multicast to every CTA
//     of the cluster, so x leaves memory once for all the column tiles; x
//     passes through once, under an evict-first L2 policy, so that it does
//     not push the weight (1 MB at sup, read for every row block) out of L2.
//     A stage is refilled once every consumer of the cluster has released it;
//   - two consumer warpgroups of 64 rows run wgmma m64n128k32 .s32.s8.s8,
//     one stage's group in flight while the next is issued, and release
//     each stage as its products complete; their warp index comes through a
//     shuffle, so that ptxas does not take their code for divergent and
//     serialise the wgmma;
//   - the epilogue (float(acc) * xs, then * ws, then bf16) writes the tile
//     into shared memory in the output map's swizzle, and a TMA store sends
//     it out under an evict-first policy while the consumers go on with the
//     next tile, whose first stages the producer has loaded meanwhile. A
//     second accumulator set, to issue the next tile's products before this
//     tile's epilogue, would not fit beside the first (it spilled in K2).
//     Rows past M come in as zeros and are not stored.
// On the card moving x and w holds it, not its products: without them it
// took nearly as long. Tiles 256 channels wide (m64n256k32, four 48 KB
// stages), clusters that also multicast w to a pair of row blocks, and an
// L2 prefetch of x ahead of the ring were each slower.
// Every mbarrier wait traps after about 4 s instead of hanging the card.
#include "common.cuh"
#include "tma_map.cuh"

// ---------------------------------------------------------------------------
// K12: fc1 + SwiGLU + per-row requantisation
// ---------------------------------------------------------------------------

namespace k12 {

constexpr int BM = 128;            // rows a block: 64 a consumer warpgroup (a wgmma's M)
constexpr int FT = 64;             // features a tile: 64 of wy, the same 64 of wg (N = 128)
constexpr int KS = 64;             // bytes of K a weight slab: one 64-byte swizzle row
constexpr int SLAB = 2 * FT * KS;  // 8 KB
constexpr int XB = 128;            // bytes of K a column of x: one 128-byte swizzle row
constexpr int CONSUMERS = 2;       // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_WARP = 4 * CONSUMERS;  // its lane 0 issues every load
constexpr int QUANT_WARPS = 3;     // the other warps of the last warpgroup
constexpr int MAX_K = 512;
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_TILES = 4;       // feature tiles a CTA in one pass: 256 features, 128 KB of t
constexpr int SMEM_LIMIT = 232448;

// Dynamic shared memory of a launch (ops/int8_matmul.py::swiglu_plan says
// the same): the 1024-byte alignment, x, t (one pass), the ring, the rows'
// maxima [2][BM] and scales [BM], and the mbarriers.
constexpr int smem_bytes(int K, int one_pass, int fc, int stages) {
  return 1024 + BM * K + (one_pass ? BM * fc * 4 : 0) + stages * SLAB + 3 * BM * 4 +
         8 * (2 * MAX_STAGES + 5 + MAX_TILES);
}

// 1 / x correctly rounded for 1 <= x < 2^126 without a branch: the
// approximate reciprocal and one Newton step by fused multiply-adds.
// rcp_near_mismatches below holds it against __frcp_rn at every float of
// that range (chip_smoke.py runs it: none differ on an H100).
__device__ __forceinline__ float rcp_near(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return __fmaf_rn(__fmaf_rn(-x, y, 1.0f), y, y);
}

// t of one accumulator pair, the reciprocal by __frcp_rn (any input)
__device__ __forceinline__ float swiglu(int ay, int ag, float xr, float sy, float sg) {
  const float y = __fmul_rn(__fmul_rn((float)ay, xr), sy);
  const float g = __fmul_rn(__fmul_rn((float)ag, xr), sg);
  const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-g)));
  return __fmul_rn(y, __fmul_rn(g, sig));
}

// a, b, c, d times inv, rounded, as the bytes of one word in that order
// (cvt.pack puts its two ints in the low bytes, the third operand's low half
// above them; |q| <= 127, so its saturation never acts)
__device__ __forceinline__ uint32_t pack_q(float a, float b, float c, float d, float inv) {
  const int q0 = rint_small(__fmul_rn(a, inv));
  const int q1 = rint_small(__fmul_rn(b, inv));
  const int q2 = rint_small(__fmul_rn(c, inv));
  const int q3 = rint_small(__fmul_rn(d, inv));
  uint32_t lo, r;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, 0;" : "=r"(lo) : "r"(q3), "r"(q2));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(q1), "r"(q0), "r"(lo));
  return r;
}

template <bool ONE_PASS>
__global__ void __launch_bounds__(THREADS, 1) swiglu_w8a8_kernel(
    const __grid_constant__ CUtensorMap map_x,   // xq [M, K]: boxes of BM rows x XB
    const __grid_constant__ CUtensorMap map_wy,  // wy [F, K]: boxes of FT rows x KS
    const __grid_constant__ CUtensorMap map_wg,  // wg [F, K]: the same
    const float* __restrict__ xs,                // [M]
    const float* __restrict__ wys,               // [F]
    const float* __restrict__ wgs,               // [F]
    int8_t* __restrict__ tq,                     // [M, F]
    float* __restrict__ ts,                      // [M]
    int M, int K, int F, int cluster, int stages) {
  constexpr int PASSES = ONE_PASS ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int fc = F / cluster;  // the CTA's features (all F in the two-pass form)
  const int tiles = fc / FT;
  unsigned char* x_s = smem;                                 // [K / XB][BM][XB], swizzled
  float* t_s = reinterpret_cast<float*>(x_s + BM * K);       // [BM][fc] (one pass)
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(t_s) + (ONE_PASS ? BM * fc * 4 : 0);  // [stages][2 FT][KS]
  float* maxima = reinterpret_cast<float*>(ring + stages * SLAB);  // [2][BM], by block parity
  float* row_inv = maxima + 2 * BM;                                // [BM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(row_inv + BM);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + MAX_STAGES);
  // x has come in; every consumer of the cluster is done with it; the
  // cluster's row maxima of a block parity are published; a tile's columns
  // of t are quantised (free for the next block's)
  const uint32_t x_full = smem_u32(bars + 2 * MAX_STAGES), x_empty = x_full + 8;
  const uint32_t max_full0 = x_full + 16, t_free0 = x_full + 32;
  const uint32_t max_local = t_free0 + 8 * MAX_TILES;  // both warpgroups' maxima are written

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid & 31;
  const uint32_t rank = ONE_PASS ? cluster_rank() : 0;
  const int f_cta = rank * fc;
  const int kslabs = K / KS;
  const int blocks = (M + BM - 1) / BM;
  const int cid = blockIdx.x / cluster, nclusters = gridDim.x / cluster;
  const float inv127 = (float)(1.0 / 127.0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's arrival + the bytes
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, CONSUMERS * cluster);
    mbar_init(max_full0, cluster);
    mbar_init(max_full0 + 8, cluster);
    for (int c = 0; c < MAX_TILES; ++c) mbar_init(t_free0 + 8 * c, QUANT_WARPS);
    mbar_init(max_local, CONSUMERS);
    mbar_init_fence();
  }
  cluster_sync();  // the cluster's mbarriers are initialised

  if (wg == CONSUMERS) {
    if (warp == PRODUCER_WARP) {
      // ---- producer: one thread issues every load --------------------------
      if (lane == 0) {
        int stage = 0, phase = 0, it = 0;
        for (int blk = cid; blk < blocks; blk += nclusters, ++it) {
          mbar_wait(x_empty, (it & 1) ^ 1);  // the cluster is done with the last block's x
          mbar_expect(x_full, BM * K);       // all of x, whichever CTA loads a column
          for (int kb = rank; kb < K / XB; kb += cluster) {
            const uint32_t dst = smem_u32(x_s + kb * BM * XB);
            if (cluster > 1)
              tma_load_2d_multicast(dst, &map_x, kb * XB, blk * BM, x_full, (1 << cluster) - 1);
            else
              tma_load_2d(dst, &map_x, kb * XB, blk * BM, x_full);
          }
          for (int pass = 0; pass < PASSES; ++pass)
            for (int tile = 0; tile < tiles; ++tile)
              for (int ks = 0; ks < kslabs; ++ks) {
                mbar_wait(empty0 + 8 * stage, phase ^ 1);
                mbar_expect(full0 + 8 * stage, SLAB);
                const int f = f_cta + tile * FT;
                const uint32_t dst = smem_u32(ring + stage * SLAB);
                tma_load_2d(dst, &map_wy, ks * KS, f, full0 + 8 * stage);
                tma_load_2d(dst + FT * KS, &map_wg, ks * KS, f, full0 + 8 * stage);
                if (++stage == stages) {
                  stage = 0;
                  phase ^= 1;
                }
              }
        }
      }
      __syncwarp();
    } else if (ONE_PASS) {
      // ---- quantisers: the rows' scales over the cluster, then tq ----------
      // (while the consumers go on with the next block)
      const int qt = tid - (PRODUCER_WARP + 1) * 32;
      int it = 0;
      for (int blk = cid; blk < blocks; blk += nclusters, ++it) {
        const int m0 = blk * BM, mb = it & 1;
        if (qt == 0) {
          // publish this CTA's maxima to the cluster: the cluster-scope fence
          // and arrivals cost the consumers nothing here
          mbar_wait(max_local, it & 1);
          asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
          for (int p = 0; p < cluster; ++p) mbar_arrive_cluster(max_full0 + 8 * mb, p);
        }
        mbar_wait_cluster(max_full0 + 8 * mb, (it >> 1) & 1);
        for (int r = qt; r < BM; r += 32 * QUANT_WARPS) {
          const uint32_t at = smem_u32(maxima + mb * BM + r);
          float v = 0.f;
#pragma unroll
          for (int p = 0; p < MAX_CLUSTER; ++p)
            if (p < cluster) v = fmaxf(v, ld_cluster_f32(map_rank(at, p)));
          const float sc = __fmul_rn(fmaxf(v, 1e-12f), inv127);
          row_inv[r] = __fdiv_rn(1.0f, sc);
          if (rank == 0 && m0 + r < M) ts[m0 + r] = sc;
        }
        named_bar_sync(1 + CONSUMERS, 32 * QUANT_WARPS);  // row_inv is written
        for (int tile = 0; tile < tiles; ++tile) {
          // 128 rows x 64 features: 16 lanes a row, a lane keeping its 4
          // features over rows RSTEP apart, QB rows loaded before any is
          // stored (the consumers wait on this loop at each block's first
          // tile)
          constexpr int RSTEP = 32 * QUANT_WARPS / (FT / 4), QB = 8;
          const int fl = tile * FT + 4 * (qt % (FT / 4));
          const float* t_col = t_s + (fl & 7);
          const int grp = fl >> 3;
          int8_t* dst = tq + (size_t)m0 * F + f_cta + fl;
          for (int r0 = qt / (FT / 4); r0 < BM; r0 += RSTEP * QB) {
            float4 v[QB];
            float inv[QB];
#pragma unroll
            for (int u = 0; u < QB; ++u) {
              const int row = r0 + u * RSTEP;
              if (row < BM) {
                v[u] =
                    *reinterpret_cast<const float4*>(t_col + row * fc + ((grp ^ (row & 7)) << 3));
                inv[u] = row_inv[row];
              }
            }
#pragma unroll
            for (int u = 0; u < QB; ++u) {
              const int row = r0 + u * RSTEP;
              if (row < BM && m0 + row < M)
                *reinterpret_cast<uint32_t*>(dst + (size_t)row * F) =
                    pack_q(v[u].x, v[u].y, v[u].z, v[u].w, inv[u]);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive_local(t_free0 + 8 * tile);
        }
        named_bar_sync(1 + CONSUMERS, 32 * QUANT_WARPS);  // row_inv may be rewritten
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, t and its row maxima -------------
    const int lt = tid % 128;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = (lt >> 5) * 16 + g;  // the thread's rows r0, r0 + 8 of its warpgroup's 64
    const uint32_t x_wg = smem_u32(x_s + wg * 64 * XB);
    int acc[64];
    int stage = 0, phase = 0, it = 0;
    for (int blk = cid; blk < blocks; blk += nclusters, ++it) {
      const int m0 = blk * BM;
      const int rows[2] = {m0 + 64 * wg + r0, m0 + 64 * wg + r0 + 8};
      float xr[2], amax[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) xr[h] = rows[h] < M ? __ldg(xs + rows[h]) : 0.f;
      mbar_wait(x_full, it & 1);
      for (int pass = 0; pass < PASSES; ++pass) {
        if (!ONE_PASS && pass == 1) {
          // the rows' scales from the first pass's maxima (a row's features
          // lie in the four lanes that share g)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = amax[h];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const float sc = __fmul_rn(fmaxf(v, 1e-12f), inv127);
            inv[h] = __fdiv_rn(1.0f, sc);
            if (t4 == 0 && rows[h] < M) ts[rows[h]] = sc;
          }
        }
        for (int tile = 0; tile < tiles; ++tile) {
          int held = -1;  // the stage whose products may still run
          for (int ks = 0; ks < kslabs; ++ks) {
            mbar_wait(full0 + 8 * stage, phase);
#pragma unroll
            for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
            wgmma_fence();
            const uint32_t xa = x_wg + (ks * KS / XB) * BM * XB + (ks * KS) % XB;
            const uint32_t wb = smem_u32(ring + stage * SLAB);
#pragma unroll
            for (int kk = 0; kk < KS / 32; ++kk)
              wgmma_m64n128k32_s8(acc, wgmma_desc<XB>(xa + 32 * kk), wgmma_desc<KS>(wb + 32 * kk),
                                  ks > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<1>();
            if (held >= 0 && lt == 0) mbar_arrive_local(empty0 + 8 * held);
            held = stage;
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
          if (lt == 0) mbar_arrive_local(empty0 + 8 * held);
          // the block's last products are done: x may be refilled in every
          // CTA of the cluster
          if (pass == PASSES - 1 && tile == tiles - 1 && lt < cluster)
            mbar_arrive_cluster(x_empty, lt);
          // the last block's values of these columns are quantised
          if (ONE_PASS) mbar_wait(t_free0 + 8 * tile, (it & 1) ^ 1);

          // the tile's t, in two halves of 16 values a thread: column 8 j +
          // 2 t4 + e of the accumulators is y of feature tile * FT + 8 j +
          // 2 t4 + e, column 64 + the same its g. The reciprocal without a
          // branch lets the values' chains interleave; a half with a 1 +
          // exp(-g) at 2^126 or more (or NaN) is computed again with
          // __frcp_rn
#pragma unroll
          for (int jh = 0; jh < FT / 8; jh += FT / 16) {
            float tv[FT / 16][2][2];
            bool wide = false;
#pragma unroll
            for (int jj = 0; jj < FT / 16; ++jj) {
              const int j = jh + jj, fl = tile * FT + 8 * j + 2 * t4;
              const float2 sy = __ldg(reinterpret_cast<const float2*>(wys + f_cta + fl));
              const float2 sg = __ldg(reinterpret_cast<const float2*>(wgs + f_cta + fl));
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float y = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + e], xr[h]),
                                            e ? sy.y : sy.x);
                  const float gt = __fmul_rn(
                      __fmul_rn((float)acc[4 * (j + 8) + 2 * h + e], xr[h]), e ? sg.y : sg.x);
                  const float den = __fadd_rn(1.0f, expf(-gt));
                  wide |= !(den < 0x1p126f);
                  tv[jj][h][e] = __fmul_rn(y, __fmul_rn(gt, rcp_near(den)));
                }
            }
            if (wide) {
#pragma unroll
              for (int jj = 0; jj < FT / 16; ++jj) {
                const int j = jh + jj, fl = tile * FT + 8 * j + 2 * t4;
                const float2 sy = __ldg(reinterpret_cast<const float2*>(wys + f_cta + fl));
                const float2 sg = __ldg(reinterpret_cast<const float2*>(wgs + f_cta + fl));
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  tv[jj][h][0] =
                      swiglu(acc[4 * j + 2 * h], acc[4 * (j + 8) + 2 * h], xr[h], sy.x, sg.x);
                  tv[jj][h][1] = swiglu(acc[4 * j + 2 * h + 1], acc[4 * (j + 8) + 2 * h + 1],
                                        xr[h], sy.y, sg.y);
                }
              }
            }
#pragma unroll
            for (int jj = 0; jj < FT / 16; ++jj) {
              const int fl = tile * FT + 8 * (jh + jj) + 2 * t4;  // the feature within the CTA's
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float t0 = tv[jj][h][0], t1 = tv[jj][h][1];
                if (ONE_PASS || pass == 0) amax[h] = fmaxf(amax[h], fmaxf(fabsf(t0), fabsf(t1)));
                if (ONE_PASS) {
                  // group fl / 8 of the row at group fl / 8 XOR row % 8
                  const int row = 64 * wg + r0 + 8 * h;
                  *reinterpret_cast<float2*>(t_s + row * fc + ((((fl >> 3) ^ (row & 7))) << 3) +
                                             (fl & 7)) = make_float2(t0, t1);
                } else if (pass == 1 && rows[h] < M) {
                  const int q0 = rint_small(__fmul_rn(t0, inv[h]));
                  const int q1 = rint_small(__fmul_rn(t1, inv[h]));
                  *reinterpret_cast<uint16_t*>(tq + (size_t)rows[h] * F + fl) =
                      (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
                }
              }
            }
          }
        }
      }
      if (ONE_PASS) {
        // the rows' maxima over the CTA's features, published to the
        // cluster; the quantisers take it from there
        const int mb = it & 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = amax[h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (t4 == 0) maxima[mb * BM + 64 * wg + r0 + 8 * h] = v;
        }
        named_bar_sync(1 + wg, 128);  // the warpgroup's maxima and t are written
        if (lt == 0) mbar_arrive_local(max_local);
      }
    }
  }
  __syncwarp();
  cluster_sync();  // no CTA leaves while a peer may still read its maxima or arrive on its barriers
}

// Counts the floats x in [1, 2^126) where rcp_near(x) differs from
// __frcp_rn(x) into *bad.
__global__ void rcp_near_check_kernel(unsigned long long* bad) {
  const uint32_t lo = 0x3f800000u, n = 0x7e800000u - lo;  // 1 .. 2^126
  unsigned long long count = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + i);
    count += __float_as_uint(rcp_near(x)) != __float_as_uint(__frcp_rn(x));
  }
  if (count) atomicAdd(bad, count);
}

int launch(const void* xq, const void* xs, const void* wy, const void* wys, const void* wg,
           const void* wgs, void* tq, void* ts, int M, int K, int F, int one_pass, int cluster,
           int stages, void* stream) {
  if (M <= 0 || K <= 0 || K > MAX_K || K % XB || F <= 0 || F % FT || stages < 2 ||
      stages > MAX_STAGES || cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  if (one_pass ? ((F / FT) % cluster || F / FT / cluster > MAX_TILES) : cluster != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(K, one_pass, F / cluster, stages);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_wy, map_wg;
  if (!make_map(&map_x, xq, 1, M, K, BM, XB) || !make_map(&map_wy, wy, 1, F, K, FT, KS) ||
      !make_map(&map_wg, wg, 1, F, K, FT, KS))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = one_pass ? (const void*)swiglu_w8a8_kernel<true>
                                : (const void*)swiglu_w8a8_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int active = 0;
  err = active_clusters(kernel, cluster, THREADS, smem, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card runs at once
  const int blocks = (M + BM - 1) / BM;
  cfg.gridDim = dim3(cluster * (blocks < active ? blocks : active));
  const float* xsp = static_cast<const float*>(xs);
  const float* wysp = static_cast<const float*>(wys);
  const float* wgsp = static_cast<const float*>(wgs);
  int8_t* tqp = static_cast<int8_t*>(tq);
  float* tsp = static_cast<float*>(ts);
  err = one_pass ? cudaLaunchKernelEx(&cfg, swiglu_w8a8_kernel<true>, map_x, map_wy, map_wg, xsp,
                                      wysp, wgsp, tqp, tsp, M, K, F, cluster, stages)
                 : cudaLaunchKernelEx(&cfg, swiglu_w8a8_kernel<false>, map_x, map_wy, map_wg,
                                      xsp, wysp, wgsp, tqp, tsp, M, K, F, cluster, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k12

// ---------------------------------------------------------------------------
// K13: int8 matmul of quantised rows (fc2)
// ---------------------------------------------------------------------------

namespace k13 {

constexpr int BM = 128;            // rows a tile: 64 a consumer warpgroup (a wgmma's M)
constexpr int BN = 128;            // output channels a tile (a wgmma's N)
constexpr int KB = 128;            // bytes of K a stage: one 128-byte swizzle row
constexpr int STAGE = (BM + BN) * KB;  // 32 KB: the x slab, then the w slab
constexpr int CONSUMERS = 2;       // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int PRODUCER_WARP = 4 * CONSUMERS;   // its lane 0 issues every load
constexpr int OUT_BYTES = CONSUMERS * 64 * BN * 2;  // a bf16 tile for each consumer
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 4;
constexpr int SMEM_LIMIT = 232448;

// Dynamic shared memory of a launch (ops/int8_matmul.py::w8a8_plan says the
// same): the 1024-byte alignment, the ring, the output tiles, the mbarriers.
constexpr int smem_bytes(int stages) {
  return 1024 + stages * STAGE + OUT_BYTES + 8 * 2 * MAX_STAGES;
}

// TO: the output's element type (__nv_bfloat16 or float)
template <typename TO>
__global__ void __launch_bounds__(THREADS, 1) w8a8_matmul_kernel(
    const __grid_constant__ CUtensorMap map_x,  // xq [M, K]: boxes of BM / cluster rows x KB
    const __grid_constant__ CUtensorMap map_w,  // wq [O, K]: boxes of BN rows x KB
    const __grid_constant__ CUtensorMap map_o,  // out [M, O] TO: boxes of 64 rows x 128 bytes
    const float* __restrict__ xs,               // [M]
    const float* __restrict__ ws,               // [O]
    int M, int K, int O, int cluster, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;                    // [stages][BM + BN][KB], swizzled
  unsigned char* out_s = ring + stages * STAGE;  // [CONSUMERS][2 boxes][64][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_s + OUT_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + MAX_STAGES);
  // the output tile leaves in PASSES column slices of PCOLS, two boxes each
  constexpr int PASSES = sizeof(TO) / 2, PCOLS = BN / PASSES, BOX = 128 / sizeof(TO);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's and warpgroup's indices through a shuffle (see the header)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  const int rank = (int)cluster_rank();  // the CTA's column tile in the cluster's
  const int kbs = K / KB;
  const int col_groups = O / BN / cluster;
  const int units = (M + BM - 1) / BM * col_groups;  // (row block, column group)
  const int cid = blockIdx.x / cluster, nclusters = gridDim.x / cluster;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);                     // the producer's arrival + the bytes
      mbar_init(empty0 + 8 * s, CONSUMERS * cluster);  // every consumer of the cluster
    }
    mbar_init_fence();
  }
  cluster_sync();  // the cluster's mbarriers are initialised

  if (wg == CONSUMERS) {
    // ---- producer: one thread fills the ring -----------------------------
    if (lane == 0) {
      const uint64_t stream = l2_evict_first();  // x is read once
      const uint16_t all = (uint16_t)((1 << cluster) - 1);
      const int xrows = BM / cluster;
      int stage = 0, phase = 0;
      for (int u = cid; u < units; u += nclusters) {
        const int m0 = u / col_groups * BM;
        const int n0 = (u % col_groups * cluster + rank) * BN;
        for (int kb = 0; kb < kbs; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the whole cluster released it
          mbar_expect(full0 + 8 * stage, STAGE);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t xd = smem_u32(ring + stage * STAGE + rank * xrows * KB);
          const uint32_t wd = smem_u32(ring + stage * STAGE + BM * KB);
          // this CTA's share of the x slab, to every CTA of the cluster
          if (cluster > 1)
            tma_load_2d_multicast_hint(xd, &map_x, kb * KB, m0 + rank * xrows, full, all, stream);
          else
            tma_load_2d_hint(xd, &map_x, kb * KB, m0, full, stream);
          tma_load_2d(wd, &map_w, kb * KB, n0, full);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // the peers' consumers have released every stage: their arrivals on
      // this CTA's empty barriers, and this CTA's multicasts into theirs,
      // are complete before it exits
      for (int s = 0; s < stages; ++s) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue -----------------
    const int lt = tid % 128;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = (lt >> 5) * 16 + g;  // the thread's rows r0, r0 + 8 of its warpgroup's 64
    unsigned char* my_out = out_s + wg * (OUT_BYTES / CONSUMERS);
    int acc[64];
    int stage = 0, phase = 0;
    for (int u = cid; u < units; u += nclusters) {
      const int m0 = u / col_groups * BM;
      const int n0 = (u % col_groups * cluster + rank) * BN;
      const int rows[2] = {m0 + 64 * wg + r0, m0 + 64 * wg + r0 + 8};
      float rs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rs[h] = rows[h] < M ? __ldg(xs + rows[h]) : 0.f;
      int held = -1;  // the stage whose products may still run
      for (int kb = 0; kb < kbs; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        wgmma_fence();
        const uint32_t xa = smem_u32(ring + stage * STAGE + wg * 64 * KB);
        const uint32_t wb = smem_u32(ring + stage * STAGE + BM * KB);
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          wgmma_m64n128k32_s8(acc, wgmma_desc<KB>(xa + 32 * kk), wgmma_desc<KB>(wb + 32 * kk),
                              kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0 && lt < cluster) mbar_arrive_cluster(empty0 + 8 * held, lt);
        held = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      if (lt < cluster) mbar_arrive_cluster(empty0 + 8 * held, lt);

      // the dequantised sums, to the output by TMA: the bf16 tile in one
      // pass, the float32 one in two column halves through the same buffer
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        if (lt == 0) bulk_wait_read<0>();  // the last store has read the buffer
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < PCOLS / 8; ++jj) {
          const int j = ps * (PCOLS / 8) + jj;
          const int col = 8 * j + 2 * t4;
          const float2 w2 = __ldg(reinterpret_cast<const float2*>(ws + n0 + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0 = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h], rs[h]), w2.x);
            const float y1 = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], rs[h]), w2.y);
            store_pair_swz128<TO>(my_out, r0 + 8 * h, col - ps * PCOLS, y0, y1);
          }
        }
        fence_proxy_async();  // the tile is read by the TMA store (the async proxy)
        named_bar_sync(1 + wg, 128);
        if (lt == 0) {
          const uint64_t stream = l2_evict_first();  // written once
          const int c0 = n0 + ps * PCOLS;
          tma_store_2d_hint(&map_o, c0, m0 + 64 * wg, smem_u32(my_out), stream);
          tma_store_2d_hint(&map_o, c0 + BOX, m0 + 64 * wg, smem_u32(my_out + 64 * 128), stream);
          bulk_commit();
        }
      }
    }
    if (lt == 0) bulk_wait_all();
  }
}

template <typename TO>
int launch(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int M,
           int K, int O, int cluster, int stages, void* stream) {
  if (M <= 0 || K <= 0 || K % KB || O <= 0 || O % BN || cluster < 1 || cluster > MAX_CLUSTER ||
      BM % cluster || (O / BN) % cluster || stages < 2 || stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(stages);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w, map_o;
  if (!make_map(&map_x, xq, 1, M, K, BM / cluster, KB) || !make_map(&map_w, wq, 1, O, K, BN, KB) ||
      !make_map(&map_o, out, sizeof(TO), M, O, 64, 128 / sizeof(TO)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w8a8_matmul_kernel<TO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int active = 0;
  err = active_clusters((const void*)kernel, cluster, THREADS, smem, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card runs at once
  const long long units = (long long)((M + BM - 1) / BM) * (O / BN / cluster);
  cfg.gridDim = dim3(cluster * (int)(units < active ? units : active));
  err = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, map_o,
                           static_cast<const float*>(xs), static_cast<const float*>(ws), M, K, O,
                           cluster, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k13

// The check of rcp_near over its whole range: bad is one zeroed
// unsigned 64-bit counter on the card.
DTT_EXPORT int rcp_near_mismatches(void* bad, void* stream) {
  k12::rcp_near_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// K a multiple of 128 up to 512, F a multiple of 64, M >= 1; one_pass,
// cluster and stages from ops/int8_matmul.py::swiglu_plan.
DTT_EXPORT int swiglu_w8a8_i8(const void* xq, const void* xs, const void* wy, const void* wys,
                              const void* wg, const void* wgs, void* tq, void* ts, int M, int K,
                              int F, int one_pass, int cluster, int stages, void* stream) {
  return k12::launch(xq, xs, wy, wys, wg, wgs, tq, ts, M, K, F, one_pass, cluster, stages, stream);
}

// K and O multiples of 128, M >= 1; the cluster (column tiles that share x)
// and stages from ops/int8_matmul.py::w8a8_plan; out_bytes 2 (bf16) or 4
// (float32).
DTT_EXPORT int w8a8_matmul(const void* xq, const void* xs, const void* wq, const void* ws,
                           void* out, int M, int K, int O, int cluster, int stages,
                           int out_bytes, void* stream) {
  if (out_bytes == 2)
    return k13::launch<__nv_bfloat16>(xq, xs, wq, ws, out, M, K, O, cluster, stages, stream);
  if (out_bytes == 4)
    return k13::launch<float>(xq, xs, wq, ws, out, M, K, O, cluster, stages, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
