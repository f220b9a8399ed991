// W8A8 matmul with the activation quantisation fused in: the LSTM input
// projection of a quantised layer, and the transformer's qkv projection.
//
// Replaces dorado_tpu/ops/int8_matmul.py::w8a8_matmul_fq (Pallas body
// _fq_kernel). Per row of x [M, K] (bf16 or float32), with wq [O, K] int8
// (one row per output channel), ws [O] and bias [O] float32:
//   amax = max|x|;  s = max(amax, 1e-12) * (1/127);  xq = rint(x * (1/s))
//   acc  = xq . wq[o]                      (int8 x int8 -> int32, exact)
//   out  = TO((float(acc) * s) * ws[o] + bias[o])     TO: x's type
// Every float step is a single correctly rounded operation (no FMA
// contraction), so the result equals the plain PyTorch version bit for bit,
// in either type. The float32 form (the JAX package's compute_dtype=float32
// path: float32 rows in, float32 gates out) is an instantiation of the same
// kernel: a quantiser lane reads its 8 values of a row as two 16-byte loads
// in place of one, with half as many rows in flight, so that its registers
// stay those of the bf16 form; and the float32 tile, twice the bf16 one's
// bytes, leaves through the same shared-memory buffer in two halves of 64
// columns, so that the ring keeps its depth. The float32 output doubles the
// bytes that bound it: 0.748 ms at hac's shape against a 0.489 ms byte
// bound, 0.458 ms at sup's qkv against 0.321 (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py).
//
// What bounds it on the H100: bytes. At hac's shape (M = 213248, K = 384,
// O = 1536) it reads 164 MB of activations and writes 655 MB of gates
// (0.245 ms at 3.35 TB/s), while its 2.5e11 int8 operations take 0.127 ms
// at the tensor cores' peak. So the output has to leave in full lines while
// the products, the quantisation and the epilogue all hide under its
// stores. The first version (mma.sync from a two-stage cp.async ring, each
// block quantising its rows before its first product, the output stored as
// 4-byte pairs from the fragments) took 1.199 ms.
//
// Design (persistent CTAs of three warpgroups, in clusters of two on
// neighbouring 128-row blocks):
//   - three quantiser warps read the next block's bf16 rows (16-byte loads,
//     half a warp a row, twelve loads a lane in flight; the row's amax by
//     shuffles) and write the int8 rows straight into the 128-byte swizzle
//     that the wgmma descriptor reads, into the free one of two A buffers
//     (one where two do not fit: K > 512, `abuf`), each row's scale beside;
//   - one producer thread streams the weight slabs (128 output channels x
//     128 bytes of K, 16 KB) through a TMA ring; each CTA of the cluster
//     loads half of every slab and multicasts it to both, so the weights
//     are read from L2 once for 256 rows; a stage is refilled once the
//     consumers of both CTAs have released it;
//   - two consumer warpgroups of 64 rows run wgmma m64n128k32 .s32.s8.s8
//     over an output tile's K, then its epilogue. Issuing the next tile's
//     products into a second set of accumulators before this tile's
//     epilogue needs 128 accumulator registers a thread: at the 168 that 384
//     threads allow, ptxas spilled and waited on the wgmma, and that form
//     was slower on the card;
//   - the epilogue writes the bf16 tile into shared memory in the output
//     map's swizzle and a TMA store sends it out in full lines; rows past M
//     are not written. Rows past M come in as zeros;
//   - x and the output pass through once: their loads and stores carry an
//     evict-first L2 policy, so that they do not push the weights out of L2
//     (with the default policy, reading the weights again took a large share
//     of the kernel's time at hac).
// Every mbarrier wait traps after about 4 s instead of hanging the card.
#include "common.cuh"
#include "tma_map.cuh"

namespace {

constexpr int BM = 128;         // rows a block: 64 a consumer warpgroup (a wgmma's M)
constexpr int BN = 128;         // output channels a tile (a wgmma's N)
constexpr int KB = 128;         // bytes of K a slab and a column of A: one 128-byte swizzle row
constexpr int CS = 2;           // CTAs a cluster
constexpr int CONSUMERS = 2;    // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_WARP = 4 * CONSUMERS;  // its lane 0 issues every weight load
constexpr int QUANT_WARPS = 3;  // the other warps of the last warpgroup
constexpr int MAX_K = 768;
constexpr int MAX_STAGES = 8;
constexpr int SLAB = BN * KB;   // 16 KB
constexpr int A_COL = BM * KB;  // one 128-byte column of an A buffer
constexpr int OUT_BYTES = CONSUMERS * 64 * BN * 2;  // a bf16 tile (half a float32 one) each
constexpr int SMEM_LIMIT = 232448;

// Dynamic shared memory of a launch (ops/int8_matmul.py::w8a8_fq_plan says
// the same): the 1024-byte alignment, the A buffers, the ring, the output
// tiles, the rows' scales [2][BM] and the mbarriers.
constexpr int smem_bytes(int K, int abuf, int stages) {
  return 1024 + abuf * BM * K + stages * SLAB + OUT_BYTES + 2 * BM * 4 + 8 * (2 * MAX_STAGES + 4);
}

// Values 2i and 2i + 1 of a lane's 8, from its one (bf16) or two (float32)
// 16-byte loads.
__device__ __forceinline__ float2 pair_at(const uint4 (&v)[1], int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&v[0])[i]);
}
__device__ __forceinline__ float2 pair_at(const uint4 (&v)[2], int i) {
  return reinterpret_cast<const float2*>(&v[i >> 1])[i & 1];
}

// Quantiser warp q's share of a block's rows (K = 128 KBS): half a warp a
// row, 8 values a lane; the row pairs q, q + 3, .. taken PAIRS at a time so
// that each lane has 10 to 12 loads of 16 bytes in flight. The rows are
// read once, so they neither stay in L1 nor push the weights out of L2.
// Row r's int8 values go to A's 128-byte column c, row r, in the 128-byte
// swizzle (16-byte chunk hl / 2 XOR r % 8, its half hl % 2); its scale to
// scale[r] (0 past M, where the values are 0).
//
// A float32 row takes two 16-byte loads a lane for the same 8 values (VEC),
// and half as many row pairs are in flight (PAIRS), so that the loads hold
// the same registers as the bf16 form's.
template <typename TI, int KBS>
__device__ __forceinline__ void quantise_rows(const TI* __restrict__ x, unsigned char* a,
                                              float* scale, int m0, int M, int q, int lane) {
  constexpr int VEC = sizeof(TI) / 2;  // 16-byte loads for 8 values
  constexpr int PAIRS = 12 / (KBS * VEC) > 0 ? 12 / (KBS * VEC) : 1;
  constexpr int K = KBS * KB;
  const uint64_t stream = l2_evict_first();  // x is read once
  const int half = lane >> 4, hl = lane & 15;
  const float inv127 = (float)(1.0 / 127.0);
  for (int p0 = q; p0 < BM / 2; p0 += QUANT_WARPS * PAIRS) {
    uint4 v[PAIRS][KBS][VEC];
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const int r = 2 * (p0 + u * QUANT_WARPS) + half, m = m0 + r;
      const bool live = r < BM && m < M;
      // the lane's 8 values of each 128-column chunk c
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m * K) + hl * VEC;
#pragma unroll
      for (int c = 0; c < KBS; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[u][c][e] =
              live ? ld_stream16(src + c * 16 * VEC + e, stream) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const int r = 2 * (p0 + u * QUANT_WARPS) + half, m = m0 + r;
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < KBS; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = pair_at(v[u][c], i);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)  // within the half-warp
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = __fmul_rn(fmaxf(amax, 1e-12f), inv127);
      const float inv = __fdiv_rn(1.0f, s);
      if (r < BM) {
#pragma unroll
        for (int c = 0; c < KBS; ++c) {
          uint32_t w[2] = {0, 0};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = pair_at(v[u][c], i);
            const int q0 = __float2int_rn(__fmul_rn(f.x, inv));
            const int q1 = __float2int_rn(__fmul_rn(f.y, inv));
            w[i >> 1] |= ((uint32_t)(q0 & 0xFF) | ((uint32_t)(q1 & 0xFF) << 8)) << (16 * (i & 1));
          }
          *reinterpret_cast<uint2*>(a + c * A_COL + r * KB + (((hl >> 1) ^ (r & 7)) << 4) +
                                    (hl & 1) * 8) = make_uint2(w[0], w[1]);
        }
        if (hl == 0) scale[r] = m < M ? s : 0.f;
      }
    }
  }
}

// TI, TO: x's and the output's element types (__nv_bfloat16 or float).
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS, 1) w8a8_fq_kernel(
    const __grid_constant__ CUtensorMap map_w,  // wq [O, K] int8: boxes of 64 rows x KB
    const __grid_constant__ CUtensorMap map_o,  // out [M, O] TO: boxes of 64 rows x 128 bytes
    const TI* __restrict__ x,                   // [M, K]
    const float* __restrict__ ws,               // [O]
    const float* __restrict__ bias,             // [O]
    int M, int K, int O, int abuf, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* a_s = smem;                             // [abuf][K / KB][BM][KB], swizzled
  unsigned char* ring = a_s + abuf * BM * K;             // [stages][BN][KB], swizzled
  unsigned char* out_s = ring + stages * SLAB;           // [CONSUMERS][2 boxes][64][128 B]
  // the output tile leaves in PASSES column slices of PCOLS, two boxes each
  constexpr int PASSES = sizeof(TO) / 2, PCOLS = BN / PASSES, BOX = 128 / sizeof(TO);
  float* row_scale = reinterpret_cast<float*>(out_s + OUT_BYTES);  // [2][BM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(row_scale + 2 * BM);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + MAX_STAGES);
  // an A buffer holds a block's int8 rows; its rows have left it
  const uint32_t a_full0 = smem_u32(bars + 2 * MAX_STAGES), a_empty0 = a_full0 + 16;

  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's and warpgroup's indices through a shuffle, so that ptxas
  // knows them uniform across the warp: with a branch on tid / 128 it took
  // the consumers' code for divergent and serialised every wgmma
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  const uint32_t rank = cluster_rank();
  const int kbs = K / KB;  // slabs a tile
  const int n_tiles = O / BN;
  const int groups = ((M + BM - 1) / BM + CS - 1) / CS;  // pairs of row blocks
  const int cid = blockIdx.x / CS, nclusters = gridDim.x / CS;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrival + the bytes
      mbar_init(empty0 + 8 * s, CONSUMERS * CS);  // every consumer of the cluster
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(a_full0 + 8 * b, QUANT_WARPS);
      mbar_init(a_empty0 + 8 * b, CONSUMERS);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the cluster's mbarriers are initialised

  if (wg == CONSUMERS) {
    if (warp == PRODUCER_WARP) {
      // ---- producer: one thread streams the weight slabs ------------------
      if (lane == 0) {
        int stage = 0, phase = 0;
        for (int grp = cid; grp < groups; grp += nclusters)
          for (int nt = 0; nt < n_tiles; ++nt)
            for (int kb = 0; kb < kbs; ++kb) {
              mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the whole cluster released it
              mbar_expect(full0 + 8 * stage, SLAB);
              tma_load_2d_multicast(smem_u32(ring + stage * SLAB + rank * 64 * KB), &map_w,
                                    kb * KB, nt * BN + rank * 64, full0 + 8 * stage,
                                    (1 << CS) - 1);
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
        // the peers' consumers have released every stage: their arrivals on
        // this CTA's empty barriers are in before it exits
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
      // ---- quantisers: the next block's int8 rows into a free A buffer -----
      const int q = warp - PRODUCER_WARP - 1;
      int it = 0;
      for (int grp = cid; grp < groups; grp += nclusters, ++it) {
        const int buf = abuf == 2 ? (it & 1) : 0;
        const int use = abuf == 2 ? (it >> 1) : it;  // earlier fills of this buffer
        mbar_wait(a_empty0 + 8 * buf, (use & 1) ^ 1);
        const int m0 = (grp * CS + rank) * BM;
        unsigned char* a = a_s + buf * BM * K;
        float* scale = row_scale + buf * BM;
        switch (kbs) {
          case 1: quantise_rows<TI, 1>(x, a, scale, m0, M, q, lane); break;
          case 2: quantise_rows<TI, 2>(x, a, scale, m0, M, q, lane); break;
          case 3: quantise_rows<TI, 3>(x, a, scale, m0, M, q, lane); break;
          case 4: quantise_rows<TI, 4>(x, a, scale, m0, M, q, lane); break;
          case 5: quantise_rows<TI, 5>(x, a, scale, m0, M, q, lane); break;
          default: quantise_rows<TI, 6>(x, a, scale, m0, M, q, lane); break;
        }
        fence_proxy_async();  // the int8 rows are read by wgmma (the async proxy)
        __syncwarp();
        if (lane == 0) mbar_arrive_local(a_full0 + 8 * buf);
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue -----------------
    const int lt = tid % 128;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = (lt >> 5) * 16 + g;  // the thread's rows r0, r0 + 8 of its warpgroup's 64
    unsigned char* my_out = out_s + wg * (OUT_BYTES / CONSUMERS);
    int acc[64];
    int stage = 0, phase = 0, it = 0;
    for (int grp = cid; grp < groups; grp += nclusters, ++it) {
      const int buf = abuf == 2 ? (it & 1) : 0;
      const int use = abuf == 2 ? (it >> 1) : it;
      const int m0 = (grp * CS + rank) * BM;
      mbar_wait(a_full0 + 8 * buf, use & 1);
      const float rs[2] = {row_scale[buf * BM + 64 * wg + r0],
                           row_scale[buf * BM + 64 * wg + r0 + 8]};
      const uint32_t a_wg = smem_u32(a_s + buf * BM * K + wg * 64 * KB);
      for (int nt = 0; nt < n_tiles; ++nt) {
        // the tile's products over its K slabs, at the ring's head
        const int first = stage;
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        wgmma_fence();
        for (int kb = 0; kb < kbs; ++kb) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t wb = smem_u32(ring + stage * SLAB);
#pragma unroll
          for (int kk = 0; kk < KB / 32; ++kk)
            wgmma_m64n128k32_s8(acc, wgmma_desc<KB>(a_wg + kb * A_COL + 32 * kk),
                                wgmma_desc<KB>(wb + 32 * kk), kb > 0 || kk > 0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        // the tile's slabs are free in every CTA of the cluster, and after
        // the block's last tile its A buffer
        if (lt < CS)
          for (int kb = 0; kb < kbs; ++kb) {
            const int s = first + kb < stages ? first + kb : first + kb - stages;
            mbar_arrive_cluster(empty0 + 8 * s, lt);
          }
        if (nt == n_tiles - 1 && lt == 0) mbar_arrive_local(a_empty0 + 8 * buf);

        // the dequantised sums plus the bias, to the output by TMA: the bf16
        // tile in one pass, the float32 one in two column halves through the
        // same buffer
#pragma unroll
        for (int ps = 0; ps < PASSES; ++ps) {
          if (lt == 0) bulk_wait_read<0>();  // the last store has read the buffer
          named_bar_sync(1 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < PCOLS / 8; ++jj) {
            const int j = ps * (PCOLS / 8) + jj;
            const int col = 8 * j + 2 * t4;
            const float2 w2 = __ldg(reinterpret_cast<const float2*>(ws + nt * BN + col));
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + nt * BN + col));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float y0 =
                  __fadd_rn(__fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h], rs[h]), w2.x), b2.x);
              const float y1 = __fadd_rn(
                  __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], rs[h]), w2.y), b2.y);
              store_pair_swz128<TO>(my_out, r0 + 8 * h, col - ps * PCOLS, y0, y1);
            }
          }
          fence_proxy_async();  // the tile is read by the TMA store (the async proxy)
          named_bar_sync(1 + wg, 128);
          if (lt == 0) {
            // the output is written once: first out of L2, so that the
            // weights stay
            const uint64_t stream = l2_evict_first();
            const int c0 = nt * BN + ps * PCOLS;
            tma_store_2d_hint(&map_o, c0, m0 + 64 * wg, smem_u32(my_out), stream);
            tma_store_2d_hint(&map_o, c0 + BOX, m0 + 64 * wg, smem_u32(my_out + 64 * 128),
                              stream);
            bulk_commit();
          }
        }
      }
    }
    if (lt == 0) bulk_wait_all();
  }
}

template <typename TI, typename TO>
int launch(const void* x, const void* wq, const void* ws, const void* bias, void* out, int M,
           int K, int O, int abuf, int stages, void* stream) {
  if (M <= 0 || K <= 0 || K > MAX_K || K % KB || O <= 0 || O % BN || abuf < 1 || abuf > 2 ||
      stages < K / KB || stages > MAX_STAGES || smem_bytes(K, abuf, stages) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_w, map_o;
  if (!make_map(&map_w, wq, 1, O, K, 64, KB) ||
      !make_map(&map_o, out, sizeof(TO), M, O, 64, 128 / sizeof(TO)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(K, abuf, stages);
  auto kernel = w8a8_fq_kernel<TI, TO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int active = 0;
  err = active_clusters((const void*)kernel, CS, THREADS, smem, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card runs at once
  const int groups = ((M + BM - 1) / BM + CS - 1) / CS;
  cfg.gridDim = dim3(CS * (groups < active ? groups : active));
  err = cudaLaunchKernelEx(&cfg, kernel, map_w, map_o, static_cast<const TI*>(x),
                           static_cast<const float*>(ws), static_cast<const float*>(bias), M, K,
                           O, abuf, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K a multiple of 128 up to 768, O a multiple of 128, M >= 1; abuf (1 or 2)
// and stages (K / 128 to 8) from ops/int8_matmul.py::w8a8_fq_plan; x and
// out both bf16 (elem_bytes 2) or both float32 (4).
DTT_EXPORT int w8a8_matmul_fq(const void* x, const void* wq, const void* ws, const void* bias,
                              void* out, int M, int K, int O, int abuf, int stages,
                              int elem_bytes, void* stream) {
  if (elem_bytes == 2)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, wq, ws, bias, out, M, K, O, abuf, stages,
                                                stream);
  if (elem_bytes == 4)
    return launch<float, float>(x, wq, ws, bias, out, M, K, O, abuf, stages, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
