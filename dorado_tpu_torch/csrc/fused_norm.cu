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
// 512-row tile by the whole weight in VMEM; here the bf16 product is written
// out on the tensor cores (mma.sync.m16n8k16, f32 accumulators).
//
// The norm needs the whole output row (O = 512), so a block owns BM = 64 rows
// and all 512 columns: 8 warps of 64 rows x 64 columns each, 128 f32
// accumulators a thread. K comes in slabs of 32 through a three-stage
// cp.async ring (x rows and all 512 weight rows of the slab: 46 KB a stage),
// so the next slabs load while this one is multiplied; the weights come from
// L2 for every block. The epilogue rounds and adds the residual in registers,
// sums each row's squares across the warp's lanes by shuffles and across the
// 8 warps through shared memory, in a fixed order.
//
// What bounds it on the H100: at sup's out_proj (M = 131072, K = 512, with a
// bias) bytes: 403 MB (x, residual, output; 0.12 ms) against 69 GFLOP
// (0.07 ms at the bf16 peak); at fc2 (K = 2048, no bias) operations:
// 275 GFLOP (0.28 ms) against 807 MB (0.24 ms). One block an SM (138 KB of
// ring): the epilogue does not overlap the next block's loads.
#include "common.cuh"

namespace {

constexpr int O = 512;          // output width: sup's d_model
constexpr int BM = 64;          // rows a block
constexpr int BK = 32;          // K a slab, in bf16
constexpr int LDS = BK + 8;     // shared row stride (80 bytes: 8 rows of an ldmatrix on 32 banks)
constexpr int STAGES = 3;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WN = O / WARPS;   // columns a warp: 64

__global__ void __launch_bounds__(THREADS) fused_norm_kernel(
    const __nv_bfloat16* __restrict__ x,    // [M, K]
    const __nv_bfloat16* __restrict__ w,    // [O, K]
    const float* __restrict__ bias,         // [O] or null
    const __nv_bfloat16* __restrict__ res,  // [M, O]
    const __nv_bfloat16* __restrict__ nw,   // [O]
    __nv_bfloat16* __restrict__ out,        // [M, O]
    int M, int K, float alpha, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDS]
  __nv_bfloat16* w_ring = x_ring + STAGES * BM * LDS;               // [STAGES][O][LDS]
  float* red = reinterpret_cast<float*>(w_ring + STAGES * O * LDS);  // [WARPS][BM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int wn = warp * WN;

  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* xs = x_ring + stage * BM * LDS;
    __nv_bfloat16* ws = w_ring + stage * O * LDS;
    const int k0 = kt * BK;
    for (int i = tid; i < (BM + O) * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      if (r < BM) {
        if (m0 + r < M)
          cp_async16(xs + r * LDS + c, x + (size_t)(m0 + r) * K + k0 + c);
        else
          *reinterpret_cast<uint4*>(xs + r * LDS + c) = make_uint4(0, 0, 0, 0);
      } else {
        cp_async16(ws + (r - BM) * LDS + c, w + (size_t)(r - BM) * K + k0 + c);
      }
    }
  };

  const int k_tiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  // acc[i][j][2h + e]: row 16i + g + 8h, column wn + 8j + 2*t4 + e
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // lane l gives the row address of matrix l / 8, row l % 8 (common.cuh)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab kt landed; the stage consumed last round is free
    const int ahead = kt + STAGES - 1;
    if (ahead < k_tiles) load_stage(ahead % STAGES, ahead);
    cp_async_commit();
    const __nv_bfloat16* xs = x_ring + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* ws = w_ring + (kt % STAGES) * O * LDS + wn * LDS;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      uint32_t a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], xs + (16 * i + a_row) * LDS + a_col + k0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ldmatrix_x4(b[jj], ws + (16 * jj + b_row) * LDS + b_col + k0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[i][2 * jj], a[i], b[jj][0], b[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], b[jj][2], b[jj][3]);
        }
    }
  }

  // ---- epilogue: h in place of the sums, and the rows' sums of squares ------
  float ss[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) ss[i][0] = ss[i][1] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = wn + 8 * j + 2 * t4;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * i + g + 8 * h;
        float r[2] = {0.f, 0.f};
        if (m < M) {
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)m * O + col);
          r[0] = __low2float(rv);
          r[1] = __high2float(rv);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sum = acc[i][j][2 * h + e];
          const float a = bias ? __fadd_rn(sum, e ? b1 : b0) : sum;
          const float ab = __bfloat162float(__float2bfloat16_rn(a));
          const float ra = __bfloat162float(__float2bfloat16_rn(__fmul_rn(r[e], alpha)));
          const float hv = __bfloat162float(__float2bfloat16_rn(__fadd_rn(ab, ra)));
          acc[i][j][2 * h + e] = hv;
          ss[i][h] = __fadd_rn(ss[i][h], __fmul_rn(hv, hv));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = ss[i][h];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t4 == 0) red[warp * BM + 16 * i + g + 8 * h] = v;
    }
  __syncthreads();

  // ---- the rows' scales, the normalised rows times the weight ---------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * i + g + 8 * h;
      const int m = m0 + row;
      float total = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < WARPS; ++w8) total = __fadd_rn(total, red[w8 * BM + row]);
      const float rstd =
          __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(total, (float)O), eps)));
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn + 8 * j + 2 * t4;
        const __nv_bfloat162 wv = *reinterpret_cast<const __nv_bfloat162*>(nw + col);
        __nv_bfloat162 y;
        y.x = __float2bfloat16_rn(__fmul_rn(
            __bfloat162float(__float2bfloat16_rn(__fmul_rn(acc[i][j][2 * h], rstd))),
            __low2float(wv)));
        y.y = __float2bfloat16_rn(__fmul_rn(
            __bfloat162float(__float2bfloat16_rn(__fmul_rn(acc[i][j][2 * h + 1], rstd))),
            __high2float(wv)));
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * O + col) = y;
      }
    }
  }
}

}  // namespace

// O = 512, K a multiple of 32, M >= 1; bias may be null.
DTT_EXPORT int matmul_residual_rmsnorm_bf16(const void* x, const void* w, const void* bias,
                                            const void* res, const void* nw, void* out, int M,
                                            int K, int out_width, float alpha, float eps,
                                            void* stream) {
  if (M <= 0 || K <= 0 || K % BK || out_width != O)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = STAGES * (BM + O) * LDS * (int)sizeof(__nv_bfloat16) +
                   WARPS * BM * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_norm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_norm_kernel<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(nw), static_cast<__nv_bfloat16*>(out), M, K, alpha, eps);
  return static_cast<int>(cudaGetLastError());
}
