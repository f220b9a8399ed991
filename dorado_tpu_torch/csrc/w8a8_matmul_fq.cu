// W8A8 matmul with the activation quantisation fused in: the LSTM input
// projection of a quantised layer, and the transformer's qkv projection.
//
// Replaces dorado_tpu/ops/int8_matmul.py::w8a8_matmul_fq (Pallas body
// _fq_kernel). Per row of x [M, K] (bf16), with wq [O, K] int8 (one row per
// output channel), ws [O] and bias [O] float32:
//   amax = max|x|;  s = max(amax, 1e-12) * (1/127);  xq = rint(x * (1/s))
//   acc  = xq . wq[o]                      (int8 x int8 -> int32, exact)
//   out  = bf16((float(acc) * s) * ws[o] + bias[o])
// Every float step is a single correctly rounded operation (no FMA
// contraction), so the result equals the plain PyTorch version bit for bit.
//
// What bounds it on the H100: bytes. At hac's shape (M = 213248, K = 384,
// O = 1536) it reads 164 MB of activations and writes 655 MB of gates, while
// its 2.5e11 int8 operations are a small share of the tensor cores' rate.
// So x is read once: a block owns 128 rows, quantises them into shared
// memory (one warp a row, amax by warp shuffles) and then walks over all
// output tiles with the int8 rows resident; the weights (0.6 MB) come from L2
// in slabs of 128 output channels by 128 bytes of K through a two-stage
// cp.async ring (int8_tile.cuh), the first slab loading while the rows are
// quantised. Up to K = 512 two blocks fit an SM, so one block's epilogue
// overlaps the other's products. M is any number of rows: the last block
// zero-fills and does not store.
#include "int8_tile.cuh"

namespace {

constexpr int MAX_K = 768;   // BM * (K + PAD) + the ring must fit shared memory
constexpr int STAGES = 2;

__global__ void __launch_bounds__(THREADS, 2) w8a8_fq_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const int8_t* __restrict__ wq,        // [O, K]
    const float* __restrict__ ws,         // [O]
    const float* __restrict__ bias,       // [O]
    __nv_bfloat16* __restrict__ out,      // [M, O]
    int M, int K, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = K + PAD;                      // shared row stride, bytes
  int8_t* a_tile = reinterpret_cast<int8_t*>(smem);                       // [BM][ld]
  int8_t* b_ring = a_tile + BM * ld;                                      // [2][BN][LDT]
  float* row_scale = reinterpret_cast<float*>(b_ring + STAGES * BN * LDT); // [BM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int k_slabs = K / BK;
  const int slabs = (O / BN) * k_slabs;

  // slab q: output tile q / k_slabs, bytes (q % k_slabs) * BK of K
  auto load_slab = [&](int q) {
    int8_t* b = b_ring + (q % STAGES) * BN * LDT;
    const int n0 = (q / k_slabs) * BN, k0 = (q % k_slabs) * BK;
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      cp_async16(b + r * LDT + c, wq + (size_t)(n0 + r) * K + k0 + c);
    }
  };
  load_slab(0);
  cp_async_commit();
  // ---- quantise this block's rows, one warp a row ------------------------
  const int chunks = K / 128;  // 8-byte loads a lane makes for one row
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    float v[MAX_K / 128][4];
    float amax = 0.f;
    if (m < M) {
      const uint2* src = reinterpret_cast<const uint2*>(x + (size_t)m * K);
#pragma unroll
      for (int c = 0; c < MAX_K / 128; ++c) {
        if (c < chunks) {
          unpack4(src[c * 32 + lane], v[c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
        }
      }
    }
    amax = warp_max(amax);
    const float s = __fmul_rn(fmaxf(amax, 1e-12f), (float)(1.0 / 127.0));
    const float inv = __fdiv_rn(1.0f, s);
    uint32_t* dst = reinterpret_cast<uint32_t*>(a_tile + r * ld);
#pragma unroll
    for (int c = 0; c < MAX_K / 128; ++c) {
      if (c < chunks) {
        uint32_t packed = 0;
        if (m < M) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = __float2int_rn(rintf(__fmul_rn(v[c][i], inv)));
            packed |= (uint32_t)(q & 0xFF) << (8 * i);
          }
        }
        dst[c * 32 + lane] = packed;
      }
    }
    if (lane == 0) row_scale[r] = (m < M) ? s : 0.f;
  }

  // ---- walk over the output tiles, a slab of K at a time -------------------
  const int wm = (warp >> 1) * 32;  // the warp's rows within the block tile
  const int wn = (warp & 1) * 64;   // its columns within the output tile
  const int g = lane >> 2, t4 = lane & 3;
  int acc[2][8][4];
  for (int q = 0; q < slabs; ++q) {
    const int ks = q % k_slabs;
    cp_async_wait<0>();
    __syncthreads();  // slab q landed (and a_tile is written); the other stage is free
    if (q + 1 < slabs) load_slab(q + 1);
    cp_async_commit();
    if (ks == 0) clear(acc);
    warp_product(acc, a_tile + ks * BK, ld, b_ring + (q % STAGES) * BN * LDT, LDT, BK, wm, wn,
                 lane);
    if (ks != k_slabs - 1) continue;

    // epilogue: dequantise, add the bias, store bf16 pairs
    const int n0 = (q / k_slabs) * BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + t4 * 2;
      const float w0 = ws[col], w1 = ws[col + 1];
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + i * 16 + g + h * 8;
          const int m = m0 + r;
          if (m < M) {
            const float s = row_scale[r];
            const float y0 = __fadd_rn(
                __fmul_rn(__fmul_rn((float)acc[i][j][2 * h], s), w0), b0);
            const float y1 = __fadd_rn(
                __fmul_rn(__fmul_rn((float)acc[i][j][2 * h + 1], s), w1), b1);
            __nv_bfloat162 y;
            y.x = __float2bfloat16_rn(y0);
            y.y = __float2bfloat16_rn(y1);
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * O + col) = y;
          }
        }
      }
    }
  }
}

}  // namespace

// K a multiple of 128 up to 768, O a multiple of 128, M >= 1.
DTT_EXPORT int w8a8_matmul_fq_bf16(const void* x, const void* wq, const void* ws,
                                   const void* bias, void* out, int M, int K, int O,
                                   void* stream) {
  if (M <= 0 || K <= 0 || K > MAX_K || K % BK || O <= 0 || O % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = BM * (K + PAD) + STAGES * BN * LDT + BM * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_fq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_fq_kernel<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, K, O);
  return static_cast<int>(cudaGetLastError());
}
