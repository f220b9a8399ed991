// Banded (windowed) softmax attention of the sup transformer with the rotary
// embedding of q and k inside.
//
// Replaces dorado_tpu/ops/attention.py::windowed_attention_ext_fused (Pallas
// body _attn_ext_fused_kernel). For each batch row n, head h and query
// position i of qkv [N, T, 3*H*64] (bf16; q | k | v thirds, head-major):
//   rot(x)[d] = bf16(cos[i][d%32] * x[d] + (d < 32 ? -sin : sin)[i][d%32] * x[d^32])
//   logit[j]  = (rot(q_i) . rot(k_j)) * 1/8        (f32)
//   valid(j)  = -wu <= j - i <= wl  and  rb - wl <= j < re + wu  and  0 <= j < T
//               with [rb, re) the reference's query strip that holds i
//               (strips of ref_elems queries, the last cut at T)
//   p[j]      = exp(logit[j] - max over valid j)  (0 where not valid)
//   out[i]    = bf16((sum_j p[j] * v_j) / sum_j p[j])
// The TPU kernel takes an extended projection [q|k|v|q_swap|k_swap] so that
// its rotation needs no lane shuffle; the swap columns are copies of q and k
// columns, so here the plain projection is enough and the halves are swapped
// while a tile is loaded.
//
// What bounds it on the H100: bytes. At sup's shape (N = 128, T = 1024,
// H = 8) it reads 403 MB and writes 134 MB, while the band's useful products
// are 69 GFLOP. A block owns 64 queries of one head and row: it rotates
// them and the 320 keys their bands can reach into shared memory (k and v of
// one head and row, 256 KB, are shared by 16 blocks that run side by side,
// so they come from L2), and each of its 4 warps takes 16 queries over the
// 272 keys their bands span, 16 keys at a time, on the tensor cores
// (mma.sync.m16n8k16 bf16): one pass for the row maxima, a second that
// recomputes the logits, exponentiates and multiplies into v. The two passes
// cost half as many products again and keep the arithmetic that of a plain
// softmax (no running rescale). p stays f32-accurate through the bf16 tensor
// cores as a sum of two bf16 terms (p = hi + lo, two products), since v is
// bf16 already. Every rotation step is a single rounded operation, so the
// rotated q and k equal the plain version's bit for bit.
#include "common.cuh"

namespace {

constexpr int D = 64;            // head width
constexpr int BQ = 64;           // queries a block
constexpr int WIN_MAX = 128;     // widest window either side
constexpr int SPAN = BQ + 2 * WIN_MAX;  // keys a block stages: [q0 - 128, q0 + 192)
constexpr int WSPAN = 16 + 2 * WIN_MAX; // keys a warp's 16 queries span
constexpr int LD = D + 8;        // shared row stride in bf16 (144 bytes)
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(uint4 v, float out[8]) {
  unpack4(make_uint2(v.x, v.y), out);
  unpack4(make_uint2(v.z, v.w), out + 4);
}

// Rotate 8 channels of the first half (lo) and their partners of the second
// half (hi) of one q or k row and store both as bf16.
__device__ __forceinline__ void rotate_store(const __nv_bfloat16* src, const float* cos_row,
                                             const float* sin_row, int c8,
                                             __nv_bfloat16* dst) {
  float lo[8], hi[8];
  unpack8(*reinterpret_cast<const uint4*>(src + c8 * 8), lo);
  unpack8(*reinterpret_cast<const uint4*>(src + 32 + c8 * 8), hi);
  const float4 ca = *reinterpret_cast<const float4*>(cos_row + c8 * 8);
  const float4 cb = *reinterpret_cast<const float4*>(cos_row + c8 * 8 + 4);
  const float4 sa = *reinterpret_cast<const float4*>(sin_row + c8 * 8);
  const float4 sb = *reinterpret_cast<const float4*>(sin_row + c8 * 8 + 4);
  const float c[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
  const float s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  uint32_t out_lo[4], out_hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float rl[2], rh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 2 * i + e;
      rl[e] = __fadd_rn(__fmul_rn(c[d], lo[d]), __fmul_rn(-s[d], hi[d]));
      rh[e] = __fadd_rn(__fmul_rn(c[d], hi[d]), __fmul_rn(s[d], lo[d]));
    }
    out_lo[i] = pack_bf16(rl[0], rl[1]);
    out_hi[i] = pack_bf16(rh[0], rh[1]);
  }
  *reinterpret_cast<uint4*>(dst + c8 * 8) = make_uint4(out_lo[0], out_lo[1], out_lo[2], out_lo[3]);
  *reinterpret_cast<uint4*>(dst + 32 + c8 * 8) =
      make_uint4(out_hi[0], out_hi[1], out_hi[2], out_hi[3]);
}

__global__ void __launch_bounds__(THREADS) attention_banded_kernel(
    const __nv_bfloat16* __restrict__ qkv,  // [N, T, 3*H*D]
    const float* __restrict__ cos_t,        // [T, D/2]
    const float* __restrict__ sin_t,        // [T, D/2]
    __nv_bfloat16* __restrict__ out,        // [N, T, H*D]
    int T, int H, int win_upper, int win_lower, int ref_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* k_s = q_s + BQ * LD;                           // [SPAN][LD]
  __nv_bfloat16* v_s = k_s + SPAN * LD;                         // [SPAN][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const int hd = H * D;
  const size_t row_stride = (size_t)3 * hd;
  const __nv_bfloat16* base = qkv + (size_t)n * T * row_stride + head * D;
  const int kb = q0 - WIN_MAX;  // position of staged key 0

  // ---- stage: rotated q, rotated k, v ------------------------------------
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < BQ * 4; i += THREADS) {
    const int r = i >> 2, c8 = i & 3;
    const int t = q0 + r;
    __nv_bfloat16* dst = q_s + r * LD;
    if (t < T) {
      rotate_store(base + (size_t)t * row_stride, cos_t + (size_t)t * (D / 2),
                   sin_t + (size_t)t * (D / 2), c8, dst);
    } else {
      *reinterpret_cast<uint4*>(dst + c8 * 8) = zero;
      *reinterpret_cast<uint4*>(dst + 32 + c8 * 8) = zero;
    }
  }
  for (int i = tid; i < SPAN * 4; i += THREADS) {
    const int r = i >> 2, c8 = i & 3;
    const int t = kb + r;
    __nv_bfloat16* dst = k_s + r * LD;
    if (t >= 0 && t < T) {
      rotate_store(base + (size_t)t * row_stride + hd, cos_t + (size_t)t * (D / 2),
                   sin_t + (size_t)t * (D / 2), c8, dst);
    } else {
      *reinterpret_cast<uint4*>(dst + c8 * 8) = zero;
      *reinterpret_cast<uint4*>(dst + 32 + c8 * 8) = zero;
    }
  }
  for (int i = tid; i < SPAN * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const int t = kb + r;
    uint4 v = zero;
    if (t >= 0 && t < T)
      v = *reinterpret_cast<const uint4*>(base + (size_t)t * row_stride + 2 * hd + c * 8);
    *reinterpret_cast<uint4*>(v_s + r * LD + c * 8) = v;
  }
  __syncthreads();

  // ---- this warp's 16 queries ---------------------------------------------
  const int r0 = warp * 16;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p = q_s + (r0 + g) * LD + kk * 16 + 2 * t4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }
  // valid keys of the thread's two rows (g and g + 8), as closed ranges
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + g + 8 * h;
    const int rb = (qi / ref_elems) * ref_elems;
    const int re = min(rb + ref_elems, T);
    lo[h] = max(max(qi - win_upper, rb - win_lower), 0);
    hi[h] = min(min(qi + win_lower, re + win_upper - 1), T - 1);
  }
  const float scale = 0.125f;  // 1 / sqrt(D)
  const float masked = -1e30f;

  // logits of 16 keys from staged row kl: s[j][2h + e] is row g + 8h, key
  // kb + kl + 8j + 2*t4 + e
  auto logits = [&](int kl, float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* p = k_s + (kl + 8 * j + g) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + kk * 16 + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + kl + 8 * j + 2 * t4 + (e & 1);
        const int h = e >> 1;
        s[j][e] = (key >= lo[h] && key <= hi[h]) ? __fmul_rn(s[j][e], scale) : masked;
      }
    }
  };

  // pass 1: row maxima
  float mx[2] = {masked, masked};
  for (int c = 0; c < WSPAN / 16; ++c) {
    float s[2][4];
    logits(r0 + 16 * c, s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }

  // pass 2: p = exp(logit - max), row sums, p . v
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float sum[2] = {0.f, 0.f};
  for (int c = 0; c < WSPAN / 16; ++c) {
    const int kl = r0 + 16 * c;
    float s[2][4];
    logits(kl, s);
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], top[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e];
          p[e] = (x == masked) ? 0.f : expf(x - mx[h]);
          sum[h] += p[e];
          top[e] = __bfloat162float(__float2bfloat16_rn(p[e]));
        }
        // a-fragment order: (row g, keys 0-7), (row g+8, keys 0-7),
        // (row g, keys 8-15), (row g+8, keys 8-15)
        p_hi[2 * j + h] = pack_bf16(top[0], top[1]);
        p_lo[2 * j + h] = pack_bf16(p[0] - top[0], p[1] - top[1]);
      }
    }
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(
          vb, v_s + (kl + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], p_hi, vb[0], vb[1]);
      mma_bf16(o[2 * dp], p_lo, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], p_hi, vb[2], vb[3]);
      mma_bf16(o[2 * dp + 1], p_lo, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }

  // ---- store ---------------------------------------------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + r0 + g + 8 * h;
    if (t >= T) continue;
    __nv_bfloat16* dst = out + ((size_t)n * T + t) * hd + head * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      __nv_bfloat162 y;
      y.x = __float2bfloat16_rn(__fdiv_rn(o[dt][2 * h], sum[h]));
      y.y = __float2bfloat16_rn(__fdiv_rn(o[dt][2 * h + 1], sum[h]));
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = y;
    }
  }
}

}  // namespace

// Heads of 64 channels, windows of at most 128 keys either side.
DTT_EXPORT int attention_banded_bf16(const void* qkv, const void* cos_t, const void* sin_t,
                                     void* out, int N, int T, int H, int head_dim,
                                     int win_upper, int win_lower, int ref_elems, void* stream) {
  if (N <= 0 || T <= 0 || H <= 0 || head_dim != D || win_upper < 0 || win_lower < 0 ||
      win_upper > WIN_MAX || win_lower > WIN_MAX || ref_elems <= 0 || N > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (BQ + 2 * SPAN) * LD * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attention_banded_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, N);
  attention_banded_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(out), T, H, win_upper,
      win_lower, ref_elems);
  return static_cast<int>(cudaGetLastError());
}
