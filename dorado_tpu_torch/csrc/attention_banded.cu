// Banded (windowed) softmax attention of the sup transformer, on four layouts
// of q, k and v. One kernel body, instantiated for three ways of staging q
// and k; four entry points.
//
// Replaces dorado_tpu/ops/attention.py's banded kernels, one entry point each:
//   attention_banded_bf16     windowed_attention_ext_fused (Pallas body
//                             _attn_ext_fused_kernel): q, k, v in one [N, T,
//                             3*H*64] projection, head-major, rotated here (K9)
//   attention_prerotated_bf16 _banded_attention_call (Pallas body
//                             _attn_banded_kernel): q and k rotated already,
//                             in a [N, T, 2*H*64] tensor; v at channel block 2
//                             of the projection (K10)
//   attention_halfperm_bf16   windowed_attention_halfperm (Pallas body
//                             _attn_rope_kernel): the projection's q and k
//                             rows halves-major, [first halves of all heads |
//                             second halves of all heads], rotated here (K11a)
//   attention_separate_bf16   windowed_attention_fused (Pallas body
//                             _attn_kernel): separate q, k, v [N, T, H, 64],
//                             no rotation, windows up to 256 keys a side (K11b)
//
// For each batch row n, head h and query position i (bf16 in and out):
//   rot(x)[d] = bf16(cos[i][d%32] * x[d] + (d < 32 ? -sin : sin)[i][d%32] * x[d^32])
//               on the rotating layouts, x[d] on the others
//   logit[j]  = (rot(q_i) . rot(k_j)) * 1/8        (f32)
//   valid(j)  = -wu <= j - i <= wl  and  rb - wl <= j < re + wu  and  0 <= j < T
//               with [rb, re) the reference's query strip that holds i
//               (strips of ref_elems queries, the last cut at T)
//   p[j]      = exp(logit[j] - max over valid j)  (0 where not valid)
//   out[i]    = bf16((sum_j p[j] * v_j) / sum_j p[j])
// The TPU kernels take an extended projection [q|k|v|q_swap|k_swap] or
// [2, T, H*D] tables so that their rotation needs no lane shuffle; here the
// halves are swapped while a tile is loaded, from the [T, D/2] tables. On
// the halves-major layout the logits are the two half dots of the TPU kernel
// summed; staged in natural order, they are one 64-channel dot.
//
// What bounds it on the H100: bytes. At sup's shape (N = 128, T = 1024,
// H = 8) it reads 403 MB and writes 134 MB, while the band's useful products
// are 69 GFLOP. A block owns 64 queries of one head and row: it stages them
// (rotated, where the layout asks) and the 48 + 16 * chunks keys their bands
// can reach into shared memory (k and v of one head and row are shared by
// 16 blocks that run side by side, so they come from L2), and each of its 4
// warps takes 16 queries over the 16 + wu + wl keys their bands span, 16
// keys at a time ("chunks" of them), on the tensor cores
// (mma.sync.m16n8k16 bf16): one pass for the row maxima, a second that
// recomputes the logits, exponentiates and multiplies into v. The two passes
// cost half as many products again and keep the arithmetic that of a plain
// softmax (no running rescale). p stays f32-accurate through the bf16 tensor
// cores as a sum of two bf16 terms (p = hi + lo, two products), since v is
// bf16 already. Every rotation step is a single rounded operation, so the
// rotated q and k equal the plain version's bit for bit, on either rotating
// layout. Windows of up to 128 keys a side take a fixed span: 320 staged
// keys from q0 - 128 and 17 chunks a warp, trip counts the compiler knows
// (a span that followed the window at run time cost K9 12% at sup's
// (127, 128) on an H100); wider ones (K11b) stage 48 + 16 * chunks keys from q0 - wu,
// 576 at (256, 256), whose 175 KB of shared memory leave one block an SM.
#include "common.cuh"

namespace {

constexpr int D = 64;            // head width
constexpr int BQ = 64;           // queries a block
constexpr int WIN_MAX = 256;     // widest window either side
constexpr int NARROW = 128;      // widest window of the fixed span
constexpr int NARROW_CHUNKS = (16 + 2 * NARROW) / 16;  // 17
constexpr int LD = D + 8;        // shared row stride in bf16 (144 bytes)
constexpr int THREADS = 128;

// how q and k are staged
constexpr int PLAIN = 0;          // copied: rotated already, or never rotated
constexpr int ROPE_HEADS = 1;     // rotated; a head's halves at h*64 and h*64 + 32
constexpr int ROPE_HALVES = 2;    // rotated; a head's halves at h*32 and H*32 + h*32

__device__ __forceinline__ void unpack8(uint4 v, float out[8]) {
  unpack4(make_uint2(v.x, v.y), out);
  unpack4(make_uint2(v.z, v.w), out + 4);
}

// Rotate 8 channels of the first half (lo) and their partners of the second
// half (hi) of one q or k row and store both as bf16, at dst and dst + 32.
__device__ __forceinline__ void rotate_store(const __nv_bfloat16* lo_src,
                                             const __nv_bfloat16* hi_src, const float* cos_row,
                                             const float* sin_row, int c8,
                                             __nv_bfloat16* dst) {
  float lo[8], hi[8];
  unpack8(*reinterpret_cast<const uint4*>(lo_src + c8 * 8), lo);
  unpack8(*reinterpret_cast<const uint4*>(hi_src + c8 * 8), hi);
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

// Stage `rows` rows of q or k starting at position t0 (rows outside [0, T)
// are zeros) into dst [rows][LD], rotated where MODE asks.
template <int MODE>
__device__ __forceinline__ void stage_qk(const __nv_bfloat16* src, size_t stride, int lo_off,
                                         int hi_off, const float* cos_t, const float* sin_t,
                                         int t0, int rows, int T, __nv_bfloat16* dst) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < rows * 4; i += THREADS) {
    const int r = i >> 2, c8 = i & 3;
    const int t = t0 + r;
    __nv_bfloat16* row = dst + r * LD;
    if (t < 0 || t >= T) {
      *reinterpret_cast<uint4*>(row + c8 * 8) = zero;
      *reinterpret_cast<uint4*>(row + 32 + c8 * 8) = zero;
    } else if (MODE == PLAIN) {
      const __nv_bfloat16* s = src + (size_t)t * stride;
      *reinterpret_cast<uint4*>(row + c8 * 8) =
          *reinterpret_cast<const uint4*>(s + lo_off + c8 * 8);
      *reinterpret_cast<uint4*>(row + 32 + c8 * 8) =
          *reinterpret_cast<const uint4*>(s + hi_off + c8 * 8);
    } else {
      const __nv_bfloat16* s = src + (size_t)t * stride;
      rotate_store(s + lo_off, s + hi_off, cos_t + (size_t)t * (D / 2),
                   sin_t + (size_t)t * (D / 2), c8, row);
    }
  }
}

// q, k, v: the batch row's position 0 of each ([T, q_stride] and so on, in
// bf16 elements); a head's q and k halves at lo_off(h), hi_off(h) of a row
// (MODE), its v and output channels at h * 64. FIXED: windows of at most
// NARROW a side, NARROW_CHUNKS chunks (`chunks` is ignored).
template <int MODE, bool FIXED>
__global__ void __launch_bounds__(THREADS) attention_banded_kernel(
    const __nv_bfloat16* __restrict__ q, int q_stride,
    const __nv_bfloat16* __restrict__ k, int k_stride,
    const __nv_bfloat16* __restrict__ v, int v_stride,
    const float* __restrict__ cos_t,        // [T, D/2] (rotating layouts)
    const float* __restrict__ sin_t,        // [T, D/2]
    __nv_bfloat16* __restrict__ out,        // [N, T, H*D]
    int T, int H, int win_upper, int win_lower, int ref_elems, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (FIXED) chunks = NARROW_CHUNKS;
  const int span = 48 + 16 * chunks;  // staged keys: [kb, kb + span)
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* k_s = q_s + BQ * LD;                           // [span][LD]
  __nv_bfloat16* v_s = k_s + span * LD;                         // [span][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const int hd = H * D;
  const int lo_off = MODE == ROPE_HALVES ? head * (D / 2) : head * D;
  const int hi_off = MODE == ROPE_HALVES ? hd / 2 + head * (D / 2) : head * D + D / 2;
  const int kb = q0 - (FIXED ? NARROW : win_upper);  // position of staged key 0

  // ---- stage q, k (rotated where MODE asks) and v ----------------------------
  stage_qk<MODE>(q + (size_t)n * T * q_stride, q_stride, lo_off, hi_off, cos_t, sin_t, q0, BQ, T,
                 q_s);
  stage_qk<MODE>(k + (size_t)n * T * k_stride, k_stride, lo_off, hi_off, cos_t, sin_t, kb, span,
                 T, k_s);
  const __nv_bfloat16* v_base = v + (size_t)n * T * v_stride + head * D;
  for (int i = tid; i < span * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const int t = kb + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T)
      val = *reinterpret_cast<const uint4*>(v_base + (size_t)t * v_stride + c * 8);
    *reinterpret_cast<uint4*>(v_s + r * LD + c * 8) = val;
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

  // pass 1: row maxima. The warp's chunks, staged rows [r0, r0 + 16 *
  // chunks), hold every key its queries' bands reach
  float mx[2] = {masked, masked};
  for (int c = 0; c < chunks; ++c) {
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
  for (int c = 0; c < chunks; ++c) {
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

template <int MODE, bool FIXED>
int launch_span(const void* q, int q_stride, const void* k, int k_stride, const void* v,
                int v_stride, const void* cos_t, const void* sin_t, void* out, int N, int T, int H,
                int win_upper, int win_lower, int ref_elems, void* stream) {
  const int chunks = FIXED ? NARROW_CHUNKS : (16 + win_upper + win_lower + 15) / 16;
  const int smem = (BQ + 2 * (48 + 16 * chunks)) * LD * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attention_banded_kernel<MODE, FIXED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attention_banded_kernel<MODE, FIXED><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), q_stride, static_cast<const __nv_bfloat16*>(k),
      k_stride, static_cast<const __nv_bfloat16*>(v), v_stride,
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(out), T, H, win_upper, win_lower, ref_elems, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch(const void* q, int q_stride, const void* k, int k_stride, const void* v, int v_stride,
           const void* cos_t, const void* sin_t, void* out, int N, int T, int H, int head_dim,
           int win_upper, int win_lower, int ref_elems, void* stream) {
  if (N <= 0 || T <= 0 || H <= 0 || head_dim != D || win_upper < 0 || win_lower < 0 ||
      win_upper > WIN_MAX || win_lower > WIN_MAX || ref_elems <= 0 || N > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (win_upper <= NARROW && win_lower <= NARROW)
    return launch_span<MODE, true>(q, q_stride, k, k_stride, v, v_stride, cos_t, sin_t, out, N, T,
                                   H, win_upper, win_lower, ref_elems, stream);
  return launch_span<MODE, false>(q, q_stride, k, k_stride, v, v_stride, cos_t, sin_t, out, N, T,
                                  H, win_upper, win_lower, ref_elems, stream);
}

const __nv_bfloat16* at(const void* p, size_t offset) {
  return static_cast<const __nv_bfloat16*>(p) + offset;
}

}  // namespace

// All four: heads of 64 channels, windows of at most 256 keys either side
// (the wrappers hold K9, K10 and K11a to the TPU kernels' 128).

// K9: qkv [N, T, 3*H*D], q | k | v head-major; cos, sin [T, D/2] float32.
DTT_EXPORT int attention_banded_bf16(const void* qkv, const void* cos_t, const void* sin_t,
                                     void* out, int N, int T, int H, int head_dim,
                                     int win_upper, int win_lower, int ref_elems, void* stream) {
  const int hd = H * head_dim;
  return launch<ROPE_HEADS>(qkv, 3 * hd, at(qkv, hd), 3 * hd, at(qkv, 2 * hd), 3 * hd, cos_t,
                            sin_t, out, N, T, H, head_dim, win_upper, win_lower, ref_elems,
                            stream);
}

// K11a: qkv [N, T, 3*H*D] with the q and k rows halves-major, v head-major.
DTT_EXPORT int attention_halfperm_bf16(const void* qkv, const void* cos_t, const void* sin_t,
                                       void* out, int N, int T, int H, int head_dim,
                                       int win_upper, int win_lower, int ref_elems,
                                       void* stream) {
  const int hd = H * head_dim;
  return launch<ROPE_HALVES>(qkv, 3 * hd, at(qkv, hd), 3 * hd, at(qkv, 2 * hd), 3 * hd, cos_t,
                             sin_t, out, N, T, H, head_dim, win_upper, win_lower, ref_elems,
                             stream);
}

// K10: qk [N, T, 2*H*D] rotated q | k; v from the projection qkv [N, T, 3*H*D].
DTT_EXPORT int attention_prerotated_bf16(const void* qk, const void* qkv, void* out, int N,
                                         int T, int H, int head_dim, int win_upper,
                                         int win_lower, int ref_elems, void* stream) {
  const int hd = H * head_dim;
  return launch<PLAIN>(qk, 2 * hd, at(qk, hd), 2 * hd, at(qkv, 2 * hd), 3 * hd, nullptr,
                       nullptr, out, N, T, H, head_dim, win_upper, win_lower, ref_elems, stream);
}

// K11b: q, k, v [N, T, H, D] each.
DTT_EXPORT int attention_separate_bf16(const void* q, const void* k, const void* v, void* out,
                                       int N, int T, int H, int head_dim, int win_upper,
                                       int win_lower, int ref_elems, void* stream) {
  const int hd = H * head_dim;
  return launch<PLAIN>(q, hd, k, hd, v, hd, nullptr, nullptr, out, N, T, H, head_dim, win_upper,
                       win_lower, ref_elems, stream);
}
