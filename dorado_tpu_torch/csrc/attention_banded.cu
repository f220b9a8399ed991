// Banded (windowed) softmax attention of the sup transformer, on four layouts
// of q, k and v. One kernel body, instantiated for three ways of staging q
// and k; four entry points. Two more at float32 (K10 and K11a, below), on a
// float32 body with two ways of staging q and k.
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
// are 69 GFLOP. The first design staged a block's 64 queries and all 320
// keys their bands reach at once (101 KB of shared memory, two blocks an
// SM, nothing overlapping the loads), staged and rotated every key five
// times over, and computed the logits twice (a max pass, then the exp
// pass): 1.41 ms, slower than dense SDPA over 4x the work.
//
// Design: a block of 8 warps owns 128 queries of one head and row, each
// warp 16 of them. Their bands reach 112 + 16 * chunks keys from kb = q0 -
// 128 (384 at windows up to 128 a side), so each key is staged and rotated
// 3 times over the blocks. They stream through a two-tile ring of 64 keys
// in shared memory: while the warps compute tile i, the next tile's v rows
// are in flight by cp.async and its k rows by loads into registers, rotated
// and stored once tile i's products are done (the rotation's tables read
// then, so that they hold no registers meanwhile); one barrier a tile. Each
// warp walks the 16-key chunks of its own band, [warp, warp + chunks) of
// the block's, two at a time where the tile holds two (two independent
// chains of products for the scheduler, and half the max and rescale work a
// key), on the tensor cores (mma.sync.m16n8k16 bf16, operands by ldmatrix)
// in one pass with a running max (online softmax): the chunks' logits raise
// the rows' max, the sums and p . v so far are scaled by exp(old max - new
// max), and p = exp(logit - max) is added. p stays f32-accurate through the
// bf16 tensor cores as a sum of two bf16 terms (p = hi + lo, two products),
// since v is bf16 already. Every rotation step is a single rounded
// operation, so the rotated q and k equal the plain version's bit for bit,
// on either rotating layout. Windows of up to 128 keys a side take a fixed
// span (17 chunks a warp, trip counts the compiler knows); wider ones (K11b,
// up to 256) take ceil((16 + wu + wl) / 16) chunks a warp and more tiles,
// with the same 55 KB of shared memory. Warps idle at the band's ends (a
// tile holds none of their chunks); the second block on each SM fills those
// slots, so a design that keeps every warp busy at the price of more
// barriers and registers does not pay.
//
// attention_prerotated_f32 (K10 at float32: the JAX package's
// compute_dtype=float32 stream, which leaves the fused-RoPE route for
// _banded_attention_call) computes the same function on float32 q, k and v
// with no rounding of the output: attention_f32_kernel, the same block of 128
// queries and 8 warps over the same two-tile ring of 64 keys, one 16-key
// chunk a warp at a time. The products are float32 in effect: each operand
// is split into tf32 hi + lo and a . b summed as a_lo b_hi + a_hi b_lo +
// a_hi b_hi on mma.sync m16n8k8 (3xTF32, as K1 float32 does; about 2^-21 of
// each product is lost), for q . k and for p . v alike. q's splits stay in
// registers for the whole band. p . v takes p straight from the logits'
// accumulator fragments: the key order inside an 8-key step does not
// matter to the sum, so the A operand's k index t (t + 4) is read as key 2t
// (2t + 1) of the step, and v's rows are read in that order. Rows are 68
// floats apart in shared memory, so that the fragment loads of q, k and v
// fall on 32 distinct banks (q_s 128 x 68 and the two rings 2 x 64 x 68 each:
// 104 KB, one block an SM). k and v both come by cp.async, since nothing is
// rotated. What bounds it: bytes in the bf16 form's count doubled, and the
// products three times over on tf32 mma.sync, which runs below the card's
// wgmma rate: 2.58 ms at sup's shape against 0.96 ms of float32 operations
// at 67 TFLOP/s, 0.39 at a third of the TF32 rate (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py).
//
// attention_halfperm_f32 (K11a at float32: windowed_attention_halfperm fed
// float32, as the JAX package's float32 stream runs the "hp" route) is the
// same float32 body with K11a's staging: q and k taken halves-major from
// the projection and rotated in float32 from the [T, D/2] tables while they
// are staged (each product and sum singly rounded, as the plain version), q
// once before the band, each tile's k rows loaded into registers while the
// tile before is computed and stored rotated after its products (v still
// by cp.async). Everything after staging is K10 float32's.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int D = 64;            // head width
constexpr int BQ = 128;          // queries a block
constexpr int BK = 64;           // keys a tile of the ring
constexpr int WIN_MAX = 256;     // widest window either side
constexpr int NARROW = 128;      // widest window of the fixed span
constexpr int NARROW_CHUNKS = (16 + 2 * NARROW) / 16;  // 17
constexpr int LD = D + 8;        // shared row stride in bf16 (144 bytes)
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;

// how q and k are staged
constexpr int PLAIN = 0;          // copied: rotated already, or never rotated
constexpr int ROPE_HEADS = 1;     // rotated; a head's halves at h*64 and h*64 + 32
constexpr int ROPE_HALVES = 2;    // rotated; a head's halves at h*32 and H*32 + h*32

__device__ __forceinline__ void unpack8(uint4 v, float out[8]) {
  unpack4(make_uint2(v.x, v.y), out);
  unpack4(make_uint2(v.z, v.w), out + 4);
}

// 8 channels of a q or k row's first half (lo) and their partners of the
// second half (hi), in registers between their load and their store to
// shared memory.
struct RowPart {
  uint4 lo, hi;
};

__device__ __forceinline__ RowPart load_part(const __nv_bfloat16* src, size_t stride, int lo_off,
                                             int hi_off, int t, int T, int c8) {
  RowPart p;
  p.lo = p.hi = make_uint4(0, 0, 0, 0);
  if (t < 0 || t >= T) return p;
  const __nv_bfloat16* s = src + (size_t)t * stride;
  p.lo = *reinterpret_cast<const uint4*>(s + lo_off + c8 * 8);
  p.hi = *reinterpret_cast<const uint4*>(s + hi_off + c8 * 8);
  return p;
}

// Store a RowPart of position t into a staged row, at channels 8 c8 and 32
// + 8 c8, rotated where MODE asks (the tables read here: small, and in L1
// or L2 after the first block): every step a single rounded operation, so
// the staged values equal the plain version's bit for bit. Rows outside
// [0, T) were loaded as zeros and stay zeros.
template <int MODE>
__device__ __forceinline__ void store_part(const RowPart& p, const float* cos_t,
                                           const float* sin_t, int t, int T, int c8,
                                           __nv_bfloat16* row) {
  uint4 out_lo = p.lo, out_hi = p.hi;
  if (MODE != PLAIN && t >= 0 && t < T) {
    float lo[8], hi[8];
    unpack8(p.lo, lo);
    unpack8(p.hi, hi);
    const float* cp = cos_t + (size_t)t * (D / 2) + c8 * 8;
    const float* sp = sin_t + (size_t)t * (D / 2) + c8 * 8;
    const float4 ca = *reinterpret_cast<const float4*>(cp);
    const float4 cb = *reinterpret_cast<const float4*>(cp + 4);
    const float4 sa = *reinterpret_cast<const float4*>(sp);
    const float4 sb = *reinterpret_cast<const float4*>(sp + 4);
    const float c[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    const float s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    uint32_t l[4], h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rl[2], rh[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 2 * i + e;
        rl[e] = __fadd_rn(__fmul_rn(c[d], lo[d]), __fmul_rn(-s[d], hi[d]));
        rh[e] = __fadd_rn(__fmul_rn(c[d], hi[d]), __fmul_rn(s[d], lo[d]));
      }
      l[i] = pack_bf16(rl[0], rl[1]);
      h[i] = pack_bf16(rh[0], rh[1]);
    }
    out_lo = make_uint4(l[0], l[1], l[2], l[3]);
    out_hi = make_uint4(h[0], h[1], h[2], h[3]);
  }
  *reinterpret_cast<uint4*>(row + c8 * 8) = out_lo;
  *reinterpret_cast<uint4*>(row + 32 + c8 * 8) = out_hi;
}

// cp.async of a tile of BK v rows from position t0 into dst [BK][LD]; rows
// outside [0, T) are zero-filled (the copy reads no byte of them).
__device__ __forceinline__ void copy_v(const __nv_bfloat16* v_base, size_t stride, int t0, int T,
                                       __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < BK * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const int t = t0 + r;
    const bool ok = t >= 0 && t < T;
    const __nv_bfloat16* src = v_base + (size_t)(ok ? t : 0) * stride + c * 8;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c * 8));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
                 "r"(ok ? 16 : 0));
  }
}

// q, k, v: the batch row's position 0 of each ([T, q_stride] and so on, in
// bf16 elements); a head's q and k halves at lo_off(h), hi_off(h) of a row
// (MODE), its v and output channels at h * 64. FIXED: windows of at most
// NARROW a side, NARROW_CHUNKS chunks (`chunks` is ignored).
template <int MODE, bool FIXED>
__global__ void __launch_bounds__(THREADS, 2) attention_banded_kernel(
    const __nv_bfloat16* __restrict__ q, int q_stride,
    const __nv_bfloat16* __restrict__ k, int k_stride,
    const __nv_bfloat16* __restrict__ v, int v_stride,
    const float* __restrict__ cos_t,        // [T, D/2] (rotating layouts)
    const float* __restrict__ sin_t,        // [T, D/2]
    __nv_bfloat16* __restrict__ out,        // [N, T, H*D]
    int T, int H, int win_upper, int win_lower, int ref_elems, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (FIXED) chunks = NARROW_CHUNKS;
  // the block's keys [kb, kb + 16 (WARPS - 1) + 16 chunks), in tiles of BK
  const int tiles = (16 * (WARPS - 1) + 16 * chunks + BK - 1) / BK;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* k_s = q_s + BQ * LD;                           // [2][BK][LD]
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;                       // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const int hd = H * D;
  const int lo_off = MODE == ROPE_HALVES ? head * (D / 2) : head * D;
  const int hi_off = MODE == ROPE_HALVES ? hd / 2 + head * (D / 2) : head * D + D / 2;
  const int kb = q0 - (FIXED ? NARROW : win_upper);  // position of the block's key 0
  const __nv_bfloat16* q_base = q + (size_t)n * T * q_stride;
  const __nv_bfloat16* k_base = k + (size_t)n * T * k_stride;
  const __nv_bfloat16* v_base = v + (size_t)n * T * v_stride + head * D;
  // thread tid stages part c8 of row kr of each k tile
  const int kr = tid >> 2, c8 = tid & 3;

  // ---- q (rotated where MODE asks), the first k and v tile -----------------
  for (int i = tid; i < BQ * 4; i += THREADS) {
    const int r = i >> 2, c = i & 3;
    const RowPart p = load_part(q_base, q_stride, lo_off, hi_off, q0 + r, T, c);
    store_part<MODE>(p, cos_t, sin_t, q0 + r, T, c, q_s + r * LD);
  }
  copy_v(v_base, v_stride, kb, T, v_s);
  cp_async_commit();
  {
    const RowPart p = load_part(k_base, k_stride, lo_off, hi_off, kb + kr, T, c8);
    store_part<MODE>(p, cos_t, sin_t, kb + kr, T, c8, k_s + kr * LD);
  }
  cp_async_wait<0>();
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

  // one pass with a running max: m the rows' max so far, sum and o their
  // sums scaled to it
  float mx[2] = {masked, masked};
  float sum[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  // NC chunks of 16 keys from staged row kl of a tile (two give the
  // scheduler two independent chains of products and halve the max and
  // rescale work a key): s[j][2h + e] is row g + 8h, key key0 + 8j + 2 t4 + e
  auto run = [&](auto nc_tag, const __nv_bfloat16* kt, const __nv_bfloat16* vt, int kl,
                 int key0) {
    constexpr int NC = decltype(nc_tag)::value;
    float s[2 * NC][4];
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // b-fragments of keys 8j .. 8j + 7, channels 0-31 and 32-63
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kb4[4];
        ldmatrix_x4(kb4, kt + (kl + 8 * j + (lane & 7)) * LD + half * 32 + (lane >> 3) * 8);
        mma_bf16(s[j], qa[2 * half], kb4[0], kb4[1]);
        mma_bf16(s[j], qa[2 * half + 1], kb4[2], kb4[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t4 + (e & 1);
        const int h = e >> 1;
        s[j][e] = (key >= lo[h] && key <= hi[h]) ? __fmul_rn(s[j][e], scale) : masked;
      }
    }
    float rescale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = masked;
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) m = fmaxf(m, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(mx[h], m);
      rescale[h] = __expf(mx[h] - m_new);
      mx[h] = m_new;
      sum[h] *= rescale[h];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= rescale[0];
      o[dt][1] *= rescale[0];
      o[dt][2] *= rescale[1];
      o[dt][3] *= rescale[1];
    }
    // p = exp(logit - max) (__expf: under 1e-6 relative error for the p
    // that count) as hi + lo, two bf16 terms: f32-accurate through the bf16
    // tensor cores
    uint32_t p_hi[NC][4], p_lo[NC][4];
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], top[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e];
          p[e] = (x == masked) ? 0.f : __expf(x - mx[h]);
          sum[h] += p[e];
          top[e] = __bfloat162float(__float2bfloat16_rn(p[e]));
        }
        // a-fragment order: (row g, keys 0-7), (row g+8, keys 0-7),
        // (row g, keys 8-15), (row g+8, keys 8-15)
        p_hi[j >> 1][2 * (j & 1) + h] = pack_bf16(top[0], top[1]);
        p_lo[j >> 1][2 * (j & 1) + h] = pack_bf16(p[0] - top[0], p[1] - top[1]);
      }
    }
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kl + 16 * ch + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], p_hi[ch], vb[0], vb[1]);
        mma_bf16(o[2 * dp], p_lo[ch], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], p_hi[ch], vb[2], vb[3]);
        mma_bf16(o[2 * dp + 1], p_lo[ch], vb[2], vb[3]);
      }
    }
  };

  // ---- the key tiles: tile i + 1's loads in flight during tile i's products
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    const bool next = i + 1 < tiles;
    const int t_next = kb + (i + 1) * BK + kr;
    RowPart part;
    if (next) {
      copy_v(v_base, v_stride, kb + (i + 1) * BK, T, v_s + (buf ^ 1) * BK * LD);
      cp_async_commit();
      part = load_part(k_base, k_stride, lo_off, hi_off, t_next, T, c8);
    }
    // the warp's chunks, block chunks [warp, warp + chunks), that lie in
    // this tile, two at a time
    const __nv_bfloat16* kt = k_s + buf * BK * LD;
    const __nv_bfloat16* vt = v_s + buf * BK * LD;
    const int c_end = min((i + 1) * (BK / 16), warp + chunks);
    int c = max(i * (BK / 16), warp);
    for (; c + 1 < c_end; c += 2)
      run(std::integral_constant<int, 2>{}, kt, vt, 16 * (c - i * (BK / 16)), kb + 16 * c);
    if (c < c_end)
      run(std::integral_constant<int, 1>{}, kt, vt, 16 * (c - i * (BK / 16)), kb + 16 * c);
    if (next)
      store_part<MODE>(part, cos_t, sin_t, t_next, T, c8, k_s + ((buf ^ 1) * BK + kr) * LD);
    cp_async_wait<0>();
    __syncthreads();
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
  const int smem = (BQ + 4 * BK) * LD * (int)sizeof(__nv_bfloat16);
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

// ---- K10 at float32 ----------------------------------------------------------

constexpr int LDF = D + 4;  // shared row stride in floats: conflict-free fragment loads

// cp.async of `rows` float rows of D channels from position t0 into dst
// [rows][LDF]; rows outside [0, T) are zero-filled (the copy reads no byte
// of them).
__device__ __forceinline__ void copy_rows_f32(const float* base, size_t stride, int t0, int rows,
                                              int T, float* dst) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = i % (D / 4);
    const int t = t0 + r;
    const bool ok = t >= 0 && t < T;
    const float* src = base + (size_t)(ok ? t : 0) * stride + c * 4;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LDF + c * 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
                 "r"(ok ? 16 : 0));
  }
}

// K11a at float32: 4 channels of a q or k row's first half (lo) and their
// partners of the second half (hi), in registers between their load and
// their rotated store.
struct HalfPartF32 {
  float4 lo, hi;
};

// Item i of a tile of rows from position t0 (row i / 8, channels 4 (i % 8) of
// each half), of a row whose head's halves sit at lo_off and hi_off; zeros
// outside [0, T).
__device__ __forceinline__ HalfPartF32 load_half_f32(const float* base, size_t stride, int lo_off,
                                                     int hi_off, int t0, int T, int i) {
  HalfPartF32 p;
  p.lo = p.hi = make_float4(0.f, 0.f, 0.f, 0.f);
  const int t = t0 + i / 8, c4 = 4 * (i % 8);
  if (t < 0 || t >= T) return p;
  const float* s = base + (size_t)t * stride;
  p.lo = *reinterpret_cast<const float4*>(s + lo_off + c4);
  p.hi = *reinterpret_cast<const float4*>(s + hi_off + c4);
  return p;
}

// Its rotation, stored at channels 4 (i % 8) and 32 + 4 (i % 8) of staged row
// i / 8 of dst [rows][LDF]: lo' = cos lo + (-sin) hi, hi' = cos hi + sin lo,
// each product and sum a single rounded operation, as the plain version
// computes them in float32.
__device__ __forceinline__ void store_half_f32(const HalfPartF32& p, const float* cos_t,
                                               const float* sin_t, int t0, int T, int i,
                                               float* dst) {
  const int t = t0 + i / 8, c4 = 4 * (i % 8);
  float4 lo = p.lo, hi = p.hi;
  if (t >= 0 && t < T) {
    const float4 c = *reinterpret_cast<const float4*>(cos_t + (size_t)t * (D / 2) + c4);
    const float4 sn = *reinterpret_cast<const float4*>(sin_t + (size_t)t * (D / 2) + c4);
    auto rot_lo = [](float cv, float sv, float l, float h) {
      return __fadd_rn(__fmul_rn(cv, l), __fmul_rn(-sv, h));
    };
    auto rot_hi = [](float cv, float sv, float l, float h) {
      return __fadd_rn(__fmul_rn(cv, h), __fmul_rn(sv, l));
    };
    lo = make_float4(rot_lo(c.x, sn.x, p.lo.x, p.hi.x), rot_lo(c.y, sn.y, p.lo.y, p.hi.y),
                     rot_lo(c.z, sn.z, p.lo.z, p.hi.z), rot_lo(c.w, sn.w, p.lo.w, p.hi.w));
    hi = make_float4(rot_hi(c.x, sn.x, p.lo.x, p.hi.x), rot_hi(c.y, sn.y, p.lo.y, p.hi.y),
                     rot_hi(c.z, sn.z, p.lo.z, p.hi.z), rot_hi(c.w, sn.w, p.lo.w, p.hi.w));
  }
  float* row = dst + (i / 8) * LDF;
  *reinterpret_cast<float4*>(row + c4) = lo;
  *reinterpret_cast<float4*>(row + D / 2 + c4) = hi;
}

// q, k, v: the batch row's position 0 of each head's channels ([T, stride]
// floats); the rest as attention_banded_kernel. HALVES (K11a at float32): q
// and k are the batch row's position 0 of the projection's q and k thirds,
// halves-major (a head's halves at h * 32 and H * 32 + h * 32), rotated by
// the [T, D/2] tables while staged: q's rows before the band, each tile's k
// rows loaded into registers while the tile before it is computed and
// stored rotated after it (v comes by cp.async as before).
template <bool FIXED, bool HALVES>
__global__ void __launch_bounds__(THREADS, 1) attention_f32_kernel(
    const float* __restrict__ q, int q_stride, const float* __restrict__ k, int k_stride,
    const float* __restrict__ v, int v_stride, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float* __restrict__ out, int T, int H,
    int win_upper, int win_lower, int ref_elems, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (FIXED) chunks = NARROW_CHUNKS;
  const int tiles = (16 * (WARPS - 1) + 16 * chunks + BK - 1) / BK;
  float* q_s = reinterpret_cast<float*>(smem);  // [BQ][LDF]
  float* k_s = q_s + BQ * LDF;                  // [2][BK][LDF]
  float* v_s = k_s + 2 * BK * LDF;              // [2][BK][LDF]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const int hd = H * D;
  const int kb = q0 - (FIXED ? NARROW : win_upper);  // position of the block's key 0
  const float* q_base = q + (size_t)n * T * q_stride + (HALVES ? 0 : head * D);
  const float* k_base = k + (size_t)n * T * k_stride + (HALVES ? 0 : head * D);
  const float* v_base = v + (size_t)n * T * v_stride + head * D;
  const int lo_off = head * (D / 2), hi_off = H * (D / 2) + head * (D / 2);  // HALVES
  constexpr int K_ITEMS = BK * 8 / THREADS;  // a thread's items of a tile of k rows (HALVES)

  if constexpr (HALVES) {
#pragma unroll
    for (int j = 0; j < BQ * 8 / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      store_half_f32(load_half_f32(q_base, q_stride, lo_off, hi_off, q0, T, i), cos_t, sin_t,
                     q0, T, i, q_s);
    }
#pragma unroll
    for (int j = 0; j < K_ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      store_half_f32(load_half_f32(k_base, k_stride, lo_off, hi_off, kb, T, i), cos_t, sin_t,
                     kb, T, i, k_s);
    }
  } else {
    copy_rows_f32(q_base, q_stride, q0, BQ, T, q_s);
    copy_rows_f32(k_base, k_stride, kb, BK, T, k_s);
  }
  copy_rows_f32(v_base, v_stride, kb, BK, T, v_s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- this warp's 16 queries, split for 3xTF32 ------------------------------
  const int r0 = warp * 16;
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float* p = q_s + (r0 + g) * LDF + kk * 8 + t4;
    tf32_split(p[0], qh[kk][0], ql[kk][0]);
    tf32_split(p[8 * LDF], qh[kk][1], ql[kk][1]);
    tf32_split(p[4], qh[kk][2], ql[kk][2]);
    tf32_split(p[8 * LDF + 4], qh[kk][3], ql[kk][3]);
  }
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
  float mx[2] = {masked, masked};
  float sum[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  // one chunk of 16 keys from staged row kl of a tile: s[j][2h + e] is row
  // g + 8h, key key0 + 8j + 2 t4 + e
  auto run = [&](const float* kt, const float* vt, int kl, int key0) {
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float* kp = kt + (kl + 8 * j + g) * LDF + kk * 8 + t4;
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(kp[0], bh0, bl0);
        tf32_split(kp[4], bh1, bl1);
        mma_3xtf32_split(s[j], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t4 + (e & 1);
        const int h = e >> 1;
        s[j][e] = (key >= lo[h] && key <= hi[h]) ? __fmul_rn(s[j][e], scale) : masked;
      }
    }
    float rescale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(mx[h], m);
      rescale[h] = __expf(mx[h] - m_new);
      mx[h] = m_new;
      sum[h] *= rescale[h];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= rescale[0];
      o[dt][1] *= rescale[0];
      o[dt][2] *= rescale[1];
      o[dt][3] *= rescale[1];
    }
    // p in the A operand's order: k index t4 is key 2 t4 of the step, t4 + 4
    // key 2 t4 + 1 (v's rows are read in the same order below)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[j][e] == masked ? 0.f : __expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += p[e];
      }
      uint32_t ph[4], pl[4];
      tf32_split(p[0], ph[0], pl[0]);  // row g, key 2 t4
      tf32_split(p[2], ph[1], pl[1]);  // row g + 8, key 2 t4
      tf32_split(p[1], ph[2], pl[2]);  // row g, key 2 t4 + 1
      tf32_split(p[3], ph[3], pl[3]);  // row g + 8, key 2 t4 + 1
      const float* vp = vt + (kl + 8 * j + 2 * t4) * LDF + g;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(vp[dt * 8], bh0, bl0);
        tf32_split(vp[LDF + dt * 8], bh1, bl1);
        mma_3xtf32_split(o[dt], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  };

  // ---- the key tiles: tile i + 1's copies in flight during tile i's products
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    const int t_next = kb + (i + 1) * BK;
    HalfPartF32 kn[HALVES ? K_ITEMS : 1];  // HALVES: tile i + 1's k rows, in flight
    if (i + 1 < tiles) {
      if constexpr (HALVES) {
#pragma unroll
        for (int j = 0; j < K_ITEMS; ++j)
          kn[j] = load_half_f32(k_base, k_stride, lo_off, hi_off, t_next, T,
                                threadIdx.x + j * THREADS);
      } else {
        copy_rows_f32(k_base, k_stride, t_next, BK, T, k_s + (buf ^ 1) * BK * LDF);
      }
      copy_rows_f32(v_base, v_stride, t_next, BK, T, v_s + (buf ^ 1) * BK * LDF);
      cp_async_commit();
    }
    const float* kt = k_s + buf * BK * LDF;
    const float* vt = v_s + buf * BK * LDF;
    const int c_end = min((i + 1) * (BK / 16), warp + chunks);
    for (int c = max(i * (BK / 16), warp); c < c_end; ++c)
      run(kt, vt, 16 * (c - i * (BK / 16)), kb + 16 * c);
    // HALVES: tile i + 1's k rows rotated into the buffer tile i - 1 used,
    // which every warp left before the barrier that ended tile i - 1
    if constexpr (HALVES) {
      if (i + 1 < tiles) {
#pragma unroll
        for (int j = 0; j < K_ITEMS; ++j)
          store_half_f32(kn[j], cos_t, sin_t, t_next, T, threadIdx.x + j * THREADS,
                         k_s + (buf ^ 1) * BK * LDF);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + r0 + g + 8 * h;
    if (t >= T) continue;
    float* dst = out + ((size_t)n * T + t) * hd + head * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8) =
          make_float2(__fdiv_rn(o[dt][2 * h], sum[h]), __fdiv_rn(o[dt][2 * h + 1], sum[h]));
  }
}

template <bool FIXED, bool HALVES>
int launch_f32_span(const float* q, int q_stride, const float* k, int k_stride, const float* v,
                    int v_stride, const float* cos_t, const float* sin_t, float* out, int N,
                    int T, int H, int win_upper, int win_lower, int ref_elems, void* stream) {
  const int chunks = FIXED ? NARROW_CHUNKS : (16 + win_upper + win_lower + 15) / 16;
  const int smem = (BQ + 4 * BK) * LDF * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel<FIXED, HALVES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, N);
  attention_f32_kernel<FIXED, HALVES><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, q_stride, k, k_stride, v, v_stride, cos_t, sin_t, out, T, H, win_upper, win_lower,
      ref_elems, chunks);
  return static_cast<int>(cudaGetLastError());
}

// K10 (HALVES false) or K11a (true) at float32: qk the rotated q | k [N, T,
// 2*H*D] (K10) or the projection [N, T, 3*H*D] with its q and k halves-major
// (K11a, rotated by the [T, D/2] tables); v at channel block 2 of the
// projection qkv [N, T, 3*H*D].
template <bool HALVES>
int launch_f32(const void* qk, const void* qkv, const void* cos_t, const void* sin_t, void* out,
               int N, int T, int H, int head_dim, int win_upper, int win_lower, int ref_elems,
               void* stream) {
  if (N <= 0 || T <= 0 || H <= 0 || head_dim != D || win_upper < 0 || win_lower < 0 ||
      win_upper > WIN_MAX || win_lower > WIN_MAX || ref_elems <= 0 || N > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = H * head_dim;
  const int stride = HALVES ? 3 * hd : 2 * hd;
  const float* qp = static_cast<const float*>(qk);
  const float* vp = static_cast<const float*>(qkv) + 2 * hd;
  const float* c = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  float* o = static_cast<float*>(out);
  if (win_upper <= NARROW && win_lower <= NARROW)
    return launch_f32_span<true, HALVES>(qp, stride, qp + hd, stride, vp, 3 * hd, c, sn, o, N, T,
                                         H, win_upper, win_lower, ref_elems, stream);
  return launch_f32_span<false, HALVES>(qp, stride, qp + hd, stride, vp, 3 * hd, c, sn, o, N, T,
                                        H, win_upper, win_lower, ref_elems, stream);
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

// K10 at float32: qk [N, T, 2*H*D] rotated q | k; v from the projection qkv
// [N, T, 3*H*D]; all float32.
DTT_EXPORT int attention_prerotated_f32(const void* qk, const void* qkv, void* out, int N,
                                        int T, int H, int head_dim, int win_upper,
                                        int win_lower, int ref_elems, void* stream) {
  return launch_f32<false>(qk, qkv, nullptr, nullptr, out, N, T, H, head_dim, win_upper,
                           win_lower, ref_elems, stream);
}

// K11a at float32: qkv [N, T, 3*H*D] float32 with the q and k rows
// halves-major, v head-major; cos, sin [T, D/2] float32.
DTT_EXPORT int attention_halfperm_f32(const void* qkv, const void* cos_t, const void* sin_t,
                                      void* out, int N, int T, int H, int head_dim,
                                      int win_upper, int win_lower, int ref_elems,
                                      void* stream) {
  return launch_f32<true>(qkv, qkv, cos_t, sin_t, out, N, T, H, head_dim, win_upper, win_lower,
                          ref_elems, stream);
}
